"""Parity of the port's spherical k-means with wdbx_tpu's, on the CPU.

The random streams of jax.random and torch.Generator differ, so the two
packages do not pick the same centroids from the same seed. The tests
hold what must agree: the objective (mean cosine of each row to its
assigned centroid) on a Gaussian mixture, within 0.01 of JAX's, for both
seeding branches (k-means++ up to 256 clusters, batched seeding above);
the port's ``index_add_`` Lloyd step against the one-hot product the JAX
package takes below 256 MB; the assignment given the same centroids,
exactly; and the empty-cluster rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wdbx_tpu.ops.kmeans import kmeans as j_kmeans
from wdbx_tpu_torch.ops.kmeans import assign_nearest, kmeans, lloyd_step

torch.set_num_threads(2)


def _mixture(rng, n, d, comps, noise=0.3):
    centers = rng.standard_normal((comps, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, comps, n)] + np.float32(noise / np.sqrt(d)) \
        * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _objective(x, cents, assign):
    return float(np.mean(np.sum(x * cents[assign], axis=1)))


@pytest.mark.parametrize("n,d,c", [
    (2000, 16, 12),     # k-means++ seeding
    (2000, 32, 40),     # k-means++ seeding, wider rows
    (1200, 16, 300),    # batched Gumbel-top-k seeding
])
def test_kmeans_objective_matches(rng, n, d, c):
    # fewer components than clusters: with one cluster per component the
    # objective depends on which local optimum the seeding lands in, in
    # either package
    x = _mixture(rng, n, d, comps=min(c // 2, 64))
    cj, aj = j_kmeans(jnp.asarray(x), num_clusters=c, iters=8)
    ct, at = kmeans(torch.from_numpy(x), num_clusters=c, iters=8)
    cj, aj = np.asarray(cj), np.asarray(aj)
    assert ct.shape == (c, d) and at.dtype == torch.int32
    np.testing.assert_allclose(np.linalg.norm(ct.numpy(), axis=1), 1.0,
                               atol=1e-5)
    obj_j = _objective(x, cj, aj)
    obj_t = _objective(x, ct.numpy(), at.numpy())
    assert abs(obj_t - obj_j) <= 0.01, (obj_t, obj_j)


def test_scatter_and_onehot_steps_agree(rng):
    # the JAX package's one-hot accumulation, in numpy
    x = _mixture(rng, 900, 16, 8)
    cents = x[:20].copy()
    onehot = np.eye(20, dtype=np.float32)[np.argmax(x @ cents.T, axis=1)]
    counts = onehot.sum(axis=0)[:, None]
    want = np.where(counts > 0, (onehot.T @ x) / np.maximum(counts, 1.0),
                    cents)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    got = lloyd_step(torch.from_numpy(x), torch.from_numpy(cents))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_assignment_matches_jax_given_centroids(rng):
    x = _mixture(rng, 1500, 32, 16)
    cj, aj = j_kmeans(jnp.asarray(x), num_clusters=16, iters=5)
    got = assign_nearest(torch.from_numpy(x), torch.from_numpy(np.asarray(cj)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(aj))


def test_empty_cluster_keeps_its_centroid(rng):
    x = np.abs(_mixture(rng, 400, 8, 4))  # all in the positive orthant
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    far = -np.ones((1, 8), np.float32) / np.float32(np.sqrt(8))  # nearest to no row
    cents = torch.from_numpy(np.concatenate([x[:3], far]))
    new = lloyd_step(torch.from_numpy(x), cents)
    np.testing.assert_allclose(new[3].numpy(), far[0], atol=1e-6)
    assert torch.isfinite(new).all()
