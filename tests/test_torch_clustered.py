"""Parity of the port's ClusteredIVFIndex with wdbx_tpu's, on the CPU:
the search paths.

A JAX index is built (its k-means picks the layout) and carried into the
port with ``clustered_index_from_arrays``, so both serve the same slab,
slot maps, centroids and extents and k-means randomness plays no part.
Blocks are c = 256 rows (``block_bytes_target = 1``). JAX's kernel path
runs its Pallas kernels in interpret mode (``ivf_kernel="pallas"``), the
port's runs their plain version on the CPU. Batches of the block paths
are powers of two, so JAX pads no query rows (its pad rows' probes of
buckets 0..P-1 are a deliberate difference of the port). Hits must name
the same slots, except at ties, with the tolerances of test_torch_ops.
"""

import numpy as np
import pytest
import torch

from test_torch_ops import TOL, assert_topk_match
from wdbx_tpu.index.clustered import ClusteredIVFIndex as JIndex
from wdbx_tpu_torch.convert import clustered_index_from_arrays
from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex as TIndex

torch.set_num_threads(2)

D = 32


def mixture(rng, n, d=D, comps=16, noise=0.6):
    centers = rng.standard_normal((comps, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, comps, n)] + noise / np.sqrt(d) * \
        rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32)


def jax_index(rng, dtype="float32", n=3000, nlist=16, nprobe=2, c=256,
              x=None):
    """A built JAX index over ``n`` mixture rows, c-row blocks."""
    j = JIndex(D, dtype=dtype, nlist=nlist, nprobe=nprobe,
               train_threshold=256, capacity=4096)
    j.batch_flat_fallback = False  # the real block scan
    row_bytes = D // 2 if dtype == "int4" else D * {
        "float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    j.block_bytes_target = 1 if c == 256 else c * row_bytes
    j.add_batch(mixture(rng, n) if x is None else x)
    j.build()
    assert j._c == c
    return j


def carry(j) -> TIndex:
    """The JAX index's in-memory state, as numpy, into a port index."""
    arrays = {"slab": np.asarray(j._slab), "valid": np.asarray(j._valid),
              "slot_of": j._slot_of,
              "residual": np.asarray(j._residual, np.int64)}
    if j._scales is not None:
        arrays["scales"] = np.asarray(j._scales)
    if j.is_trained:
        arrays["centroids"] = np.asarray(j._centroids)
        arrays["bucket_start"] = j._bucket_start
    meta = dict(
        dim=j.dim, metric=j.metric, dtype=j.dtype_name, size=j._size,
        next_slot=j._next_slot, free=list(j._free), capacity=j._cap,
        nlist=j.nlist, nprobe=j.nprobe, trained=j.is_trained,
        built_size=j._built_size, residual_base=j._residual_base,
        next_ext_slot=j._next_ext_slot, free_slots=list(j._free_slots),
        pos_quarantine=j._quar_flat(), block_rows=j._c,
        fresh_base=j._fresh_base,
    )
    t = clustered_index_from_arrays(arrays, meta, device="cpu")
    t.batch_flat_fallback = j.batch_flat_fallback
    return t


def set_both(j, t, **attrs):
    for key, value in attrs.items():
        setattr(j, key, value)
        setattr(t, key, value)


def assert_same_search(j, t, q, k, tol, slot_mask=None):
    sj, ij = j.search(q, k, slot_mask=slot_mask)
    st, it = t.search(q, k, slot_mask=slot_mask)
    assert it.dtype == np.int64 and st.shape == sj.shape
    assert_topk_match(sj, ij, st, it, tol)
    return st, it


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("kernel", ["lax", "pallas"])
def test_block_scan_paths_match(rng, dtype, kernel):
    j = jax_index(rng, dtype)
    t = carry(j)
    set_both(j, t, ivf_kernel=kernel)
    q = mixture(rng, 16)
    assert t._use_kernel(10) == (kernel == "pallas")
    assert not t._use_ranges(16, t.nprobe)
    assert_same_search(j, t, q, 10, TOL[dtype])


@pytest.mark.parametrize("version,qprec", [("v1", "bf16"), ("v2", "bf16"),
                                           ("v2", "int8"), ("v1", "int8")])
def test_kernel_generations_and_query_precision(rng, version, qprec):
    j = jax_index(rng, "int8")
    t = carry(j)
    set_both(j, t, ivf_kernel="pallas", kernel_version=version,
             kernel_qprec=qprec)
    assert t._kernel_gen() == version
    assert_same_search(j, t, mixture(rng, 8), 10, TOL["int8"])


def test_int4_v1_takes_v2(rng):
    j = jax_index(rng, "int4")
    t = carry(j)
    set_both(j, t, ivf_kernel="pallas", kernel_version="v1")
    assert t._kernel_gen() == j._kernel_gen() == "v2"
    assert_same_search(j, t, mixture(rng, 8), 10, TOL["int4"])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("b", [1, 3])
def test_ranges_path_matches(rng, dtype, b):
    j = jax_index(rng, dtype, nprobe=3)
    t = carry(j)
    assert t._use_ranges(4, 3) and j._use_ranges(4, 3)
    assert_same_search(j, t, mixture(rng, b), 10, TOL[dtype])


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
def test_narrow_geometry_at_small_batch(rng, kernel):
    """B <= 4 with the ranges path off scans the c/4 extents."""
    j = jax_index(rng, "bfloat16", c=1024, nprobe=3)
    t = carry(j)
    set_both(j, t, ivf_kernel=kernel, latency_path="narrow")
    assert t._small["c"] == 256 and t._c == 1024
    assert_same_search(j, t, mixture(rng, 1), 10, TOL["bfloat16"])
    assert_same_search(j, t, mixture(rng, 4), 10, TOL["bfloat16"])


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
def test_search_pipelined_matches(rng, kernel):
    j = jax_index(rng, "int8")
    t = carry(j)
    set_both(j, t, ivf_kernel=kernel)
    qs = mixture(rng, 16).reshape(2, 8, D)
    sj, ij = j.search_pipelined(qs, 10)
    st, it = t.search_pipelined(qs, 10)
    assert st.shape == (2, 8, 10)
    assert_topk_match(sj, ij, st, it, TOL["int8"])
    # the unresolved device tensors resolve to the same hits
    handle = t.search_pipelined(torch.from_numpy(qs), 10, materialize=False)
    assert isinstance(handle.scores, torch.Tensor)
    s2, i2 = t.resolve_pipelined(handle)
    np.testing.assert_array_equal(i2, it)


@pytest.mark.parametrize("kernel", ["lax", "pallas"])
@pytest.mark.parametrize("frac", [0.25, 0.01])
def test_filtered_search_matches(rng, kernel, frac):
    """~25% selectivity pushes the mask down into the scan (nprobe
    boosted); under 2% the search takes the exact masked scan."""
    j = jax_index(rng, "float32")
    t = carry(j)
    set_both(j, t, ivf_kernel=kernel)
    mask = rng.random(4096) < frac
    pm = t._pos_mask(mask)
    _, nprobe, exact = t._filter_plan(mask, t.nprobe, 16)
    assert exact == (frac < 0.02)
    assert (j._filter_plan(mask, j.nprobe, 16)[1:]) == (nprobe, exact)
    np.testing.assert_array_equal(pm, j._pos_mask(mask))
    st, it = assert_same_search(j, t, mixture(rng, 8), 10, TOL["float32"],
                                slot_mask=mask)
    assert mask[it[it >= 0]].all()


def test_deep_k_takes_the_portable_scan(rng):
    """Past KERNEL_K_MAX the kernel path hands over to the portable scan
    in both packages."""
    j = jax_index(rng, "bfloat16")
    t = carry(j)
    set_both(j, t, ivf_kernel="pallas", KERNEL_K_MAX=8)
    assert not t._use_kernel(10) and t._use_kernel(8)
    assert_same_search(j, t, mixture(rng, 8), 10, TOL["bfloat16"])


def test_pos_mask_cache_sees_in_place_writes(rng):
    """The position-mask cache is keyed on the write counter: a delete
    in place (same ``_valid`` tensor) must not serve a stale mask."""
    t = carry(jax_index(rng, "float32"))
    mask = np.ones(4096, bool)
    before = t._pos_mask(mask)
    t.remove_slots(np.arange(10))
    after = t._pos_mask(mask)
    assert before is not after
    assert before.sum() - after.sum() == 10
