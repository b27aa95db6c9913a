"""Parity of the port's query-side prep for the clustered block scan
(``prep_query_block``) with wdbx_tpu's, on the CPU.

int8 query codes and their scales must be bit-identical to the JAX
function as its callers run it, under ``jit`` (both libraries round half
to even; compiled, XLA turns ``qmax / 127.0`` into a product with the
float32 reciprocal, while an eager call divides and differs in the last
bit for some rows). The port does not pad batches under 32 rows: its
rows must equal the first rows of JAX's padded block.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wdbx_tpu.kernels import quant as jquant
from wdbx_tpu_torch.kernels import quant as tquant

torch.set_num_threads(2)


@pytest.mark.parametrize("b,d", [(1, 64), (5, 32), (37, 64)])
def test_int8_query_codes_bit_identical(rng, b, d):
    q = rng.standard_normal((b, d)).astype(np.float32) * 3
    q[0] = 0.0  # the 1e-20 floor of an all-zero query
    if b > 1:
        q[1, :3] = [127.0, 63.5, -63.5]  # scale 1: exact halves
    prep = jax.jit(partial(jquant.prep_query_block, slab_dtype=jnp.int8,
                           int8=True, qprec="int8"))
    qj, sj, bj = prep(jnp.asarray(q))
    qt, st, bt = tquant.prep_query_block(torch.from_numpy(q), torch.int8,
                                         True, "INT8")
    assert bj == bt == b
    assert qt.dtype == torch.int8 and st.shape == (b, 1)
    np.testing.assert_array_equal(np.asarray(qj)[:b], qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj)[:b], st.numpy())
    assert (qt.numpy()[0] == 0).all() and st[0, 0] > 0


@pytest.mark.parametrize("slab,int8", [("int8", True), ("bfloat16", False),
                                       ("float32", False)])
def test_float_query_types_match(rng, slab, int8):
    q = rng.standard_normal((5, 32)).astype(np.float32)
    jdt = {"int8": jnp.int8, "bfloat16": jnp.bfloat16,
           "float32": jnp.float32}[slab]
    tdt = getattr(torch, slab)
    qj, sj, _ = jquant.prep_query_block(jnp.asarray(q), jdt, int8, "bf16")
    qt, st, _ = tquant.prep_query_block(torch.from_numpy(q), tdt, int8,
                                        "bf16")
    want = torch.bfloat16 if int8 else tdt
    assert qt.dtype == want and (st.numpy() == 0).all()
    np.testing.assert_array_equal(
        np.asarray(qj, np.float32)[:5], qt.to(torch.float32).numpy()
    )


def test_unknown_qprec_raises():
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="qprec"):
        tquant.prep_query_block(q, torch.int8, True, "fp8")
    with pytest.raises(ValueError, match="qprec"):
        jquant.prep_query_block(jnp.zeros((2, 8)), jnp.int8, True, "fp8")
