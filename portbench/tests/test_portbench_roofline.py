"""The roofline arithmetic reproduces the bounds the repository's kernel
table was measured against (``chip_smoke.py``, NVIDIA H100 80GB HBM3)."""

import pytest

from portbench import roofline


def test_k1_bf16_search_bound_at_1m_x_384():
    # PERF.md's kernel table: K1 bf16, 1,048,576 x 384, B=128, k=10
    t, by = roofline.flat_search_s("bfloat16", 1 << 20, 384, 128, 10)
    assert by == "bytes"
    assert round(t * 1e3, 3) == 0.241


def test_k3_int8_bound_at_10m_x_768():
    # the chip log's K3 int8 row at nprobe 1: 490 live blocks of 1,024
    # rows, u = 1,024, B=128, k=10, bound_ms 0.11584343880597016
    t, by = roofline.block_scan_s("int8", "bfloat16", 490, 1024, 768, 128,
                                  10, 1024)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(0.11584343880597016, rel=1e-12)


def test_k3_int8_bound_grows_with_live_blocks():
    # nprobe 4's widest batch read 1,651 live blocks in the same log
    t1, _ = roofline.block_scan_s("int8", "bfloat16", 490, 1024, 768, 128,
                                  10, 1024)
    t4, _ = roofline.block_scan_s("int8", "bfloat16", 1651, 1024, 768, 128,
                                  10, 4096)
    assert t4 / t1 == pytest.approx(1651 / 490, rel=1e-3)


def test_k1_stage1_at_the_bulk_cell():
    # 10M valid bf16 rows of 768, B=128: bytes-bound near 4.59 ms
    t, by = roofline.flat_stage1_s("bfloat16", 10_000_000, 768, 128, 10, 132)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(4.589, abs=2e-3)
    ops = 2.0 * 128 * 10_000_000 * 768 / roofline.PEAK_OPS_S["bfloat16"]
    assert ops < t


def test_operations_bound_a_float32_slab():
    t, by = roofline.flat_search_s("float32", 1 << 20, 384, 128, 10)
    assert by == "operations"
    assert t == pytest.approx(2.0 * 128 * (1 << 20) * 384 / 67e12)
