"""The cases of ``tests/test_metrics.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (5 cases):
TestLatencyRecorder: test_record_and_summary, test_timed_context,
test_reservoir_bounds_memory, test_reset, test_store_integration.

Changed beyond the imports and the fixture: nothing. Left out: nothing.

The reference file's description:

Latency metrics tests.
"""

import numpy as np

from wdbx_tpu_torch.utils.metrics import LatencyRecorder

import pytest
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


class TestLatencyRecorder:
    def test_record_and_summary(self):
        rec = LatencyRecorder()
        for ms in (1, 2, 3, 4, 100):
            rec.record("search", ms / 1000)
        s = rec.summary()["search"]
        assert s["count"] == 5
        assert 1 <= s["p50_ms"] <= 4
        assert s["p99_ms"] >= 50
        assert s["mean_ms"] > 0

    def test_timed_context(self):
        rec = LatencyRecorder()
        with rec.timed("op"):
            x = sum(range(1000))
        assert rec.summary()["op"]["count"] == 1

    def test_reservoir_bounds_memory(self):
        rec = LatencyRecorder(capacity=64)
        for i in range(1000):
            rec.record("op", 0.001)
        assert len(rec._data["op"]) == 64
        assert rec.summary()["op"]["count"] == 1000

    def test_reset(self):
        rec = LatencyRecorder()
        rec.record("op", 0.001)
        rec.reset()
        assert rec.summary() == {}

    def test_store_integration(self, temp_dir, rng):
        from wdbx_tpu_torch.core.config import WDBXConfig
        from wdbx_tpu_torch.store.vector_store import VectorStore

        store = VectorStore(
            WDBXConfig({"VECTOR_DIMENSION": 8, "DATA_DIR": temp_dir})
        )
        store.store("a", rng.standard_normal(8).astype(np.float32))
        store.search(rng.standard_normal(8).astype(np.float32))
        latency = store.get_stats()["latency"]
        assert latency["store"]["count"] == 1
        assert latency["search"]["count"] == 1
