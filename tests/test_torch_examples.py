"""The port's walkthroughs (``wdbx_tpu_torch/examples/``) on the CPU, at
the cuts of ``tests/test_examples.py``: 500 rows for ``basic_usage``,
``CHUNK = 1_024`` for ``clustered_at_scale``; the mesh examples on 8
logical shards. Each runs in-process through its ``main(argv)`` with
``--device cpu`` and prints what its JAX counterpart prints."""

import numpy as np
import pytest
import torch

from wdbx_tpu_torch.examples import (
    basic_usage,
    clustered_at_scale,
    production_serving,
    rag_implementation,
    sharded_serving,
)
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the mesh examples set the mesh size; restore it after each case
    monkeypatch.setenv(MESH_SIZE_ENV, "8")
    monkeypatch.setenv("WDBX_OLLAMA_DEMO", "true")


def test_basic_usage_small(tmp_path, capsys):
    basic_usage.main(["--device", "cpu", "--rows", "500",
                      "--data-dir", str(tmp_path / "basic")])
    out = capsys.readouterr().out
    assert "batch stored 500" in out
    assert "self-hit rate 1.00" in out


def test_rag_example(tmp_path, capsys):
    rag_implementation.main(["--device", "cpu",
                             "--data-dir", str(tmp_path / "rag")])
    out = capsys.readouterr().out
    assert "ingested" in out
    assert "answer:" in out


def test_clustered_at_scale_runs(capsys):
    clustered_at_scale.main(["--device", "cpu", "--chunk", "1024"])
    out = capsys.readouterr().out
    assert "bulk-loaded 8192 rows" in out
    assert "ids stable" in out
    assert "save/load round trip OK" in out


def test_sharded_serving_runs(capsys):
    sharded_serving.main(["--device", "cpu", "--shards", "8",
                          "--rows", "500"])
    out = capsys.readouterr().out
    assert "mesh: 4 shards x 2 replicas (8 positions)" in out
    assert "stored 500 vectors" in out
    assert "64 concurrent requests served" in out


def test_production_serving_runs(capsys):
    production_serving.main(["--device", "cpu", "--shards", "8"])
    out = capsys.readouterr().out
    assert "index: sharded_ivf, nlist=16" in out
    assert "tables split over 8 'shard' positions" in out
    assert "results identical to the blocking path" in out
    assert "recovered shards=[0]" in out
    assert "post-heal query: doc-7" in out
    rec = float(out.split("recall@10=")[1].split()[0])
    assert np.isfinite(rec) and rec >= 0.95
