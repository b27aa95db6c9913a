"""A tiny-size run of each cell's code path on the CPU: the program's
plain paths under the real harness, load, check and line."""

import json

import pytest
import torch

from portbench import harness

BENCH = harness.spec()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_dry_run_prints_a_well_formed_line(workload, trace, tiny, seed):
    line, checks = harness.run_cell(workload, seed, 1.0, trace,
                                    device="cpu", overrides=tiny, bench=BENCH)
    text = json.dumps(line)
    assert "\n" not in text and json.loads(text) == line
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"]: m["unit"]
            for m in harness.metrics_of(BENCH, workload, trace)}
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name]
        assert isinstance(m["value"], float) and m["value"] > 0
    if not trace:
        # every end-to-end metric of the cell is there (the device ones
        # of a traced run need the card)
        assert set(line["metrics"]) == set(want)
    else:
        assert line["metrics"]
        assert set(line["metrics"]) <= set(want)
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    assert len(checks) == len(line["checks"])
    assert all(text.startswith("check ") for text in checks)


@pytest.mark.chip
def test_tiny_run_on_the_card(tiny, seed):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    for workload in CELLS:
        line, _ = harness.run_cell(workload, seed, 2.0, True, overrides=tiny,
                                   bench=BENCH)
        assert line["correct"] is True, line["checks"]
        assert line["device"]["platform"] == "gpu"
        assert line["device"]["busy_s"] > 0
