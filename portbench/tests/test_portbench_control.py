"""The control, the program with its own path one precision below the
configuration's switched on (an int8 slab for the bf16 one), fails the
configuration's limits, and the program as configured passes them: at a
size the CPU holds, with the configuration's width and metric, through
the whole run and the check."""

import pytest

from portbench import harness
from portbench.control import reading

BENCH = harness.spec()


@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_limits_and_the_program_passes(workload, control,
                                                         tiny, seed):
    got = reading(workload, seed, 1.0, control, device="cpu", overrides=tiny,
                  bench=BENCH)
    assert got["readings"]["unanswered"] == 0
    assert got["correct"] is (not control), got["checks"]
    if control:
        assert got["checks"]["rank_gap_mean"]["value"] > \
            got["checks"]["rank_gap_mean"]["limit"]
