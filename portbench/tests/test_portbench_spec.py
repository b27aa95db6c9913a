"""BENCHMARK.json keeps to the contract, and every name it holds
resolves to the file the harness finds by that name."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    for word in cmd[1:]:
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_names_units_and_texts():
    items = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for it in items:
        assert NAME.match(it["name"]), it["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [it["name"] for it in BENCH[kind]]
        assert len(names) == len(set(names)), kind


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_workload_resolves():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        cfg = harness.config_of(BENCH, w["config"])
        assert cfg["name"] == w["config"]
        assert configs[w["config"]]["source"] == cfg["source"]
        assert configs[w["config"]]["reduced"] == cfg["reduced"]
        traffic = harness.traffic_of(w["traffic"])
        assert harness.ENTRIES[traffic["loop"]] == traffic["entry"]
        used.add(w["config"])
    assert used == set(configs)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_it_must(workload):
    e2e = harness.metrics_of(BENCH, workload, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per = harness.metrics_of(BENCH, workload, trace=True)
    assert per and all(m["moves"] in names for m in per)
    for m in e2e + per:
        assert callable(harness.reader(m["name"]).read)


def test_layers_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_four_chip_cells_within_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_config_files_state_limits_and_guarantees():
    for c in BENCH["configs"]:
        cfg = harness.load_json(ROOT, c["file"])
        assert set(cfg["limits"]) == {"unanswered", "malformed",
                                      "rank_gap_mean"}
        assert cfg["limits"]["unanswered"] == 0
        assert cfg["limits"]["malformed"] == 0
        assert cfg["guarantees"] and cfg["assumed"]
        # the control is the program's own lower-precision path
        assert set(cfg["control"]) == {"settings"}
        assert set(cfg["control"]["settings"]) <= set(cfg["settings"])
        json.dumps(cfg)
