"""A run loads neither JAX nor the JAX package, the reference loads
nothing of the program, and a run without a card prints no result."""

import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness

ROOT = harness.ROOT


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("wdbx_tpu", True), ("wdbx_tpu.core.wdbx", True),
    ("wdbx_tpu_torch", False), ("wdbx_tpu_torch.core.wdbx", False),
    ("jaxtyping", False)])
def test_forbidden_names_compare_whole_top_level_names(monkeypatch, name,
                                                       bad):
    for mod in [m for m in sys.modules if m.split(".")[0] in
                harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    got = harness.leaked_modules()
    assert got == ([name.split(".")[0]] if bad else [])


def _py(code: str, cwd: str = ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_the_yardstick_imports_nothing_of_the_program():
    out = _py("import sys; import portbench.reference.exact, "
              "portbench.reference.mixture, portbench.check, "
              "portbench.roofline, portbench.loops; "
              "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'wdbx_tpu_torch', 'wdbx_tpu', 'jax'}))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_whole_run_loads_no_jax():
    code = ("import json, sys; sys.path.insert(0, 'portbench/tests'); "
            "from conftest import TINY, SEED; from portbench import harness; "
            "line, _ = harness.run_cell('flat10m.bulk', SEED, 0.5, True, "
            "device='cpu', overrides=TINY); "
            "print(json.dumps([line['correct'], harness.leaked_modules()]))")
    out = _py(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"


def _run_py(cwd: str):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "flat10m.bulk",
         "--seed", "8589934592", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_no_result_and_a_failing_code():
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
