"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` (a ``read(ctx)`` that returns a number or None,
and optionally ``SPANS``: the program calls whose spans it reads, as
``"module:attr"`` targets or ``(target, meta)`` pairs).
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from portbench import check, loops
from portbench.reference.exact import Reference
from portbench.reference.mixture import Mixture

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names a run must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "wdbx_tpu")
#: spans the breakdown labels idle gaps with, besides the metrics' own
LABEL_SPANS = (
    "wdbx_tpu_torch.store.vector_store:VectorStore.search_batch",
    "wdbx_tpu_torch.store.vector_store:VectorStore._merge_hits",
)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def config_of(bench: dict, name: str, root: str = ROOT) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return load_json(root, cfg["file"])
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic_of(name: str) -> dict:
    return load_json(HERE, "traffic", f"{name}.json")


def reader(name: str):
    """The module ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "portbench.metrics." + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    sys.modules[mod_name] = mod
    return mod


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``workload`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}

    def reports(m: dict) -> bool:
        if "workloads" in m:
            return workload in m["workloads"]
        return m["moves"] in moved

    return [m for m in bench["per_layer"] if reports(m)]


def merge(base: dict, over: dict | None) -> dict:
    out = copy.deepcopy(base)
    for key, val in (over or {}).items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], val)
        else:
            out[key] = val
    return out


def process_age() -> float:
    """Seconds since this process started (0 where /proc is absent)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: the process's age at this module's import, against ``perf_counter``
_AGE0, _T0 = process_age(), time.perf_counter()


def since_start() -> float:
    return _AGE0 + time.perf_counter() - _T0


@dataclass
class Ctx:
    """What a metric reader can read."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float = 0.0
    load: loops.LoadResult | None = None
    result: dict = field(default_factory=dict)
    spans: Any = None
    trace: Any = None
    n_rows: int = 0


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def make_facade(config: dict, device: str, data_dir: str):
    from wdbx_tpu_torch import WDBX

    settings = dict(config["settings"])
    return WDBX(vector_dimension=settings.pop("VECTOR_DIMENSION"),
                num_shards=settings.pop("NUM_SHARDS"), data_dir=data_dir,
                config=settings, enable_plugins=False,
                device=None if device == "cuda" else device,
                log_level="WARNING")


def load_corpus(db, mix: Mixture, n_rows: int) -> None:
    """Bulk-load the corpus chunk by chunk through one pinned buffer:
    the host never holds more than a chunk. Ids are ``str(row)``."""
    pinned = None
    for lo, rows in mix.chunks(n_rows):
        if rows.is_cuda:
            if pinned is None:
                pinned = torch.empty((mix.chunk_rows, mix.d),
                                     dtype=torch.float32, pin_memory=True)
            host = pinned[: rows.shape[0]]
            host.copy_(rows)
        else:
            host = rows
        db.store.bulk_load([str(i) for i in range(lo, lo + rows.shape[0])],
                           host.numpy())
        del rows


def prepare(config: dict, traffic: dict, seed: int, device: str,
            data_dir: str):
    """Set-up before the warm-up: the kernels' build, the facade, the
    corpus bulk-loaded (and indexed), the query pool. Returns ``(db,
    mixture, queries)``, the queries as float32 numpy."""
    corpus = config["corpus"]
    t = time.perf_counter()
    if device == "cuda":
        from wdbx_tpu_torch.kernels import build

        build.build_all()
        log(f"kernels ready in {time.perf_counter() - t:.3f} s")
    mix = Mixture(seed, corpus["components"], corpus["dim"], corpus["noise"],
                  corpus["chunk_rows"], device)
    db = make_facade(config, device, data_dir)
    t = time.perf_counter()
    load_corpus(db, mix, corpus["rows"])
    if config.get("build_index"):
        for index in db.store.indices:
            index.build()
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"corpus loaded and indexed in {time.perf_counter() - t:.3f} s")
    return db, mix, mix.queries(traffic["pool"]).cpu().numpy()


def install_spans(log_: Any, metric_mods: list) -> None:
    targets: dict[str, Any] = {t: None for t in LABEL_SPANS}
    for mod in metric_mods:
        for item in getattr(mod, "SPANS", ()):
            target, meta = item if isinstance(item, tuple) else (item, None)
            if targets.get(target) is None:
                targets[target] = meta
    for target, meta in targets.items():
        log_.install(target, meta)


#: the entry each loop drives, as the traffic files name it
ENTRIES = {"closed": "WDBX.vector_search_batch"}


def run_load(db, traffic: dict, queries: np.ndarray, seed: int,
             seconds: float, on_start, on_end) -> loops.LoadResult:
    if ENTRIES.get(traffic["loop"]) != traffic["entry"] or \
            traffic.get("filter") is not None:
        # a filter needs metadata in the corpus and in the reference
        raise SystemExit(f"traffic {traffic} is not one this harness drives")
    plan = loops.batches(traffic, seed, len(queries))
    return loops.closed_loop(db.vector_search_batch, queries, plan, traffic,
                             seconds, seed, on_start=on_start, on_end=on_end)


def device_info(device: str, chips: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             root: str = ROOT, bench: dict | None = None,
             readings: dict | None = None) -> tuple[dict, list[str]]:
    """One run. Returns the result line's object and the check lines.
    Tests and ``control.py`` only: ``overrides`` replaces parts of the
    configuration and traffic (``{"config": {...}, "traffic": {...}}``),
    ``bench`` stands in for ``BENCHMARK.json``, and ``readings`` receives
    every number the check read."""
    bench = bench or spec(root)
    cell = cell_of(bench, workload)
    config = merge(config_of(bench, cell["config"], root),
                   (overrides or {}).get("config"))
    traffic = merge(traffic_of(cell["traffic"]),
                    (overrides or {}).get("traffic"))
    corpus = config["corpus"]
    entries = metrics_of(bench, workload, trace)
    mods = {m["name"]: reader(m["name"]) for m in entries}
    ctx = Ctx(cell=cell, config=config, traffic=traffic,
              n_rows=corpus["rows"])

    span_log = devtrace = None
    if trace:
        from portbench.spans import SpanLog

        span_log = SpanLog()
        install_spans(span_log, list(mods.values()))
    data_dir = tempfile.mkdtemp(prefix="portbench_")
    try:
        db, mix, queries = prepare(config, traffic, seed, device, data_dir)
        if trace and device == "cuda":
            from portbench.devtrace import DeviceTrace

            devtrace = DeviceTrace()
            devtrace.start()  # the profiler's own first start, in set-up
            devtrace.stop()

        def on_start():
            # every window starts from a collected heap, so runs see the
            # interpreter's collections at the same points of their load
            gc.collect()
            ctx.setup_s = since_start()
            if span_log is not None:
                span_log.recording = True
            if devtrace is not None:
                devtrace.start()

        def on_end():
            if devtrace is not None:
                t = time.perf_counter()
                devtrace.stop()
                log(f"trace read in {time.perf_counter() - t:.3f} s, "
                    f"{len(devtrace.ops)} device operations")
            if span_log is not None:
                span_log.recording = False

        load = run_load(db, traffic, queries, seed, seconds, on_start,
                        on_end)
        ctx.load, ctx.spans, ctx.trace = load, span_log, devtrace
        info = device_info(device, cell["chips"])
        log(f"window {load.window_s:.3f} s, {load.attempted} attempted, "
            f"{load.answered} answered")
        del db
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # the check: the answers kept, against the reference
        answers = check.Answers(load.qidx, load.answers, traffic["k"],
                                corpus["rows"])
        pq, prow = answers.pairs()
        t = time.perf_counter()
        ref = Reference(torch.as_tensor(queries, device=device),
                        traffic["k"]).run(mix.chunks(corpus["rows"]), pq, prow)
        log(f"reference in {time.perf_counter() - t:.3f} s")
        ctx.result = check.compare(answers, load.attempted, load.answered,
                                   ref, pq, prow, config["limits"])
        if readings is not None:
            readings.update(ctx.result["readings"])
    finally:
        if span_log is not None:
            span_log.uninstall()
        shutil.rmtree(data_dir, ignore_errors=True)

    metrics = {}
    for entry in entries:
        value = mods[entry["name"]].read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    line: dict[str, Any] = {
        "correct": ctx.result["correct"],
        "attempted": load.attempted,
        "failed": load.attempted - load.answered,
        "metrics": metrics,
        "device": info,
    }
    if trace and devtrace is not None:
        t = time.perf_counter()
        line["device"]["busy_s"] = devtrace.busy_s
        line["device"]["window_s"] = devtrace.window_s
        line["breakdown"] = {
            "device_ops": devtrace.top_ops(),
            "idle_gaps": devtrace.idle_by_host(span_log.spans)}
        log(f"breakdown in {time.perf_counter() - t:.3f} s, "
            f"{len(span_log.spans)} spans")
    line["checks"] = ctx.result["checks"]
    lines = [f"check {name}: {c['value']} (limit {c['limit']})"
             for name, c in ctx.result["checks"].items()]
    return line, lines


def leaked_modules() -> list[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))
