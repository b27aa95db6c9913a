"""Drive the PyTorch / CUDA port (wdbx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

Phases (each prints JSON lines; any failure exits non-zero):
  device     nvidia-smi's name and power limit, torch and CUDA versions
  build      nvcc of wdbx_tpu_torch/csrc/*.cu (one process per source,
             all started together) into the git-ignored build directory
  kernels    each kernel against its plain PyTorch version on the card:
             float32 / bf16 / int8 / int4 slabs, N=65,536, d=384, B=128,
             k in {10, 256}, ~10% invalid rows, plus all-invalid and
             k > valid cases; then ragged shapes (B=5 and 37, N off the
             128-row tile, k=1 and 1024, d=100)
  main       the facade: WDBX(INDEX_DTYPE=bfloat16) bulk-loads 1,048,576
             unit rows, answers vector_search_batch (B=128) and
             vector_search; every hit list is held against the plain
             version on the index's slab, and recall@10 against a float32
             oracle must reach 0.9938
  pipelined  FlatIndex.search_pipelined at bench.py's operating point
             (NB=64, B=128, k=10) for float32, bf16, int8 and int4 slabs,
             timed with CUDA events; all NB batches of its output are held
             against the plain version, and the float32 and bf16 raw
             recall@10 must reach 0.9938; one batch of 128 times the
             kernels, the plain version and the library call; then an
             int8 facade search with the raw-store rerank (RAW_STORE=ram),
             whose recall@10 must reach 0.9938 too
Then a "kernels" line (launches on the driven paths, times, bounds) and,
last, {"ok": true, "device": {...}}.

Launch counts: every path (main, each pipelined slab, the int8 facade)
runs with the kernels' counters set to 0 just before it and read just
after; comparison and timing launches are never counted.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# the operation rate of each slab type's products. int8 / int4 rows are
# scored as bf16 products, float32 rows on the CUDA cores.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 989e12,
              "int4": 989e12}
RECALL_BAR = 0.9938  # recall@10 at bench.py's operating point (BENCH_r05)
N_ROWS = 1 << 20  # bench.py's corpus: 1,048,576 x 384
KERNEL_ROWS = 65536  # rows of the kernel-against-plain cases
ATOL = 1e-4  # kernel vs plain: same exact products, other summation order
REPLACES = {
    "float32": "wdbx_tpu/kernels/fused_topk.py:153",
    "bfloat16": "wdbx_tpu/kernels/fused_topk.py:153",
    "int8": "wdbx_tpu/kernels/fused_topk.py:177",
    "int4": "wdbx_tpu/kernels/fused_topk.py:177",
}
SOURCE = "wdbx_tpu_torch/csrc/fused_topk.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rescorer(db, queries, scales=None, int4=False):
    """The true score of (query row, slot) pairs on the kernels' inputs:
    float32 products of the stored values, times the row scale."""
    import torch

    from wdbx_tpu_torch.kernels.quant import unpack_int4

    def rescore(qrow, slot):
        qrow, slot = qrow.to(db.device), slot.to(db.device)
        rows = unpack_int4(db[slot]) if int4 else db[slot]
        s = (queries[qrow].to(torch.float32) * rows.to(torch.float32)).sum(-1)
        return s * scales[slot] if scales is not None else s

    return rescore


def check_topk(name, ref, got, rescore, atol=ATOL) -> float:
    """Sorted (B, k) results agree: -inf / -1 in the same places, finite
    scores within ``atol``, every returned slot truly scores what it is
    returned with (``rescore``), equal slot sets except at ties. Returns
    the largest score difference."""
    import torch

    (vr, ir), (vg, ig) = ref, got
    if vr.shape != vg.shape or ir.shape != ig.shape:
        fail(f"{name}: shapes {tuple(vr.shape)} vs {tuple(vg.shape)}")
    nr, ng = torch.isneginf(vr), torch.isneginf(vg)
    if not torch.equal(nr, ng):
        fail(f"{name}: -inf placement differs")
    if not torch.equal(ig == -1, ng) or not torch.equal(ir == -1, nr):
        fail(f"{name}: -1 slots do not match -inf scores")
    err = float((vr - vg)[~nr].abs().max()) if (~nr).any() else 0.0
    if err > atol:
        fail(f"{name}: max score difference {err} > {atol}")
    if (~ng).any():
        rows = torch.arange(vg.shape[0], device=vg.device)[:, None]
        true = rescore(rows.expand_as(ig)[~ng], ig[~ng]).to(vg.device)
        off = float((true - vg[~ng]).abs().max())
        if off > ATOL:  # another summation order than either side
            fail(f"{name}: a slot is returned {off} off its own score")
    sr, sg = torch.sort(ir, dim=1).values, torch.sort(ig, dim=1).values
    bad = (sr != sg).any(dim=1).nonzero().flatten().tolist()
    for row in bad:
        a, b = set(ir[row].tolist()), set(ig[row].tolist())
        kth = vr[row][~nr[row]].min()
        scores = {int(i): float(v) for i, v in zip(ir[row], vr[row])}
        scores.update({int(i): float(v) for i, v in zip(ig[row], vg[row])})
        for slot in a ^ b:
            if abs(scores[slot] - float(kth)) > atol:
                fail(f"{name}: row {row} slot {slot} differs off a tie")
    return err


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    return card


def phase_build():
    from wdbx_tpu_torch.kernels import build

    t0 = time.perf_counter()
    info = build.build_all()
    lines = [ln.strip() for n in info for ln in info[n]["log"].splitlines()
             if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source_s": {n: round(v["seconds"], 3) for n, v in info.items()},
          "ptxas": lines[:24]})


def _slab(dtype, x):
    """Slab, scales and int4 flag for unit rows ``x`` (float32, device)."""
    import torch

    from wdbx_tpu_torch.kernels.quant import quantize_rows, quantize_rows_int4

    if dtype == "int8":
        q, s = quantize_rows(x)
        return q, s, False
    if dtype == "int4":
        q, s = quantize_rows_int4(x)
        return q, s, True
    return x.to(getattr(torch, dtype)), None, False


def phase_kernels(n_rows, seed):
    """Each slab type's kernels against the plain version: at the main
    width (d=384, B=128) and at ragged shapes (B and N off the tiles,
    k=1 and k=1024, and d=100, which takes the CUDA-core body)."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(n_rows, 384, 128, (10, 256)), (10_000, 384, 5, (1, 1024)),
              (3_000, 100, 37, (10,))]
    errs = {}
    for n, d, b, ks in shapes:
        x = torch.randn((n, d), generator=g, device="cuda")
        x = x / x.norm(dim=1, keepdim=True)
        q = torch.randn((b, d), generator=g, device="cuda")
        valid = torch.rand((n,), generator=g, device="cuda") > 0.1
        for dtype in ("float32", "bfloat16", "int8", "int4"):
            slab, scales, int4 = _slab(dtype, x)
            qk = tf._prep_queries(slab, q, scales, True)
            rescore = rescorer(slab, qk, scales, int4)
            cases = [(f"k{k}", valid, k) for k in ks]
            if n == n_rows and dtype in ("bfloat16", "int4"):
                few = torch.zeros_like(valid)
                few[torch.randperm(n, generator=g, device="cuda")[:5]] = True
                cases += [("all_invalid", torch.zeros_like(valid), 10),
                          ("k_gt_valid", few, 10)]
            for case, vmask, k in cases:
                ref = tf.fused_topk_plain(slab, qk, vmask, k, scales=scales,
                                          int4=int4)
                pv, pi = tf.fused_topk_partial(slab, qk, vmask, k,
                                               scales=scales, int4=int4)
                got = tf.topk_merge_partials(pv, pi, k)
                torch.cuda.synchronize()
                name = f"{dtype}/n{n}_d{d}_b{b}/{case}"
                err = check_topk(name, ref, got, rescore)
                merge_err = check_topk(name + "/merge",
                                       tf.merge_partials_plain(pv, pi, k),
                                       got, rescore, atol=0.0)
                key = f"fused_topk_partial[{dtype}]"
                errs[key] = max(errs.get(key, 0.0), err)
                errs["topk_merge_partials"] = max(
                    errs.get("topk_merge_partials", 0.0), merge_err)
                emit({"phase": "kernels", "case": name, "n": n, "d": d,
                      "b": b, "k": k, "max_abs_err": err, "tol": ATOL,
                      "merge_max_abs_err": merge_err})
            del slab, scales
    v, i = tf.fused_topk_search(x.to(torch.bfloat16), q[:0], valid, k=10)
    if v.shape != (0, 10) or i.shape != (0, 10):
        fail(f"empty batch gave {tuple(v.shape)} / {tuple(i.shape)}")
    return errs


def _counts():
    from wdbx_tpu_torch.kernels import fused_topk as tf

    c = {f"fused_topk_partial[{k}]": v
         for k, v in tf.fused_topk_partial.launches.items()}
    c["topk_merge_partials"] = tf.topk_merge_partials.launches
    return c


def _data(n_rows, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, 384), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((64, 128, 384), dtype=np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    # bench.py's traffic: unit queries sent as bf16 (its oracle scores
    # the same bf16 queries against the float32 corpus)
    import torch

    q = torch.from_numpy(q).to(torch.bfloat16).to(torch.float32).numpy()
    return x, q


def _oracle(x_dev, qs, k=10):
    """Float32 top-k rows of every query batch in ``qs`` (NB, B, d): a
    yardstick (torch.matmul with TF32 off), never on the port's path."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for batch in qs:
        qd = torch.as_tensor(batch, device="cuda")
        out.append(torch.topk(qd @ x_dev.T, k, dim=1).indices.cpu().numpy())
    return np.concatenate(out)


def _recall(hits, truth) -> float:
    got = [{int(h[0]) for h in row} for row in hits]
    return float(sum(len(g & set(t.tolist())) for g, t in zip(got, truth))
                 / truth.size)


def _plain_of(index, queries, k):
    """The plain version of the kernels on ``index``'s own slab, for
    ``queries`` (B, d) as the index's search prepares them: the sorted
    (B, k) result on the host, and the rescorer of those inputs."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    scales = index._scales if index._is_quantized else None
    q = torch.as_tensor(queries, dtype=torch.float32, device="cuda")
    qk = tf._prep_queries(index._slab, q, scales, index.metric == "cosine")
    v, i = tf.fused_topk_plain(index._slab, qk, index._valid, k,
                               scales=scales, int4=index._is_int4)
    return ((v.cpu(), i.cpu()),
            rescorer(index._slab, qk, scales, index._is_int4))


def check_facade(name, db, queries, hits, k=10) -> float:
    """The facade's hit lists (one shard, no filter, no rerank) against
    the plain version on the index's slab, hit ids mapped to slots."""
    import torch

    if db.store.num_shards != 1:
        fail(f"{name}: expects one shard")
    ref, rescore = _plain_of(db.store.indices[0], queries, k)
    reg = db.store.registries[0]
    got_v = torch.tensor([[s for _, s, _ in row] for row in hits])
    got_i = torch.tensor([[reg.lookup(h[0]) for h in row] for row in hits])
    return check_topk(name, ref, (got_v, got_i), rescore)


def phase_main(x, qs, truth, paths, tmp):
    import numpy as np

    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.kernels import fused_topk as tf

    n_rows = len(x)
    db = WDBX(vector_dimension=384, enable_plugins=False,
              data_dir=os.path.join(tmp, "main"),
              config={"INDEX_TYPE": "flat", "INDEX_DTYPE": "bfloat16",
                      "INDEX_CAPACITY": n_rows, "RAW_STORE": "none",
                      "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
    t0 = time.perf_counter()
    db.store.bulk_load([str(i) for i in range(n_rows)], x)
    load_s = time.perf_counter() - t0
    tf.reset_launches()
    t0 = time.perf_counter()
    hits = []
    for i in range(3):
        hits += db.vector_search_batch(qs[i], limit=10)
    one = db.vector_search(qs[3, 0].tolist(), limit=10)
    wall = time.perf_counter() - t0
    paths["main"] = _counts()
    if paths["main"]["fused_topk_partial[bfloat16]"] < 4:
        fail(f"main path did not run the bf16 kernel: {paths['main']}")
    if len(one) != 10 or any(len(h) != 10 for h in hits):
        fail("main path returned short hit lists")
    scores = np.array([[s for _, s, _ in row] for row in hits])
    if not np.isfinite(scores).all() or (np.diff(scores, axis=1) > 0).any():
        fail("main path scores are not finite and sorted")
    err = max(check_facade("main/vector_search_batch", db,
                           qs[:3].reshape(-1, 384), hits),
              check_facade("main/vector_search", db, qs[3, :1], [one]))
    rec = _recall(hits, truth[:3 * qs.shape[1]])
    emit({"phase": "main", "n": n_rows, "dtype": "bfloat16",
          "bulk_load_s": round(load_s, 3), "batches": 3, "batch": 128,
          "search_wall_s": round(wall, 4), "max_abs_err_vs_plain": err,
          "tol": ATOL, "recall_at_10": rec, "recall_bar": RECALL_BAR,
          "launches": paths["main"]})
    if rec < RECALL_BAR:
        fail(f"recall@10 {rec} < {RECALL_BAR}")
    del db
    return err


def _bound_ms(dtype, n, d, b, k) -> tuple[float, str]:
    row = {"float32": 4 * d, "bfloat16": 2 * d, "int8": d, "int4": d // 2}
    nbytes = n * row[dtype] + n  # slab + validity
    if dtype in ("int8", "int4"):
        nbytes += 4 * n  # scales
    nbytes += b * d * (4 if dtype == "float32" else 2) + b * k * 12
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2.0 * b * n * d / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_pipelined(x, qs, x_dev, truth, paths, tmp, timings, errs):
    import torch

    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.index.flat import FlatIndex
    from wdbx_tpu_torch.kernels import fused_topk as tf

    n_rows, d = x.shape
    nb, b, k = qs.shape[0], qs.shape[1], 10
    qstack = torch.as_tensor(qs, device="cuda")
    for dtype in ("bfloat16", "int8", "int4", "float32"):
        index = FlatIndex(384, dtype=dtype, capacity=n_rows, device="cuda")
        index.add_batch(x_dev)
        tf.reset_launches()
        scores, slots = index.search_pipelined(qstack, k=k)
        paths[f"pipelined[{dtype}]"] = _counts()
        name = f"fused_topk_partial[{dtype}]"
        if scores.shape != (nb, b, k) or slots.shape != (nb, b, k):
            fail(f"pipelined {dtype}: result shape {scores.shape}")
        # the main path's own output (one launch pair over NB*B queries)
        # against the plain version, batch by batch
        err = 0.0
        for i in range(nb):
            ref, rescore = _plain_of(index, qs[i], k)
            err = max(err, check_topk(
                f"pipelined/{dtype}/batch{i}", ref,
                (torch.as_tensor(scores[i]), torch.as_tensor(slots[i])),
                rescore))
        errs[name] = max(errs.get(name, 0.0), err)
        flat_slots = slots.reshape(nb * b, k)
        rec = float(sum(len(set(a.tolist()) & set(t.tolist()))
                        for a, t in zip(flat_slots, truth)) / truth.size)
        if dtype in ("float32", "bfloat16") and rec < RECALL_BAR:
            fail(f"pipelined {dtype} raw recall@10 {rec} < {RECALL_BAR}")
        call_ms = cuda_ms(lambda: index.search_pipelined(
            qstack, k=k, materialize=False), reps=3, warm=1)
        # one batch of 128 at the kernels' inputs: kernel, plain, library
        slab, valid, scales = index._slab, index._valid, index._scales
        qk = tf._prep_queries(slab, qstack[0], scales, True)
        int4 = dtype == "int4"
        part = lambda: tf.fused_topk_partial(  # noqa: E731
            slab, qk, valid, k, scales=scales, int4=int4)
        ms = cuda_ms(part)
        # every row masked: no score is offered to the per-query top-k, so
        # this is stage 1's streaming + scoring time without the selection
        none_valid = torch.zeros_like(valid)
        score_only_ms = cuda_ms(lambda: tf.fused_topk_partial(
            slab, qk, none_valid, k, scales=scales, int4=int4))
        pv, pi = part()
        # and at B=128 (another tiling than the NB*B launch)
        err = check_topk(f"{dtype}/n{n_rows}_b{b}",
                         tf.fused_topk_plain(slab, qk, valid, k,
                                             scales=scales, int4=int4),
                         tf.topk_merge_partials(pv, pi, k),
                         rescorer(slab, qk, scales, int4))
        errs[name] = max(errs[name], err)
        merge_ms = cuda_ms(lambda: tf.topk_merge_partials(pv, pi, k))
        merge_plain_ms = cuda_ms(lambda: tf.merge_partials_plain(pv, pi, k))
        merge_library_ms = cuda_ms(
            lambda: torch.topk(pv.reshape(b, -1), k, dim=1))
        plain_ms = cuda_ms(lambda: tf.fused_topk_plain(
            slab, qk, valid, k, scales=scales, int4=int4), reps=3, warm=1)
        if int4:
            library_ms = None  # no PyTorch call takes packed int4 rows
        else:
            lib_slab = slab.to(torch.bfloat16) if dtype == "int8" else slab
            lib_q = qk.to(lib_slab.dtype)
            library_ms = cuda_ms(lambda: torch.topk(
                torch.matmul(lib_q, lib_slab.T), k, dim=1), reps=3, warm=1)
        bound, by = _bound_ms(dtype, n_rows, d, b, k)
        mb_bytes = pv.numel() * 8 + b * k * 12
        timings[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms,
            "merge_ms": merge_ms, "merge_plain_ms": merge_plain_ms,
            "merge_library_ms": merge_library_ms,
            "merge_bound_ms": mb_bytes / HBM_BYTES_S * 1e3,
        }
        emit({"phase": "pipelined", "dtype": dtype, "n": n_rows, "nb": nb,
              "b": b, "k": k, "call_ms": call_ms,
              "ms_per_batch": call_ms / nb, "qps": nb * b / call_ms * 1e3,
              "kernel_ms_b128": ms, "score_only_ms_b128": score_only_ms,
              "merge_ms_b128": merge_ms,
              "bound_ms_b128": bound, "bound_by": by,
              "plain_ms_b128": plain_ms, "library_ms_b128": library_ms,
              "max_abs_err_vs_plain": errs[name], "tol": ATOL,
              "recall_at_10_raw": rec,
              "launches": paths[f"pipelined[{dtype}]"]})
        del index, slab, valid, none_valid, scales, pv, pi
        torch.cuda.empty_cache()

    # int8 through the facade with the raw-store exact rerank
    db = WDBX(vector_dimension=384, enable_plugins=False,
              data_dir=os.path.join(tmp, "int8"),
              config={"INDEX_TYPE": "flat", "INDEX_DTYPE": "int8",
                      "INDEX_CAPACITY": n_rows, "RAW_STORE": "ram",
                      "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
    db.store.bulk_load([str(i) for i in range(n_rows)], x)
    tf.reset_launches()
    t0 = time.perf_counter()
    hits = db.vector_search_batch(qs[0], limit=10)
    wall = time.perf_counter() - t0
    paths["facade_int8_rerank"] = _counts()
    rec = _recall(hits, truth[:b])
    emit({"phase": "pipelined", "path": "facade int8 + rerank", "n": n_rows,
          "b": b, "limit": 10, "wall_s": round(wall, 4),
          "recall_at_10": rec, "launches": paths["facade_int8_rerank"]})
    if rec < RECALL_BAR:
        fail(f"int8 + rerank recall@10 {rec} < {RECALL_BAR}")
    del db


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import wdbx_tpu_torch  # noqa: F401  (fails outside a checkout, before any output)

    card = phase_device()
    phase_build()
    errs = phase_kernels(KERNEL_ROWS, args.seed)
    paths: dict[str, dict] = {}
    timings: dict[str, dict] = {}
    x, qs = _data(N_ROWS, args.seed)
    x_dev = torch.as_tensor(x, device="cuda")
    truth = _oracle(x_dev, qs)
    with tempfile.TemporaryDirectory(prefix="wdbx_smoke_") as tmp:
        main_err = phase_main(x, qs, truth, paths, tmp)
        errs["fused_topk_partial[bfloat16]"] = max(
            errs["fused_topk_partial[bfloat16]"], main_err)
        phase_pipelined(x, qs, x_dev, truth, paths, tmp, timings, errs)
    del x_dev
    kernels = []
    total = {}
    for counts in paths.values():
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c
    for dtype in ("float32", "bfloat16", "int8", "int4"):
        name = f"fused_topk_partial[{dtype}]"
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[dtype], "launches": total[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    mt = timings["fused_topk_partial[bfloat16]"]
    kernels.append({
        "name": "topk_merge_partials", "route": "cuda", "source": SOURCE,
        "replaces": "wdbx_tpu/kernels/fused_topk.py:127",
        "launches": total["topk_merge_partials"],
        "max_abs_err": errs["topk_merge_partials"], "ms": mt["merge_ms"],
        "plain_ms": mt["merge_plain_ms"],
        "bound_ms": mt["merge_bound_ms"], "bound_by": "bytes",
        "library_ms": mt["merge_library_ms"],
    })
    for kern in kernels:
        if kern["launches"] < 1:
            fail(f"{kern['name']} was not launched on any driven path")
    emit({"paths": paths})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
