"""Drive the PyTorch / CUDA port (wdbx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

Phases (each prints JSON lines; any failure exits non-zero):
  device     nvidia-smi's name and power limit, torch and CUDA versions
  build      nvcc of wdbx_tpu_torch/csrc/*.cu (one process per source,
             all started together) into the git-ignored build directory
  kernels    each kernel against its plain PyTorch version on the card:
             float32 / bf16 / int8 / int4 slabs, N=65,536, d=384, B=128,
             k in {10, 256} (float32: {1, 10, 128, 256, 1024}, each query
             tile of the tiled body), ~10% invalid rows, plus all-invalid
             and k > valid cases; then ragged shapes (B=5 and 37, N off
             the 128-row tile, k=1 and 1024, bf16 / int8 / int4 at d=768
             with k 10 and 50, B=1 at k 1 / 10 / 50, d=100, float32
             d=98); the scan body of every launch must be the shape
             rule's (want_body: bf16 / int8 / int4 take the pipelined body
             where its buffers fit, and every such case also runs the
             first tensor-core body against the plain version); corpora
             of duplicated rows (float32, bf16, int8, int4) searched twice
             must give identical slots
  merge      stage 2 against its plain version: k in {1, 10, 50, 128,
             1024}, B in {1, 128}, m off a multiple of 32, ties, -inf
             entries and all -inf rows
  main       the facade: WDBX(INDEX_DTYPE=bfloat16) bulk-loads 1,048,576
             unit rows, answers vector_search_batch (B=128) and
             vector_search; every hit list is held against the plain
             version on the index's slab, and recall@10 against a float32
             oracle must reach 0.9938; the pipelined body must serve it
  default_facade
             WDBX() with the default INDEX_DTYPE (float32 flat) at
             1,048,576 x 384: vector_search_batch (B=128) held against
             the plain version, recall@10 gated at 0.9938, and the tiled
             float32 body must have served it
  pipelined  FlatIndex.search_pipelined at bench.py's operating point
             (NB=64, B=128, k=10) for float32, bf16, int8 and int4 slabs,
             timed with CUDA events; all NB batches of its output are held
             against the plain version, and the float32 and bf16 raw
             recall@10 must reach 0.9938 (float32 must run the tiled
             body, bf16, int8 and int4 the pipelined one); one batch of
             128 times the kernels (also with every row masked: stage 1
             without selection; bf16, int8 and int4 also through the
             first tensor-core body), the merge
             (eagerly and in a CUDA graph, beside torch.topk, at k 10, 128
             and 1024), the plain version and the library call; then an
             int8 facade search with the raw-store rerank (RAW_STORE=ram),
             whose recall@10 must reach 0.9938 too (pipelined body)
  clustered_kernels
             the clustered block scan (K3 v2, K4 v1) against its plain
             version: every slab type and query type, d=768, c in {256,
             1024}, a block list with a dead suffix and an interior hole,
             an all-dead list, ~10% invalid rows, k in {10, 50, 128}, B in
             {1, 128}; the int4 and int8-query modes also at d 384 and
             768, B in {1, 5, 37, 128}, k in {1, 10, 50}; the body of every
             case must be the shape rule's, and the pipelined body's cases
             also run the first one; int8 and int4 slabs of duplicated
             rows searched twice with int8 queries give identical slots
  clustered  benchmarks/clustered_10m.py's point: 10,000,000 x 768 rows of
             a 4096-component mixture, generated on the card chunk by
             chunk, int8 ClusteredIVFIndex (nlist 4096) filled by
             build_from; search_pipelined (NB=8, B=128) at nprobe 1 and 4,
             k=50, v1, and int8 queries at nprobe 1 and 4, k 10 and 50,
             every batch against the plain version on the same block
             list; recall@10 against a float32 oracle streamed over the
             regenerated corpus, the x5 float32 rerank at nprobe 1 gated
             at 0.97; B=1 at nprobe 4 (narrow blocks) and 1 (the ranges
             scan); stage 1 / stage 2 / call times beside the bound from
             the batch's live blocks (every path must run the pipelined
             body, also timed against the first tensor-core body)
  clustered_facade
             WDBX(INDEX_TYPE=ivf, IVF_NPROBE=2, int8, RAW_STORE=ram) at
             1,048,576 x 384 (a 1024-component mixture):
             vector_search_batch unfiltered and at 10% (pushdown) and 1%
             (exact masked route) filter selectivity, and vector_search;
             every kernel-path call of the index against the plain
             version, recall@10 gated at 0.95, the unfiltered batch's
             block list must not cover every live block, and the kernel
             route must run the pipelined body; then float32, bf16 and
             int4 clustered indexes (int4 also with int8 queries) through
             search_pipelined, timed (float32 must run the tiled body,
             bf16 and int4 the pipelined one)
  ivf_kernels
             K5, the IVF bucket scan, against its plain version: bf16 and
             float32 tables, d 384 and 100, C 128 and 1408, k in {1, 10,
             128}, B in {1, 128} at 8 probes, an all-invalid bucket and one
             with fewer valid rows than k; 128 queries all probing the
             same 8 buckets (items split at the group size), repeated
             (query, probe) pairs and an out-of-range probe (its row all
             -inf / -1); each case through the shape rule's stage-1 body
             (grouped where rows are whole 16-byte chunks) and again
             through the per-pair body, and the grouping kernel against
             its plain version
  dense_ivf  benchmarks/ivf_crossover.py's clustered point through the
             dense IVFIndex: 1,048,576 x 384 rows of a 1024-component
             mixture (noise 0.45/sqrt(d)) as a bf16 slab, nlist 1024,
             tuned to recall 0.97 on 64 held-out queries; K5 searches at
             B in {1, 8, 64, 128} at the tuned nprobe and at 8, each held
             against the plain version of the whole query and against the
             lax scan; recall@10 over 256 held-out queries gated at 0.95
             on both paths; deletes, adds and updates; filters at 10%
             (K5) and 1% (exact route); lax search_pipelined (NB=32,
             B=64); an int8 index (lax, int8 tables); the SOAR facade
             (INDEX_TYPE=ivf, IVF_ASSIGNMENTS=2) with a save / load round
             trip (every K5 search must run the grouping and the
             grouped body); K5 stage 1 (also the per-pair body as
             old_ms), grouping, stage 2 and call times beside the bound
             and the unique probed buckets' bytes at B 1 / 64 / 128
Then a "paths" line (launches of each driven path, by kernel and by
stage-1 scan body), a "kernels" line (launches on the driven paths,
times, bounds; each stage-1 row also its body, score-only, merge time
and parts, and where the pipelined body ran the first tensor-core
body's time as old_ms; the merge row its CUDA-graph times and its times
at k 10, 128 and 1024; the K5 rows their body, the per-pair body's time
as old_ms, merge, grouping and call times; the grouping kernel its own
row) and, last, {"ok": true, "device": {...}}.

Launch counts: every path (main, the default facade, each pipelined
slab, the int8 facade, each clustered path) runs with the kernels'
counters set to 0 just before it and read just after; comparison and
timing launches are never counted.
"""

from __future__ import annotations

import argparse
import json
import math
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
# float32 k of the kernel cases: each picks a query tile of the tiled body
F32_KS = (1, 10, 128, 256, 1024)
MERGE_KS = (1, 10, 50, 128, 1024)  # k of the stage-2 cases
# the stage-1 body each flat slab type's driven path must take
PATH_BODY = {"float32": "fma_tiled", "bfloat16": "mma_pipe",
             "int8": "mma_pipe", "int4": "mma_pipe"}
MERGE_TIMED_KS = (10, 128, 1024)  # k of the stage-2 times (bf16 partials)
REPLACES = {
    "float32": "wdbx_tpu/kernels/fused_topk.py:153",
    "bfloat16": "wdbx_tpu/kernels/fused_topk.py:153",
    "int8": "wdbx_tpu/kernels/fused_topk.py:177",
    "int4": "wdbx_tpu/kernels/fused_topk.py:177",
}
SOURCE = "wdbx_tpu_torch/csrc/fused_topk.cu"
# the block scan's peak by query type: float32 on the CUDA cores, bf16 and
# int8 products on the tensor cores
PEAK_QOPS_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
CLU_SOURCE = "wdbx_tpu_torch/csrc/clustered_scan.cu"
CLU_REPLACES = {"v2": "wdbx_tpu/kernels/clustered_scan.py:107",
                "v1": "wdbx_tpu/kernels/clustered_scan.py:50"}
# recall@10 bars the clustered engine inherits from benchmarks/RESULTS.md:
# 10M x 768 int8 after the x5 rerank at nprobe 1 (0.9859 on the JAX
# package's own draw of the mixture; another generator here, hence the
# margin), and the filtered / unfiltered serving bar
RERANK_BAR = 0.97
FACADE_BAR = 0.95
IVF_SOURCE = "wdbx_tpu_torch/csrc/ivf_scan.cu"
IVF_REPLACES = "wdbx_tpu/kernels/ivf_scan.py:34"
# the grouping stands in for the TPU call's walk of the pairs, their
# probe ids scalar-prefetched into the index maps
IVF_GROUP_REPLACES = "wdbx_tpu/kernels/ivf_scan.py:127"
# the dense engine's bar: recall@10 >= 0.95 on the 1M x 384 clustered
# corpus (benchmarks/RESULTS.md:692-728), on each scan path
DENSE_BAR = 0.95
DENSE_TUNE = 0.97  # the tuner's target for the dense index's nprobe


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


def graph_ms(fn, reps: int = 20):
    """Device time of one ``fn()`` without the host's launch cost: ``reps``
    calls captured in a CUDA graph, replayed and timed with CUDA events.
    Returns the time, or the capture's error as a string."""
    import torch

    try:
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return cuda_ms(graph.replay, reps=5, warm=1) / reps
    except RuntimeError as e:  # a capture the runtime refused
        torch.cuda.synchronize()
        return f"not measured: {e}"[:200]


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


def want_body(dtype, qtype, d, b, k, aligned=True):
    """The stage-1 body the shape rule gives a launch: ``mma_pipe`` for
    bf16 / int8 / int4 slabs (d % 32 == 0 with bf16 queries, d % 64 == 0
    with int8 queries) when 32 queries of width d stay resident and some
    query tile's 128 buffers fit beside them for k (``fused_topk.pipe_qt``
    on the kernel's own shared-memory sizes), ``mma`` for the other
    tensor-core cases, ``fma_tiled`` / ``fma`` for float32 and ragged
    widths."""
    from wdbx_tpu_torch.kernels import build
    from wdbx_tpu_torch.kernels import clustered_scan as cs
    from wdbx_tpu_torch.kernels import fused_topk as tf

    if dtype == "float32":
        return "fma_tiled" if d % 4 == 0 and aligned else "fma"
    if d % (64 if qtype == "int8" else 32) or not aligned:
        return "fma"
    lib = build.load("clustered_scan")

    def smem(qt, cap):
        return lib.wdbx_clustered_block_partial_smem(
            tf.BODY_CODES["mma_pipe"], tf.SLAB_CODES[dtype],
            cs.QUERY_CODES[qtype], qt, cap, d)

    if tf.PIPE_QT[0] * d * tf.QUERY_BYTES[qtype] <= tf.PIPE_QUERY_BYTES \
            and tf.pipe_qt(b, k, d, smem, qtype) is not None:
        return "mma_pipe"
    return "mma"


def _body_of(run):
    """The scan body of the one stage-1 launch ``run()`` makes, and its
    result."""
    from wdbx_tpu_torch.kernels import fused_topk as tf

    before = dict(tf.fused_topk_partial.bodies)
    out = run()
    ran = [b for b, c in tf.fused_topk_partial.bodies.items()
           if c != before[b]]
    if len(ran) != 1:
        fail(f"expected one stage-1 launch, bodies moved: {ran}")
    return ran[0], out


def phase_kernels(n_rows, seed):
    """Each slab type's kernels against the plain version: at the main
    width (d=384, B=128) and at ragged shapes (B and N off the tiles,
    k=1 and k=1024, d=100 and d=98). float32 runs k in {1, 10, 128, 256,
    1024} at B=128, which picks each query tile of the tiled body (128,
    128, 64, 32, 16); an unaligned float32 view and d=98 must take the
    CUDA-core body; a corpus of duplicated rows must give the same slots
    on two runs."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    g = torch.Generator(device="cuda").manual_seed(seed)
    every = ("float32", "bfloat16", "int8", "int4")
    shapes = [(n_rows, 384, 128, (10, 256), every),
              (10_000, 384, 5, (1, 1024), every),
              (3_000, 768, 37, (10, 50), ("bfloat16", "int8", "int4")),
              (3_000, 384, 1, (1, 10, 50), ("bfloat16", "int8", "int4")),
              (3_000, 100, 37, (10,), every),
              (3_000, 98, 37, (10,), ("float32",))]
    errs, bodies = {}, {}
    for n, d, b, ks, dtypes in shapes:
        x = torch.randn((n, d), generator=g, device="cuda")
        x = x / x.norm(dim=1, keepdim=True)
        q = torch.randn((b, d), generator=g, device="cuda")
        valid = torch.rand((n,), generator=g, device="cuda") > 0.1
        for dtype in dtypes:
            slab, scales, int4 = _slab(dtype, x)
            qk = tf._prep_queries(slab, q, scales, True)
            rescore = rescorer(slab, qk, scales, int4)
            kk = F32_KS if dtype == "float32" and n == n_rows else ks
            cases = [(f"k{k}", slab, valid, k) for k in kk]
            if n == n_rows and dtype in ("float32", "bfloat16", "int4"):
                few = torch.zeros_like(valid)
                few[torch.randperm(n, generator=g, device="cuda")[:5]] = True
                cases += [("all_invalid", slab, torch.zeros_like(valid), 10),
                          ("k_gt_valid", slab, few, 10)]
            if n == n_rows and dtype == "float32":
                # a view 4 bytes off a 16-byte boundary
                buf = torch.empty(n * d + 1, device="cuda")
                view = buf[1:].view(n, d)
                view.copy_(slab)
                cases.append(("unaligned_view", view, valid, 10))
            for case, sl, vmask, k in cases:
                ref = tf.fused_topk_plain(sl, qk, vmask, k, scales=scales,
                                          int4=int4)
                body, (pv, pi) = _body_of(lambda: tf.fused_topk_partial(
                    sl, qk, vmask, k, scales=scales, int4=int4))
                got = tf.topk_merge_partials(pv, pi, k)
                torch.cuda.synchronize()
                name = f"{dtype}/n{n}_d{d}_b{b}/{case}"
                unaligned = sl.data_ptr() % 16 != 0
                if unaligned != (case == "unaligned_view"):
                    fail(f"{name}: slab alignment is not the case's")
                want = want_body(dtype, "float32" if dtype == "float32"
                                 else "bfloat16", d, b, k, not unaligned)
                if body != want:
                    fail(f"{name}: ran the {body} body, expected {want}")
                err = check_topk(name, ref, got, rescore)
                if body == "mma_pipe":
                    # the first tensor-core body on the same inputs
                    pv2, pi2 = tf.fused_topk_partial(
                        sl, qk, vmask, k, scales=scales, int4=int4,
                        body="mma")
                    err = max(err, check_topk(
                        name + "/mma", ref, tf.topk_merge_partials(pv2, pi2, k),
                        rescore))
                merge_err = check_topk(name + "/merge",
                                       tf.merge_partials_plain(pv, pi, k),
                                       got, rescore, atol=0.0)
                key = f"fused_topk_partial[{dtype}]"
                errs[key] = max(errs.get(key, 0.0), err)
                errs["topk_merge_partials"] = max(
                    errs.get("topk_merge_partials", 0.0), merge_err)
                bodies.setdefault(key, set()).add(body)
                emit({"phase": "kernels", "case": name, "n": n, "d": d,
                      "b": b, "k": k, "body": body, "parts": pv.shape[1],
                      "max_abs_err": err, "tol": ATOL,
                      "merge_max_abs_err": merge_err})
            del slab, scales
    v, i = tf.fused_topk_search(x.to(torch.bfloat16), q[:0], valid, k=10)
    if v.shape != (0, 10) or i.shape != (0, 10):
        fail(f"empty batch gave {tuple(v.shape)} / {tuple(i.shape)}")
    phase_determinism(g, errs)
    emit({"phase": "kernels", "bodies": {k: sorted(v)
                                         for k, v in bodies.items()}})
    return errs


def phase_determinism(g, errs):
    """Each body on a corpus of 8 copies of 8,192 rows (copies 8,192
    rows apart, so in other chunks): float32 (the tiled body), bf16,
    int8 and int4 (the pipelined body). Two runs give the same scores
    and slots
    bit for bit, and k=11 cuts through a group of copies, so the plain
    version may pick other copies: equal except at ties."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    base = torch.randn((8192, 384), generator=g, device="cuda")
    x = (base / base.norm(dim=1, keepdim=True)).repeat(8, 1)
    q = torch.randn((128, 384), generator=g, device="cuda")
    valid = torch.ones(x.shape[0], dtype=torch.bool, device="cuda")
    for dtype, want in (("float32", "fma_tiled"), ("bfloat16", "mma_pipe"),
                        ("int8", "mma_pipe"), ("int4", "mma_pipe")):
        slab, scales, int4 = _slab(dtype, x)
        qk = tf._prep_queries(slab, q, scales, True)
        runs = []
        for _ in range(2):
            body, (pv, pi) = _body_of(lambda: tf.fused_topk_partial(
                slab, qk, valid, 11, scales=scales, int4=int4))
            runs.append((pv, pi) + tf.topk_merge_partials(pv, pi, 11))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        name = f"{dtype}/duplicates/k11"
        err = check_topk(name, tf.fused_topk_plain(slab, qk, valid, 11,
                                                   scales=scales, int4=int4),
                         runs[0][2:], rescorer(slab, qk, scales, int4))
        emit({"phase": "kernels", "case": name, "body": body, "copies": 8,
              "identical_runs": same, "max_abs_err": err, "tol": ATOL})
        if body != want or not same:
            fail(f"{name}: body {body}, identical runs {same}")
        key = f"fused_topk_partial[{dtype}]"
        errs[key] = max(errs[key], err)


def phase_merge(seed, errs):
    """Stage 2 against its plain version on synthetic partials: k in
    {1, 10, 50, 128, 1024}, B in {1, 128}, m = 33 k + 7 candidates a
    query (off a multiple of 32), about 20% of them -inf, repeated
    scores (ties), and rows that are all -inf."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    n_cases = 0
    for b in (1, 128):
        for k in MERGE_KS:
            m = 33 * k + 7
            pv = torch.randn((b, 1, m), generator=g, device="cuda")
            pv = torch.round(pv * 64) / 64  # repeated scores: ties
            pv[torch.rand((b, 1, m), generator=g, device="cuda") < 0.2] = \
                float("-inf")
            if b > 1:
                pv[0] = float("-inf")
            pv[b // 2, :, : m // 2] = float("-inf")
            pos = torch.arange(m, device="cuda", dtype=torch.int32)
            pi = (m - 1 - pos).expand(b, 1, m).contiguous()
            pi = torch.where(torch.isneginf(pv), -1, pi)

            def rescore(qrow, slot, pv=pv, m=m):
                return pv[qrow.to(pv.device), 0, m - 1 - slot.to(pv.device)]

            for case, v in (("random", pv),
                            ("all_inf", torch.full_like(pv, float("-inf")))):
                if case == "all_inf" and k not in (1, 1024):
                    continue
                got = tf.topk_merge_partials(v, pi, k)
                torch.cuda.synchronize()
                err = check_topk(f"merge/b{b}_k{k}_m{m}/{case}",
                                 tf.merge_partials_plain(v, pi, k), got,
                                 rescore, atol=0.0)
                if case == "all_inf" and not torch.isneginf(got[0]).all():
                    fail(f"merge b{b} k{k}: an all -inf input gave rows")
                errs["topk_merge_partials"] = max(
                    errs.get("topk_merge_partials", 0.0), err)
                n_cases += 1
    emit({"phase": "merge", "cases": n_cases, "ks": list(MERGE_KS),
          "max_abs_err": errs["topk_merge_partials"], "tol": 0.0})


def _counts():
    from wdbx_tpu_torch.kernels import clustered_scan as cs
    from wdbx_tpu_torch.kernels import fused_topk as tf
    from wdbx_tpu_torch.kernels import ivf_scan as ivs

    c = {f"fused_topk_partial[{k}]": v
         for k, v in tf.fused_topk_partial.launches.items()}
    c.update({f"fused_topk_partial.bodies.{k}": v
              for k, v in tf.fused_topk_partial.bodies.items()})
    c["topk_merge_partials"] = tf.topk_merge_partials.launches
    c.update({clu_name(k): v
              for k, v in cs.clustered_block_partial.launches.items()})
    c.update({f"clustered_block_partial.bodies.{k}": v
              for k, v in cs.clustered_block_partial.bodies.items()})
    c.update({f"ivf_bucket_partial[{k}]": v
              for k, v in ivs.ivf_bucket_partial.launches.items()})
    c.update({f"ivf_bucket_partial.bodies.{k}": v
              for k, v in ivs.ivf_bucket_partial.bodies.items()})
    c["ivf_group_pairs"] = ivs.group_pairs.launches
    return c


def _nonzero(counts):
    return {name: c for name, c in counts.items() if c}


def _reset():
    from wdbx_tpu_torch.kernels import clustered_scan as cs
    from wdbx_tpu_torch.kernels import fused_topk as tf
    from wdbx_tpu_torch.kernels import ivf_scan as ivs

    tf.reset_launches()
    cs.reset_launches()
    ivs.reset_launches()


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

    n_rows = len(x)
    db = WDBX(vector_dimension=384, enable_plugins=False,
              data_dir=os.path.join(tmp, "main"),
              config={"INDEX_TYPE": "flat", "INDEX_DTYPE": "bfloat16",
                      "INDEX_CAPACITY": n_rows, "RAW_STORE": "none",
                      "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
    t0 = time.perf_counter()
    db.store.bulk_load([str(i) for i in range(n_rows)], x)
    load_s = time.perf_counter() - t0
    _reset()
    t0 = time.perf_counter()
    hits = []
    for i in range(3):
        hits += db.vector_search_batch(qs[i], limit=10)
    one = db.vector_search(qs[3, 0].tolist(), limit=10)
    wall = time.perf_counter() - t0
    paths["main"] = _counts()
    if paths["main"]["fused_topk_partial[bfloat16]"] < 4 or \
            paths["main"]["fused_topk_partial.bodies.mma_pipe"] < 4:
        fail(f"main path did not run the pipelined bf16 body: "
             f"{paths['main']}")
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


def phase_default_facade(x, qs, truth, paths, tmp):
    """WDBX() as a user gets it, INDEX_DTYPE left at its float32 default:
    a batch of 128 through the facade, held against the plain version,
    recall@10 gated, served by the tiled float32 body."""
    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.index.flat import FlatIndex

    n_rows = len(x)
    db = WDBX(vector_dimension=384, enable_plugins=False,
              data_dir=os.path.join(tmp, "default"),
              config={"INDEX_CAPACITY": n_rows, "RAW_STORE": "none",
                      "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
    index = db.store.indices[0]
    if not isinstance(index, FlatIndex) or index.dtype_name != "float32":
        fail(f"WDBX() gave {type(index).__name__} "
             f"{getattr(index, 'dtype_name', '?')}")
    t0 = time.perf_counter()
    db.store.bulk_load([str(i) for i in range(n_rows)], x)
    load_s = time.perf_counter() - t0
    _reset()
    t0 = time.perf_counter()
    hits = db.vector_search_batch(qs[0], limit=10)
    wall = time.perf_counter() - t0
    name = "default_facade"
    paths[name] = _counts()
    if paths[name]["fused_topk_partial[float32]"] < 1 or \
            paths[name]["fused_topk_partial.bodies.fma_tiled"] < 1:
        fail(f"WDBX() did not run the tiled float32 body: {paths[name]}")
    err = check_facade("default_facade/vector_search_batch", db, qs[0],
                       hits)
    rec = _recall(hits, truth[: qs.shape[1]])
    emit({"phase": "default_facade", "n": n_rows, "dtype": "float32",
          "bulk_load_s": round(load_s, 3), "b": qs.shape[1],
          "search_wall_s": round(wall, 4), "max_abs_err_vs_plain": err,
          "tol": ATOL, "recall_at_10": rec, "recall_bar": RECALL_BAR,
          "launches": _nonzero(paths[name])})
    if rec < RECALL_BAR:
        fail(f"default facade recall@10 {rec} < {RECALL_BAR}")
    del db, index
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


def time_merge(pv, pi, k) -> dict:
    """Stage 2 on (B, parts, k) partials: the kernel, its plain version
    and torch.topk over the same partials, beside the bytes bound."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    b = pv.shape[0]

    def merge():
        return tf.topk_merge_partials(pv, pi, k)

    def library():
        return torch.topk(pv.reshape(b, -1), k, dim=1)

    return {"ms": cuda_ms(merge),
            "plain_ms": cuda_ms(lambda: tf.merge_partials_plain(pv, pi, k)),
            "library_ms": cuda_ms(library),
            "graph_ms": graph_ms(merge), "library_graph_ms": graph_ms(library),
            "bound_ms": (pv.numel() * 8 + b * k * 12) / HBM_BYTES_S * 1e3,
            "parts": int(pv.shape[1])}


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
        _reset()
        scores, slots = index.search_pipelined(qstack, k=k)
        paths[f"pipelined[{dtype}]"] = _counts()
        name = f"fused_topk_partial[{dtype}]"
        body = PATH_BODY[dtype]
        if paths[f"pipelined[{dtype}]"][
                f"fused_topk_partial.bodies.{body}"] < 1:
            fail(f"pipelined {dtype} did not run the {body} body: "
                 f"{paths[f'pipelined[{dtype}]']}")
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
        old_ms = None
        if body == "mma_pipe":  # the first tensor-core body, same inputs
            old_ms = cuda_ms(lambda: tf.fused_topk_partial(
                slab, qk, valid, k, scales=scales, int4=int4, body="mma"))
        pv, pi = part()
        # and at B=128 (another tiling than the NB*B launch)
        err = check_topk(f"{dtype}/n{n_rows}_b{b}",
                         tf.fused_topk_plain(slab, qk, valid, k,
                                             scales=scales, int4=int4),
                         tf.topk_merge_partials(pv, pi, k),
                         rescorer(slab, qk, scales, int4))
        errs[name] = max(errs[name], err)
        merge = time_merge(pv, pi, k)
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
        merge_at_k = {}
        if dtype == "bfloat16":  # stage 2 at deeper k, on this slab's partials
            for kk in MERGE_TIMED_KS:
                if kk == k:
                    merge_at_k[kk] = merge
                    continue
                pvk, pik = tf.fused_topk_partial(slab, qk, valid, kk)
                merge_at_k[kk] = time_merge(pvk, pik, kk)
                del pvk, pik
        timings[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms, "body": body,
            "old_ms": old_ms,
            "score_only_ms": score_only_ms, "parts": pv.shape[1],
            "merge_ms": merge["ms"], "merge": merge,
            "merge_at_k": merge_at_k,
        }
        emit({"phase": "pipelined", "dtype": dtype, "n": n_rows, "nb": nb,
              "b": b, "k": k, "call_ms": call_ms,
              "ms_per_batch": call_ms / nb, "qps": nb * b / call_ms * 1e3,
              "kernel_ms_b128": ms, "score_only_ms_b128": score_only_ms,
              "old_body_ms_b128": old_ms,
              "merge_ms_b128": merge["ms"], "body": body,
              "parts_b128": pv.shape[1],
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
    _reset()
    t0 = time.perf_counter()
    hits = db.vector_search_batch(qs[0], limit=10)
    wall = time.perf_counter() - t0
    paths["facade_int8_rerank"] = _counts()
    if paths["facade_int8_rerank"]["fused_topk_partial.bodies.mma_pipe"] < 1:
        fail(f"int8 facade did not run the pipelined body: "
             f"{paths['facade_int8_rerank']}")
    rec = _recall(hits, truth[:b])
    emit({"phase": "pipelined", "path": "facade int8 + rerank", "n": n_rows,
          "b": b, "limit": 10, "wall_s": round(wall, 4),
          "recall_at_10": rec, "launches": paths["facade_int8_rerank"]})
    if rec < RECALL_BAR:
        fail(f"int8 + rerank recall@10 {rec} < {RECALL_BAR}")
    del db


# -- the clustered engine (K3 / K4) -----------------------------------------


def clu_name(key: str) -> str:
    return f"clustered_block_partial.{key}"


def block_rescorer(slab, qq, qs, scales, int4):
    """``rescorer`` for the block scan's inputs: with int8 queries the
    int32 product times the row scale, then times the query scale."""
    import torch

    base = rescorer(slab, qq, scales, int4)
    if qq.dtype != torch.int8:
        return base
    qs = qs.reshape(-1)
    return lambda qrow, pos: base(qrow, pos) * qs[qrow.to(qs.device)]


def _mixture(n_comp, d, seed, noise=0.67):
    """A Gaussian mixture on the sphere (``n_comp`` unit centres, noise
    ``noise`` / sqrt(d): at 0.67 the within-cluster cosine is about
    0.83), generated on the card: ``chunk(seed, m)`` gives m unit rows,
    the same for the same seed on every call, so a corpus is regenerated
    instead of kept."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn((n_comp, d), generator=g, device="cuda")
    centers /= centers.norm(dim=1, keepdim=True)
    noise = noise / math.sqrt(d)

    def chunk(seed, m):
        g = torch.Generator(device="cuda").manual_seed(seed)
        ids = torch.randint(0, n_comp, (m,), generator=g, device="cuda")
        x = centers[ids] + noise * torch.randn((m, d), generator=g,
                                               device="cuda")
        return x / x.norm(dim=1, keepdim=True)

    return chunk


def _block_list(index, q, k, pad_b, valid, nprobe):
    """The block list of the index's kernel path for ``q``: the
    (normalized) queries, ``uniq`` / ``ok`` and the block rows c."""
    from wdbx_tpu_torch.index.clustered import _kernelpath_list

    if index._use_ranges(pad_b, nprobe) or not index._use_kernel(k):
        fail(f"batch of {pad_b} at nprobe {nprobe}, k={k} does not take "
             "the kernel path")
    geom, c, m, lo, hi = index._geom(pad_b)
    u = index._scan_u(pad_b, nprobe, geom)
    qn, uniq, ok = _kernelpath_list(
        index._slab, valid, index._centroids, lo, hi, q, nprobe, u, m, c,
        index._precision, index.metric == "cosine", pad_b)
    return qn, uniq, ok, c


def _block_plain(index, q, k, pad_b, valid=None, nprobe=None):
    """The index's kernel path with the kernel's plain version: the same
    probes, block list and residual merge. Returns the (B, k) device
    result, the rescorer of the kernel's inputs, and the live blocks."""
    from wdbx_tpu_torch.index.ivf import _residual_merge
    from wdbx_tpu_torch.kernels import clustered_scan as cs
    from wdbx_tpu_torch.kernels.quant import prep_query_block

    nlist = int(index._centroids.shape[0])
    nprobe = min(index.nprobe, nlist) if nprobe is None else nprobe
    valid = index._valid if valid is None else valid
    qn, uniq, ok, c = _block_list(index, q, k, pad_b, valid, nprobe)
    scales = index._scales if index._is_quantized else None
    qprec = (getattr(index, "kernel_qprec", "bf16")
             if index._kernel_gen() == "v2" else "bf16")
    v, p = cs.clustered_block_topk_plain(
        index._slab, valid, scales, uniq, ok, qn, k, c,
        int4=index._is_int4, qprec=qprec)
    v, p = _residual_merge(
        index._slab, valid, index._residual_tensor(), index._scales, v, p,
        qn, k=k, precision=index._precision, int8=index._is_int8,
        int4=index._is_int4)
    qq, qs, _ = prep_query_block(qn, index._slab.dtype, scales is not None,
                                 qprec)
    return ((v, p), block_rescorer(index._slab, qq, qs, scales,
                                   index._is_int4), int(ok.sum()))


def check_pipelined(name, index, qstack, k, out) -> tuple[float, int]:
    """Every batch of a ``search_pipelined(..., materialize=False)``
    result (positions) against the plain version on the same block
    list. Returns the largest score difference and the most live
    blocks of a batch."""
    scores, pos = out
    nb, b = qstack.shape[0], qstack.shape[1]
    if scores.shape != (nb, b, k) or pos.shape != (nb, b, k):
        fail(f"{name}: result shape {tuple(scores.shape)}")
    err, live = 0.0, 0
    for i in range(nb):
        ref, rescore, n_live = _block_plain(index, qstack[i], k, b)
        err = max(err, check_topk(f"{name}/batch{i}", ref,
                                  (scores[i], pos[i]), rescore))
        live = max(live, n_live)
    return err, live


def _block_bound_ms(slab_dtype, qtype, live, c, d, b, k, u):
    row = {"float32": 4 * d, "bfloat16": 2 * d, "int8": d, "int4": d // 2}
    quant = slab_dtype in ("int8", "int4")
    nbytes = live * c * (row[slab_dtype] + 1 + (4 if quant else 0))
    nbytes += 8 * u + b * d * {"float32": 4, "bfloat16": 2, "int8": 1}[qtype]
    nbytes += b * k * 8
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2.0 * b * live * c * d / PEAK_QOPS_S[qtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_block_scan(index, q, k, nprobe, gen, qprec):
    """One batch at the kernels' inputs on ``index``'s state: stage 1,
    stage 2, the plain version and the library yardstick (gather the
    live blocks, torch.matmul, torch.topk), beside the bound from the
    batch's live-block count."""
    import torch

    from wdbx_tpu_torch.kernels import clustered_scan as cs
    from wdbx_tpu_torch.kernels import fused_topk as tf
    from wdbx_tpu_torch.kernels.quant import prep_query_block

    b, d = q.shape
    slab, valid = index._slab, index._valid
    scales = index._scales if index._is_quantized else None
    int4 = index._is_int4
    qn, uniq, ok, c = _block_list(index, q, k, b, valid, nprobe)
    qq, qs, _ = prep_query_block(qn, slab.dtype, scales is not None, qprec)

    def stage1(v=valid):
        return cs.clustered_block_partial(slab, v, scales, uniq, ok, qq,
                                          qs, k, c, int4=int4, gen=gen)

    ms = cuda_ms(stage1)
    # every row masked (same block list): stage 1 without the selection
    none_valid = torch.zeros_like(valid)
    score_only_ms = cuda_ms(lambda: stage1(none_valid))
    before = dict(cs.clustered_block_partial.bodies)
    pv, pi = stage1()
    body = [b for b, n in cs.clustered_block_partial.bodies.items()
            if n != before[b]][0]
    old_ms = None
    if body == "mma_pipe":  # the first tensor-core body, same inputs
        old_ms = cuda_ms(lambda: cs.clustered_block_partial(
            slab, valid, scales, uniq, ok, qq, qs, k, c, int4=int4, gen=gen,
            body="mma"))
    merge_ms = cuda_ms(lambda: tf.topk_merge_partials(pv, pi, k))
    plain_ms = cuda_ms(lambda: cs.clustered_block_topk_plain(
        slab, valid, scales, uniq, ok, qn, k, c, int4=int4, qprec=qprec),
        reps=3, warm=1)
    ids = uniq[ok]
    pos = (ids[:, None] * c + torch.arange(c, device="cuda")).reshape(-1)
    library_ms = None  # no PyTorch call takes packed int4 rows
    if not int4:
        lq = qn.to(torch.bfloat16 if scales is not None else slab.dtype)

        def library():
            rows = slab[pos].to(lq.dtype)
            s = torch.matmul(lq, rows.T)
            if scales is not None:
                s = s * scales[pos]
            return torch.topk(s.masked_fill(~valid[pos], float("-inf")), k)

        library_ms = cuda_ms(library, reps=3, warm=1)
    live = int(ok.sum())
    skey = "int4" if int4 else str(slab.dtype).replace("torch.", "")
    qtype = str(qq.dtype).replace("torch.", "")
    bound, by = _block_bound_ms(skey, qtype, live, c, d, b, k, len(uniq))
    return {"ms": ms, "score_only_ms": score_only_ms, "merge_ms": merge_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by, "body": body,
            "old_ms": old_ms,
            "parts": int(pv.shape[1]), "live_blocks": live,
            "u": int(len(uniq)), "c": c}


# the K3 modes with int4 rows or int8 queries, swept at more shapes
MOVED_MODES = (("v2", "int4", "bfloat16"), ("v2", "int8", "int8"),
               ("v2", "int4", "int8"))


def phase_clustered_kernels(seed, errs):
    """K3 / K4 against their plain version on the card: every slab type
    and query type of both generations, d=768, c in {256, 1024}, a block
    list with a dead suffix and an interior hole, an all-dead list, ~10%
    invalid rows, k in {10, 50, 128}, B in {1, 128}; the int4 and
    int8-query modes also at d 384 and 768 with B in {1, 5, 37, 128} and
    k in {1, 10, 50}; the pipelined body's cases also through the first
    tensor-core body. Then int8 queries on corpora of duplicated rows."""
    import torch

    from wdbx_tpu_torch.kernels import clustered_scan as cs
    from wdbx_tpu_torch.kernels import fused_topk as tf
    from wdbx_tpu_torch.kernels.quant import prep_query_block

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cap = 65536
    n_cases = 0
    sweeps = ((768, cs.MODES, (1, 128), (10, 50, 128)),
              (768, MOVED_MODES, (5, 37), (1, 10, 50)),
              (384, MOVED_MODES, (1, 5, 37, 128), (1, 10, 50)))
    d_now = None
    for d, modes, batches, ks in sweeps:
        if d != d_now:
            x = torch.randn((cap, d), generator=g, device="cuda")
            x = x / x.norm(dim=1, keepdim=True)
            valid = torch.rand((cap,), generator=g, device="cuda") > 0.1
            q_all = torch.randn((128, d), generator=g, device="cuda")
            slabs = {dt: _slab(dt, x) for dt in ("float32", "bfloat16",
                                                 "int8", "int4")}
            d_now = d
        for c in (256, 1024):
            nblocks = cap // c
            uniq = torch.randperm(nblocks, generator=g, device="cuda")[:24]
            ok = torch.zeros(24, dtype=torch.bool, device="cuda")
            ok[:18] = True
            ok[5] = False  # interior hole; entries 18.. are the dead suffix
            for gen, sk, qk in modes:
                slab, scales, int4 = slabs[sk]
                qprec = "int8" if qk == "int8" else "bf16"
                wrapper = (cs.clustered_block_topk_v2 if gen == "v2"
                           else cs.clustered_block_topk)
                lists = [("list", uniq, ok)]
                if c == 1024:
                    lists.append(("all_dead", uniq, torch.zeros_like(ok)))
                for b in batches:
                    q = q_all[:b]
                    qq, qs, _ = prep_query_block(q, slab.dtype,
                                                 scales is not None, qprec)
                    rescore = block_rescorer(slab, qq, qs, scales, int4)
                    for k in ks:
                        for case, u_, ok_ in lists:
                            kw = dict(int4=int4, qprec=qprec) \
                                if gen == "v2" else {}
                            before = dict(cs.clustered_block_partial.bodies)
                            got = wrapper(slab, valid, scales, u_, ok_, q,
                                          k=k, c=c, **kw)
                            body = [x for x, n in
                                    cs.clustered_block_partial.bodies.items()
                                    if n != before[x]]
                            ref = cs.clustered_block_topk_plain(
                                slab, valid, scales, u_, ok_, q, k, c,
                                int4=int4, qprec=qprec)
                            torch.cuda.synchronize()
                            key = clu_name(cs.mode_key(gen, sk, qk))
                            name = f"{key}/d{d}_c{c}_b{b}_k{k}/{case}"
                            want = want_body(sk, qk, d, b, k)
                            if body != [want]:
                                fail(f"{name}: ran {body}, expected {want}")
                            err = check_topk(name, ref, got, rescore)
                            if want == "mma_pipe":
                                # the first tensor-core body, same inputs
                                pv2, pi2 = cs.clustered_block_partial(
                                    slab, valid, scales, u_, ok_, qq, qs, k,
                                    c, int4=int4, gen=gen, body="mma")
                                err = max(err, check_topk(
                                    name + "/mma", ref,
                                    tf.topk_merge_partials(pv2, pi2, k),
                                    rescore))
                            if case == "all_dead" and not torch.isneginf(
                                    got[0]).all():
                                fail(f"{name}: a dead list returned rows")
                            errs[key] = max(errs.get(key, 0.0), err)
                            n_cases += 1
    emit({"phase": "clustered_kernels", "cases": n_cases, "cap": cap,
          "d": [768, 384], "tol": ATOL,
          "max_abs_err": {k: v for k, v in errs.items()
                          if k.startswith("clustered")}})
    del slabs, x, valid
    torch.cuda.empty_cache()
    phase_clustered_determinism(g, errs)


def phase_clustered_determinism(g, errs):
    """int8 queries against int8 and int4 slabs of 8 copies of 8,192
    rows (c = 1,024: every copy in other blocks), all 64 blocks listed:
    two runs give the same scores and slots bit for bit, and k=11 cuts
    through a group of copies, so the plain version may pick other
    copies: equal except at ties."""
    import torch

    from wdbx_tpu_torch.kernels import clustered_scan as cs
    from wdbx_tpu_torch.kernels import fused_topk as tf
    from wdbx_tpu_torch.kernels.quant import prep_query_block

    base = torch.randn((8192, 384), generator=g, device="cuda")
    x = (base / base.norm(dim=1, keepdim=True)).repeat(8, 1)
    q = torch.randn((128, 384), generator=g, device="cuda")
    valid = torch.ones(x.shape[0], dtype=torch.bool, device="cuda")
    c = 1024
    uniq = torch.arange(x.shape[0] // c, dtype=torch.int32, device="cuda")
    ok = torch.ones_like(uniq, dtype=torch.bool)
    for sk in ("int8", "int4"):
        slab, scales, int4 = _slab(sk, x)
        qq, qs, _ = prep_query_block(q, slab.dtype, True, "int8")
        runs = []
        for _ in range(2):
            before = dict(cs.clustered_block_partial.bodies)
            pv, pi = cs.clustered_block_partial(slab, valid, scales, uniq, ok,
                                                qq, qs, 11, c, int4=int4)
            body = [b for b, n in cs.clustered_block_partial.bodies.items()
                    if n != before[b]]
            runs.append((pv, pi) + tf.topk_merge_partials(pv, pi, 11))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        key = clu_name(cs.mode_key("v2", sk, "int8"))
        name = f"{key}/duplicates/k11"
        err = check_topk(name, cs.clustered_block_topk_plain(
            slab, valid, scales, uniq, ok, q, 11, c, int4=int4, qprec="int8"),
            runs[0][2:], block_rescorer(slab, qq, qs, scales, int4))
        emit({"phase": "clustered_kernels", "case": name, "body": body,
              "copies": 8, "identical_runs": same, "max_abs_err": err,
              "tol": ATOL})
        if body != ["mma_pipe"] or not same:
            fail(f"{name}: body {body}, identical runs {same}")
        errs[key] = max(errs[key], err)


def _stream_truth(chunks, q, k, cand_src=None):
    """Float32 top-k source rows of ``q`` over the regenerated corpus
    (torch.matmul with TF32 off, a top-k merge per chunk), and the exact
    scores of the candidate source rows ``cand_src`` (Q, F), gathered in
    the same pass. A yardstick, never on the port's path."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    nq = q.shape[0]
    best_v = torch.full((nq, k), float("-inf"), device="cuda")
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device="cuda")
    exact = (torch.full(cand_src.shape, float("-inf"), device="cuda")
             if cand_src is not None else None)
    lo = 0
    for x in chunks():
        m = x.shape[0]
        v, i = torch.topk(q @ x.T, k, dim=1)
        v = torch.cat([best_v, v], dim=1)
        i = torch.cat([best_i, i + lo], dim=1)
        best_v, sel = torch.topk(v, k, dim=1)
        best_i = torch.gather(i, 1, sel)
        if cand_src is not None:
            inside = (cand_src >= lo) & (cand_src < lo + m)
            rows = x[(cand_src - lo).clamp(0, m - 1)]
            exact = torch.where(inside, (rows * q[:, None, :]).sum(-1), exact)
        lo += m
    return best_i, exact


def _slot_recall(got_slots, truth_slots) -> float:
    hit = sum(len(set(a.tolist()) & set(t.tolist()))
              for a, t in zip(got_slots, truth_slots))
    return float(hit / truth_slots.numel())


def phase_clustered(seed, paths, timings, errs):
    """The 10M x 768 int8 clustered index of benchmarks/clustered_10m.py
    (4096-component mixture, nlist 4096), filled by build_from, served
    by search_pipelined; every batch against the plain version, recall
    against a float32 oracle."""
    import torch

    from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex

    n, d, chunk_rows, nb, b, k = 10_000_000, 768, 524_288, 8, 128, 10
    mix = _mixture(4096, d, seed + 7)

    def chunks():
        for i, lo in enumerate(range(0, n, chunk_rows)):
            yield mix(1000 + i, min(chunk_rows, n - lo))

    index = ClusteredIVFIndex(d, dtype="int8", nlist=4096, nprobe=1,
                              train_threshold=1 << 62, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = index.build_from(chunks, train_chunks=1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if index.count() != n or index._c != 1024 or index.capacity != 10_485_760:
        fail(f"10M build: size {index.count()}, c {index._c}, "
             f"cap {index.capacity}")
    emit({"phase": "clustered", "step": "build_from", "n": n, "d": d,
          "nlist": 4096, "dtype": "int8", "capacity": index.capacity,
          "c": index._c, "build_s": build_s})
    q = mix(9999, nb * b)
    qstack = q.reshape(nb, b, d)
    slots_t = torch.as_tensor(slots, device="cuda")
    src_of_slot = torch.empty_like(slots_t)
    src_of_slot[slots_t] = torch.arange(n, device="cuda")

    def drive(name, nprobe, kk, gen="v2", qprec="bf16", stack=qstack):
        index.nprobe, index.kernel_version = nprobe, gen
        index.kernel_qprec = qprec
        _reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = index.search_pipelined(stack, kk, materialize=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[name] = _counts()
        return out, wall

    results = {}
    for nprobe, gen, qprec, kk in (
            (1, "v2", "bf16", 10), (4, "v2", "bf16", 10),
            (1, "v2", "bf16", 50), (1, "v1", "bf16", 10),
            (1, "v2", "int8", 10), (4, "v2", "int8", 10),
            (1, "v2", "int8", 50)):
        name = f"clustered_10m[nprobe{nprobe},k{kk},{gen},q={qprec}]"
        out, wall = drive(name, nprobe, kk, gen, qprec)
        key = clu_name(cs_key(gen, "int8", qprec))
        body = "mma_pipe"
        if paths[name][key] < 1 or \
                paths[name][f"clustered_block_partial.bodies.{body}"] < 1:
            fail(f"{name} did not run {key} with the {body} body: "
                 f"{paths[name]}")
        err, live = check_pipelined(name, index, qstack, kk, out)
        errs[key] = max(errs.get(key, 0.0), err)
        results[name] = out
        emit({"phase": "clustered", "path": name, "nb": nb, "b": b, "k": kk,
              "wall_s": wall, "max_abs_err_vs_plain": err, "tol": ATOL,
              "max_live_blocks": live, "launches": paths[name]})
        if kk == 10 and nprobe == 1:
            tm = time_block_scan(index, qstack[0], kk, nprobe, gen, qprec)
            tm["call_ms_per_batch"] = cuda_ms(lambda: index.search_pipelined(
                qstack, kk, materialize=False), reps=3, warm=1) / nb
            timings[key] = tm
            emit({"phase": "clustered", "timing": key, "nprobe": nprobe,
                  "b": b, "k": kk, **tm})
    index.nprobe, index.kernel_version, index.kernel_qprec = 4, "v2", "bf16"
    tm4 = time_block_scan(index, qstack[0], 10, 4, "v2", "bf16")
    emit({"phase": "clustered", "timing": "nprobe4", "b": b, "k": 10, **tm4})

    # recall against the float32 oracle, with the x5 exact rerank
    def slots_of(out):
        return index.resolve_pipelined(out)[1].reshape(nb * b, -1)

    cand = torch.as_tensor(slots_of(results[
        "clustered_10m[nprobe1,k50,v2,q=bf16]"]), device="cuda")
    cand_src = torch.where(cand >= 0, src_of_slot[cand.clamp(min=0)], -1)
    t0 = time.perf_counter()
    truth_src, exact = _stream_truth(chunks, q, 10, cand_src)
    oracle_s = time.perf_counter() - t0
    truth = slots_t[truth_src].cpu()
    exact = torch.where(cand >= 0, exact, float("-inf"))
    rerank = torch.gather(cand, 1, torch.topk(exact, 10, dim=1).indices).cpu()
    rec = {f"raw_nprobe{p}": _slot_recall(
        torch.as_tensor(slots_of(results[f"clustered_10m[nprobe{p},k10,v2,q=bf16]"])),
        truth) for p in (1, 4)}
    rec["rerank_x5_nprobe1"] = _slot_recall(rerank, truth)
    rec["raw_v1_nprobe1"] = _slot_recall(torch.as_tensor(slots_of(
        results["clustered_10m[nprobe1,k10,v1,q=bf16]"])), truth)
    for p in (1, 4):
        rec[f"raw_qint8_nprobe{p}"] = _slot_recall(torch.as_tensor(slots_of(
            results[f"clustered_10m[nprobe{p},k10,v2,q=int8]"])), truth)
    emit({"phase": "clustered", "recall_at_10": rec, "queries": nb * b,
          "oracle_s": oracle_s, "bar_rerank_x5_nprobe1": RERANK_BAR})
    if rec["rerank_x5_nprobe1"] < RERANK_BAR:
        fail(f"10M x5-rerank recall@10 {rec['rerank_x5_nprobe1']} "
             f"< {RERANK_BAR}")

    # B=1: nprobe 4 takes the narrow-block kernel, nprobe 1 the ranges scan
    q1 = q[:16].reshape(16, 1, d)
    for nprobe in (4, 1):
        name = f"clustered_10m[b1,nprobe{nprobe}]"
        out, _ = drive(name, nprobe, 10, stack=q1)
        route = "ranges" if index._use_ranges(1, nprobe) else \
            f"kernel (c={index._geom(1)[1]})"
        if route != "ranges":
            err, live = check_pipelined(name, index, q1, 10, out)
            errs[clu_name(cs_key("v2", "int8", "bf16"))] = max(
                errs[clu_name(cs_key("v2", "int8", "bf16"))], err)
        ms = cuda_ms(lambda: index.search_pipelined(q1, 10, materialize=False),
                     reps=3, warm=1) / 16
        got = torch.as_tensor(index.resolve_pipelined(out)[1].reshape(16, -1))
        emit({"phase": "clustered", "path": name, "route": route,
              "ms_per_query": ms, "recall_at_10_raw": _slot_recall(
                  got, truth[:16]), "launches": paths[name]})
        if (route == "ranges") != (nprobe == 1):
            fail(f"{name}: took the {route} route")
    del index, slots_t, src_of_slot
    torch.cuda.empty_cache()


def cs_key(gen, slab, qprec):
    from wdbx_tpu_torch.kernels import clustered_scan as cs

    qtype = {"int8": "int8", "bf16": "bfloat16"}[qprec]
    if slab in ("float32", "bfloat16"):
        qtype = slab
    return cs.mode_key(gen, slab, qtype)


def _check_calls(name, index, calls, errs):
    """The route of each recorded ``index.search`` call of the facade,
    and each kernel-path result against the plain version on the same
    index state (filter pushdown included). Returns the routes and, for
    each kernel-path call, the blocks its list holds beside the blocks
    that hold a live row."""
    import torch

    from wdbx_tpu_torch.index.flat import _next_pow2

    routes, cover = [], []
    pos_of = torch.as_tensor(index._pos_of, device="cuda").long()
    for queries, kk, mask, (sc, sl) in calls:
        nlist = int(index._centroids.shape[0])
        pm, nprobe, exact = index._filter_plan(
            mask, min(index.nprobe, nlist), nlist)
        pad_b = _next_pow2(len(queries))
        if exact or index._use_ranges(pad_b, nprobe):
            routes.append("exact" if exact else "ranges")
            continue
        routes.append("kernel")
        valid = index._valid if pm is None else index._masked_valid_dev(
            index._valid, pm, index._cap)
        ref, rescore, listed = _block_plain(
            index, torch.as_tensor(queries, device="cuda"), kk, pad_b,
            valid, nprobe)
        c = index._geom(pad_b)[1]
        cover.append([listed, int(valid[: index._cap].reshape(-1, c)
                                  .any(dim=1).sum())])
        sl = torch.as_tensor(sl, device="cuda")
        pos = torch.where(sl >= 0, pos_of[sl.clamp(min=0)], -1)
        key = clu_name(cs_key(index._kernel_gen(), index.dtype_name,
                              getattr(index, "kernel_qprec", "bf16")))
        errs[key] = max(errs.get(key, 0.0), check_topk(
            name, ref, (torch.as_tensor(sc, device="cuda"), pos), rescore))
    return routes, cover


def phase_clustered_facade(seed, paths, timings, errs, tmp):
    """INDEX_TYPE=ivf through the facade at 1,048,576 x 384 (a
    1024-component mixture), int8 with the raw-store rerank, unfiltered
    and filtered at 10% (pushdown) and 1% (exact masked route); then a
    clustered index of each other slab type served by search_pipelined."""
    import numpy as np
    import torch

    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex

    n, d, b, k = 1 << 20, 384, 128, 10
    mix = _mixture(1024, d, seed + 11)
    x_dev = torch.cat([mix(2000 + i, 1 << 18) for i in range(4)])
    q = mix(8888, b)
    tag = np.arange(n) % 100  # tag < 10: 10% of rows; tag == 0: 1%
    db = WDBX(vector_dimension=d, enable_plugins=False,
              data_dir=os.path.join(tmp, "ivf"),
              config={"INDEX_TYPE": "ivf", "IVF_NLIST": 1024,
                      "IVF_NPROBE": 2, "INDEX_DTYPE": "int8",
                      "RAW_STORE": "ram",
                      "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
    index = db.store.indices[0]
    if db.store.num_shards != 1 or not isinstance(index, ClusteredIVFIndex):
        fail(f"INDEX_TYPE=ivf gave {type(index).__name__}")
    t0 = time.perf_counter()
    db.store.bulk_load([str(i) for i in range(n)], x_dev.cpu().numpy(),
                       {"tag": tag})
    db.optimize()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    # at c = 2,048 rows the dedup bound u of a batch of 128 reaches the
    # block count, which the index would serve with the exact flat scan:
    # drive the block scan. At nprobe 2 the unfiltered batch lists only
    # part of the blocks (gated below), so its recall tests the
    # clustering; the 10% filter's probe boost lists them all.
    index.batch_flat_fallback = False
    calls = []
    search = index.search

    def recording(queries, kk, slot_mask=None):
        out = search(queries, kk, slot_mask=slot_mask)
        calls.append((np.array(queries, np.float32), kk, slot_mask, out))
        return out

    index.search = recording
    tagd = torch.as_tensor(tag, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {}
    for label, flt, sel in (("unfiltered", None, None),
                            ("filter_10pct", {"tag": {"$lt": 10}}, tagd < 10),
                            ("filter_1pct", {"tag": 0}, tagd == 0)):
        name = f"clustered_facade[{label}]"
        calls.clear()
        _reset()
        t0 = time.perf_counter()
        hits = db.vector_search_batch(q.cpu().numpy(), limit=k,
                                      filter_metadata=flt)
        wall = time.perf_counter() - t0
        paths[name] = _counts()
        s = q @ x_dev.T
        if sel is not None:
            s = s.masked_fill(~sel[None, :], float("-inf"))
        truth = torch.topk(s, k, dim=1).indices.cpu().numpy()
        rec[label] = _recall(hits, truth)
        routes, cover = _check_calls(name, index, calls, errs)
        emit({"phase": "clustered_facade", "path": name, "n": n, "b": b,
              "nprobe": index.nprobe, "wall_s": wall, "routes": routes,
              "blocks_listed_of_live": cover, "recall_at_10": rec[label],
              "bar": FACADE_BAR, "launches": paths[name]})
        if rec[label] < FACADE_BAR:
            fail(f"{name}: recall@10 {rec[label]} < {FACADE_BAR}")
        if label == "unfiltered" and cover[0][0] >= cover[0][1]:
            fail(f"{name}: the block list covers the corpus ({cover}); "
                 "its recall would not test the clustering")
        want = "exact" if label == "filter_1pct" else "kernel"
        if routes != [want]:
            fail(f"{name}: routes {routes}, expected [{want!r}]")
        if want == "kernel" and (paths[name][clu_name(
                cs_key("v2", "int8", "bf16"))] < 1 or paths[name][
                "clustered_block_partial.bodies.mma_pipe"] < 1):
            fail(f"{name}: K3 was not launched with the pipelined body: "
                 f"{paths[name]}")
    # one query at a time (B=1)
    name = "clustered_facade[vector_search]"
    calls.clear()
    _reset()
    one = [db.vector_search(q[i].tolist(), limit=k) for i in range(8)]
    paths[name] = _counts()
    truth = torch.topk(q[:8] @ x_dev.T, k, dim=1).indices.cpu().numpy()
    rec["vector_search"] = _recall(one, truth)
    routes, cover = _check_calls(name, index, calls, errs)
    emit({"phase": "clustered_facade", "path": name, "routes": routes,
          "blocks_listed_of_live": cover,
          "recall_at_10": rec["vector_search"], "launches": paths[name]})
    if rec["vector_search"] < FACADE_BAR:
        fail(f"{name}: recall@10 {rec['vector_search']} < {FACADE_BAR}")
    emit({"phase": "clustered_facade", "load_and_optimize_s": load_s})
    index.search = search
    del db, index
    torch.cuda.empty_cache()

    # the other slab types (and int8 queries on int4) at the same size
    qstack = mix(7777, 8 * b).reshape(8, b, d)
    for dtype, qprec in (("float32", "bf16"), ("bfloat16", "bf16"),
                         ("int4", "bf16"), ("int4", "int8")):
        name = f"clustered_slabs[{dtype},q={qprec}]"
        if dtype != "int4" or qprec == "bf16":
            index = ClusteredIVFIndex(d, dtype=dtype, nlist=1024, nprobe=1,
                                      train_threshold=1 << 62,
                                      device="cuda")
            index.build_from(lambda: (x_dev[i:i + (1 << 18)]
                                      for i in range(0, n, 1 << 18)))
        index.kernel_qprec = qprec
        _reset()
        out = index.search_pipelined(qstack, k, materialize=False)
        torch.cuda.synchronize()
        paths[name] = _counts()
        key = clu_name(cs_key("v2", dtype, qprec))
        body = "fma_tiled" if dtype == "float32" else "mma_pipe"
        if paths[name][key] < 1 or \
                paths[name][f"clustered_block_partial.bodies.{body}"] < 1:
            fail(f"{name} did not run {key} with the {body} body: "
                 f"{paths[name]}")
        err, live = check_pipelined(name, index, qstack, k, out)
        errs[key] = max(errs.get(key, 0.0), err)
        tm = time_block_scan(index, qstack[0], k, 1, "v2", qprec)
        tm["call_ms_per_batch"] = cuda_ms(lambda: index.search_pipelined(
            qstack, k, materialize=False), reps=3, warm=1) / 8
        timings[key] = tm
        emit({"phase": "clustered_slabs", "path": name, "n": n, "d": d,
              "nb": 8, "b": b, "k": k, "nprobe": 1,
              "max_abs_err_vs_plain": err, "tol": ATOL, **tm,
              "launches": paths[name]})
        if dtype != "int4" or qprec == "int8":
            del index
            torch.cuda.empty_cache()
    del x_dev


# -- the dense IVF engine (K5) -----------------------------------------------


def bucket_rescorer(rows, probes, qidx, qq):
    """``rescorer`` for K5's inputs: the float32 product of pair s's
    table-typed query row and row ``pos`` of its bucket."""
    def rescore(srow, pos):
        srow, pos = srow.to(rows.device), pos.to(rows.device)
        r = rows[probes[srow].long(), pos].to(qq.device).float()
        return (qq[qidx[srow].long()].float() * r).sum(-1)

    return rescore


def check_grouping(name, probes, qidx, nlist, b, g) -> None:
    """The grouping kernel against its plain version: the same items,
    and within each bucket the same pair ids (the kernel's order there is
    its atomics')."""
    import torch

    from wdbx_tpu_torch.kernels import ivf_scan as ivs

    p32, q32 = probes.to(torch.int32), qidx.to(torch.int32)
    order, items, n_items = ivs.group_pairs(p32, q32, nlist, b, g)
    want_o, want_i, want_n = ivs.group_pairs_plain(probes, qidx, nlist, b, g)
    n = int(n_items[0])
    if n != want_n or not torch.equal(items[:n], want_i):
        fail(f"{name}: group_pairs items differ from the plain version")
    ok = (p32 >= 0) & (p32 < nlist) & (q32 >= 0) & (q32 < b)
    key = torch.where(ok, p32, nlist).long()
    got = order.long()
    got = got[torch.argsort(key[got] * len(got) + got)]
    if not torch.equal(got, want_o.long()):
        fail(f"{name}: group_pairs order differs from the plain version")


def phase_ivf_kernels(seed, errs):
    """K5 against its plain version: bf16 and float32 tables, d 384 and
    ragged 100, C 128 and 1408, k 1 / 10 / 128, B 1 and 128 at P 8,
    through the shape rule's body and again through the per-pair body;
    then 128 queries all probing the same 8 buckets (items split at g),
    repeated (query, probe) pairs and an out-of-range probe (its row all
    -inf / -1). Bucket 0 is all invalid and bucket 1 holds 5 valid rows;
    both are among every batch's probes. The grouping kernel is held
    against its plain version on every case."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf
    from wdbx_tpu_torch.kernels import ivf_scan as ivs

    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    nlist, p = 64, 8
    n_cases = 0
    bodies = {}
    errs["ivf_group_pairs"] = 0.0
    for d in (384, 100):
        for c in (128, 1408):
            x = torch.randn((nlist, c, d), generator=g, device="cuda")
            x = x / x.norm(dim=-1, keepdim=True)
            valid = torch.rand((nlist, c), generator=g, device="cuda") > 0.1
            valid[0] = False
            valid[1] = False
            valid[1, :5] = True
            q = torch.randn((128, d), generator=g, device="cuda")
            for dtype in ("bfloat16", "float32"):
                table = x.to(getattr(torch, dtype))
                want = ivs.pick_body(dtype, d, table.data_ptr())
                for case in ("b1", "b128", "skewed", "duplicates",
                             "out_of_range"):
                    b = 1 if case == "b1" else 128
                    if case == "skewed":  # every query probes buckets 0-7
                        probes = torch.arange(8, device="cuda").repeat(b)
                    else:
                        probes = torch.randint(0, nlist, (b * p,),
                                               generator=g, device="cuda")
                        probes[:2] = torch.tensor([0, 1], device="cuda")
                    qidx = torch.arange(b, device="cuda").repeat_interleave(p)
                    if case == "duplicates":
                        probes[8:24] = probes[:16].clone()
                        qidx[8:24] = qidx[:16].clone()
                    live = torch.ones_like(probes, dtype=torch.bool)
                    ref_probes = probes.clone()
                    if case == "out_of_range":
                        probes[5], live[5] = nlist + 3, False
                    qq = q[:b].to(table.dtype)
                    rescore = bucket_rescorer(table, ref_probes[live],
                                              qidx[live], qq)
                    for k in (1, 10, 128):
                        name = (f"ivf_bucket_partial[{dtype}]/"
                                f"d{d}_c{c}_{case}_k{k}")
                        ref = ivs.ivf_bucket_scan_plain(table, valid,
                                                        ref_probes, qidx,
                                                        q[:b], k)
                        check_grouping(name, probes, qidx, nlist, b,
                                       ivs.group_size(d, k))
                        call = ivs.ivf_bucket_scan(table, valid, probes, qidx,
                                                   q[:b], k)
                        for body in (None, "pair"):
                            before = dict(ivs.ivf_bucket_partial.bodies)
                            pv, pi = ivs.ivf_bucket_partial(
                                table, valid, probes, qidx, qq, k, body=body)
                            ran = [n for n, v in
                                   ivs.ivf_bucket_partial.bodies.items()
                                   if v != before[n]]
                            if ran != [body or want]:
                                fail(f"{name}: ran {ran}, not "
                                     f"{body or want}")
                            got = tf.topk_merge_partials(pv, pi, k)
                            torch.cuda.synchronize()
                            label = f"{name}/{ran[0]}"
                            if body is None:
                                for part, w in zip(call, got):
                                    if not torch.equal(part, w):
                                        fail(f"{label}: ivf_bucket_scan "
                                             "differs from its two stages")
                            if not live.all():
                                dead = ~live
                                if not torch.isneginf(got[0][dead]).all() or \
                                        not (got[1][dead] == -1).all():
                                    fail(f"{label}: the out-of-range pair "
                                         "gave rows")
                            err = check_topk(
                                label, (ref[0][live], ref[1][live]),
                                (got[0][live], got[1][live]), rescore)
                            if case != "skewed":
                                if not torch.isneginf(got[0][0]).all():
                                    fail(f"{label}: the all-invalid bucket "
                                         "gave rows")
                                if int(torch.isfinite(got[0][1]).sum()) != \
                                        min(k, 5):
                                    fail(f"{label}: k past the valid count")
                            key = f"ivf_bucket_partial[{dtype}]"
                            errs[key] = max(errs.get(key, 0.0), err)
                            bodies.setdefault(f"d{d}_{dtype}", set()).add(
                                ran[0])
                            n_cases += 1
            del x, valid, table
    emit({"phase": "ivf_kernels", "cases": n_cases, "nlist": nlist,
          "tol": ATOL, "bodies": {k: sorted(v) for k, v in bodies.items()},
          "max_abs_err": {k: v for k, v in errs.items()
                          if k.startswith("ivf_")}})
    torch.cuda.empty_cache()


class plain_k5:
    """Within the block, the dense index's kernel path calls K5's plain
    version instead of the kernel: the same routing, probes, masks and
    residual merge around it, so a search there is the plain version of
    the whole query on the same index state."""

    def __enter__(self):
        from wdbx_tpu_torch.kernels import ivf_scan as ivs

        self.real = ivs.ivf_bucket_scan
        ivs.ivf_bucket_scan = (
            lambda rows, valid, probes, qidx, q, k=10, interpret=False:
            ivs.ivf_bucket_scan_plain(rows, valid, probes, qidx, q, k))
        return self

    def __exit__(self, *exc):
        from wdbx_tpu_torch.kernels import ivf_scan as ivs

        ivs.ivf_bucket_scan = self.real


def _dense_rescorer(index, queries):
    """True scores of (query row, slot) pairs on the dense index's inputs:
    the normalized query in the slab's type against the slab row (the
    bucket copy of a bf16 slab's row is the same bits)."""
    import torch

    from wdbx_tpu_torch.ops.normalize import l2_normalize

    q = l2_normalize(torch.as_tensor(queries, device="cuda"))
    return rescorer(index._slab, q.to(index._slab.dtype))


def _as_dev(out):
    import torch

    return (torch.as_tensor(out[0], device="cuda"),
            torch.as_tensor(out[1], device="cuda"))


def _bound_k5(index, probes, b, k, dtype="bfloat16"):
    """K5's least time on this run's pairs: the valid rows of the unique
    probed buckets read once (with their validity bytes), the pair ids,
    the queries and the results, over the HBM rate; or its products
    (2 d per valid row of every pair) over the table type's peak."""
    import torch

    d = index.dim
    es = 2 if dtype == "bfloat16" else 4
    cnt = index._bucket_valid.sum(dim=1)
    uniq = torch.unique(probes)
    c = index._bucket_valid.shape[1]
    nbytes = (int(cnt[uniq].sum()) * d * es + len(uniq) * c
              + probes.numel() * 8 + b * d * es + probes.numel() * k * 12)
    pair_bytes = int(cnt[probes].sum()) * d * es
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2.0 * int(cnt[probes].sum()) * d / PEAK_OPS_S[dtype] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, len(uniq), pair_bytes


def time_k5(index, queries, nprobe, k=10, table=None, dtype="bfloat16"):
    """K5 at the index's own pairs for ``queries``: stage 1 (the shape
    rule's body, and the per-pair body as ``old_ms``; both also in a CUDA
    graph), the grouping (eagerly and in a CUDA graph), stage 2, the
    whole call, stage 1 with every row masked (set-up only, in a graph),
    a contiguous torch read of the unique buckets' bytes, the plain
    version and the library yardstick (gather the pairs' buckets,
    torch.bmm, torch.topk) with CUDA events, beside the bound and the
    bytes of the unique probed buckets' valid rows. ``table`` replaces
    the index's bucket rows (same layout)."""
    import torch

    from wdbx_tpu_torch.index.ivf import _probes
    from wdbx_tpu_torch.kernels import fused_topk as tf
    from wdbx_tpu_torch.kernels import ivf_scan as ivs
    from wdbx_tpu_torch.ops.normalize import l2_normalize

    table = index._bucket_rows if table is None else table
    valid = index._bucket_valid
    qn = l2_normalize(torch.as_tensor(queries, device="cuda"))
    b = qn.shape[0]
    probe = _probes(qn, index._centroids, nprobe, index._precision)
    probes = probe.reshape(-1)
    qidx = torch.arange(b, device="cuda").repeat_interleave(probe.shape[1])
    qq = qn.to(table.dtype)
    body = ivs.pick_body(dtype, index.dim, table.data_ptr())
    part = lambda: ivs.ivf_bucket_partial(  # noqa: E731
        table, valid, probes, qidx, qq, k)
    old = lambda: ivs.ivf_bucket_partial(  # noqa: E731
        table, valid, probes, qidx, qq, k, body="pair")
    ms, old_ms = cuda_ms(part), cuda_ms(old)
    # device times without the host's launch cost (small B is host-bound)
    part_graph_ms, old_graph_ms = graph_ms(part), graph_ms(old)
    g = ivs.group_size(index.dim, k)
    p32, q32 = probes.to(torch.int32), qidx.to(torch.int32)
    group = lambda: ivs.group_pairs(  # noqa: E731
        p32, q32, valid.shape[0], b, g)
    group_ms = cuda_ms(group)
    group_graph_ms = graph_ms(group)
    group_plain_ms = cuda_ms(lambda: ivs.group_pairs_plain(
        probes, qidx, valid.shape[0], b, g), reps=3, warm=1)
    n_items = int(group()[2][0])
    pv, pi = part()
    merge_ms = cuda_ms(lambda: tf.topk_merge_partials(pv, pi, k))
    call_ms = cuda_ms(lambda: ivs.ivf_bucket_scan(table, valid, probes, qidx,
                                                  qn, k))
    plain_ms = cuda_ms(lambda: ivs.ivf_bucket_scan_plain(
        table, valid, probes, qidx, qn, k), reps=3, warm=1)

    def library():
        rows = table[probes]
        s = torch.bmm(rows, qq[qidx][:, :, None])[..., 0]
        return torch.topk(s.masked_fill(~valid[probes], float("-inf")), k)

    library_ms = cuda_ms(library, reps=3, warm=1)
    bound, by, uniq, pair_bytes = _bound_k5(index, probes, b, k, dtype)
    es = 2 if dtype == "bfloat16" else 4
    uniq_bytes = int(valid.sum(dim=1)[torch.unique(probes)].sum()) * \
        index.dim * es
    # what holds stage 1 back: with every row masked it reads no row and
    # keeps only the units' set-up, claims and writes; a contiguous read
    # of as many bytes as the unique buckets' valid rows is the rate the
    # card streams at
    none = torch.zeros_like(valid)
    setup_only_ms = graph_ms(lambda: ivs.ivf_bucket_partial(
        table, none, probes, qidx, qq, k))
    flat = table.reshape(-1)[: uniq_bytes // es]
    stream_ms = cuda_ms(lambda: flat.sum(dtype=torch.float32))
    # the grouping reads the pair ids and writes the order and the items
    group_bytes = probes.numel() * 12 + n_items * 12 + 8
    return {"ms": ms, "body": body, "old_ms": old_ms,
            "graph_ms": part_graph_ms, "old_graph_ms": old_graph_ms,
            "merge_ms": merge_ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
            "b": b, "pairs": int(probes.numel()), "unique_buckets": uniq,
            "items": n_items, "group_size": g,
            "unique_bucket_bytes": uniq_bytes,
            "setup_only_ms": setup_only_ms, "stream_ms": stream_ms,
            "pair_bytes_bound_ms": pair_bytes / HBM_BYTES_S * 1e3,
            "parts": int(pv.shape[1]),
            "group": {"ms": group_ms, "graph_ms": group_graph_ms,
                      "plain_ms": group_plain_ms,
                      "bound_ms": group_bytes / HBM_BYTES_S * 1e3}}


def _slot_sets_recall(slots, truth) -> float:
    import numpy as np

    return float(np.mean([len(set(a.tolist()) & set(t.tolist())) / len(t)
                          for a, t in zip(slots, truth)]))


def phase_dense_ivf(seed, paths, timings, errs, tmp):
    """The dense IVFIndex at benchmarks/ivf_crossover.py's clustered
    point (1,048,576 x 384, a 1024-component mixture, bf16 slab, nlist
    1024): build, tune, K5 and lax searches held against each other and
    against the plain version, recall against a float32 oracle,
    mutations, filters, the pipelined lax path, an int8 index and the
    SOAR facade."""
    import numpy as np
    import torch

    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.index.ivf import IVFIndex

    n, d, k = 1 << 20, 384, 10
    mix = _mixture(1024, d, seed + 13, noise=0.45)
    x_dev = torch.cat([mix(3000 + i, 1 << 18) for i in range(4)])
    held = mix(4444, 256)  # held-out queries of the same mixture
    held_np = held.cpu().numpy()
    torch.backends.cuda.matmul.allow_tf32 = False
    truth = torch.topk(held @ x_dev.T, k, dim=1).indices.cpu().numpy()

    index = IVFIndex(d, dtype="bfloat16", nlist=1024, nprobe=8,
                     train_threshold=1 << 62, capacity=n, device="cuda")
    index.add_batch(x_dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cap_b = int(index._bucket_rows.shape[1])
    emit({"phase": "dense_ivf", "step": "build", "n": n, "d": d,
          "nlist": 1024, "dtype": "bfloat16", "build_s": build_s,
          "cap_b": cap_b, "spilled_rows": len(index._residual),
          "table_gb": index._bucket_rows.numel() * 2 / 1e9})
    if index._bucket_rows.dtype != torch.bfloat16:
        fail(f"dense tables are {index._bucket_rows.dtype}, not bf16")

    index.batch_flat_fallback = False
    t0 = time.perf_counter()
    # tuned on 64 queries against the index's own bf16 exact scan, gated
    # on 256 against a float32 oracle: a 0.96 target gave nprobe 5 and
    # 0.9492 on the gate (H100 run), hence the margin
    tuned_rec = index.tune(held_np[:64], k=k, target_recall=DENSE_TUNE)
    tuned = index.nprobe
    emit({"phase": "dense_ivf", "step": "tune", "nprobe": tuned,
          "recall_at_10_vs_index_exact": tuned_rec,
          "tune_s": time.perf_counter() - t0})

    def search(label, kernel, queries, nprobe, mask=None):
        index.ivf_kernel, index.nprobe = kernel, nprobe
        _reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = index.search(queries, k, slot_mask=mask)
        wall = time.perf_counter() - t0
        paths[label] = _counts()
        return out, wall

    def check_k5_call(label, queries, nprobe, mask=None):
        """A K5 search held against the plain version of the whole query
        and the lax scan on the same state. Returns the output."""
        got, wall = search(label, "pallas", queries, nprobe, mask)
        if paths[label]["ivf_bucket_partial[bfloat16]"] < 1 or \
                paths[label]["topk_merge_partials"] < 1:
            fail(f"{label} did not run K5: {paths[label]}")
        if paths[label]["ivf_bucket_partial.bodies.grouped"] < 1 or \
                paths[label]["ivf_group_pairs"] < 1:
            fail(f"{label} did not run the grouped body: {paths[label]}")
        with plain_k5():
            ref = index.search(queries, k, slot_mask=mask)
        index.ivf_kernel = "lax"
        lax = index.search(queries, k, slot_mask=mask)
        index.ivf_kernel = "pallas"
        rescore = _dense_rescorer(index, queries)
        err = check_topk(label, _as_dev(ref), _as_dev(got), rescore)
        check_topk(label + "/vs_lax", _as_dev(lax), _as_dev(got), rescore)
        errs["ivf_bucket_partial[bfloat16]"] = max(
            errs.get("ivf_bucket_partial[bfloat16]", 0.0), err)
        return got, wall, err

    for nprobe in sorted({tuned, 8}):
        for b in (1, 8, 64, 128):
            label = f"dense_ivf[b{b},nprobe{nprobe}]"
            _, wall, err = check_k5_call(label, held_np[:b], nprobe)
            emit({"phase": "dense_ivf", "path": label, "wall_s": wall,
                  "max_abs_err_vs_plain": err, "tol": ATOL,
                  "launches": _nonzero(paths[label])})

    rec = {}
    for kernel in ("pallas", "lax"):
        label = f"dense_ivf[recall,{kernel}]"
        (_, got), _ = search(label, kernel, held_np, tuned)
        rec[kernel] = _slot_sets_recall(got, truth)
    emit({"phase": "dense_ivf", "recall_at_10": rec, "nprobe": tuned,
          "queries": 256, "bar": DENSE_BAR})
    for kernel, r in rec.items():
        if r < DENSE_BAR:
            fail(f"dense_ivf {kernel} recall@10 {r} < {DENSE_BAR}")

    for nprobe, b in sorted({(tuned, 1), (tuned, 64), (tuned, 128),
                             (8, 64)}):
        tm = time_k5(index, held_np[:b], nprobe)
        emit({"phase": "dense_ivf", "timing": f"k5[b{b},nprobe{nprobe}]",
              **tm})
        if (nprobe, b) == (tuned, 64):
            timings["ivf_bucket_partial[bfloat16]"] = dict(tm, nprobe=nprobe)
    f32 = index._bucket_rows.to(torch.float32)
    timings["ivf_bucket_partial[float32]"] = dict(
        time_k5(index, held_np[:64], tuned, table=f32, dtype="float32"),
        nprobe=tuned)
    del f32

    # mutations: 1% deletes, 1,000 fresh rows, 100 updates
    g = torch.Generator(device="cpu").manual_seed(seed + 17)
    dead = torch.randperm(n, generator=g)[: n // 100].numpy()
    index.remove_slots(dead)
    fresh = mix(5555, 1000)
    fresh_slots = index.add_batch(fresh)
    moved = mix(6666, 100)
    upd = np.setdiff1d(np.arange(0, n, n // 128), dead)[:100]
    index.update_slots(upd, moved)
    label = "dense_ivf[after_mutations]"
    probe_q = torch.cat([x_dev[torch.as_tensor(dead[:32], device="cuda")],
                         fresh[:16], moved[:16]]).cpu().numpy()
    (_, got), _, _ = check_k5_call(label, probe_q, tuned)
    dead_set = set(dead.tolist())
    if dead_set & set(got.ravel().tolist()):
        fail(f"{label}: a deleted row came back")
    if not (got[32:48, 0] == fresh_slots[:16]).all() or \
            not (got[48:64, 0] == upd[:16]).all():
        fail(f"{label}: a fresh or updated row does not rank first")
    emit({"phase": "dense_ivf", "path": label, "deleted": len(dead),
          "added": 1000, "updated": len(upd),
          "residual": len(index._residual),
          "quarantine": len(index._quarantine),
          "launches": _nonzero(paths[label])})

    # filters: 10% pushes down into the bucket tables (K5), 1% is exact
    live = index._valid.cpu().numpy()
    for frac, want in ((10, "k5"), (1, "exact")):
        mask = (np.arange(index.capacity) % 100) < frac
        label = f"dense_ivf[filter_{frac}pct]"
        if want == "k5":
            got, _, err = check_k5_call(label, held_np[:64], tuned, mask)
        else:
            got, _ = search(label, "pallas", held_np[:64], tuned, mask)
            if paths[label]["ivf_bucket_partial[bfloat16]"] != 0:
                fail(f"{label}: the exact route launched K5")
        xm = torch.cat([x_dev, fresh])  # the rows by slot
        xm[torch.as_tensor(upd, device="cuda")] = moved
        sel = torch.as_tensor(mask & live, device="cuda")[: xm.shape[0]]
        s = torch.as_tensor(held_np[:64], device="cuda") @ xm.T
        s = s.masked_fill(~sel[None, :], float("-inf"))
        ftruth = torch.topk(s, k, dim=1).indices.cpu().numpy()
        slots = got[1]
        if not mask[slots[slots >= 0]].all():
            fail(f"{label}: a filtered-out row was returned")
        frec = _slot_sets_recall(slots, ftruth)
        emit({"phase": "dense_ivf", "path": label, "route": want,
              "recall_at_10": frec, "bar": DENSE_BAR,
              "launches": _nonzero(paths[label])})
        if frec < DENSE_BAR:
            fail(f"{label}: recall@10 {frec} < {DENSE_BAR}")
        del xm, s

    # the lax pipelined path, NB=32 x B=64
    index.ivf_kernel, index.nprobe = "lax", tuned
    qstack = mix(7070, 32 * 64).reshape(32, 64, d)
    _reset()
    out = index.search_pipelined(qstack, k)
    paths["dense_ivf[search_pipelined]"] = _counts()
    first = index.search(qstack[0].cpu().numpy(), k)
    check_topk("dense_ivf[search_pipelined]/batch0", _as_dev(first),
               _as_dev((out[0][0], out[1][0])),
               _dense_rescorer(index, qstack[0]))
    pipe_ms = cuda_ms(lambda: index.search_pipelined(
        qstack, k, materialize=False), reps=2, warm=1)
    emit({"phase": "dense_ivf", "path": "search_pipelined", "nb": 32,
          "b": 64, "nprobe": tuned, "call_ms": pipe_ms,
          "ms_per_batch": pipe_ms / 32, "qps": 32 * 64 / pipe_ms * 1e3})
    del index, qstack
    torch.cuda.empty_cache()

    # int8: int8 code tables, the lax scan whatever ivf_kernel says
    i8 = IVFIndex(d, dtype="int8", nlist=1024, nprobe=tuned,
                  train_threshold=1 << 62, capacity=n, device="cuda")
    i8.add_batch(x_dev)
    i8.build()
    i8.batch_flat_fallback = False
    i8.ivf_kernel = "pallas"
    _reset()
    _, got = i8.search(held_np, k)
    paths["dense_ivf[int8]"] = _counts()
    if i8._bucket_rows.dtype != torch.int8 or i8._bucket_scale is None:
        fail("int8 dense tables are not int8 codes + scales")
    if paths["dense_ivf[int8]"]["ivf_bucket_partial[bfloat16]"]:
        fail("the int8 dense index launched K5")
    emit({"phase": "dense_ivf", "path": "int8", "nprobe": tuned,
          "recall_at_10": _slot_sets_recall(got, truth),
          "table_gb": i8._bucket_rows.numel() / 1e9})
    del i8
    torch.cuda.empty_cache()

    # the SOAR facade: INDEX_TYPE=ivf with IVF_ASSIGNMENTS=2
    cfg = {"INDEX_TYPE": "ivf", "IVF_ASSIGNMENTS": 2, "IVF_NLIST": 1024,
           "IVF_NPROBE": tuned, "INDEX_DTYPE": "bfloat16",
           "INDEX_CAPACITY": n, "RAW_STORE": "none",
           "VECTOR_STORE_AUTOSAVE_INTERVAL": 0}
    path = os.path.join(tmp, "soar")

    def open_db():
        db = WDBX(vector_dimension=d, enable_plugins=False, data_dir=path,
                  config=cfg)
        ix = db.store.indices[0]
        if db.store.num_shards != 1 or type(ix) is not IVFIndex or \
                ix.assignments != 2:
            fail(f"SOAR facade gave {type(ix).__name__}")
        ix.ivf_kernel = "pallas"
        ix.batch_flat_fallback = False
        return db, ix

    db, ix = open_db()
    t0 = time.perf_counter()
    db.store.bulk_load([str(i) for i in range(n)], x_dev.cpu().numpy())
    db.optimize()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not ix.is_trained:
        fail("SOAR facade did not build")
    label = "dense_ivf[soar_facade]"
    _reset()
    hits = db.vector_search_batch(held_np, limit=k)
    one = db.vector_search(held_np[0].tolist(), limit=k)
    paths[label] = _counts()
    if paths[label]["ivf_bucket_partial[bfloat16]"] < 2 or \
            paths[label]["ivf_bucket_partial.bodies.grouped"] < 2:
        fail(f"{label} did not run K5's grouped body: {paths[label]}")
    for row in hits + [one]:
        ids = [h[0] for h in row]
        if len(ids) != k or len(set(ids)) != k:
            fail(f"{label}: a hit list repeats an id or is short")
    soar_rec = _recall(hits, truth)
    emit({"phase": "dense_ivf", "path": label, "nprobe": tuned,
          "load_and_build_s": load_s,
          "cap_b": int(ix._bucket_rows.shape[1]),
          "table_gb": ix._bucket_rows.numel() * 2 / 1e9,
          "recall_at_10": soar_rec, "assignments_1_recall": rec["pallas"],
          "launches": _nonzero(paths[label])})
    if soar_rec < rec["pallas"]:
        fail(f"{label}: recall@10 {soar_rec} < assignments=1's "
             f"{rec['pallas']}")
    before = db.vector_search_batch(held_np[:16], limit=k)
    t0 = time.perf_counter()
    db.store.save()
    del db, ix
    torch.cuda.empty_cache()
    db, ix = open_db()
    after = db.vector_search_batch(held_np[:16], limit=k)
    round_s = time.perf_counter() - t0
    if not ix.is_trained or [[h[0] for h in r] for r in before] != \
            [[h[0] for h in r] for r in after]:
        fail(f"{label}: the save / load round trip changed the hits")
    emit({"phase": "dense_ivf", "path": label + "/save_load",
          "round_trip_s": round_s, "count": db.count_vectors()})
    del db, ix, x_dev
    torch.cuda.empty_cache()


def _extras(t) -> dict:
    """A stage-1 row's scan body, its time with every row masked (no
    selection), stage-2 time on its partials, the part count and, where
    the pipelined body ran, the first tensor-core body's time on the same
    inputs (``old_ms``)."""
    out = {k: t[k] for k in ("body", "score_only_ms", "merge_ms", "parts")}
    if t.get("old_ms") is not None:
        out["old_ms"] = t["old_ms"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import wdbx_tpu_torch  # noqa: F401  (fails outside a checkout, before any output)

    card = phase_device()
    phase_build()
    errs = phase_kernels(KERNEL_ROWS, args.seed)
    phase_merge(args.seed, errs)
    phase_clustered_kernels(args.seed, errs)
    phase_ivf_kernels(args.seed, errs)
    paths: dict[str, dict] = {}
    timings: dict[str, dict] = {}
    x, qs = _data(N_ROWS, args.seed)
    x_dev = torch.as_tensor(x, device="cuda")
    truth = _oracle(x_dev, qs)
    with tempfile.TemporaryDirectory(prefix="wdbx_smoke_") as tmp:
        main_err = phase_main(x, qs, truth, paths, tmp)
        errs["fused_topk_partial[bfloat16]"] = max(
            errs["fused_topk_partial[bfloat16]"], main_err)
        errs["fused_topk_partial[float32]"] = max(
            errs["fused_topk_partial[float32]"],
            phase_default_facade(x, qs, truth, paths, tmp))
        phase_pipelined(x, qs, x_dev, truth, paths, tmp, timings, errs)
        del x, x_dev
        torch.cuda.empty_cache()
        phase_clustered(args.seed, paths, timings, errs)
        phase_clustered_facade(args.seed, paths, timings, errs, tmp)
        phase_dense_ivf(args.seed, paths, timings, errs, tmp)
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
            **_extras(t),
        })
    mt = timings["fused_topk_partial[bfloat16]"]
    kernels.append({
        "name": "topk_merge_partials", "route": "cuda", "source": SOURCE,
        "replaces": "wdbx_tpu/kernels/fused_topk.py:127",
        "launches": total["topk_merge_partials"],
        "max_abs_err": errs["topk_merge_partials"], "ms": mt["merge"]["ms"],
        "plain_ms": mt["merge"]["plain_ms"],
        "bound_ms": mt["merge"]["bound_ms"], "bound_by": "bytes",
        "library_ms": mt["merge"]["library_ms"],
        "graph_ms": mt["merge"]["graph_ms"],
        "library_graph_ms": mt["merge"]["library_graph_ms"],
        "parts": mt["merge"]["parts"], "at_k": mt["merge_at_k"],
    })
    for gen, slab, qprec in (("v2", "float32", "bf16"),
                             ("v2", "bfloat16", "bf16"),
                             ("v2", "int8", "bf16"), ("v2", "int4", "bf16"),
                             ("v2", "int8", "int8"), ("v2", "int4", "int8"),
                             ("v1", "int8", "bf16")):
        name = clu_name(cs_key(gen, slab, qprec))
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CLU_SOURCE,
            "replaces": CLU_REPLACES[gen], "launches": total[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **_extras(t),
        })
    gt = timings["ivf_bucket_partial[bfloat16]"]["group"]
    kernels.append({
        "name": "ivf_group_pairs", "route": "cuda", "source": IVF_SOURCE,
        "replaces": IVF_GROUP_REPLACES, "launches": total["ivf_group_pairs"],
        "max_abs_err": errs["ivf_group_pairs"], "ms": gt["ms"],
        "plain_ms": gt["plain_ms"], "bound_ms": gt["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "graph_ms": gt["graph_ms"],
    })
    for dtype in ("bfloat16", "float32"):
        name = f"ivf_bucket_partial[{dtype}]"
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": IVF_SOURCE,
            "replaces": IVF_REPLACES, "launches": total[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{key: t[key] for key in ("body", "old_ms", "graph_ms",
                                       "old_graph_ms", "merge_ms",
                                       "call_ms", "parts")},
            "group_ms": t["group"]["ms"],
        })
    # the dense index always builds bf16 tables: only the function
    # itself (ivf_kernels, and its timing on a float32 copy) reaches the
    # float32 mode, so it has no driven launch to show
    kernels[-1]["driven"] = False
    for kern in kernels:
        if kern["launches"] < 1 and kern.get("driven", True):
            fail(f"{kern['name']} was not launched on any driven path")
    emit({"paths": {name: _nonzero(c) for name, c in paths.items()}})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
