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
             rule's (want_body: bf16 at d % 64 == 0, d <= 768, k <= 32
             and B > 64 takes the wgmma body, and every such case also
             runs the pipelined body against the plain version; bf16 /
             int8 / int4 otherwise take the pipelined body where its
             buffers fit, and every such case also runs the first
             tensor-core body, and the wgmma body by name where it fits
             B = 1 / 5 / 37); bf16 at d=768, B=300, k 1 / 10 / 32; corpora of
             duplicated rows (float32, bf16 on both the wgmma and the
             pipelined body, int8, int4) searched twice must give
             identical slots
  k1_10m     K1 bf16 at 10,000,000 x 768, B=128, k=10 (the flat cell's
             launch): the wgmma body against the plain version, then its
             time beside the pipelined body's, both score-only, the
             bound, the plain version's and the library's
  merge      stage 2 against its plain version: k in {1, 10, 50, 128,
             1024}, B in {1, 128}, m off a multiple of 32, ties, -inf
             entries and all -inf rows
  main       the facade: WDBX(INDEX_DTYPE=bfloat16) bulk-loads 1,048,576
             unit rows, answers vector_search_batch (B=128) and
             vector_search; every hit list is held against the plain
             version on the index's slab, and recall@10 against a float32
             oracle must reach 0.9938; the wgmma body must serve every
             batch's launch, the pipelined body the single query's
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
             body, bf16 the wgmma body, int8 and int4 the pipelined one);
             one batch of 128 times the kernels (also with every row
             masked: stage 1 without selection; bf16 also through the
             pipelined body, int8 and int4 through the first tensor-core
             body), the merge
             (eagerly and in a CUDA graph, beside torch.topk, at k 10, 128
             and 1024), the plain version and the library call; then an
             int8 facade search with the raw-store rerank (RAW_STORE=ram),
             whose recall@10 must reach 0.9938 too (pipelined body)
  sharded    the mesh layer on the one card, on the flat phases' rows:
             ShardedFlatIndex over make_mesh(8) (8 logical shards of
             131,072 rows) with bf16, int8 and int4 slabs: search at
             B=128 and B=1 and search_pipelined (NB=64, B=128, k=10),
             every batch held against K1 / K2's plain version on the
             slot-order view, each call's counters showing one stage-1
             launch a shard on the shape rule's body (bf16 batches of
             more than 64 queries on wgmma) and one merge, bf16 raw
             recall@10 gated at 0.9938; a make_mesh2(2, 4) replicated
             index the same way; a live remesh to 7 shards, adopt_mesh +
             an npz reload, a per-position (PERSIST_BACKEND=orbax) round
             trip, each searched again against the plain version; the
             facade with enable_distributed and INDEX_TYPE=sharded_flat
             (WDBX_TORCH_MESH_SIZE=8): vector_search_batch against the
             plain version, a real health check, heal(allow_remesh=True)
             under a report with one position down (re-stripes to 7, the
             same hits); ShardedIVFIndex (bf16, nlist 1024) at the
             dense_ivf phase's corpus through the facade: build, tune to
             0.97, recall@10 over 256 held-out queries gated at 0.95,
             every returned score rescored from the slab, the pipelined
             path, a checkpoint heal(); ms a batch beside the
             single-device FlatIndex's and the bound
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
  sharded_clustered
             benchmarks/filtered.py's sharded point (FILTERED_SHARDED=1):
             ShardedClusteredIndex over make_mesh(8), 2,000,000 x 768 int8
             rows of a 4096-component mixture (noise 0.67/sqrt(d)), nlist
             2048, nprobe 4, B=64, k=10, filled by build_from (each bucket
             striped within one row a shard); search at B=64 (one K3
             stage 1 a shard on the pipelined body, one merge) and B=1 (the
             ranges scan), search_pipelined (NB=8), int8 queries and v1:
             every per-shard K3 launch against its plain version on the
             same block list, and each answer against the plain partials
             merged; times beside the single-device ClusteredIVFIndex on
             the same rows; recall@10 against a float32 oracle gated at
             0.95 after tune(), and at 10% (pushdown) / 1% / 0.1% (exact
             masked, K2) filters after tune_filtered; a background
             rebuild while threads search and write (every acknowledged
             write answers after the swap, every delete is gone); a live
             remesh to 7; then at 524,288 rows the int4 tier, a
             make_mesh2(2, 4) replicated index, an npz reload after
             adopt_mesh, a per-position checkpoint, and the facade with
             enable_distributed and heal(allow_remesh=True) at full probe
             (the same hits on 7 positions)
  multiprocess
             two ranks of the port sharing the card (each a subprocess
             running _rank_main) join through ShardEngine.initialize
             (WDBX_TORCH_MESH_SIZE=4 each) into a global make_mesh() of 8
             positions; on it, with identical calls on both ranks:
             ShardedFlatIndex at bench.py's point (1,048,576 x 384 bf16,
             nothing cut): search at B=128, search_pipelined (NB=64),
             remove_slots of 1,024 slots and a search that must not
             return them, an orbax round trip (each rank its own
             positions' files) and an npz save; the same rows as int8
             (one B=128 search, K2); ShardedClusteredIndex at the
             sharded_clustered phase's point (2,000,000 x 768 int8, nlist
             2048, nprobe 4, B=64, batch fallback off): build_from across
             the ranks (rank 0 trains, rows move through the all-to-all),
             search, search_pipelined (NB=8), the 1% filter through the
             exact masked route (K2 a shard), an npz round trip. Each
             rank holds every K1 / K2 / K3 launch on its shards against
             the plain version, expects 4 stage-1 launches and 2 merges
             (the rank's, then the cross-rank one) a call, and times the
             calls and their split (stage 1, the rank's merge, the
             gather through gloo, the final merge) with the bytes each
             collective sent. Here, both ranks' answers must be equal,
             match the plain version over the whole slab and the
             single-process 8-position index loaded from their
             checkpoints, and reach recall@10 0.9938 (flat bf16) and 0.95
             (sharded clustered, also at the 1% filter); times beside
             the single-process sharded / sharded_clustered numbers of
             the same run. Then make_mesh2(2) on the same ranks (a full
             copy of 4 shards a rank, each rank serving half of every
             batch and the ranks gathering the answered rows): the flat
             point in bf16 (B=128, B=1 where rank 0 launches nothing,
             pipelined NB=64, the removals, 32 updates and 32 adds that
             both copies take and both groups find, npz and per-position
             round trips) and int8 (B=128), and ShardedClusteredIndex at
             the same point (build, search, pipelined, the 1% filter, and
             the unreplicated ranks' checkpoint loaded on it); answers
             equal to the unreplicated ones, recall@10 0.9938 / 0.95.
             Last, the production_serving deployment: WDBX(
             enable_distributed=True, INDEX_TYPE=sharded_ivf) at the
             dense_ivf phase's point (1,048,576 x 384 bf16, nlist 1024),
             built across the ranks (rank 0 trains, the rows fill their
             buckets' tables through the all-to-all), tuned to 0.97, two
             B=128 searches and a pipelined NB=2 stack (the quota scan,
             no kernel), 10% (pushdown) and 1% (exact masked, K1 a
             shard) filters, the batch fallback (K1 a shard), 1,024
             removals and a search, per-position and npz round trips;
             here one process's 8-position index loaded from the ranks'
             npz replays the calls and must answer alike, every score is
             rescored from the slab, and recall@10 is gated at 0.95
             unfiltered and at both filters. Then recovery across the
             ranks, with a fault injected into rank 1's probe of
             position 7 that the real health check gathers to both
             ranks: the flat point remeshed live to the degraded 7
             positions (4 + 3; rows cross through the all-to-all), B=128,
             B=1 and pipelined searches against the plain version over
             one process's 7-position index of the ranks' npz, the
             slots as before the remesh and recall@10 0.9938, the remesh
             back to 8, adopt_mesh + the npz reload; the
             production_serving deployment's heal(allow_remesh=True)
             (live remesh and rebuild on 7 shards, re-tuned to 0.97,
             recall@10 0.95 unfiltered and at 10% / 1%, replayed by one
             process's 7-position index), the walkthrough's
             checkpoint heal (store.save, clear, heal: the same hits),
             then every position of rank 1 failing its probe: heal onto
             rank 0's 4 positions (rank 1 holds none and keeps
             answering) and, the probe passing again, back onto the 8,
             each re-tuned, replayed by one process's index of the same
             shard count and gated at recall@10 0.95 unfiltered and at
             10% / 1%;
             the sharded clustered index's build_background in a thread
             of each rank while its main thread searches (K3), adds,
             updates, removes and filters (K2), the swap at the same
             foreground call on both ranks, every write found and every
             removal gone after it, recall@10 0.95 (also at the 1%
             filter) against the float32 oracle over the written corpus,
             then a remesh to 7 with the clustered rebuild (paths
             multiprocess_replicated, multiprocess_replicated_clustered,
             multiprocess_ivf, multiprocess_remesh, multiprocess_heal,
             multiprocess_background). A second spawn puts 4 ranks of 2
             positions on the card, the same 8 positions in all:
             make_mesh2(2) lays group 0 on ranks 0-1 and group 1 on
             ranks 2-3, so each group spans two ranks. The flat point in
             bf16 (B=128, B=1 where ranks 0-1 launch nothing, pipelined
             NB=64), each search one gloo all-gather (collective.stats
             must show it), its split (stage 1, the rank's merge, the
             one all-gather and gloo alone, the merge of the group's
             ranks), the same rows through WDBX(enable_distributed=True,
             MESH_REPLICAS=2), and ShardedClusteredIndex at the sharded
             clustered point (build, search, pipelined, the 1% filter);
             here all four ranks' answers must be equal, match the plain
             version over the whole slab and one process's index on
             make_mesh2(2, 4) loaded from their npz, and reach recall@10
             0.9938 (flat) and 0.95 (clustered, also filtered). Then
             meshes that leave ranks without a position, at the flat
             point: the index remeshed live onto make_mesh(3) (rank 3
             holds none) and make_mesh2(2, 2) (ranks 2-3 hold none), and
             the facade's deployment with every position of rank 3
             failing its probe, healed onto ranks 0-2 and back; a B=128
             search at each step against the plain version (paths
             multiprocess_spanning, multiprocess_emptied)
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
  server     benchmarks/RESULTS.md:730-743's point over HTTP: WDBX with
             INDEX_DTYPE=bfloat16 and its other arguments at their
             defaults (the card, plugins, batching at 128 / 3 ms)
             bulk-loads the flat phases' 1,048,576 x 384 rows;
             WDBXAPIServer in a thread on 127.0.0.1 answers 320
             concurrent searches (k=10) from 16 client threads, a batch
             search of 32, posted vectors and the searches that find
             them, an embedding from the demo local embedder stored and
             found, /stats, /metrics (coalescing), /plugins and
             /visualize?format=json (the PCA on the card), then /save;
             every answer against the facade's direct vector_search
             (scores within 1e-5, ids equal off ties), recall@10 gated at
             0.9938, K1 bf16 (either body) and the merge must serve
             it; requests/s, latency percentiles, flushes and the device
             ms against the wall ms of a flush (CUDA events)
  cli        python -m wdbx_tpu_torch.cli (by runpy) in a subprocess on
             the card, --data-dir at the saved server store: stats,
             plugins and search --vector through its interactive mode,
             the hits against the server's answer; save and load seconds
  batcher_clustered
             benchmarks/store_serving.py's point: 256 client coroutines
             through QueryBatcher(max_batch=128) for 10 s into a 262,144
             x 384 ivf_clustered int8 store (nlist 256, nprobe 1, a
             1024-component mixture, no raw copies); every flush's
             answers against the store's direct search_batch of the same
             queries, K3 must serve it; QPS, latency percentiles, flushes
             by route (kernel / ranges)
Then a "paths" line (launches of each driven path, by kernel and by
stage-1 scan body), a "kernels" line (launches on the driven paths,
times, bounds; each stage-1 row also its body, score-only, merge time
and parts, and where the pipelined body ran the first tensor-core
body's time as old_ms; the merge row its CUDA-graph times and its times
at k 10, 128 and 1024; the K5 rows their body, the per-pair body's time
as old_ms, merge, grouping and call times; the grouping kernel its own
row) and, last, {"ok": true, "device": {...}}.

Launch counts: every path (main, the default facade, each pipelined
slab, the int8 facade, the sharded flat, replicated, facade and IVF
paths, each clustered path, the sharded clustered paths, both ranks'
multiprocess paths (their counts come back in the ranks' reports), the
server, the cli's process, the batcher)
runs with the kernels' counters set to 0 just
before it and read just after; comparison and timing launches are never
counted.
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
PATH_BODY = {"float32": "fma_tiled", "bfloat16": "wgmma",
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
# an HTTP or batched answer against the facade's / store's direct call:
# the two may take other stage-1 bodies, whose float sums run in other
# orders
MATCH_TOL = 1e-5
BATCHER_SECONDS = 10.0  # benchmarks/store_serving.py's DURATION
BATCHER_ROWS = 262_144  # benchmarks/store_serving.py's STORE_N


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


def _wgmma_fits(dtype, qtype, d, k):
    """The wgmma body takes the launch's types, width and k: bf16 slab and
    queries, d % 64 == 0, 64 queries of width d resident (d <= 768),
    k <= 32 (its alignment rule is the caller's)."""
    from wdbx_tpu_torch.kernels import fused_topk as tf

    return dtype == qtype == "bfloat16" and d % 64 == 0 \
        and 64 * d * 2 <= tf.PIPE_QUERY_BYTES and k <= 32


def want_body(dtype, qtype, d, b, k, aligned=True, k1=True):
    """The stage-1 body the shape rule gives a launch: for K1 / K2
    (``k1``; the block scan has no such body) ``wgmma`` for batches of
    more than 64 queries that ``_wgmma_fits``; ``mma_pipe`` for
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
    if k1 and b > 64 and _wgmma_fits(dtype, qtype, d, k):
        return "wgmma"
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
              (10_000, 768, 300, (1, 10, 32), ("bfloat16",)),
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
                # the same inputs through the body it replaces (the
                # pipelined body for wgmma, the first tensor-core body for
                # it) and, for a bf16 batch of at most 64 that the wgmma
                # body fits, through that body by name
                others = {"wgmma": ["mma_pipe"], "mma_pipe": ["mma"]}.get(
                    body, [])
                if body == "mma_pipe" and not unaligned and \
                        _wgmma_fits(dtype, "bfloat16", d, k):
                    others.append("wgmma")
                for other in others:
                    pv2, pi2 = tf.fused_topk_partial(
                        sl, qk, vmask, k, scales=scales, int4=int4,
                        body=other)
                    err = max(err, check_topk(
                        f"{name}/{other}", ref,
                        tf.topk_merge_partials(pv2, pi2, k), rescore))
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
    rows apart, so in other chunks): float32 (the tiled body), bf16 (the
    wgmma body, and the pipelined body by name), int8 and int4 (the
    pipelined body). Two runs give the same scores and slots
    bit for bit, and k=11 cuts through a group of copies, so the plain
    version may pick other copies: equal except at ties."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    base = torch.randn((8192, 384), generator=g, device="cuda")
    x = (base / base.norm(dim=1, keepdim=True)).repeat(8, 1)
    q = torch.randn((128, 384), generator=g, device="cuda")
    valid = torch.ones(x.shape[0], dtype=torch.bool, device="cuda")
    for dtype, want, named in (("float32", "fma_tiled", None),
                               ("bfloat16", "wgmma", None),
                               ("bfloat16", "mma_pipe", "mma_pipe"),
                               ("int8", "mma_pipe", None),
                               ("int4", "mma_pipe", None)):
        slab, scales, int4 = _slab(dtype, x)
        qk = tf._prep_queries(slab, q, scales, True)
        runs = []
        for _ in range(2):
            body, (pv, pi) = _body_of(lambda: tf.fused_topk_partial(
                slab, qk, valid, 11, scales=scales, int4=int4, body=named))
            runs.append((pv, pi) + tf.topk_merge_partials(pv, pi, 11))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        name = f"{dtype}/duplicates/k11" + (f"/{named}" if named else "")
        err = check_topk(name, tf.fused_topk_plain(slab, qk, valid, 11,
                                                   scales=scales, int4=int4),
                         runs[0][2:], rescorer(slab, qk, scales, int4))
        emit({"phase": "kernels", "case": name, "body": body, "copies": 8,
              "identical_runs": same, "max_abs_err": err, "tol": ATOL})
        if body != want or not same:
            fail(f"{name}: body {body}, identical runs {same}")
        key = f"fused_topk_partial[{dtype}]"
        errs[key] = max(errs[key], err)


K1_10M = (10_000_000, 768, 128, 10)  # the flat cell's launch: n, d, B, k


def phase_k1_10m(seed, errs) -> dict:
    """K1 bf16 at the flat cell's launch (10M x 768, B=128, k=10, ~10%
    invalid rows): the shape rule's body (wgmma) against the plain
    version, then the times of that body and of the pipelined body by
    name, each also with every row masked (score-only), beside the bytes
    bound, the plain version and the library (matmul, then torch.topk)."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    n, d, b, k = K1_10M
    g = torch.Generator(device="cuda").manual_seed(seed + 24)
    slab = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
    for i in range(0, n, 1 << 20):
        y = torch.randn((min(1 << 20, n - i), d), generator=g, device="cuda")
        slab[i:i + y.shape[0]] = (y / y.norm(dim=1, keepdim=True)).to(
            torch.bfloat16)
        del y
    valid = torch.rand((n,), generator=g, device="cuda") > 0.1
    q = tf._prep_queries(slab, torch.randn((b, d), generator=g,
                                           device="cuda"), None, True)
    body, (pv, pi) = _body_of(lambda: tf.fused_topk_partial(slab, q, valid,
                                                            k))
    if body != want_body("bfloat16", "bfloat16", d, b, k):
        fail(f"k1_10m: ran the {body} body")
    name = f"bfloat16/n{n}_d{d}_b{b}/k{k}"
    got = tf.topk_merge_partials(pv, pi, k)
    plain_ms = cuda_ms(lambda: tf.fused_topk_plain(slab, q, valid, k),
                       reps=1, warm=0)
    ref = tf.fused_topk_plain(slab, q, valid, k)
    err = check_topk(name, ref, got, rescorer(slab, q))
    errs["fused_topk_partial[bfloat16]"] = max(
        errs["fused_topk_partial[bfloat16]"], err)
    del ref, got
    torch.cuda.empty_cache()
    none_valid = torch.zeros_like(valid)
    row = {"phase": "k1_10m", "n": n, "d": d, "b": b, "k": k, "body": body,
           "parts": pv.shape[1], "max_abs_err": err, "tol": ATOL}
    for label, named in (("", None), ("pipe_", "mma_pipe")):
        row[label + "ms"] = cuda_ms(lambda: tf.fused_topk_partial(
            slab, q, valid, k, body=named))
        row[label + "score_only_ms"] = cuda_ms(lambda: tf.fused_topk_partial(
            slab, q, none_valid, k, body=named))
    row["bound_ms"], row["bound_by"] = _bound_ms("bfloat16", n, d, b, k)
    row["plain_ms"] = plain_ms
    row["library_ms"] = cuda_ms(lambda: torch.topk(
        torch.matmul(q, slab.T), k, dim=1), reps=3, warm=1)
    emit(row)
    del slab, valid, none_valid, q, pv, pi
    torch.cuda.empty_cache()
    return row


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
    batches = _counts()
    one = db.vector_search(qs[3, 0].tolist(), limit=10)
    wall = time.perf_counter() - t0
    paths["main"] = _counts()
    # every batch's launch on the wgmma body, the single query's on the
    # pipelined one (a batch of one)
    launches = batches["fused_topk_partial[bfloat16]"]
    if launches < 3 or \
            batches["fused_topk_partial.bodies.wgmma"] != launches or \
            paths["main"]["fused_topk_partial.bodies.mma_pipe"] != 1:
        fail(f"main path's batches did not all run the wgmma body, or its "
             f"single query the pipelined one: {paths['main']}")
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
        # the body this one replaced, same inputs: the pipelined body for
        # wgmma, the first tensor-core body for the pipelined one
        old = {"wgmma": "mma_pipe", "mma_pipe": "mma"}.get(body)
        if old is not None:
            old_ms = cuda_ms(lambda: tf.fused_topk_partial(
                slab, qk, valid, k, scales=scales, int4=int4, body=old))
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
            "call_ms": call_ms,
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


# -- the mesh layer (ShardedFlatIndex, ShardEngine, ShardedIVFIndex) ------
SHARDS = 8  # logical mesh positions on the one card
SHARDED_SOURCE_ROWS = "wdbx_tpu_torch/parallel/sharded_flat.py"


def _slot_view(index):
    """A sharded index's slab, validity and scales in slot order (slot
    ``s`` at row ``s``: the layout of its npz checkpoint), assembled on
    the card from the first replica group's shards."""
    import torch

    n_dev = index.n_devices

    def inter(parts):
        out = torch.empty((index.capacity,) + tuple(parts[0].shape[1:]),
                          dtype=parts[0].dtype, device="cuda")
        for s in range(n_dev):
            out[s::n_dev] = parts[s]
        return out

    scales = inter(index._row_scales) if index._is_quantized else None
    return inter(index._slabs), inter(index._valids), scales


def _plain_sharded(index, view, queries, k):
    """K1 / K2's plain version on the slot-order view for ``queries``
    (B, d) as the index prepares them: the sorted (B, k) result (row =
    slot) on the host, and the rescorer of those inputs."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    slab, valid, scales = view
    q = torch.as_tensor(queries, dtype=torch.float32, device="cuda")
    qk = tf._prep_queries(slab, q, scales, index.metric == "cosine")
    v, i = tf.fused_topk_plain(slab, qk, valid, k, scales=scales,
                               int4=index._is_int4)
    return (v.cpu(), i.cpu()), rescorer(slab, qk, scales, index._is_int4)


def _tally(paths, label, counts):
    paths[label] = _add_counts(paths.get(label, {}), counts)


def _sharded_call(label, index, dtype, b, run, paths):
    """``run()`` with the counters at 0 just before and read just after:
    every replica group that got queries of a batch of ``b`` must launch
    one stage 1 a shard, all on the shape rule's body, and one merge."""
    _reset()
    out = run()
    counts = _counts()
    _tally(paths, label, counts)
    r, n_dev = index.replicas, index.n_devices
    groups = sum(1 for g in range(r) if b * (g + 1) // r > b * g // r)
    per = -(-b // r)
    want = want_body(dtype, "bfloat16", index.dim, per, 10)
    if want not in (PATH_BODY[dtype], "mma_pipe"):
        fail(f"{label}: the shape rule gives {want}, not {PATH_BODY[dtype]}"
             f" or mma_pipe, at B={per}")
    if counts[f"fused_topk_partial[{dtype}]"] != n_dev * groups or \
            counts[f"fused_topk_partial.bodies.{want}"] != n_dev * groups \
            or counts["topk_merge_partials"] != groups:
        fail(f"{label}: expected {n_dev * groups} stage-1 launches on "
             f"{want} and {groups} merges: {_nonzero(counts)}")
    return out


def _check_sharded(name, index, view, queries, got, k=10) -> float:
    import torch

    ref, rescore = _plain_sharded(index, view, queries, k)
    return check_topk(name, ref, (torch.as_tensor(got[0]),
                                  torch.as_tensor(got[1])), rescore)


def _drive_sharded(label, index, dtype, qs, qstack, paths, errs,
                   pipelined=True):
    """search at B=128 and B=1, then search_pipelined over the stack,
    every batch held against the plain version on the slot-order view.
    Returns the pipelined slots (NB, B, k) or None."""
    name = f"fused_topk_partial[{dtype}]"
    view = _slot_view(index)
    err = 0.0
    for q in (qs[0], qs[1][:1]):
        got = _sharded_call(label, index, dtype, len(q),
                            lambda q=q: index.search(q, 10), paths)
        err = max(err, _check_sharded(f"{label}/{dtype}/search b{len(q)}",
                                      index, view, q, got))
    slots = None
    if pipelined:
        nb, b = qs.shape[0], qs.shape[1]
        # one launch a shard over the stack's queries of its group
        scores, slots = _sharded_call(
            label, index, dtype, nb * b,
            lambda: index.search_pipelined(qstack, k=10), paths)
        if scores.shape != (nb, b, 10):
            fail(f"{label}: pipelined shape {scores.shape}")
        for i in range(nb):
            err = max(err, _check_sharded(
                f"{label}/{dtype}/pipelined batch{i}", index, view, qs[i],
                (scores[i], slots[i])))
    errs[name] = max(errs.get(name, 0.0), err)
    return slots


def _sharded_breakdown(index, qstack, k) -> dict:
    """Where a pipelined call's time goes (bf16, all NB*B queries at
    once): the 8 stage-1 launches with and without selection (every row
    masked), the merge of their partials, and the same for one launch
    over the slot-order view of the same rows. Comparison launches:
    never counted."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    slabs, valids = index._slabs, index._valids
    qk = tf._prep_queries(slabs[0], qstack.reshape(-1, qstack.shape[-1]),
                          None, True)
    none = [torch.zeros_like(v) for v in valids]

    def stage1(vs):
        return [tf.fused_topk_partial(slabs[p], qk, vs[p], k)
                for p in range(index.n_devices)]

    out = {"stage1_ms": cuda_ms(lambda: stage1(valids), reps=3, warm=1),
           "score_only_ms": cuda_ms(lambda: stage1(none), reps=3, warm=1)}
    parts = stage1(valids)
    pv = torch.cat([p[0] for p in parts], 1)
    pi = torch.cat([p[1] for p in parts], 1)
    out["merge_ms"] = cuda_ms(lambda: tf.topk_merge_partials(pv, pi, k),
                              reps=3, warm=1)
    out["parts"] = int(pv.shape[1])
    del parts, pv, pi
    slab, valid, _ = _slot_view(index)
    nothing = torch.zeros_like(valid)
    out["single_stage1_ms"] = cuda_ms(
        lambda: tf.fused_topk_partial(slab, qk, valid, k), reps=3, warm=1)
    out["single_score_only_ms"] = cuda_ms(
        lambda: tf.fused_topk_partial(slab, qk, nothing, k), reps=3, warm=1)
    pv, pi = tf.fused_topk_partial(slab, qk, valid, k)
    out["single_merge_ms"] = cuda_ms(
        lambda: tf.topk_merge_partials(pv, pi, k), reps=3, warm=1)
    out["single_parts"] = int(pv.shape[1])
    out["call_queries"] = int(qk.shape[0])
    return out


def phase_sharded(x, qs, x_dev, truth, paths, timings, errs, tmp, seed):
    """The mesh layer on one card: ShardedFlatIndex over 8 logical
    positions (bf16, int8, int4) and 2 x 4 replicas, a remesh to 7, an
    npz reload after adopt_mesh, a per-position checkpoint, the facade
    with enable_distributed and heal(), and ShardedIVFIndex at the dense
    IVF phase's point."""
    import asyncio
    from unittest import mock

    import numpy as np
    import torch

    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.ops.normalize import l2_normalize
    from wdbx_tpu_torch.parallel import (
        ShardedFlatIndex,
        ShardedIVFIndex,
        make_mesh,
        make_mesh2,
    )
    from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

    t_phase = time.perf_counter()
    n_rows, d = x.shape
    nb, b, k = qs.shape[0], qs.shape[1], 10
    qstack = torch.as_tensor(qs, device="cuda")
    rec_of = {}
    bf16_index = None
    for dtype in ("bfloat16", "int8", "int4"):
        index = ShardedFlatIndex(d, dtype=dtype, capacity=n_rows,
                                 mesh=make_mesh(SHARDS))
        if index.rows_per_device != n_rows // SHARDS:
            fail(f"sharded {dtype}: {index.rows_per_device} rows a shard")
        index.add_batch(x_dev)
        slots = _drive_sharded("sharded_flat", index, dtype, qs, qstack,
                               paths, errs)
        flat = slots.reshape(nb * b, k)
        rec_of[dtype] = float(sum(len(set(a.tolist()) & set(t.tolist()))
                                  for a, t in zip(flat, truth)) / truth.size)
        call_ms = cuda_ms(lambda: index.search_pipelined(
            qstack, k=k, materialize=False), reps=3, warm=1)
        search_ms = cuda_ms(lambda: index.search(qs[0], k), reps=5, warm=1)
        single = timings[f"fused_topk_partial[{dtype}]"]
        bound, by = _bound_ms(dtype, n_rows, d, b, k)
        emit({"phase": "sharded", "path": "sharded_flat", "dtype": dtype,
              "n": n_rows, "shards": SHARDS,
              "rows_per_shard": index.rows_per_device, "nb": nb, "b": b,
              "k": k, "ms_per_batch": call_ms / nb,
              "single_device_ms_per_batch": single["call_ms"] / nb,
              "search_b128_ms": search_ms, "bound_ms": bound,
              "bound_by": by, "recall_at_10_raw": rec_of[dtype],
              "max_abs_err_vs_plain": errs[f"fused_topk_partial[{dtype}]"],
              "tol": ATOL})
        timings.setdefault("sharded", {})[dtype] = {
            "ms_per_batch": call_ms / nb, "search_b128_ms": search_ms}
        if dtype == "bfloat16":
            bf16_index = index
            emit({"phase": "sharded", "path": "breakdown",
                  **_sharded_breakdown(index, qstack, k)})
        else:
            del index
    if rec_of["bfloat16"] < RECALL_BAR:
        fail(f"sharded bf16 raw recall@10 {rec_of['bfloat16']} < "
             f"{RECALL_BAR}")

    # replicas: 2 groups x 4 shards, every write on both copies
    rep = ShardedFlatIndex(d, dtype="bfloat16", capacity=n_rows,
                           mesh=make_mesh2(2, 4))
    rep.add_batch(x_dev)
    for p in range(4, 8):
        if not torch.equal(rep._slabs[p], rep._slabs[p - 4]):
            fail(f"replica position {p} differs from its shard")
    slots = _drive_sharded("sharded_replicated", rep, "bfloat16", qs,
                           qstack, paths, errs)
    rep_rec = float(sum(len(set(a.tolist()) & set(t.tolist())) for a, t in
                        zip(slots.reshape(nb * b, k), truth)) / truth.size)
    rep_ms = cuda_ms(lambda: rep.search_pipelined(
        qstack, k=k, materialize=False), reps=3, warm=1) / nb
    emit({"phase": "sharded", "path": "sharded_replicated",
          "mesh": rep.mesh.shape, "ms_per_batch": rep_ms,
          "recall_at_10_raw": rep_rec})
    del rep

    # topology: a live remesh to 7, a cold re-host from npz, and the
    # per-position checkpoint
    index = bf16_index
    t0 = time.perf_counter()
    index.remesh(make_mesh(7))
    remesh_s = time.perf_counter() - t0
    if index.n_devices != 7 or index.count() != n_rows:
        fail(f"remesh: {index.n_devices} shards, {index.count()} rows")
    _drive_sharded("sharded_flat", index, "bfloat16", qs[:4], qstack[:4],
                   paths, errs)
    path = os.path.join(tmp, "sharded_npz")
    t0 = time.perf_counter()
    index.save(path)
    save_s = time.perf_counter() - t0
    index.adopt_mesh(make_mesh(SHARDS))
    if index.count() != 0 or index.n_devices != SHARDS:
        fail("adopt_mesh left rows behind")
    t0 = time.perf_counter()
    if not index.load(path) or index.count() != n_rows:
        fail("npz reload after adopt_mesh")
    load_s = time.perf_counter() - t0
    before = _drive_sharded("sharded_flat", index, "bfloat16", qs[:4],
                            qstack[:4], paths, errs)
    index.persist_backend = "orbax"
    t0 = time.perf_counter()
    index.save(os.path.join(tmp, "sharded_pos"))
    pos_save_s = time.perf_counter() - t0
    again = ShardedFlatIndex(d, dtype="bfloat16", mesh=make_mesh(SHARDS))
    t0 = time.perf_counter()
    if not again.load(os.path.join(tmp, "sharded_pos")):
        fail("per-position checkpoint did not load")
    pos_load_s = time.perf_counter() - t0
    after = _drive_sharded("sharded_flat", again, "bfloat16", qs[:4],
                           qstack[:4], paths, errs)
    if not np.array_equal(np.sort(before, -1), np.sort(after, -1)):
        fail("per-position round trip changed the answers")
    emit({"phase": "sharded", "path": "topology", "remesh_to": 7,
          "remesh_s": remesh_s, "npz_save_s": save_s, "npz_load_s": load_s,
          "positions_save_s": pos_save_s, "positions_load_s": pos_load_s})
    del index, again, bf16_index
    torch.cuda.empty_cache()

    # the facade: enable_distributed, a real health check, heal()
    old_env = os.environ.get(MESH_SIZE_ENV)
    os.environ[MESH_SIZE_ENV] = str(SHARDS)
    try:
        db = WDBX(vector_dimension=d, enable_plugins=False,
                  enable_distributed=True,
                  data_dir=os.path.join(tmp, "sharded_facade"),
                  config={"INDEX_TYPE": "sharded_flat",
                          "INDEX_DTYPE": "bfloat16",
                          "INDEX_CAPACITY": n_rows, "RAW_STORE": "none",
                          "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
        asyncio.run(db.initialize())
        db.store.bulk_load([str(i) for i in range(n_rows)], x)
        index = db.store.indices[0]
        reg = db.store.registries[0]

        def facade_search(tag):
            hits = _sharded_call("sharded_facade", index, "bfloat16", b,
                                 lambda: db.vector_search_batch(qs[0],
                                                                limit=k),
                                 paths)
            got_v = torch.tensor([[s for _, s, _ in row] for row in hits])
            got_i = torch.tensor([[reg.lookup(h[0]) for h in row]
                                  for row in hits])
            errs["fused_topk_partial[bfloat16]"] = max(
                errs["fused_topk_partial[bfloat16]"],
                _check_sharded(f"sharded_facade/{tag}", index,
                               _slot_view(index), qs[0], (got_v, got_i)))
            return hits

        hits = facade_search("before heal")
        health = db.shard_engine.health_check()
        names = list(db.shard_engine.mesh.names)
        if not health["healthy"] or sorted(health["devices"]) != \
                sorted(names) or len(names) != SHARDS:
            fail(f"health_check: {health}")
        down = {"healthy": False, "devices": {
            n: ("error: down" if n == names[3] else "ok") for n in names}}
        t0 = time.perf_counter()
        with mock.patch.object(db.shard_engine, "health_check",
                               return_value=down):
            report = db.heal(allow_remesh=True)
        heal_s = time.perf_counter() - t0
        if report["remeshed_to"] != names[:3] + names[4:] or \
                index.n_devices != SHARDS - 1:
            fail(f"heal did not re-stripe onto 7: {report['remeshed_to']}")
        healed = facade_search("after heal")
        for row, (h0, h1) in enumerate(zip(hits, healed)):
            if [h[0] for h in h0] != [h[0] for h in h1] or max(
                    abs(a[1] - c[1]) for a, c in zip(h0, h1)) > MATCH_TOL:
                fail(f"heal changed the hits of row {row}")
        emit({"phase": "sharded", "path": "sharded_facade",
              "positions": names, "health": health["healthy"],
              "heal_s": heal_s, "remeshed_to": len(report["remeshed_to"]),
              "engine": db.get_stats()["shard_engine"]["devices"][:2]})
        asyncio.run(db.shutdown())
        del db, index
    finally:
        if old_env is None:
            os.environ.pop(MESH_SIZE_ENV, None)
        else:
            os.environ[MESH_SIZE_ENV] = old_env
    torch.cuda.empty_cache()

    # ShardedIVFIndex at the dense IVF phase's point, through the facade
    # (production_serving.py's flow: build, search, pipelined, heal)
    mix = _mixture(1024, d, seed + 13, noise=0.45)
    xi = torch.cat([mix(3000 + i, 1 << 18) for i in range(4)])
    held = mix(4444, 256)
    torch.backends.cuda.matmul.allow_tf32 = False
    ivf_truth = torch.topk(held @ xi.T, k, dim=1).indices.cpu().numpy()
    os.environ[MESH_SIZE_ENV] = str(SHARDS)
    try:
        db = WDBX(vector_dimension=d, enable_plugins=False,
                  enable_distributed=True,
                  data_dir=os.path.join(tmp, "sharded_ivf"),
                  config={"INDEX_TYPE": "sharded_ivf",
                          "INDEX_DTYPE": "bfloat16", "IVF_NLIST": 1024,
                          "IVF_TRAIN_THRESHOLD": 1 << 62,
                          "INDEX_CAPACITY": 1 << 20, "RAW_STORE": "none",
                          "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
        asyncio.run(db.initialize())
        db.store.bulk_load([str(i) for i in range(len(xi))],
                           xi.cpu().numpy())
        index = db.store.indices[0]
        if not isinstance(index, ShardedIVFIndex):
            fail(f"sharded_ivf gave {type(index).__name__}")
        t0 = time.perf_counter()
        index.build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        index.batch_flat_fallback = False
        held_np = held.cpu().numpy()
        tuned_rec = index.tune(held_np[:64], k=k, target_recall=DENSE_TUNE)
        _reset()
        t0 = time.perf_counter()
        got = [index.search(held_np[i:i + 128], k) for i in (0, 128)]
        torch.cuda.synchronize()
        search_s = (time.perf_counter() - t0) / 2
        _tally(paths, "sharded_ivf", _counts())
        scores = np.concatenate([g[0] for g in got])
        slots = np.concatenate([g[1] for g in got])
        rec = _slot_sets_recall(slots, ivf_truth)
        # every returned score is q . row of the slab (bf16 queries
        # against the bf16 rows the tables copy)
        qn = l2_normalize(held).to(torch.bfloat16)
        rows = torch.as_tensor(index.get_vectors(slots.reshape(-1)),
                               device="cuda").reshape(256, k, d)
        true = (qn.float()[:, None, :] * rows).sum(-1).cpu().numpy()
        off = float(np.abs(true - scores).max())
        if (slots < 0).any() or off > ATOL:
            fail(f"sharded_ivf: a returned score is {off} off q . row")
        pipe = index.search_pipelined(held_np.reshape(2, 128, d), k)
        if not np.array_equal(np.sort(pipe[1].reshape(256, k), 1),
                              np.sort(slots, 1)):
            fail("sharded_ivf: pipelined slots differ from search")
        index.batch_flat_fallback = True  # production_serving's default
        db.store.save()
        index.clear()  # simulated loss
        t0 = time.perf_counter()
        report = db.heal()
        heal_s = time.perf_counter() - t0
        index.batch_flat_fallback = False
        _reset()
        after = index.search(held_np[:128], k)
        _tally(paths, "sharded_ivf", _counts())
        if report["recovered_shards"] != [0] or not index.is_trained or \
                not np.array_equal(np.sort(after[1], 1),
                                   np.sort(slots[:128], 1)):
            fail(f"sharded_ivf heal: {report['recovered_shards']}")
        _reset()
        index.batch_flat_fallback = True  # B=128 x nprobe covers the corpus
        flat_route = index.search(held_np[:128], k)
        _tally(paths, "sharded_ivf", _counts())
        emit({"phase": "sharded", "path": "sharded_ivf", "n": len(xi),
              "shards": index.n_devices, "nlist": 1024,
              "cap_b": int(index._bucket_slot[0].shape[1]),
              "build_s": build_s, "nprobe": index.nprobe,
              "tuned_recall_vs_index_exact": tuned_rec,
              "search_b128_s": search_s, "recall_at_10": rec,
              "bar": DENSE_BAR, "rescore_max_off": off,
              "heal_s": heal_s,
              "flat_fallback_recall": _slot_sets_recall(
                  flat_route[1], ivf_truth[:128])})
        if rec < DENSE_BAR:
            fail(f"sharded_ivf recall@10 {rec} < {DENSE_BAR}")
        asyncio.run(db.shutdown())
        del db, index
    finally:
        os.environ.pop(MESH_SIZE_ENV, None)
    del xi, held
    torch.cuda.empty_cache()
    emit({"phase": "sharded", "seconds": time.perf_counter() - t_phase})


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
    scores, pos = out.scores, out.ids
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


def _dedup_extents(nlist, nblocks, c, rng):
    """Bucket block extents of a cluster-ordered slab of ``nblocks * c``
    rows: ``(lo, hi, m)`` as ``ClusteredIVFIndex._install_layout``
    derives them, from uneven bucket sizes that fill 90% of it."""
    import numpy as np

    sizes = rng.gamma(2.0, 1.0, nlist)
    counts = np.floor(sizes / sizes.sum() * nblocks * c * 0.9).astype(np.int64)
    start = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    lo = start[:-1] // c
    hi = -(-start[1:] // c)
    width, m = int((hi - lo).max()), 1
    while m < width:
        m *= 2
    return lo, hi, m


def phase_block_dedup(seed):
    """The block-list dedup kernel (``kernels/block_dedup.py``) against
    its plain version, entry for entry: uniform and skewed probes, with
    and without dead blocks, u below and above the distinct count, at a
    small geometry, the 10M cell's (9,766 blocks of 1,024 rows, nlist
    4,096, B = 128 and 1, nprobe 8) and the kernel's largest nblocks;
    then both timed at the cell's geometry."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.index.clustered import _dedup_blocks_plain
    from wdbx_tpu_torch.kernels.block_dedup import MAX_BLOCKS, block_dedup

    rng = np.random.default_rng(seed)
    geoms = [(24, 64, 16, 32, 4, (8, 64)),
             (4096, 9766, 1024, 128, 8, (2048, 4096, 8192)),
             (4096, 9766, 1024, 1, 8, (8, 64)),
             (8192, MAX_BLOCKS, 64, 256, 16, (4096, 16384))]
    timing = None
    for nlist, nblocks, c, b, p, us in geoms:
        lo, hi, m = _dedup_extents(nlist, nblocks, c, rng)
        lo_d = torch.as_tensor(lo, device="cuda")
        hi_d = torch.as_tensor(hi, device="cuda")
        for skewed in (False, True):
            probe = np.stack([rng.permutation(nlist)[:p] for _ in range(b)])
            if skewed:  # most queries hammer the same few buckets
                probe[: max(1, b - 4)] = probe[0]
            probe_d = torch.as_tensor(probe, dtype=torch.int64, device="cuda")
            for kill in (False, True):
                valid = None
                if kill:
                    v = rng.random(nblocks * c) < 0.9
                    for blk in rng.choice(nblocks, max(1, nblocks // 20),
                                          replace=False):
                        v[blk * c:(blk + 1) * c] = False
                    valid = torch.as_tensor(v, device="cuda")
                for u in us:
                    want = _dedup_blocks_plain(probe_d, lo_d, hi_d, nblocks,
                                               u, m, valid, c)
                    got = block_dedup(probe_d, lo_d, hi_d, nblocks, u, m,
                                      valid, c)
                    torch.cuda.synchronize()
                    name = (f"block_dedup/nb{nblocks}_b{b}_p{p}_u{u}"
                            f"{'_skewed' if skewed else ''}"
                            f"{'_dead' if kill else ''}")
                    if got is None:
                        fail(f"{name}: the kernel refused its own rule")
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        bad = int((got[0] != want[0]).sum())
                        fail(f"{name}: {bad} of {len(want[0])} entries "
                             "differ from the plain version")
                    emit({"phase": "block_dedup", "case": name,
                          "live": int(want[1].sum()), "u": len(want[0]),
                          "equal": True})
                    if (nblocks, b, u, skewed, kill) == (9766, 128, 4096,
                                                         False, True):
                        args = (probe_d, lo_d, hi_d, nblocks, u, m, valid, c)
                        timing = {
                            "kernel_ms": cuda_ms(lambda: block_dedup(*args),
                                                 reps=50),
                            "plain_ms": cuda_ms(
                                lambda: _dedup_blocks_plain(*args), reps=50)}
    emit({"phase": "block_dedup", "timing_10m_b128": timing})


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
                            want = want_body(sk, qk, d, b, k, k1=False)
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


def _stream_truth(chunks, q, k, cand_src=None, src_mask=None):
    """Float32 top-k source rows of ``q`` over the regenerated corpus
    (torch.matmul with TF32 off, a top-k merge per chunk), and the exact
    scores of the candidate source rows ``cand_src`` (Q, F), gathered in
    the same pass; ``src_mask`` (a bool tensor over the source rows)
    keeps only the rows it selects. A yardstick, never on the port's
    path."""
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
        s = q @ x.T
        if src_mask is not None:
            s = s.masked_fill(~src_mask[None, lo:lo + m], float("-inf"))
        v, i = torch.topk(s, k, dim=1)
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


# -- the sharded clustered engine (K3 per shard) -----------------------------

# benchmarks/filtered.py's sharded point: 2,000,000 x 768 int8 rows,
# nlist 2048 (generated and loaded SC_STEP rows at a time)
SC_N, SC_D, SC_NLIST, SC_STEP = 2_000_000, 768, 2048, 250_000
# rows and nlist of the int4 tier (cut for time)
SC_SMALL, SC_SMALL_NLIST = 1 << 19, 512
SC_TUNE = 0.97  # tune()'s target against the index's own exact scan
SC_SELECTIVITIES = (0.10, 0.01, 0.001)  # benchmarks/filtered.py's filters


class _K3Recorder:
    """While entered, records each stage-1 launch of the sharded
    clustered engine (its inputs and partials). The wrapper launches
    nothing itself: the counters still count the engine's launches."""

    def __enter__(self):
        from wdbx_tpu_torch.parallel import sharded_clustered as scm

        self.mod, self.orig, self.calls = scm, scm.clustered_block_partial, []

        def recording(slab, valid, scales, uniq, ok, qq, qs, k, c,
                      int4=False, gen="v2", body=None):
            out = self.orig(slab, valid, scales, uniq, ok, qq, qs, k, c,
                            int4=int4, gen=gen, body=body)
            self.calls.append(dict(slab=slab, valid=valid, scales=scales,
                                   uniq=uniq, ok=ok, qq=qq, qs=qs, k=k, c=c,
                                   int4=int4, gen=gen, out=out))
            return out

        scm.clustered_block_partial = recording
        return self

    def __exit__(self, *exc):
        self.mod.clustered_block_partial = self.orig

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def _k3_key(call) -> str:
    import torch

    from wdbx_tpu_torch.kernels import clustered_scan as cs

    slab = "int4" if call["int4"] else str(call["slab"].dtype)[6:]
    return clu_name(cs.mode_key(call["gen"], slab, str(call["qq"].dtype)[6:]))


def _k3_plain(call):
    """``clustered_block_topk_plain`` on a recorded launch's slab, block
    list and queries (float queries that prepare to the launch's own)."""
    import torch

    from wdbx_tpu_torch.kernels import clustered_scan as cs

    qq, qs = call["qq"], call["qs"]
    int8q = qq.dtype == torch.int8
    qf = qq.to(torch.float32) * qs if int8q else qq.to(torch.float32)
    return cs.clustered_block_topk_plain(
        call["slab"], call["valid"], call["scales"], call["uniq"], call["ok"],
        qf, call["k"], call["c"], int4=call["int4"],
        qprec="int8" if int8q else "bf16")


def _check_k3_launches(name, calls, errs):
    """Every recorded stage-1 launch, merged by a comparison launch,
    against its plain version on the same block list. Returns the
    largest error and the plain results."""
    from wdbx_tpu_torch.kernels import fused_topk as tf

    err, plains = 0.0, []
    for i, call in enumerate(calls):
        ref = _k3_plain(call)
        got = tf.topk_merge_partials(*call["out"], call["k"])
        key = _k3_key(call)
        e = check_topk(f"{name}/launch{i}", ref, got, block_rescorer(
            call["slab"], call["qq"], call["qs"], call["scales"],
            call["int4"]))
        errs[key] = max(errs.get(key, 0.0), e)
        err = max(err, e)
        plains.append(ref)
    return err, plains


def _check_sc_calls(name, index, calls, out, errs) -> float:
    """Every recorded per-shard stage 1, merged by a comparison launch,
    against its plain version on the same block list; then, where the
    index holds no fresh rows and one replica group served, each batch's
    answer (``out``: host scores and slots, (B, k) or (NB, B, k)) against
    the plain partials of its shards merged by the plain merge."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf

    err, plains = _check_k3_launches(name, calls, errs)
    n_dev = index.n_devices
    if index._residual or index.replicas != 1 or not calls:
        return err
    scores, slots = (np.asarray(a) for a in out)
    if scores.ndim == 2:
        scores, slots = scores[None], slots[None]
    for bi in range(len(plains) // n_dev):
        group = plains[bi * n_dev:(bi + 1) * n_dev]
        pv = torch.stack([v for v, _ in group], 1)
        pi = torch.stack([torch.where(p >= 0, p * n_dev + s, -1)
                          for s, (_, p) in enumerate(group)], 1)
        v, p = tf.merge_partials_plain(pv, pi, scores.shape[-1])
        v, p = v.cpu().numpy(), p.cpu().numpy()
        ref_slots = np.where(p >= 0, index._slot_of[np.clip(p, 0, None)], -1)
        for row in range(v.shape[0]):
            ref = [(int(s), float(x)) for s, x in zip(ref_slots[row], v[row])
                   if s >= 0]
            got = [(int(s), float(x)) for s, x in
                   zip(slots[bi][row], scores[bi][row]) if s >= 0]
            err = max(err, _same_hits(f"{name}/batch{bi}/row{row}", ref, got,
                                      ATOL))
    return err


def _sc_call(rec, label, run, paths, k3, merges, body=None, k2=0):
    """``run()`` with the counters at 0 just before and read just after:
    ``k3`` block-scan stage-1 launches (all on ``body``), ``k2`` fused
    stage-1 launches and ``merges`` merges, or the phase fails.
    ``rec.last`` then holds this run's block-scan launches."""
    from wdbx_tpu_torch.kernels import clustered_scan as cs
    from wdbx_tpu_torch.kernels import fused_topk as tf

    rec.take()
    _reset()
    out = run()
    counts = _counts()
    rec.last = rec.take()
    _tally(paths, label, counts)
    got = (sum(cs.clustered_block_partial.launches.values()),
           sum(tf.fused_topk_partial.launches.values()),
           tf.topk_merge_partials.launches)
    on_body = cs.clustered_block_partial.bodies.get(body, 0) if body else k3
    if got != (k3, k2, merges) or on_body != k3:
        fail(f"{label}: expected {k3} block-scan launches on {body}, {k2} "
             f"fused launches and {merges} merges: {_nonzero(counts)}")
    return out


def _check_sc_flat(name, index, queries, pos_mask, got, errs) -> float:
    """An answer of the sharded clustered engine's flat routes (the exact
    masked scan, the batch fallback: K1 / K2 on every shard, one merge)
    against the plain version on the position-order view (``_slot_view``
    interleaves the shards: row p is global striped position p), the
    position mask ANDed into the validity; the answer's slots are held
    as their positions."""
    import numpy as np
    import torch

    slab, valid, scales = _slot_view(index)
    if pos_mask is not None:
        valid = valid & torch.as_tensor(pos_mask[:index.capacity],
                                        device="cuda")
    scores, slots = (torch.as_tensor(np.asarray(a)) for a in got)
    pos_of = torch.as_tensor(index._pos_of).long()
    pos = torch.where(slots >= 0, pos_of[slots.clamp(min=0)], -1)
    err = _check_sharded(name, index, (slab, valid, scales), queries,
                         (scores, pos), k=scores.shape[-1])
    dtype = "int4" if index._is_int4 else str(slab.dtype)[6:]
    key = f"fused_topk_partial[{dtype}]"
    errs[key] = max(errs.get(key, 0.0), err)
    return err


def _sc_breakdown(index, calls, single, q, k, nprobe) -> dict:
    """Where a B=64 search's stage 1 goes: the recorded per-shard launches
    again (with and without selection: every row masked), the merge of
    their partials, the bound from their live blocks, beside the
    single-device index's one K3 launch on the same queries. Comparison
    launches: never counted."""
    import torch

    from wdbx_tpu_torch.kernels import clustered_scan as cs
    from wdbx_tpu_torch.kernels import fused_topk as tf

    def stage1(masked=False):
        return [cs.clustered_block_partial(
            c["slab"], torch.zeros_like(c["valid"]) if masked else c["valid"],
            c["scales"], c["uniq"], c["ok"], c["qq"], c["qs"], c["k"],
            c["c"], int4=c["int4"], gen=c["gen"]) for c in calls]

    out = {"stage1_ms": cuda_ms(stage1, reps=5, warm=1),
           "score_only_ms": cuda_ms(lambda: stage1(True), reps=5, warm=1)}
    parts = stage1()
    pv = torch.cat([p[0] for p in parts], 1)
    pi = torch.cat([p[1] for p in parts], 1)
    out["merge_ms"] = cuda_ms(lambda: tf.topk_merge_partials(pv, pi, k))
    out["parts"] = int(pv.shape[1])
    live = [int(c["ok"].sum()) for c in calls]
    out["live_blocks_per_shard"] = live
    out["blocks_per_shard"] = index.rows_per_device // index._c
    d, b, c = index.dim, q.shape[0], index._c
    bounds = [_block_bound_ms("int8", "bfloat16", n, c, d, b, k,
                              len(cl["uniq"])) for n, cl in zip(live, calls)]
    out["bound_ms"] = sum(t for t, _ in bounds)
    out["bound_by"] = bounds[0][1]
    tm = time_block_scan(single, q, k, nprobe, "v2", "bf16")
    out["single"] = {key: tm[key] for key in (
        "ms", "score_only_ms", "merge_ms", "parts", "live_blocks", "u", "c",
        "bound_ms", "bound_by", "body")}
    out["single"]["blocks"] = single.capacity // single._c
    return out


def phase_sharded_clustered(seed, paths, timings, errs, tmp):
    """benchmarks/filtered.py's sharded point (FILTERED_SHARDED=1) on
    make_mesh(8): 2,000,000 x 768 int8 rows of a 4096-component mixture,
    nlist 2048, nprobe 4, B=64, k=10, filled by build_from; every K3
    launch held against its plain version; recall gated at 0.95
    unfiltered (after tune) and at 10% / 1% / 0.1% filters (after
    tune_filtered), every flat-route answer (exact masked, the batch
    fallback) against K2's plain version; search_pipelined, int8
    queries, v1, a background rebuild under load, a remesh to 7, 2 x 4
    replicas, an npz reload after adopt_mesh, a per-position checkpoint
    and the facade with heal(); the int4 tier at 524,288 rows."""
    import asyncio
    import shutil
    import threading
    from unittest import mock

    import numpy as np
    import torch

    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex
    from wdbx_tpu_torch.parallel import (
        ShardedClusteredIndex,
        make_mesh,
        make_mesh2,
    )
    from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

    t_phase = time.perf_counter()
    n, d, nlist, b, k, nb = SC_N, SC_D, SC_NLIST, 64, 10, 8
    step = SC_STEP
    mix = _mixture(4096, d, seed + 17)

    def chunks():
        for i, lo in enumerate(range(0, n, step)):
            yield mix(5000 + i, min(step, n - lo))

    def counts_spread(index):
        lc = index._local_counts
        return int((lc.max(axis=0) - lc.min(axis=0)).max())

    index = ShardedClusteredIndex(d, dtype="int8", capacity=n,
                                  mesh=make_mesh(SHARDS), nlist=nlist,
                                  nprobe=4, train_threshold=1 << 62,
                                  device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = index.build_from(chunks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    spread = counts_spread(index)
    if index.count() != n or spread > 1 or not index.is_trained or \
            index.rows_per_device % index._c:
        fail(f"sharded clustered build: {index.count()} rows, spread "
             f"{spread}, c {index._c}, {index.rows_per_device} a shard")
    # the exact flat rule: a batch whose dedup bound covers the slab goes
    # to K2; at 250,000 rows a shard and c = 1,024 the B=64 bound reaches
    # every block of a shard, so it would. The block scan is the path
    # under test: drive it (as tune() does); the default route is driven
    # once beside it.
    u = index._scan_u(b, 4)
    flat_rule = u * index._c * index.n_devices >= index.count()
    index.batch_flat_fallback = False
    emit({"phase": "sharded_clustered", "step": "build_from", "n": n,
          "d": d, "nlist": nlist, "dtype": "int8", "shards": SHARDS,
          "capacity": index.capacity,
          "rows_per_shard": index.rows_per_device, "c": index._c,
          "max_spread_per_bucket": spread, "build_s": build_s,
          "u_b64": u, "flat_rule_at_b64": flat_rule})

    single = ClusteredIVFIndex(d, dtype="int8", nlist=nlist, nprobe=4,
                               train_threshold=1 << 62, device="cuda")
    t0 = time.perf_counter()
    single_slots = single.build_from(chunks)
    torch.cuda.synchronize()
    single_build_s = time.perf_counter() - t0
    single.batch_flat_fallback = False

    q_all = mix(9999, nb * b)
    qstack = q_all.reshape(nb, b, d)
    q64 = q_all[:b]
    src_slot = torch.as_tensor(slots, device="cuda")
    src_single = torch.as_tensor(single_slots, device="cuda")
    truth_src, _ = _stream_truth(chunks, q_all, k)
    truth = src_slot[truth_src].cpu()
    truth_single = src_single[truth_src].cpu()
    body = want_body("int8", "bfloat16", d, b, k)
    if body != "mma_pipe":
        fail(f"sharded_clustered: the shape rule gives {body} at B={b}")
    label = "sharded_clustered"

    # search at B=64 (K3 on every shard, one merge) and B=1 (ranges)
    with _K3Recorder() as rec:
        got = _sc_call(rec, label, lambda: index.search(q64, k), paths,
                       SHARDS, 1, body)
        calls = rec.last
        err = _check_sc_calls(f"{label}/search b64", index, calls, got, errs)
        breakdown = _sc_breakdown(index, calls, single, q64, k, 4)
        for i in range(4):
            one = _sc_call(rec, label,
                           lambda i=i: index.search(q64[i:i + 1], k),
                           paths, 0, 1)
            if (one[1] < 0).any() or not np.isfinite(one[0]).all():
                fail(f"{label}/search b1: {one}")
        route_b1 = index._route_of(1, 4, k)
        if route_b1 != "ranges":
            fail(f"{label}: B=1 took the {route_b1} route")
        search_ms = cuda_ms(lambda: index.search(q64, k), reps=10, warm=3)
        # the default route at B=64: the flat rule holds, so the batch
        # fallback serves it (K2 on every shard, one merge); the single
        # index's rule does not hold at its u and c, so K3 serves it there
        index.batch_flat_fallback = single.batch_flat_fallback = True
        got_fb = _sc_call(rec, "sharded_clustered_fallback",
                          lambda: index.search(q64, k), paths, 0, 1,
                          k2=SHARDS)
        err = max(err, _check_sc_flat(f"{label}/fallback b64", index, q64,
                                      None, got_fb, errs))
        fallback_ms = cuda_ms(lambda: index.search(q64, k), reps=10, warm=3)
        _reset()
        single.search(q64, k)
        single_default = _nonzero(_counts())
        single_default_ms = cuda_ms(lambda: single.search(q64, k), reps=10,
                                    warm=3)
        index.batch_flat_fallback = single.batch_flat_fallback = False
        search_b1_ms = cuda_ms(lambda: index.search(q64[:1], k), reps=10,
                               warm=3)
        single_ms = cuda_ms(lambda: single.search(q64, k), reps=10, warm=3)

        # search_pipelined: NB=8 batches of 64, one K3 a shard a batch
        out = _sc_call(rec, label, lambda: index.search_pipelined(
            qstack, k, materialize=False), paths, SHARDS * nb, nb, body)
        resolved = index.resolve_pipelined(out)
        err = max(err, _check_sc_calls(f"{label}/pipelined", index,
                                       rec.last, resolved, errs))
        pipe_ms = cuda_ms(lambda: index.search_pipelined(
            qstack, k, materialize=False), reps=3, warm=1) / nb
        single_pipe_ms = cuda_ms(lambda: single.search_pipelined(
            qstack, k, materialize=False), reps=3, warm=1) / nb
        rec_n4 = _slot_recall(torch.as_tensor(resolved[1].reshape(nb * b, k)),
                              truth)
        single_n4 = _slot_recall(torch.as_tensor(single.resolve_pipelined(
            single.search_pipelined(qstack, k, materialize=False))[1]
            .reshape(nb * b, k)), truth_single)

        # int8 queries (v2), then v1 once
        for gen, qprec in (("v2", "int8"), ("v1", "bf16")):
            index.kernel_version, index.kernel_qprec = gen, qprec
            want = want_body("int8", "int8" if qprec == "int8"
                             else "bfloat16", d, b, k)
            got_v = _sc_call(rec, f"{label}[{gen},q={qprec}]",
                             lambda: index.search(q64, k), paths, SHARDS, 1,
                             want)
            err = max(err, _check_sc_calls(f"{label}/{gen}/q={qprec}", index,
                                           rec.last, got_v, errs))
        index.kernel_version, index.kernel_qprec = "auto", "bf16"

        # recall after tune(): the index's nprobe for SC_TUNE against its
        # own exact scan, then recall against the float32 oracle
        t0 = time.perf_counter()
        tuned = index.tune(mix(4343, b).cpu().numpy(), k=k,
                           target_recall=SC_TUNE)
        tune_s = time.perf_counter() - t0
        nprobe_t = index.nprobe
        got_t = _sc_call(rec, label,
                         lambda: index.search_pipelined(qstack, k),
                         paths, SHARDS * nb, nb, body)
        err = max(err, _check_sc_calls(f"{label}/tuned", index, rec.last,
                                       got_t, errs))
        rec_t = _slot_recall(torch.as_tensor(got_t[1].reshape(nb * b, k)),
                             truth)
        single.nprobe = nprobe_t
        single_t = _slot_recall(torch.as_tensor(single.search_pipelined(
            qstack, k)[1].reshape(nb * b, k)), truth_single)
        emit({"phase": "sharded_clustered", "path": label, "b": b, "k": k,
              "nprobe": 4, "search_b64_ms": search_ms,
              "search_b1_ms": search_b1_ms, "route_b1": route_b1,
              "single_device_search_b64_ms": single_ms,
              "fallback_on_search_b64_ms": fallback_ms,
              "single_device_fallback_on_search_b64_ms": single_default_ms,
              "single_device_fallback_on_launches": single_default,
              "pipelined_ms_per_batch": pipe_ms,
              "single_device_pipelined_ms_per_batch": single_pipe_ms,
              "single_device_build_s": single_build_s,
              "recall_at_10_nprobe4": rec_n4,
              "single_device_recall_at_10_nprobe4": single_n4,
              "tuned_nprobe": nprobe_t, "tuned_recall_vs_index_exact": tuned,
              "tune_s": tune_s, "recall_at_10_tuned": rec_t,
              "single_device_recall_at_10_tuned": single_t, "bar": FACADE_BAR,
              "max_abs_err_vs_plain": err, "tol": ATOL,
              "breakdown": breakdown})
        timings["sharded_clustered"] = {"search_b64_ms": search_ms,
                                        "pipelined_ms_per_batch": pipe_ms}
        if rec_t < FACADE_BAR:
            fail(f"{label}: tuned recall@10 {rec_t} < {FACADE_BAR}")
        del single
        torch.cuda.empty_cache()

        # filters at benchmarks/filtered.py's selectivities, nprobe 4:
        # pushdown (K3) above FILTER_EXACT_THRESHOLD, the exact masked scan
        # (K2 on every shard) below it
        index.nprobe = 4
        rng = np.random.default_rng(seed)
        q_tune = mix(4242, 32).cpu().numpy()
        flabel = "sharded_clustered_filtered"
        for sel in SC_SELECTIVITIES:
            pick = rng.choice(n, int(n * sel), replace=False)
            mask = np.zeros(index.capacity, bool)
            mask[slots[pick]] = True
            pm, nprobe_f, exact = index._filter_plan(mask, 4, nlist)
            tuned_f = None
            if not exact:
                tuned_f = index.tune_filtered(q_tune, mask, k=k,
                                              target_recall=FACADE_BAR)
                _, nprobe_f, _ = index._filter_plan(mask, 4, nlist)
            got_f = _sc_call(
                rec, flabel,
                lambda mask=mask: index.search(q64, k, slot_mask=mask),
                paths, 0 if exact else SHARDS, 1, None if exact else body,
                k2=SHARDS if exact else 0)
            if exact:
                err = max(err, _check_sc_flat(f"{flabel}/{sel}", index, q64,
                                              pm, got_f, errs))
            else:
                err = max(err, _check_sc_calls(f"{flabel}/{sel}", index,
                                               rec.last, got_f, errs))
            src_mask = torch.zeros(n, dtype=torch.bool, device="cuda")
            src_mask[torch.as_tensor(pick, device="cuda")] = True
            t_src, _ = _stream_truth(chunks, q64, k, src_mask=src_mask)
            rec_f = _slot_recall(torch.as_tensor(got_f[1]),
                                 src_slot[t_src].cpu())
            ms_f = cuda_ms(lambda mask=mask: index.search(
                q64, k, slot_mask=mask), reps=3, warm=1)
            emit({"phase": "sharded_clustered", "path": flabel,
                  "selectivity": sel,
                  "route": "exact masked (K2)" if exact else "pushdown (K3)",
                  "nprobe": nprobe_f, "boosts": dict(index._filter_boosts),
                  "tune_sample_recall": tuned_f, "search_b64_ms": ms_f,
                  "recall_at_10": rec_f, "bar": FACADE_BAR})
            if rec_f < FACADE_BAR:
                fail(f"{flabel} {sel}: recall@10 {rec_f} < {FACADE_BAR}")
            if exact != (sel < 0.02):
                fail(f"{flabel} {sel}: took the "
                     f"{'exact' if exact else 'pushdown'} route")

        # a background rebuild while a thread searches and another writes:
        # every acknowledged write answers afterwards, every delete is gone
        # a deleted slot id is recycled by a later add: ``dead`` keeps the
        # ids that stay deleted
        added, dead, updated, window_writes, served, faults = (
            {}, set(), {}, [0], [0], [])
        n_adds, n_dels = [0], [0]
        stop = threading.Event()

        def writer():
            try:
                i = 0
                while not stop.is_set():
                    in_window = index._cow_writes
                    new = index.add_batch(mix(100_000 + i, 256))
                    for j, s in enumerate(new):
                        added[int(s)] = (100_000 + i, 256, j)
                        dead.discard(int(s))
                    gone = slots[1000 + 64 * i:1000 + 64 * (i + 1)]
                    index.remove_slots(gone)
                    dead.update(int(s) for s in gone)
                    n_adds[0] += len(new)
                    n_dels[0] += len(gone)
                    lo = n // 4 + 32 * i
                    upd = slots[lo:lo + 32]
                    index.update_slots(upd, mix(200_000 + i, 32))
                    for j, s in enumerate(upd):
                        updated[int(s)] = (200_000 + i, 32, j)
                    window_writes[0] += int(in_window and index._cow_writes)
                    i += 1
            except BaseException as e:  # surfaced below
                faults.append(e)

        def searcher():
            try:
                while not stop.is_set():
                    index.search(q64, k)
                    served[0] += 1
            except BaseException as e:
                faults.append(e)

        workers = [threading.Thread(target=writer),
                   threading.Thread(target=searcher)]
        for w in workers:
            w.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        index.build_background()
        bg_s = time.perf_counter() - t0
        time.sleep(0.5)
        stop.set()
        for w in workers:
            w.join(300)
        if faults or any(w.is_alive() for w in workers):
            fail(f"background rebuild under load: {faults}")
        if index._cow_writes or not index.is_trained or \
                index.count() != n + n_adds[0] - n_dels[0] or \
                not window_writes[0]:
            fail(f"background rebuild: count {index.count()}, window "
                 f"writes {window_writes[0]}")
        if (index._positions_of(np.asarray(sorted(dead))) >= 0).any():
            fail("background rebuild: a deleted slot still has a row")

        def rows_of(keyed):
            by_seed = {}
            for s, (sd, m, j) in keyed.items():
                by_seed.setdefault((sd, m), []).append((j, s))
            for (sd, m), pairs in by_seed.items():
                rows = mix(sd, m)
                js = torch.as_tensor([j for j, _ in pairs], device="cuda")
                yield rows[js], np.asarray([s for _, s in pairs])

        missing = 0
        for keyed in (added, updated):
            for rows, want_slots in rows_of(keyed):
                _, got_s = index.search(rows, k)
                missing += int(sum(int(s) not in set(r.tolist())
                                   for s, r in zip(want_slots, got_s)))
        # the first deletes are source rows 1000.. of the first chunk
        dead_rows = mix(5000, step)[1000:1064]
        _, got_d = index.search(dead_rows, k)
        if missing or set(got_d.ravel().tolist()) & set(dead):
            fail(f"background rebuild lost {missing} acknowledged writes or "
                 "served a deleted slot")
        emit({"phase": "sharded_clustered", "path": "build_background",
              "bg_build_s": bg_s, "searches_served": served[0],
              "adds": n_adds[0], "deletes": n_dels[0],
              "updates": len(updated), "writes_in_window": window_writes[0],
              "residual_after": len(index._residual)})

        # a live remesh to 7 shards: rebuilt there, K3 on each of 7
        t0 = time.perf_counter()
        index.remesh(make_mesh(SHARDS - 1))
        torch.cuda.synchronize()
        remesh_s = time.perf_counter() - t0
        if index.n_devices != SHARDS - 1 or not index.is_trained or \
                counts_spread(index) > 1:
            fail(f"remesh to 7: {index.n_devices} shards")
        got7 = _sc_call(rec, label, lambda: index.search(q64, k), paths,
                        SHARDS - 1, 1, body)
        err = max(err, _check_sc_calls(f"{label}/remesh7", index, rec.last,
                                       got7, errs))
        emit({"phase": "sharded_clustered", "path": "remesh", "to": 7,
              "remesh_s": remesh_s, "rows": index.count(),
              "rows_per_shard": index.rows_per_device, "c": index._c})
        del index
        torch.cuda.empty_cache()

        def built(chunk_fn, rows, nl, dtype="int8", mesh=None, **kw):
            ix = ShardedClusteredIndex(
                d, dtype=dtype, capacity=rows, nlist=nl, nprobe=4,
                mesh=mesh or make_mesh(SHARDS), train_threshold=1 << 62,
                device="cuda", **kw)
            ix.build_from(chunk_fn)
            ix.batch_flat_fallback = False
            return ix

        # the int4 tier at 524,288 rows (cut for time)
        small = SC_SMALL

        def small_chunks(sstep=min(1 << 17, small)):
            for i in range(0, small, sstep):
                yield mix(6000 + i // sstep, sstep)

        i4 = built(small_chunks, small, SC_SMALL_NLIST, "int4")
        got4 = _sc_call(rec, "sharded_clustered_int4",
                        lambda: i4.search(q64, k), paths, SHARDS, 1,
                        want_body("int4", "bfloat16", d, b, k))
        err4 = _check_sc_calls("sharded_clustered_int4", i4, rec.last, got4,
                               errs)
        del i4

        # the full point again: 2 x 4 replicas, checkpoints, the facade
        rep = built(chunks, n, nlist, mesh=make_mesh2(2, 4), replicas=2)
        for p in range(4, 8):
            if not torch.equal(rep._slabs[p], rep._slabs[p - 4]):
                fail(f"replica position {p} differs from its shard")
        got_r = _sc_call(rec, "sharded_clustered_replicated",
                         lambda: rep.search(q64, k), paths, SHARDS, 2,
                         want_body("int8", "bfloat16", d, b // 2, k))
        err_r = _check_sc_calls("sharded_clustered_replicated", rep,
                                rec.last, got_r, errs)
        rep_ms = cuda_ms(lambda: rep.search(q64, k), reps=5, warm=1)
        del rep
        torch.cuda.empty_cache()
        ckpt = tempfile.mkdtemp(prefix="sclu_", dir=tmp)
        cp = built(chunks, n, nlist)
        before = cp.search(q64, k)
        path = os.path.join(ckpt, "npz")
        t0 = time.perf_counter()
        cp.save(path)
        save_s = time.perf_counter() - t0
        cp.adopt_mesh(make_mesh(SHARDS))
        if cp.count() != 0 or cp.is_trained:
            fail("adopt_mesh left rows behind")
        t0 = time.perf_counter()
        if not cp.load(path) or cp.count() != n or not cp.is_trained:
            fail("npz reload after adopt_mesh")
        load_s = time.perf_counter() - t0
        cp.batch_flat_fallback = False
        after = _sc_call(rec, label, lambda: cp.search(q64, k), paths,
                         SHARDS, 1, body)
        err = max(err, _check_sc_calls(f"{label}/npz reload", cp, rec.last,
                                       after, errs))
        cp.persist_backend = "orbax"
        t0 = time.perf_counter()
        cp.save(os.path.join(ckpt, "pos"))
        pos_save_s = time.perf_counter() - t0
        del cp
        torch.cuda.empty_cache()
        again = ShardedClusteredIndex(d, dtype="int8", nlist=nlist,
                                      mesh=make_mesh(SHARDS), device="cuda")
        t0 = time.perf_counter()
        if not again.load(os.path.join(ckpt, "pos")):
            fail("per-position checkpoint did not load")
        pos_load_s = time.perf_counter() - t0
        again.batch_flat_fallback = False
        pos_after = _sc_call(rec, label, lambda: again.search(q64, k), paths,
                             SHARDS, 1, body)
        err = max(err, _check_sc_calls(f"{label}/position reload", again,
                                       rec.last, pos_after, errs))
        for a, c in ((before, after), (before, pos_after)):
            if not (np.array_equal(a[1], c[1]) and np.array_equal(a[0], c[0])):
                fail("a checkpoint round trip changed the answers")
        shutil.rmtree(ckpt)
        emit({"phase": "sharded_clustered", "path": "replicas, checkpoints",
              "n": n, "int4_n": small,
              "int4_max_abs_err_vs_plain": err4,
              "replicated_mesh": dict(make_mesh2(2, 4).shape),
              "replicated_search_b64_ms": rep_ms,
              "replicated_max_abs_err_vs_plain": err_r,
              "npz_save_s": save_s, "npz_load_s": load_s,
              "position_save_s": pos_save_s, "position_load_s": pos_load_s})
        del again
        torch.cuda.empty_cache()

        # the facade: enable_distributed, a health check, heal() onto 7
        # positions; full probe, so the answers do not depend on layout.
        # Every search's launches and its answer (recorded at the index)
        # are held against the plain version.
        old_env = os.environ.get(MESH_SIZE_ENV)
        os.environ[MESH_SIZE_ENV] = str(SHARDS)
        try:
            db = WDBX(vector_dimension=d, enable_plugins=False,
                      enable_distributed=True,
                      data_dir=os.path.join(tmp, "sclu_facade"),
                      config={"INDEX_TYPE": "sharded_clustered",
                              "INDEX_DTYPE": "int8",
                              "IVF_NLIST": nlist, "IVF_NPROBE": nlist,
                              "IVF_TRAIN_THRESHOLD": 1 << 62,
                              "INDEX_CAPACITY": n, "RAW_STORE": "none",
                              "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
            asyncio.run(db.initialize())
            lo = 0
            for rows in chunks():
                db.store.bulk_load([str(i) for i in range(lo, lo + len(rows))],
                                   rows.cpu().numpy())
                lo += len(rows)
            fx = db.store.indices[0]
            if not isinstance(fx, ShardedClusteredIndex):
                fail(f"INDEX_TYPE=sharded_clustered gave {type(fx).__name__}")
            fx.build()
            fx.batch_flat_fallback = False
            answers, index_search = [], fx.search

            def answering(queries, k, slot_mask=None):
                out = index_search(queries, k, slot_mask=slot_mask)
                answers.append(out)
                return out

            fx.search = answering
            qn = q64.cpu().numpy()
            flabel = "sharded_clustered_facade"
            hits = _sc_call(rec, flabel, lambda: db.vector_search_batch(
                qn, limit=k), paths, SHARDS, 1, body)
            err = max(err, _check_sc_calls(f"{flabel}/8", fx, rec.last,
                                           answers[-1], errs))
            health = db.shard_engine.health_check()
            names = list(db.shard_engine.mesh.names)
            if not health["healthy"] or len(names) != SHARDS:
                fail(f"health_check: {health}")
            down = {"healthy": False, "devices": {
                nm: ("error: down" if nm == names[3] else "ok")
                for nm in names}}
            t0 = time.perf_counter()
            with mock.patch.object(db.shard_engine, "health_check",
                                   return_value=down):
                report = db.heal(allow_remesh=True)
            heal_s = time.perf_counter() - t0
            if report["remeshed_to"] != names[:3] + names[4:] or \
                    fx.n_devices != SHARDS - 1 or not fx.is_trained:
                fail(f"heal did not re-stripe onto 7: {report}")
            healed = _sc_call(rec, flabel, lambda: db.vector_search_batch(
                qn, limit=k), paths, SHARDS - 1, 1, body)
            err = max(err, _check_sc_calls(f"{flabel}/7", fx, rec.last,
                                           answers[-1], errs))
            for row, (h0, h1) in enumerate(zip(hits, healed)):
                _same_hits(f"{flabel}/row{row}", [h[:2] for h in h0],
                           [h[:2] for h in h1])
            emit({"phase": "sharded_clustered", "path": flabel,
                  "n": n, "health": health["healthy"], "heal_s": heal_s,
                  "remeshed_to": len(report["remeshed_to"])})
            asyncio.run(db.shutdown())
            del db, fx, index_search
        finally:
            if old_env is None:
                os.environ.pop(MESH_SIZE_ENV, None)
            else:
                os.environ[MESH_SIZE_ENV] = old_env
    torch.cuda.empty_cache()
    emit({"phase": "sharded_clustered",
          "seconds": time.perf_counter() - t_phase,
          "max_abs_err_vs_plain": err, "tol": ATOL,
          "launches": {name: _nonzero(paths[name]) for name in paths
                       if name.startswith("sharded_clustered")}})



# -- the dense IVF engine (K5) -----------------------------------------------


MP_RANKS = 2  # processes of the multiprocess phase, sharing the card
MP_POSITIONS = 4  # positions a rank: the sharded phases' 8 in all
MP_DEADLINE_S = 600  # the ranks' whole run, build and checks included
MP_REMOVED = 1024  # slots the flat path removes


class _K1Recorder:
    """While entered, records each stage-1 launch of the sharded flat
    engine (its inputs and partials); the counters still count the
    engine's launches."""

    def __enter__(self):
        from wdbx_tpu_torch.parallel import sharded_flat as sfm

        self.mod, self.orig, self.calls = sfm, sfm.fused_topk_local, []

        def recording(db, queries, valid, k, scales=None, int4=False):
            out = self.orig(db, queries, valid, k, scales=scales, int4=int4)
            self.calls.append(dict(db=db, q=queries, valid=valid, k=k,
                                   scales=scales, int4=int4, out=out))
            return out

        sfm.fused_topk_local = recording
        return self

    def __exit__(self, *exc):
        self.mod.fused_topk_local = self.orig

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def _check_k1_launches(name, calls, errs) -> float:
    """Every recorded K1 / K2 launch of a shard, merged by a comparison
    launch, against its plain version on the same inputs."""
    from wdbx_tpu_torch.kernels import fused_topk as tf

    err = 0.0
    for i, c in enumerate(calls):
        ref = tf.fused_topk_plain(c["db"], c["q"], c["valid"], c["k"],
                                  scales=c["scales"], int4=c["int4"])
        got = tf.topk_merge_partials(*c["out"], c["k"])
        e = check_topk(f"{name}/launch{i}", ref, got, rescorer(
            c["db"], c["q"], c["scales"], c["int4"]))
        dtype = "int4" if c["int4"] else str(c["db"].dtype)[6:]
        key = f"fused_topk_partial[{dtype}]"
        errs[key] = max(errs.get(key, 0.0), e)
        err = max(err, e)
    return err


def _mp_call(rec, label, run, counts, stage1, merges, body, key):
    """``run()`` with the counters at 0 just before and read just after:
    ``stage1`` launches of ``key`` on ``body`` and ``merges`` merges, or
    the rank fails. ``rec.last`` then holds the run's launches."""
    from wdbx_tpu_torch.kernels import fused_topk as tf

    rec.take()
    _reset()
    out = run()
    got = _counts()
    rec.last = rec.take()
    _tally(counts, label, got)
    if got[key] != stage1 or got["topk_merge_partials"] != merges or \
            got[f"fused_topk_partial.bodies.{body}"] != stage1 or \
            sum(tf.fused_topk_partial.launches.values()) != stage1:
        fail(f"{label}: expected {stage1} launches of {key} on {body} and "
             f"{merges} merges: {_nonzero(got)}")
    return out


def _wall_ms(fn, reps, warm=1) -> float:
    """Wall ms of ``fn()`` (host clock, the card synchronized around)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _mp_split(index, stage1, b, k) -> dict:
    """Where a search's time goes on a rank of ``index``: ``stage1()``
    (the rank's stage-1 launches for its group's slice of a batch of
    ``b``, returning their partials), the rank's merge, the one
    all-gather of every rank's (slice, k') block (host staging and gloo;
    also of a host copy, gloo alone), the merge of the group's ranks,
    and ``_serve`` around the rank's merged slice (pack, gather, merges).
    Every rank times the same sequence, so the gathers meet. Comparison
    launches: never counted."""
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf
    from wdbx_tpu_torch.parallel import collective

    g = index._groups[0]
    out = {"stage1_ms": cuda_ms(stage1, reps=5, warm=1)}
    pv, pi = stage1()
    out["slice_rows"] = int(pv.shape[0])
    out["local_merge_ms"] = cuda_ms(
        lambda: index._merge_own(pv, pi, k, tf.merge_partials), reps=10,
        warm=2)
    v, i = index._merge_own(pv, pi, k, tf.merge_partials)
    kr = v.shape[1]
    packed = torch.cat([v.contiguous().view(torch.int32),
                        i.to(torch.int32)], -1)
    out["gather_ms"] = _wall_ms(lambda: collective.all_gather(packed),
                                reps=20, warm=2)
    host = packed.cpu()  # the same gather without the device copies
    out["gather_gloo_only_ms"] = _wall_ms(
        lambda: collective.all_gather(host), reps=20, warm=2)
    every = collective.all_gather(packed)
    part = torch.stack([every[r] for r in range(index.mesh.world)
                        if index._group_shards[r, g]], 1)
    gv = part[..., :kr].contiguous().view(torch.float32)
    gi = part[..., kr:].contiguous()
    out["final_merge_ms"] = cuda_ms(
        lambda: tf.topk_merge_partials(gv, gi, k), reps=10, warm=2)
    out["call_ms"] = _wall_ms(lambda: index._serve(
        b, k, lambda g_, lo, hi: (v, i), tf.merge_partials), reps=5)
    out["gather_bytes_per_rank"] = int(packed.numel() * 4)
    return out


def _coll_since(before) -> dict:
    """Collective calls, bytes sent and ms since ``before``, by kind."""
    from wdbx_tpu_torch.parallel import collective

    now = collective.stats()
    return {kind: {key: s[key] - before.get(kind, {}).get(key, 0)
                   for key in s} for kind, s in now.items()
            if s["calls"] != before.get(kind, {}).get("calls", 0)}


def _rank_main(rank, world, port, tmp, seed):
    """One rank of the ``multiprocess`` phase (started by
    ``phase_multiprocess``): joins through ``ShardEngine.initialize`` on
    the global mesh of ``world`` x ``MP_POSITIONS`` positions, drives the
    flat engine (bf16, int8) and the sharded clustered engine on its
    shards, then both on ``make_mesh2(2)`` (a copy a rank), then the
    production_serving deployment (``ShardedIVFIndex`` through
    ``WDBX(enable_distributed=True)``); holds every stage-1 launch
    against its plain version, times the calls and their split, and
    writes its report and answers to ``tmp`` for the parent."""
    os.environ.update(WDBX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      WDBX_NUM_PROCESSES=str(world),
                      WDBX_PROCESS_ID=str(rank),
                      WDBX_TORCH_MESH_SIZE=str(MP_POSITIONS))
    import asyncio

    import numpy as np
    import torch

    from wdbx_tpu_torch.core.config import WDBXConfig
    from wdbx_tpu_torch.ops.normalize import l2_normalize
    from wdbx_tpu_torch.parallel import (
        ShardedClusteredIndex,
        ShardedFlatIndex,
        ShardEngine,
        collective,
    )

    engine = ShardEngine(WDBXConfig(
        {"DATA_DIR": os.path.join(tmp, f"mp_engine{rank}")}))
    asyncio.run(engine.initialize())
    mesh = engine.mesh
    own = list(range(rank * MP_POSITIONS, (rank + 1) * MP_POSITIONS))
    if mesh.size != world * MP_POSITIONS or \
            list(mesh.local_positions) != own or \
            any(d.type != "cuda" for d in mesh.devices):
        fail(f"rank {rank}: mesh {mesh.names} owners {mesh.owners}")
    health = engine.health_check()
    if not health["healthy"] or len(health["devices"]) != mesh.size:
        fail(f"rank {rank}: health {health}")
    counts: dict[str, dict] = {}
    errs: dict[str, float] = {}
    rep = {"rank": rank, "mesh": list(mesh.names), "counts": counts,
           "errs": errs}
    ans = {}
    k = 10
    pipe_body = want_body("bfloat16", "bfloat16", 384, 128, k)

    # the flat engine at bench.py's point, bf16
    x, qs = _data(N_ROWS, seed)
    nb, b = qs.shape[0], qs.shape[1]
    qstack = torch.as_tensor(qs, device="cuda")
    idx = ShardedFlatIndex(384, dtype="bfloat16", capacity=N_ROWS,
                           mesh=mesh)
    t0 = time.perf_counter()
    idx.add_batch(x)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    label = "multiprocess_flat"
    bf16 = "fused_topk_partial[bfloat16]"
    with _K1Recorder() as k1:
        before = collective.stats()
        ans["search"] = _mp_call(k1, label, lambda: idx.search(qs[0], k),
                                 counts, MP_POSITIONS, 2, pipe_body, bf16)
        search_coll = _coll_since(before)
        err = _check_k1_launches(f"{label}/search", k1.last, errs)
        ans["pipelined"] = _mp_call(
            k1, label, lambda: idx.search_pipelined(qstack, k), counts,
            MP_POSITIONS, 2, pipe_body, bf16)
        err = max(err, _check_k1_launches(f"{label}/pipelined", k1.last,
                                          errs))
        # 1,024 removed slots (the first batch's best hits among them)
        pick = np.random.default_rng(seed + 5).permutation(N_ROWS)
        first = np.unique(ans["search"][1][:, 0])
        rest = pick[~np.isin(pick, first)][:MP_REMOVED - len(first)]
        removed = np.concatenate([first, rest]).astype(np.int64)
        idx.remove_slots(removed)
        ans["removed"] = _mp_call(k1, label, lambda: idx.search(qs[0], k),
                                  counts, MP_POSITIONS, 2, pipe_body, bf16)
        err = max(err, _check_k1_launches(f"{label}/removed", k1.last,
                                          errs))
        if np.isin(ans["removed"][1], removed).any():
            fail(f"{label}: a removed slot was returned")
    search_ms = _wall_ms(lambda: idx.search(qs[0], k), reps=10, warm=2)
    pipe_ms = _wall_ms(lambda: idx.search_pipelined(qstack, k), reps=3) / nb
    qk = l2_normalize(torch.as_tensor(qs[0], device="cuda"))
    split = _mp_split(
        idx, lambda: idx._shard_parts(0, qk, k, idx._valids, True), b, k)
    # orbax (one file a position, each rank its own) and the npz for the
    # parent
    idx.persist_backend = "orbax"
    t0 = time.perf_counter()
    idx.save(os.path.join(tmp, "mp_orbax"))
    orbax_save_s = time.perf_counter() - t0
    back = ShardedFlatIndex(384, dtype="bfloat16", capacity=N_ROWS,
                            mesh=mesh)
    back.persist_backend = "orbax"
    t0 = time.perf_counter()
    if not back.load(os.path.join(tmp, "mp_orbax")):
        fail(f"{label}: the orbax checkpoint did not load")
    orbax_load_s = time.perf_counter() - t0
    with _K1Recorder() as k1:
        again = _mp_call(k1, label, lambda: back.search(qs[0], k), counts,
                         MP_POSITIONS, 2, pipe_body, bf16)
    if not (np.array_equal(again[1], ans["removed"][1])
            and np.array_equal(again[0], ans["removed"][0])):
        fail(f"{label}: the orbax round trip answers otherwise")
    del back
    idx.persist_backend = "npz"
    t0 = time.perf_counter()
    idx.save(os.path.join(tmp, "mp_flat"))
    npz_save_s = time.perf_counter() - t0
    rep["flat"] = {
        "n": N_ROWS, "positions": mesh.size, "rows_per_shard":
        idx.rows_per_device, "add_s": add_s, "b": b, "k": k, "nb": nb,
        "search_b128_ms": search_ms, "pipelined_ms_per_batch": pipe_ms,
        "split_b128": split, "search_collectives": search_coll,
        "orbax_save_s": orbax_save_s, "orbax_load_s": orbax_load_s,
        "npz_save_s": npz_save_s, "removed": int(len(removed)),
        "max_abs_err_vs_plain": err}
    ans["removed_slots"] = (removed, removed)
    del idx
    torch.cuda.empty_cache()

    # the same rows as int8: one B=128 search (K2 on the rank's shards)
    idx8 = ShardedFlatIndex(384, dtype="int8", capacity=N_ROWS, mesh=mesh)
    idx8.add_batch(x)
    i8 = "fused_topk_partial[int8]"
    body8 = want_body("int8", "bfloat16", 384, 128, k)
    with _K1Recorder() as k1:
        ans["int8"] = _mp_call(k1, "multiprocess_int8",
                               lambda: idx8.search(qs[0], k), counts,
                               MP_POSITIONS, 2, body8, i8)
        err8 = _check_k1_launches("multiprocess_int8/search", k1.last, errs)
    rep["int8"] = {"search_b128_ms": _wall_ms(lambda: idx8.search(qs[0], k),
                                              reps=10, warm=2),
                   "max_abs_err_vs_plain": err8}
    del idx8
    torch.cuda.empty_cache()
    rep["replicated"] = _rank_replicated(x, qs, removed, ans, counts, errs,
                                         tmp, seed)
    rep["remesh"] = _rank_remesh(engine, x, qs, ans, counts, errs, tmp)
    del x

    # sharded clustered at benchmarks/filtered.py's sharded point
    n, d, nlist, bc, nbc = SC_N, SC_D, SC_NLIST, 64, 8
    mix = _mixture(4096, d, seed + 17)

    def chunks():
        for i, lo in enumerate(range(0, n, SC_STEP)):
            yield mix(5000 + i, min(SC_STEP, n - lo))

    c = ShardedClusteredIndex(d, dtype="int8", capacity=n, mesh=mesh,
                              nlist=nlist, nprobe=4,
                              train_threshold=1 << 62)
    before = collective.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = c.build_from(chunks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_coll = _coll_since(before)
    lc = c._local_counts
    if not np.array_equal(slots, np.arange(n)) or not c.is_trained or \
            int((lc.max(axis=0) - lc.min(axis=0)).max()) > 1:
        fail(f"rank {rank}: the clustered build across the ranks")
    c.batch_flat_fallback = False
    q_all = mix(9999, nbc * bc)
    qstack_c = q_all.reshape(nbc, bc, d)
    q64 = q_all[:bc]
    body3 = want_body("int8", "bfloat16", d, bc, k)
    clabel = "multiprocess_clustered"
    with _K3Recorder() as rec:
        before = collective.stats()
        ans["clustered"] = _sc_call(rec, clabel, lambda: c.search(q64, k),
                                    counts, MP_POSITIONS, 2, body3)
        clu_coll = _coll_since(before)
        err3, _ = _check_k3_launches(f"{clabel}/search", rec.last, errs)
        calls = rec.last
        ans["clustered_pipelined"] = _sc_call(
            rec, clabel, lambda: c.search_pipelined(qstack_c, k), counts,
            MP_POSITIONS * nbc, 2 * nbc, body3)
        e, _ = _check_k3_launches(f"{clabel}/pipelined", rec.last, errs)
        err3 = max(err3, e)
    # 1%: the exact masked route, K2 on the rank's shards
    pick = np.random.default_rng(seed).choice(n, n // 100, replace=False)
    mask = np.zeros(c.capacity, bool)
    mask[pick] = True
    if not c._filter_plan(mask, 4, nlist)[2]:
        fail(f"{clabel}: the 1% filter did not take the exact route")
    body_f = want_body("int8", "bfloat16", d, bc, k)
    with _K1Recorder() as k1:
        ans["clustered_filtered"] = _mp_call(
            k1, clabel, lambda: c.search(q64, k, slot_mask=mask), counts,
            MP_POSITIONS, 2, body_f, i8)
        err3 = max(err3, _check_k1_launches(f"{clabel}/filtered 1%",
                                            k1.last, errs))
    ans["filter_pick"] = (pick, pick)
    c_search_ms = _wall_ms(lambda: c.search(q64, k), reps=10, warm=3)
    c_pipe_ms = _wall_ms(lambda: c.search_pipelined(qstack_c, k),
                         reps=3) / nbc
    c_filter_ms = _wall_ms(lambda: c.search(q64, k, slot_mask=mask),
                           reps=5, warm=1)
    from wdbx_tpu_torch.kernels import clustered_scan as cs

    def k3_stage1():
        parts = [cs.clustered_block_partial(
            cl["slab"], cl["valid"], cl["scales"], cl["uniq"], cl["ok"],
            cl["qq"], cl["qs"], cl["k"], cl["c"], int4=cl["int4"],
            gen=cl["gen"]) for cl in calls]
        return (torch.cat([p[0] for p in parts], 1),
                torch.cat([p[1] for p in parts], 1))

    c_split = _mp_split(c, k3_stage1, bc, k)
    c_split["live_blocks_per_shard"] = [int(cl["ok"].sum()) for cl in calls]
    t0 = time.perf_counter()
    c.save(os.path.join(tmp, "mp_clu"))
    c_save_s = time.perf_counter() - t0
    back = ShardedClusteredIndex(d, dtype="int8", capacity=n, mesh=mesh,
                                 nlist=nlist, nprobe=4,
                                 train_threshold=1 << 62)
    t0 = time.perf_counter()
    if not back.load(os.path.join(tmp, "mp_clu")):
        fail(f"{clabel}: the npz checkpoint did not load")
    c_load_s = time.perf_counter() - t0
    back.batch_flat_fallback = False
    with _K3Recorder() as rec:
        again = _sc_call(rec, clabel, lambda: back.search(q64, k), counts,
                         MP_POSITIONS, 2, body3)
    if not np.array_equal(again[1], ans["clustered"][1]):
        fail(f"{clabel}: the reloaded index answers otherwise")
    del back
    rep["clustered"] = {
        "n": n, "d": d, "nlist": nlist, "b": bc, "k": k, "nprobe": 4,
        "c": c._c, "rows_per_shard": c.rows_per_device, "build_s": build_s,
        "build_collectives": build_coll, "search_b64_ms": c_search_ms,
        "pipelined_ms_per_batch": c_pipe_ms, "filtered_1pct_ms": c_filter_ms,
        "split_b64": c_split, "search_collectives": clu_coll,
        "npz_save_s": c_save_s, "npz_load_s": c_load_s,
        "max_abs_err_vs_plain": err3}
    del calls, k3_stage1
    rep["background"] = _rank_background(c, engine, mix, q64, pick, ans,
                                         counts, errs, seed)
    del c
    torch.cuda.empty_cache()
    rep["replicated_clustered"] = _rank_replicated_clustered(
        chunks, q64, qstack_c, pick, ans, counts, errs, tmp)
    rep["ivf"] = _rank_ivf(tmp, seed, ans, counts, errs)
    rep["collectives"] = collective.stats()
    np.savez(os.path.join(tmp, f"mp_ans{rank}.npz"),
             **{f"{key}|{j}": np.asarray(v) for key, pair in ans.items()
                for j, v in enumerate(pair)})
    with open(os.path.join(tmp, f"mp_rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    collective.barrier()
    asyncio.run(engine.shutdown())
    print(f"rank {rank} done", flush=True)


MP_DOWN = "cuda:0#7"  # the position whose probe fails, on rank 1


def _inject_fault(engine, rank=1, every=False):
    """On ``rank``, make this engine's probe of ``MP_DOWN`` (``every``:
    of every position the rank holds) fail: the real ``health_check``
    then gathers the fault to every rank."""
    from wdbx_tpu_torch.parallel import ShardEngine

    if engine.mesh.rank != rank:
        return

    def probe(name, device):
        if every or name == MP_DOWN:
            return "error: injected"
        return ShardEngine._probe(engine, name, device)

    engine._probe = probe


def _degraded7(engine):
    """The degraded mesh of the fault: positions 0-6, rank 0 owning 4 and
    rank 1 3, the survivors' names kept."""
    _inject_fault(engine)
    try:
        health = engine.health_check()
    finally:
        engine.__dict__.pop("_probe", None)
    mesh = engine.degraded_mesh(health)
    if health["healthy"] or health["devices"][MP_DOWN] == "ok" or \
            mesh.names != engine.mesh.names[:7] or \
            mesh.owners != (0, 0, 0, 0, 1, 1, 1):
        fail(f"rank {engine.mesh.rank}: degraded mesh {mesh.names} "
             f"{mesh.owners} of {health}")
    return mesh


def _rank_remesh(engine, x, qs, ans, counts, errs, tmp):
    """``ShardedFlatIndex`` bf16 at bench.py's point, live-remeshed from
    8 positions to the degraded 7 (4 + 3): B=128, B=1 and pipelined
    searches (K1 on the rank's 4 or 3 shards, 2 merges), each launch
    against its plain version; the npz the parent reads; the remesh back
    to 8; ``adopt_mesh`` onto 7 and the npz reload. Returns the rank's
    report: remesh seconds and the bytes the all-to-all sent."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.parallel import ShardedFlatIndex, collective

    label, k = "multiprocess_remesh", 10
    key = "fused_topk_partial[bfloat16]"
    mesh8 = engine.mesh
    m7 = _degraded7(engine)
    own7 = len(m7.local_positions)
    idx = ShardedFlatIndex(384, dtype="bfloat16", capacity=N_ROWS,
                           mesh=mesh8)
    idx.add_batch(x)
    ans["remesh_before"] = idx.search(qs[0], k)
    qstack = torch.as_tensor(qs, device="cuda")
    body = want_body("bfloat16", "bfloat16", 384, 128, k)
    body1 = want_body("bfloat16", "bfloat16", 384, 1, k)

    def remesh(mesh):
        before = collective.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.remesh(mesh)
        torch.cuda.synchronize()
        coll = _coll_since(before).get("all_to_all", {})
        return {"s": time.perf_counter() - t0,
                "all_to_all_mb": coll.get("bytes", 0) / 1e6,
                "all_to_all_calls": coll.get("calls", 0),
                **idx.last_remesh}

    out = {"to7": remesh(m7)}
    with _K1Recorder() as k1:
        ans["remesh_search"] = _mp_call(
            k1, label, lambda: idx.search(qs[0], k), counts, own7, 2, body,
            key)
        err = _check_k1_launches(f"{label}/search", k1.last, errs)
        ans["remesh_b1"] = _mp_call(
            k1, label, lambda: idx.search(qs[1][:1], k), counts, own7, 2,
            body1, key)
        err = max(err, _check_k1_launches(f"{label}/b1", k1.last, errs))
        ans["remesh_pipelined"] = _mp_call(
            k1, label, lambda: idx.search_pipelined(qstack, k), counts, own7,
            2, body, key)
        err = max(err, _check_k1_launches(f"{label}/pipelined", k1.last,
                                          errs))
    out["search_b128_ms"] = _wall_ms(lambda: idx.search(qs[0], k), reps=10,
                                     warm=2)
    path = os.path.join(tmp, "mp_remesh7")
    idx.save(path)
    out["to8"] = remesh(mesh8)
    with _K1Recorder() as k1:
        ans["remesh_back"] = _mp_call(
            k1, label, lambda: idx.search(qs[0], k), counts, MP_POSITIONS, 2,
            body, key)
        err = max(err, _check_k1_launches(f"{label}/back to 8", k1.last,
                                          errs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.adopt_mesh(m7)
    if idx.count() or not idx.load(path):
        fail(f"{label}: adopt_mesh + the npz reload")
    out["adopt_reload_s"] = time.perf_counter() - t0
    with _K1Recorder() as k1:
        ans["remesh_reload"] = _mp_call(
            k1, label, lambda: idx.search(qs[0], k), counts, own7, 2, body,
            key)
        err = max(err, _check_k1_launches(f"{label}/reload", k1.last, errs))
    for name in ("remesh_back", "remesh_reload"):
        ref = ans["remesh_before" if name == "remesh_back"
                  else "remesh_search"]
        if not np.array_equal(ans[name][1], ref[1]):
            fail(f"{label}: {name} answers otherwise")
    out["max_abs_err_vs_plain"] = err
    del idx
    torch.cuda.empty_cache()
    return out


def _rank_heal(db, held_np, picks, ans, counts, errs, tmp):
    """The production_serving deployment loses position 7 (a fault in
    rank 1's probe): ``heal(allow_remesh=True)`` remeshes live to 7 and
    rebuilds, then re-tunes to 0.97; the searches of ``_heal_calls`` (the
    quota scan; the 1% filter's exact route, K1 on the rank's shards);
    the npz the parent replays; then the walkthrough's checkpoint heal
    (``store.save()``, ``clear()``, ``heal()``), which must give the
    same hits back. Then every position of rank 1 fails its probe:
    ``heal`` onto rank 0's 4 positions, and, the probe passing again,
    back onto the 8, each re-tuned, with ``_heal_calls`` and an npz for
    the parent. Returns the rank's report."""
    import numpy as np

    label, k, d = "multiprocess_heal", 10, 384
    engine = db.shard_engine
    index = db.store.indices[0]
    names = list(engine.mesh.names)
    # ``_ivf_calls`` removed slots from the index alone: drop their ids
    # (bulk-loaded as the slot numbers) from the store's registry too, so
    # heal's integrity layer finds the two in step
    for slot in ans["ivf_removed_slots"][0]:
        if db.store.registries[0].remove(str(int(slot))) is None:
            fail(f"{label}: id {slot} not in the registry")
    _inject_fault(engine)
    t0 = time.perf_counter()
    report = db.heal(allow_remesh=True)
    heal_s = time.perf_counter() - t0
    engine.__dict__.pop("_probe", None)
    if report["remeshed_to"] != names[:7] or \
            report["rehost"] != {"0": "live"} or \
            report["unrecovered_shards"] or index.n_devices != 7 or \
            not index.is_trained or db.store.indices[0] is not index:
        fail(f"{label}: heal {report}")
    # 128 tuning queries: the recall of a 64-query sample varies by
    # ~0.007 (k=10), as much as the margin between the tuner's 0.97 on
    # the index's own scan and the 0.95 gate against the float32 oracle
    t0 = time.perf_counter()
    tuned = index.tune(held_np[:128], k=k, target_recall=DENSE_TUNE)
    tune_s = time.perf_counter() - t0
    own = len(index.mesh.local_positions)
    flat_errs = []

    def quota_call(run):
        _reset()
        got = run()
        c = _counts()
        _tally(counts, label, c)
        if _nonzero(c):
            fail(f"{label}: the quota route launched {_nonzero(c)}")
        return got

    body = want_body("bfloat16", "bfloat16", d, 128, k)
    with _K1Recorder() as rec:
        def flat_call(run):
            got = _mp_call(rec, label, run, counts, own, 2, body,
                           "fused_topk_partial[bfloat16]")
            flat_errs.append(_check_k1_launches(f"{label}/flat route",
                                                rec.last, errs))
            return got

        ans.update(_heal_calls(index, held_np, picks, quota_call, flat_call))
    index.save(os.path.join(tmp, "mp_heal"))
    t0 = time.perf_counter()
    db.store.save()
    save_s = time.perf_counter() - t0
    index.clear()
    t0 = time.perf_counter()
    again = db.heal()
    ckpt_s = time.perf_counter() - t0
    if again["recovered_shards"] != [0] or again["remeshed_to"] or \
            not index.is_trained or index.n_devices != 7:
        fail(f"{label}: the checkpoint heal {again}")
    index.batch_flat_fallback = False
    back = quota_call(lambda: index.search(held_np[:128], k))
    if not (np.array_equal(back[1], ans["heal_search"][1][:128])
            and np.array_equal(back[0], ans["heal_search"][0][:128])):
        fail(f"{label}: the checkpoint heal answers otherwise")
    out = {"heal_s": heal_s, "rehost": report["rehost"],
           "remeshed_to": report["remeshed_to"],
           "nlist": int(index._centroids.shape[0]), "nprobe": index.nprobe,
           "tuned_recall_vs_index_exact": tuned, "tune_s": tune_s,
           "store_save_s": save_s, "checkpoint_heal_s": ckpt_s,
           "search_b128_ms": _wall_ms(lambda: index.search(
               held_np[:128], k), reps=5)}
    # every position of rank 1 fails its probe: heal onto rank 0 alone
    # (rank 1 holds none and keeps answering), then, the probe passing
    # again, back onto the 8 positions the engine started on
    one_rank = {}
    for step, want in (("heal_one", names[:4]), ("heal_back", names)):
        if step == "heal_one":
            _inject_fault(engine, every=True)
        t0 = time.perf_counter()
        got = db.heal(allow_remesh=True)
        step_s = time.perf_counter() - t0
        engine.__dict__.pop("_probe", None)
        mine = len(index.mesh.local_positions)
        if got["remeshed_to"] != want or got["rehost"] != {"0": "live"} \
                or got["unrecovered_shards"] or \
                index.n_devices != len(want) or not index.is_trained or \
                mine != (4 if step == "heal_back" or engine.mesh.rank == 0
                         else 0):
            fail(f"{label}/{step}: heal {got}, {mine} positions here")
        t0 = time.perf_counter()
        tuned1 = index.tune(held_np[:128], k=k, target_recall=DENSE_TUNE)
        tune1_s = time.perf_counter() - t0
        with _K1Recorder() as rec:
            def flat_call(run):
                own1 = len(index.mesh.local_positions)
                spread = len(set(index.mesh.owners)) > 1
                got1 = _mp_call(rec, label, run, counts, own1,
                                int(own1 > 0) + int(spread), body,
                                "fused_topk_partial[bfloat16]")
                flat_errs.append(_check_k1_launches(
                    f"{label}/{step}/flat route", rec.last, errs))
                return got1

            calls = _heal_calls(index, held_np, picks, quota_call, flat_call)
        ans.update({f"{step}/{key}": v for key, v in calls.items()})
        index.save(os.path.join(tmp, f"mp_{step}"))
        one_rank[step] = {
            "heal_s": step_s, "remeshed_to": got["remeshed_to"],
            "local_positions": mine, "nlist": int(index._centroids.shape[0]),
            "nprobe": index.nprobe, "tuned_recall_vs_index_exact": tuned1,
            "tune_s": tune1_s, "search_b128_ms": _wall_ms(
                lambda: index.search(held_np[:128], k), reps=5),
            "remesh": index.last_remesh}
    return dict(out, one_rank=one_rank,
                max_abs_err_vs_plain=max(flat_errs))


def _heal_calls(index, held, picks, quota_call, flat_call):
    """The healed IVF index's searches, which the parent replays: two
    B=128 searches (the quota scan), the 10% filter (pushdown) and the 1%
    one (exact masked, K1 a shard)."""
    import numpy as np

    k = 10
    index.batch_flat_fallback = False
    two = [quota_call(lambda i=i: index.search(held[i:i + 128], k))
           for i in (0, 128)]
    m10, m1 = (_slot_mask(index.capacity, p) for p in picks)
    return {"heal_search": tuple(np.concatenate(z) for z in zip(*two)),
            "heal_f10": quota_call(
                lambda: index.search(held[:128], k, slot_mask=m10)),
            "heal_f1": flat_call(
                lambda: index.search(held[:128], k, slot_mask=m1))}


def _bg_writes(n, mix, seed, first):
    """The background window's writes: 64 updated slots, 320 new rows
    (the first 64 the updates, the rest two adds of 128) and 1,024
    removed slots (the first search's best hits among them), disjoint."""
    import numpy as np

    rng = np.random.default_rng(seed + 37)
    pool = rng.permutation(n)
    pool = pool[~np.isin(pool, first)]
    upd = np.sort(pool[:64])
    removed = np.concatenate([first, pool[64:64 + MP_REMOVED - len(first)]])
    return upd, removed.astype(np.int64), mix(7777, 320)


def _rank_background(c, engine, mix, q64, pick, ans, counts, errs, seed):
    """``build_background()`` on the sharded clustered index in a thread
    of this rank, while this thread makes the same calls as the other
    rank: B=64 searches (K3 on the rank's shards), two adds of 128, 64
    updates, 1,024 removals, the 1% filter (K2), then searches until the
    swap; every launch against its plain version. After the swap: every
    written row is found, every removed one gone; then the remesh to 7
    with the clustered rebuild. Returns the rank's report."""
    import threading

    import numpy as np
    import torch

    from wdbx_tpu_torch.parallel import collective

    label, k, d, n = "multiprocess_background", 10, SC_D, SC_N
    body3 = want_body("int8", "bfloat16", d, 64, k)
    i8 = "fused_topk_partial[int8]"
    own = MP_POSITIONS
    mask = _slot_mask(c.capacity, pick)
    first = np.unique(c.search(q64, k)[1][:, 0])
    upd, removed, new = _bg_writes(n, mix, seed, first)
    new_np = new.cpu().numpy()
    box = []
    thread = threading.Thread(
        target=lambda: box.append(c.build_background()), daemon=True)
    err = 0.0
    with _K3Recorder() as rec, _K1Recorder() as k1:
        def search(name, q=q64, k3=own):
            nonlocal err
            got = _sc_call(rec, label, lambda: c.search(q, k), counts, k3, 2,
                           want_body("int8", "bfloat16", d, len(q), k))
            err = max(err, _check_k3_launches(f"{label}/{name}", rec.last,
                                              errs)[0])
            return got

        def filtered(name):
            nonlocal err
            got = _mp_call(k1, label, lambda: c.search(q64, k,
                                                       slot_mask=mask),
                           counts, own, 2, body3, i8)
            err = max(err, _check_k1_launches(f"{label}/{name}", k1.last,
                                              errs))
            return got

        group_before = collective.stats(by_group=True).get("background", {})
        thread.start()
        while c._bg_win is None and thread.is_alive():
            time.sleep(0.001)
        t0 = time.perf_counter()
        ans["bg_s0"] = search("s0")
        added = [np.asarray(c.add_batch(new_np[64:192]))]
        c.update_slots(upd, new_np[:64])
        added.append(np.asarray(c.add_batch(new_np[192:])))
        c.remove_slots(removed)
        ans["bg_s1"] = search("s1")
        ans["bg_f1"] = filtered("f1")
        extra = 0
        while getattr(c, "last_background", None) is None:
            search(f"extra{extra}")  # the foreground goes on to the swap
            extra += 1
        window_wall_s = time.perf_counter() - t0
        thread.join(120)
        if thread.is_alive() or box != [None]:
            fail(f"{label}: the background build did not end well: {box}")
        # step (2)'s traffic: the background group's collectives alone
        group = {kind: {key: v - group_before.get(kind, {}).get(key, 0)
                        for key, v in st.items()}
                 for kind, st in collective.stats(by_group=True)[
                     "background"].items()}
        bg = dict(c.last_background)
        if bg["outcome"] != "swap":
            fail(f"{label}: the window ended in {bg}")
        ans["bg_final"] = search("final")
        ans["bg_final_f1"] = filtered("final f1")
        written = np.concatenate([upd, *added])
        ans["bg_written"] = search("written", new_np)
        ans["bg_write_slots"] = (written, np.asarray(
            [len(added[0]), len(added[1])]))
        ans["bg_removed"] = (removed, upd)
        if not np.array_equal(ans["bg_written"][1][:, 0], written):
            fail(f"{label}: an acknowledged write is not found")
        if any(np.isin(ans[key][1], removed).any() for key in (
                "bg_final", "bg_final_f1", "bg_written")):
            fail(f"{label}: a removed slot was returned")
        # what one agreement costs: the 8-byte all-gather alone
        one = torch.tensor([1], dtype=torch.int64)
        agree_ms = _wall_ms(lambda: collective.all_gather(one), reps=50,
                            warm=5)
        m7 = _degraded7(engine)
        before = collective.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.remesh(m7)
        torch.cuda.synchronize()
        remesh_s = time.perf_counter() - t0
        coll = _coll_since(before)
        ans["bg_remesh7"] = search("remesh7", k3=len(m7.local_positions))
    return {**bg, "window_wall_s": window_wall_s, "extra_searches": extra,
            "background_group": group,
            "agreement_ms": agree_ms, "remesh7_s": remesh_s,
            "remesh7_move": c.last_remesh,
            "remesh7_all_to_all_mb": coll.get("all_to_all", {}).get(
                "bytes", 0) / 1e6,
            "max_abs_err_vs_plain": err}


MP_IVF_CONFIG = {"INDEX_TYPE": "sharded_ivf", "INDEX_DTYPE": "bfloat16",
                 "IVF_NLIST": 1024, "IVF_TRAIN_THRESHOLD": 1 << 62,
                 "INDEX_CAPACITY": 1 << 20, "RAW_STORE": "none",
                 "VECTOR_STORE_AUTOSAVE_INTERVAL": 0}


def _written_rows(seed):
    """The 64 unit rows the replicated path writes: 32 updates, 32 adds."""
    import numpy as np

    new = np.random.default_rng(seed + 23).standard_normal(
        (64, 384)).astype(np.float32)
    return new / np.linalg.norm(new, axis=1, keepdims=True)


def _rank_replicated(x, qs, removed, ans, counts, errs, tmp, seed):
    """``make_mesh2(2)`` on the two ranks: each holds one full copy of 4
    shards. The flat point in bf16 and int8: B=128 and B=1 (group 0's
    slice is empty, so rank 0 launches nothing and still joins the
    answers' gather), search_pipelined, the flat path's removals, then
    updates and adds that both copies take (read back from each rank's
    own copy, and searched by both groups), npz and per-position round
    trips. Returns the rank's report."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.kernels import fused_topk as tf
    from wdbx_tpu_torch.parallel import ShardedFlatIndex, collective
    from wdbx_tpu_torch.parallel.mesh import make_mesh2

    mesh = make_mesh2(2)
    rank = mesh.rank
    if mesh.local_groups != (rank,) or mesh.shape != {
            "replica": 2, "shard": MP_POSITIONS}:
        fail(f"rank {rank}: replicated mesh {mesh.shape} groups "
             f"{mesh.local_groups}")
    k, nb, b = 10, qs.shape[0], qs.shape[1]
    half = b // 2
    qstack = torch.as_tensor(qs, device="cuda")
    label = "multiprocess_replicated"
    out = {}
    for dtype in ("bfloat16", "int8"):
        key = f"fused_topk_partial[{dtype}]"
        idx = ShardedFlatIndex(384, dtype=dtype, capacity=N_ROWS, mesh=mesh)
        t0 = time.perf_counter()
        idx.add_batch(x)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        with _K1Recorder() as k1:
            ans[f"rep_{dtype}"] = _mp_call(
                k1, label, lambda: idx.search(qs[0], k), counts,
                MP_POSITIONS, 1, want_body(dtype, "bfloat16", 384, half, k),
                key)
            err = _check_k1_launches(f"{label}/{dtype}/search", k1.last,
                                     errs)
        search_ms = _wall_ms(lambda: idx.search(qs[0], k), reps=10, warm=2)
        if dtype == "int8":
            out["int8"] = {"add_s": add_s, "search_b128_ms": search_ms,
                           "max_abs_err_vs_plain": err}
            del idx
            break
        with _K1Recorder() as k1:
            ans["rep_b1"] = _mp_call(
                k1, label, lambda: idx.search(qs[1][:1], k), counts,
                MP_POSITIONS * rank, rank,
                want_body(dtype, "bfloat16", 384, 1, k), key)
            err = max(err, _check_k1_launches(f"{label}/b1", k1.last, errs))
            ans["rep_pipelined"] = _mp_call(
                k1, label, lambda: idx.search_pipelined(qstack, k), counts,
                MP_POSITIONS, 1,
                want_body(dtype, "bfloat16", 384, nb * half, k), key)
            err = max(err, _check_k1_launches(f"{label}/pipelined", k1.last,
                                              errs))
            idx.remove_slots(removed)
            ans["rep_removed"] = _mp_call(
                k1, label, lambda: idx.search(qs[0], k), counts,
                MP_POSITIONS, 1, want_body(dtype, "bfloat16", 384, half, k),
                key)
            err = max(err, _check_k1_launches(f"{label}/removed", k1.last,
                                              errs))
        b1_ms = _wall_ms(lambda: idx.search(qs[1][:1], k), reps=10, warm=2)
        pipe_ms = _wall_ms(lambda: idx.search_pipelined(qstack, k),
                           reps=3) / nb
        v = torch.zeros((b, k), device="cuda")
        i = torch.zeros((b, k), dtype=torch.int64, device="cuda")
        share_ms = _wall_ms(lambda: idx._serve(
            b, k, lambda g, lo, hi: (v[lo:hi], i[lo:hi]),
            tf.merge_partials), reps=20, warm=2)
        # writes both copies take: 32 updates and 32 adds, read back from
        # this rank's own copy; each group searches all 64
        new = _written_rows(seed)
        upd = np.setdiff1d(np.arange(4096), removed)[:32]
        idx.update_slots(upd, new[:32])
        added = idx.add_batch(new[32:])
        written = np.concatenate([upd, np.asarray(added, np.int64)])
        ans["rep_written"] = (idx.get_vectors(written), written)
        found = idx.search(np.concatenate([new, new]), 1)
        if not np.array_equal(found[1][:, 0], np.concatenate([written] * 2)):
            fail(f"{label}: a written row is not found by both groups")
        ans["rep_found"] = found
        ans["rep_count"] = (np.asarray([idx.count(), idx.valid_count()]),
                            np.asarray([idx.get_stats()["size"],
                                        idx.get_stats()["replicas"]]))
        q = qs[2]
        ans["rep_final"] = idx.search(q, k)
        # checkpoints: rank 0 writes its copy (npz, or 4 files); every
        # rank loads it into the group it holds
        saves = {}
        for backend in ("npz", "orbax"):
            idx.persist_backend = backend
            path = os.path.join(tmp, f"mp_rep_{backend}")
            t0 = time.perf_counter()
            idx.save(path)
            save_s = time.perf_counter() - t0
            back = ShardedFlatIndex(384, dtype=dtype, capacity=N_ROWS,
                                    mesh=mesh)
            back.persist_backend = backend
            t0 = time.perf_counter()
            if not back.load(path):
                fail(f"{label}: the {backend} checkpoint did not load")
            load_s = time.perf_counter() - t0
            again = back.search(q, k)
            if not (np.array_equal(again[1], ans["rep_final"][1])
                    and np.array_equal(again[0], ans["rep_final"][0])):
                fail(f"{label}: the {backend} round trip answers otherwise")
            saves[backend] = {"save_s": save_s, "load_s": load_s}
            del back
        out["bfloat16"] = {
            "add_s": add_s, "search_b128_ms": search_ms, "search_b1_ms":
            b1_ms, "pipelined_ms_per_batch": pipe_ms,
            "answers_gather_ms": share_ms, "checkpoints": saves,
            "max_abs_err_vs_plain": err}
        del idx
        torch.cuda.empty_cache()
    out["collectives"] = collective.stats()
    return out


def _rank_replicated_clustered(chunks, q64, qstack_c, pick, ans, counts,
                               errs, tmp):
    """``ShardedClusteredIndex`` on ``make_mesh2(2)`` at the sharded
    clustered point: the build (rank 0 trains and assigns on its own
    copy, no row moves), search, search_pipelined, the 1% filter (exact
    masked, K2 a shard); then the unreplicated ranks' checkpoint loaded
    on this mesh (the same layout: the same answers). Returns the rank's
    report."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.parallel import ShardedClusteredIndex, collective
    from wdbx_tpu_torch.parallel.mesh import make_mesh2

    n, d, nlist, k = SC_N, SC_D, SC_NLIST, 10
    nbc, bc = qstack_c.shape[0], qstack_c.shape[1]
    mesh = make_mesh2(2)
    label = "multiprocess_replicated_clustered"
    c = ShardedClusteredIndex(d, dtype="int8", capacity=n, mesh=mesh,
                              nlist=nlist, nprobe=4, train_threshold=1 << 62)
    before = collective.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = c.build_from(chunks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_coll = _coll_since(before)
    if not np.array_equal(slots, np.arange(n)) or not c.is_trained:
        fail(f"{label}: the build")
    c.batch_flat_fallback = False
    body3 = want_body("int8", "bfloat16", d, bc // 2, k)
    with _K3Recorder() as rec:
        ans["rep_clustered"] = _sc_call(rec, label, lambda: c.search(q64, k),
                                        counts, MP_POSITIONS, 1, body3)
        err, _ = _check_k3_launches(f"{label}/search", rec.last, errs)
        ans["rep_clustered_pipelined"] = _sc_call(
            rec, label, lambda: c.search_pipelined(qstack_c, k), counts,
            MP_POSITIONS * nbc, nbc, body3)
        e, _ = _check_k3_launches(f"{label}/pipelined", rec.last, errs)
        err = max(err, e)
    mask = np.zeros(c.capacity, bool)
    mask[pick] = True
    if not c._filter_plan(mask, 4, nlist)[2]:
        fail(f"{label}: the 1% filter did not take the exact route")
    with _K1Recorder() as k1:
        ans["rep_clustered_filtered"] = _mp_call(
            k1, label, lambda: c.search(q64, k, slot_mask=mask), counts,
            MP_POSITIONS, 1, want_body("int8", "bfloat16", d, bc // 2, k),
            "fused_topk_partial[int8]")
        err = max(err, _check_k1_launches(f"{label}/filtered 1%", k1.last,
                                          errs))
    search_ms = _wall_ms(lambda: c.search(q64, k), reps=10, warm=3)
    pipe_ms = _wall_ms(lambda: c.search_pipelined(qstack_c, k),
                       reps=3) / nbc
    filter_ms = _wall_ms(lambda: c.search(q64, k, slot_mask=mask), reps=5,
                         warm=1)
    del c
    torch.cuda.empty_cache()
    back = ShardedClusteredIndex(d, dtype="int8", capacity=n, mesh=mesh,
                                 nlist=nlist, nprobe=4,
                                 train_threshold=1 << 62)
    t0 = time.perf_counter()
    if not back.load(os.path.join(tmp, "mp_clu")):
        fail(f"{label}: the unreplicated ranks' npz did not load")
    load_s = time.perf_counter() - t0
    back.batch_flat_fallback = False
    with _K3Recorder() as rec:
        ans["rep_clu_loaded"] = _sc_call(
            rec, label, lambda: back.search(q64, k), counts, MP_POSITIONS,
            1, body3)
        e, _ = _check_k3_launches(f"{label}/loaded", rec.last, errs)
        err = max(err, e)
        ans["rep_clu_loaded_pipelined"] = _sc_call(
            rec, label, lambda: back.search_pipelined(qstack_c, k), counts,
            MP_POSITIONS * nbc, nbc, body3)
        e, _ = _check_k3_launches(f"{label}/loaded pipelined", rec.last,
                                  errs)
        err = max(err, e)
    del back
    torch.cuda.empty_cache()
    return {"n": n, "d": d, "nlist": nlist, "b": bc, "k": k, "nprobe": 4,
            "build_s": build_s, "build_collectives": build_coll,
            "search_b64_ms": search_ms, "pipelined_ms_per_batch": pipe_ms,
            "filtered_1pct_ms": filter_ms, "npz_load_s": load_s,
            "max_abs_err_vs_plain": err}


def _ivf_data(seed):
    """The dense IVF point: 1,048,576 x 384 rows of a 1024-component
    mixture (noise 0.45/sqrt(d)) and 256 held-out queries, on the card."""
    import torch

    mix = _mixture(1024, 384, seed + 13, noise=0.45)
    return (torch.cat([mix(3000 + i, 1 << 18) for i in range(4)]),
            mix(4444, 256))


def _ivf_filters(seed, n):
    """The 10% and 1% filters' slots (the same on every rank)."""
    import numpy as np

    rng = np.random.default_rng(seed + 29)
    return (rng.choice(n, n // 10, replace=False),
            rng.choice(n, n // 100, replace=False))


def _slot_mask(capacity, pick):
    import numpy as np

    mask = np.zeros(capacity, bool)
    mask[pick] = True
    return mask


def _ivf_calls(index, held, picks, removed, quota_call, flat_call):
    """The sharded IVF searches the ranks make and the parent replays,
    in order: two B=128 searches and a pipelined NB=2 stack (the quota
    scan, fallback off), a 10% filter (pushdown) and a 1% one (exact
    masked, K1 a shard), the batch fallback (K1 a shard), then the
    removals and a search. ``quota_call`` / ``flat_call`` wrap the calls
    of each route."""
    import numpy as np

    k, d = 10, held.shape[1]
    out = {}
    index.batch_flat_fallback = False
    two = [quota_call(lambda i=i: index.search(held[i:i + 128], k))
           for i in (0, 128)]
    out["ivf_search"] = tuple(np.concatenate(z) for z in zip(*two))
    out["ivf_pipelined"] = quota_call(
        lambda: index.search_pipelined(held.reshape(2, 128, d), k))
    m10, m1 = (_slot_mask(index.capacity, p) for p in picks)
    out["ivf_f10"] = quota_call(
        lambda: index.search(held[:128], k, slot_mask=m10))
    out["ivf_f1"] = flat_call(
        lambda: index.search(held[:128], k, slot_mask=m1))
    index.batch_flat_fallback = True
    out["ivf_fallback"] = flat_call(lambda: index.search(held[:128], k))
    index.batch_flat_fallback = False
    index.remove_slots(removed)
    out["ivf_removed"] = quota_call(lambda: index.search(held[:128], k))
    return out


def _rank_ivf(tmp, seed, ans, counts, errs):
    """The production_serving deployment on the global mesh:
    ``WDBX(enable_distributed=True, INDEX_TYPE="sharded_ivf")`` at the
    dense IVF point, bulk-loaded, built across the ranks and tuned; the
    calls of ``_ivf_calls`` (the quota route launches no kernel: its
    counters must stay 0; the exact masked and fallback routes launch
    K1 on the rank's 4 shards and 2 merges, each against its plain
    version); the split of a B=128 search; per-position and npz round
    trips. The npz written after the tuning is what the parent replays
    the calls on. Returns the rank's report."""
    import asyncio

    import numpy as np
    import torch

    from wdbx_tpu_torch.core.wdbx import WDBX
    from wdbx_tpu_torch.ops.normalize import l2_normalize
    from wdbx_tpu_torch.parallel import ShardedIVFIndex, collective
    from wdbx_tpu_torch.parallel.sharded_ivf import _topk_merge

    label, k, d = "multiprocess_ivf", 10, 384
    rank = collective.rank_world()[0]
    xi, held = _ivf_data(seed)
    n = len(xi)
    db = WDBX(vector_dimension=d, enable_plugins=False,
              enable_distributed=True,
              data_dir=os.path.join(tmp, f"mp_ivf_db{rank}"),
              config=MP_IVF_CONFIG)
    asyncio.run(db.initialize())
    t0 = time.perf_counter()
    db.store.bulk_load([str(i) for i in range(n)], xi.cpu().numpy())
    load_s = time.perf_counter() - t0
    del xi
    torch.cuda.empty_cache()
    index = db.store.indices[0]
    if not isinstance(index, ShardedIVFIndex) or not index.mesh.is_global \
            or index.mesh.local_positions != tuple(range(
                rank * MP_POSITIONS, (rank + 1) * MP_POSITIONS)):
        fail(f"{label}: {type(index).__name__} on {index.mesh.names}")
    before = collective.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_coll = _coll_since(before)
    index.batch_flat_fallback = False
    held_np = held.cpu().numpy()
    t0 = time.perf_counter()
    tuned = index.tune(held_np[:64], k=k, target_recall=DENSE_TUNE)
    tune_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index.save(os.path.join(tmp, "mp_ivf"))
    npz_save_s = time.perf_counter() - t0

    def quota_call(run):
        _reset()
        got = run()
        c = _counts()
        _tally(counts, label, c)
        if _nonzero(c):
            fail(f"{label}: the quota route launched {_nonzero(c)}")
        return got

    flat_errs = []
    body = want_body("bfloat16", "bfloat16", d, 128, k)
    picks = _ivf_filters(seed, n)
    first = np.unique(np.concatenate([
        index.search(held_np[i:i + 128], k)[1][:, 0] for i in (0, 128)]))
    rest = np.random.default_rng(seed + 31).permutation(n)
    rest = rest[~np.isin(rest, first)][:MP_REMOVED - len(first)]
    removed = np.concatenate([first, rest]).astype(np.int64)
    with _K1Recorder() as rec:
        def flat_call(run):
            got = _mp_call(rec, label, run, counts, MP_POSITIONS, 2, body,
                           "fused_topk_partial[bfloat16]")
            flat_errs.append(_check_k1_launches(f"{label}/flat route",
                                                rec.last, errs))
            return got

        ans.update(_ivf_calls(index, held_np, picks, removed, quota_call,
                              flat_call))
    if np.isin(ans["ivf_removed"][1], removed).any():
        fail(f"{label}: a removed slot was returned")
    ans["ivf_picks"] = picks
    ans["ivf_removed_slots"] = (removed, removed)
    # the split of a B=128 search: the rank's quota scans and its merge
    # (no collective), the gather of every rank's (B, k), the final merge
    search_ms = _wall_ms(lambda: index.search(held_np[:128], k), reps=5)
    pipe_ms = _wall_ms(lambda: index.search_pipelined(
        held_np.reshape(2, 128, d), k), reps=3) / 2
    q = torch.as_tensor(held_np[:128], device="cuda")
    nprobe = index.nprobe
    quota = index._quota(128 * nprobe)
    qn = l2_normalize(q)  # the rank's shards alone, for the timing
    local_ms = _wall_ms(lambda: index._ivf_shards(
        qn, k, nprobe, quota, index._bucket_valid, index._valids), reps=5)
    v, i = index._ivf_shards(qn, k, nprobe, quota, index._bucket_valid,
                             index._valids)
    pv = torch.randn((128, 1, MP_POSITIONS * k), device="cuda")
    pi = torch.zeros((128, 1, MP_POSITIONS * k), dtype=torch.int64,
                     device="cuda")
    rank_merge_ms = cuda_ms(lambda: _topk_merge(pv, pi, k), reps=10)
    packed = torch.cat([v.contiguous().view(torch.int32),
                        i.to(torch.int32)], -1)
    gather_ms = _wall_ms(lambda: collective.all_gather(packed), reps=20,
                         warm=2)
    host = packed.cpu()
    gloo_ms = _wall_ms(lambda: collective.all_gather(host), reps=20, warm=2)
    every = collective.all_gather(packed)
    gv = every[..., :k].contiguous().view(torch.float32)
    gi = every[..., k:]
    gv, gi = gv.transpose(0, 1).contiguous(), gi.transpose(0, 1).contiguous()
    final_ms = cuda_ms(lambda: _topk_merge(gv, gi, k), reps=10)
    # per-position and npz round trips of the final state
    saves = {}
    for backend in ("orbax", "npz"):
        index.persist_backend = backend
        path = os.path.join(tmp, f"mp_ivf_{backend}")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        back = ShardedIVFIndex(d, dtype="bfloat16", capacity=n,
                               mesh=index.mesh, nlist=1024,
                               train_threshold=1 << 62)
        back.persist_backend = backend
        t0 = time.perf_counter()
        if not back.load(path) or not back.is_trained:
            fail(f"{label}: the {backend} checkpoint did not load")
        load_s2 = time.perf_counter() - t0
        back.batch_flat_fallback = False
        again = quota_call(lambda: back.search(held_np[:128], k))
        if not (np.array_equal(again[1], ans["ivf_removed"][1])
                and np.array_equal(again[0], ans["ivf_removed"][0])):
            fail(f"{label}: the {backend} round trip answers otherwise")
        saves[backend] = {"save_s": save_s, "load_s": load_s2}
        del back
    stats = index.get_stats()
    ans["ivf_count"] = (np.asarray([index.count(), index.valid_count()]),
                        np.asarray([stats["size"], stats["nprobe"]]))
    rep = {"n": n, "nlist": int(index._centroids.shape[0]),
           "cap_b": index._table_shape[1],
           "bulk_load_s": load_s, "build_s": build_s,
           "build_collectives": build_coll,
           "build_all_to_all_bytes": build_coll.get(
               "all_to_all", {}).get("bytes", 0),
           "tune_s": tune_s, "nprobe": nprobe,
           "tuned_recall_vs_index_exact": tuned, "npz_save_s": npz_save_s,
           "search_b128_ms": search_ms, "pipelined_ms_per_batch": pipe_ms,
           "split_b128": {"quota_scans_and_rank_merge_ms": local_ms,
                          "rank_merge_ms": rank_merge_ms,
                          "gather_ms": gather_ms,
                          "gather_gloo_only_ms": gloo_ms,
                          "final_merge_ms": final_ms},
           "checkpoints": saves,
           "max_abs_err_vs_plain": max(flat_errs)}
    rep["heal"] = _rank_heal(db, held_np, picks, ans, counts, errs, tmp)
    # no db.shutdown(): its store save would write the whole index again
    del db, index
    torch.cuda.empty_cache()
    return rep


MP_SPAN_RANKS = 4  # processes of the spanning spawn, sharing the card
MP_SPAN_POSITIONS = 2  # positions a rank there: the same 8 in all
#: B=128 ms a rank of earlier runs (PR 14's final run, H100 80GB HBM3,
#: 700 W): make_mesh2(2) on 2 ranks of 4 (a copy a rank), and the
#: unreplicated 8 positions on the same 2 ranks
EARLIER_B128_MS = {"replicated_within_rank_pr14": [3.93, 3.90],
                   "unreplicated_pr14": [4.69, 4.71]}


def _span_expect(index, b):
    """The launches one rank makes for a batch of ``b`` (or a flat
    pipelined stack of such batches: one launch a shard over all of
    them) on ``index``'s mesh: ``(stage-1 launches, merges)``. Stage 1
    a shard held of each group with queries, one merge of the rank's
    shards of each such group, and one merge a group whose shards lie on
    several ranks."""
    cuts = index._cuts(b)
    held = index._group_shards
    me = held[index._me]
    stage1 = merges = 0
    for g in range(index.replicas):
        if cuts[g + 1] == cuts[g]:
            continue
        if me[g]:
            stage1 += int(me[g])
            merges += 1
        merges += int((held[:, g] > 0).sum() > 1)
    return stage1, merges


def _span_call(rec, label, index, run, counts, errs, b, nb=1, key=None,
               dtype="bfloat16"):
    """``run()`` on ``index`` through ``_mp_call`` with the launches
    ``_span_expect`` gives for batches of ``b`` (``nb`` of them in one
    flat pipelined stack); every recorded K1 launch against its plain
    version. Returns the answer and the largest error."""
    stage1, merges = _span_expect(index, b)
    per = -(-b // index.replicas) * nb
    out = _mp_call(rec, label, run, counts, stage1, merges,
                   want_body(dtype, "bfloat16", index.dim, per, 10),
                   key or f"fused_topk_partial[{dtype}]")
    return out, _check_k1_launches(label, rec.last, errs)


def _span_main(rank, world, port, tmp, seed):
    """One rank of the ``multiprocess`` phase's second spawn:
    ``MP_SPAN_RANKS`` ranks of ``MP_SPAN_POSITIONS`` positions on the one
    card, the same 8 positions in all. ``make_mesh2(2)`` lays group 0 on
    ranks 0-1 and group 1 on ranks 2-3 (``_span_flat``,
    ``_span_clustered``); then meshes that leave ranks without a
    position (``_span_emptied``). Writes the rank's report and answers
    to ``tmp`` for the parent."""
    os.environ.update(WDBX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      WDBX_NUM_PROCESSES=str(world),
                      WDBX_PROCESS_ID=str(rank),
                      WDBX_TORCH_MESH_SIZE=str(MP_SPAN_POSITIONS))
    import asyncio

    import numpy as np
    import torch

    from wdbx_tpu_torch.core.config import WDBXConfig
    from wdbx_tpu_torch.parallel import ShardEngine, collective

    engine = ShardEngine(WDBXConfig(
        {"DATA_DIR": os.path.join(tmp, f"sp_engine{rank}")}))
    asyncio.run(engine.initialize())
    counts: dict[str, dict] = {}
    errs: dict[str, float] = {}
    rep = {"rank": rank, "counts": counts, "errs": errs}
    ans = {}
    x, qs = _data(N_ROWS, seed)
    rep["spanning"], idx, db = _span_flat(x, qs, ans, counts, errs, tmp)
    del x
    rep["emptied"] = _span_emptied(idx, db, qs, ans, counts, errs)
    del idx, db
    torch.cuda.empty_cache()
    rep["spanning_clustered"] = _span_clustered(seed, ans, counts, errs,
                                                tmp)
    rep["collectives"] = collective.stats()
    np.savez(os.path.join(tmp, f"sp_ans{rank}.npz"),
             **{f"{key}|{j}": np.asarray(v) for key, pair in ans.items()
                for j, v in enumerate(pair)})
    with open(os.path.join(tmp, f"sp_rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    collective.barrier()
    asyncio.run(engine.shutdown())
    print(f"rank {rank} done", flush=True)


def _span_flat(x, qs, ans, counts, errs, tmp):
    """``ShardedFlatIndex`` bf16 at bench.py's point on ``make_mesh2(2)``
    over 4 ranks of 2 positions: each group's 4 shards on two ranks.
    B=128, B=1 (group 0's slice is empty: ranks 0-1 launch nothing and
    still join the gather) and pipelined searches, each launch against
    its plain version, the gloo calls of a search, the split, the npz
    the parent reads; then the same rows through
    ``WDBX(enable_distributed=True, MESH_REPLICAS=2)``. Returns the
    rank's report, the index and the facade."""
    import asyncio

    import numpy as np
    import torch

    from wdbx_tpu_torch.core.wdbx import WDBX
    from wdbx_tpu_torch.ops.normalize import l2_normalize
    from wdbx_tpu_torch.parallel import ShardedFlatIndex, collective
    from wdbx_tpu_torch.parallel.mesh import make_mesh2

    label, k = "multiprocess_spanning", 10
    nb, b = qs.shape[0], qs.shape[1]
    mesh = make_mesh2(2)
    rank = mesh.rank
    if mesh.shape != {"replica": 2, "shard": 4} or \
            mesh.owners != (0, 0, 1, 1, 2, 2, 3, 3) or \
            mesh.local_groups != (rank // 2,):
        fail(f"{label}: rank {rank} mesh {mesh.shape} {mesh.owners} "
             f"{mesh.local_groups}")
    idx = ShardedFlatIndex(384, dtype="bfloat16", capacity=N_ROWS, mesh=mesh)
    t0 = time.perf_counter()
    idx.add_batch(x)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    qstack = torch.as_tensor(qs, device="cuda")
    g = rank // 2
    lo, hi = idx._cuts(b)[g:g + 2]
    qk = l2_normalize(torch.as_tensor(qs[0][lo:hi], device="cuda"))
    err = 0.0
    with _K1Recorder() as k1:
        before = collective.stats()
        ans["span_search"], e = _span_call(k1, label, idx,
                                           lambda: idx.search(qs[0], k),
                                           counts, errs, b)
        search_coll = _coll_since(before)
        err = max(err, e)
        before = collective.stats()
        ans["span_b1"], e = _span_call(k1, label, idx,
                                       lambda: idx.search(qs[1][:1], k),
                                       counts, errs, 1)
        b1_coll = _coll_since(before)
        err = max(err, e)
        before = collective.stats()
        ans["span_pipelined"], e = _span_call(
            k1, label, idx, lambda: idx.search_pipelined(qstack, k), counts,
            errs, b, nb)
        pipe_coll = _coll_since(before)
        err = max(err, e)
    for name, got in (("search", search_coll), ("b1", b1_coll),
                      ("pipelined", pipe_coll)):
        if {kind: c["calls"] for kind, c in got.items()} != \
                {"all_gather": 1}:
            fail(f"{label}/{name}: collectives {got}, not one all-gather")
    out = {"add_s": add_s,
           "search_b128_ms": _wall_ms(lambda: idx.search(qs[0], k), reps=10,
                                      warm=2),
           "search_b1_ms": _wall_ms(lambda: idx.search(qs[1][:1], k),
                                    reps=10, warm=2),
           "pipelined_ms_per_batch": _wall_ms(
               lambda: idx.search_pipelined(qstack, k), reps=3) / nb,
           "split_b128": _mp_split(idx, lambda: idx._shard_parts(
               g, qk, k, idx._valids, True), b, k),
           "search_collectives": search_coll, "b1_collectives": b1_coll,
           "pipelined_collectives": pipe_coll}
    t0 = time.perf_counter()
    idx.save(os.path.join(tmp, "sp_flat"))
    out["npz_save_s"] = time.perf_counter() - t0
    # the facade on the same layout: MESH_REPLICAS=2 over 4 ranks of 2
    db = WDBX(vector_dimension=384, enable_plugins=False,
              enable_distributed=True,
              data_dir=os.path.join(tmp, f"sp_db{rank}"),
              config={"INDEX_TYPE": "sharded_flat", "MESH_REPLICAS": 2,
                      "INDEX_DTYPE": "bfloat16",
                      "VECTOR_STORE_AUTOSAVE_INTERVAL": 0})
    asyncio.run(db.initialize())
    t0 = time.perf_counter()
    db.store.bulk_load([str(i) for i in range(N_ROWS)], x)
    torch.cuda.synchronize()
    out["facade_bulk_load_s"] = time.perf_counter() - t0
    fx = db.store.indices[0]
    if fx.mesh.owners != mesh.owners or fx.replicas != 2 or \
            fx.count() != N_ROWS:
        fail(f"{label}/facade: index on {fx.mesh.owners}, {fx.count()} rows")
    with _K1Recorder() as k1:
        hits, e = _span_call(
            k1, label, fx, lambda: db.vector_search_batch(qs[0], limit=k),
            counts, errs, b)
    err = max(err, e)
    ans["span_facade"] = (
        np.asarray([[h[1] for h in row] for row in hits], np.float32),
        np.asarray([[int(h[0]) for h in row] for row in hits]))
    out["facade_search_b128_ms"] = _wall_ms(
        lambda: db.vector_search_batch(qs[0], limit=k), reps=5, warm=1)
    out["max_abs_err_vs_plain"] = err
    return out, idx, db


def _span_emptied(idx, db, qs, ans, counts, errs):
    """Meshes that leave ranks without a position, at the flat point:
    the spanning index remeshed live onto ``make_mesh(3)`` (rank 3 holds
    nothing) and onto ``make_mesh2(2, 2)`` (ranks 2-3 hold nothing); then
    the facade's deployment with every position of rank 3 failing its
    probe: ``heal`` re-stripes onto ranks 0-2, and, the probe passing
    again, back onto the 8. A B=128 search at each step, each launch
    against its plain version. Returns the rank's report: the remesh
    seconds and bytes sent, the heal seconds."""
    from wdbx_tpu_torch.parallel.mesh import make_mesh, make_mesh2

    label, k = "multiprocess_emptied", 10
    rank = idx.mesh.rank
    out = {}
    err = 0.0
    with _K1Recorder() as k1:
        for step, make in (("mesh3", lambda: make_mesh(3)),
                           ("mesh2x2", lambda: make_mesh2(2, 2))):
            mesh = make()
            idx.remesh(mesh)
            ans[f"emptied_{step}"], e = _span_call(
                k1, label, idx, lambda: idx.search(qs[0], k), counts, errs,
                qs.shape[1])
            err = max(err, e)
            out[step] = {"owners": list(mesh.owners),
                         "local_positions": len(mesh.local_positions),
                         "remesh": idx.last_remesh,
                         "search_b128_ms": _wall_ms(
                             lambda: idx.search(qs[0], k), reps=5, warm=1)}
        engine, fx = db.shard_engine, db.store.indices[0]
        for step in ("heal_down", "heal_back"):
            if step == "heal_down":
                _inject_fault(engine, rank=MP_SPAN_RANKS - 1, every=True)
            t0 = time.perf_counter()
            got = db.heal(allow_remesh=True)
            heal_s = time.perf_counter() - t0
            engine.__dict__.pop("_probe", None)
            want = 6 if step == "heal_down" else 8
            if len(got["remeshed_to"]) != want or \
                    got["rehost"] != {"0": "live"} or fx.n_devices != want:
                fail(f"{label}/{step}: heal {got}")
            ans[f"emptied_{step}"], e = _span_call(
                k1, label, fx, lambda: fx.search(qs[0], k), counts, errs,
                qs.shape[1])
            err = max(err, e)
            out[step] = {"owners": list(fx.mesh.owners),
                         "local_positions": len(fx.mesh.local_positions),
                         "heal_s": heal_s, "remesh": fx.last_remesh,
                         "search_b128_ms": _wall_ms(
                             lambda: fx.search(qs[0], k), reps=5, warm=1)}
    if out["mesh3"]["local_positions"] != (0 if rank == 3 else 1) or \
            out["heal_down"]["local_positions"] != (0 if rank == 3 else 2):
        fail(f"{label}: rank {rank} holds {out}")
    out["max_abs_err_vs_plain"] = err
    return out


def _span_clustered(seed, ans, counts, errs, tmp):
    """``ShardedClusteredIndex`` on ``make_mesh2(2)`` over 4 ranks of 2
    positions at the sharded clustered point (2M x 768 int8, nlist 2048,
    nprobe 4, B=64): the build (rank 0 trains; rows travel to both
    copies of their shard), search and search_pipelined (K3 on the
    rank's 2 shards of its group's 32 queries a batch, each launch
    against its plain version), the 1% filter (the exact masked route,
    K2 on the rank's shards), the npz the parent reads. Returns the
    rank's report."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.parallel import ShardedClusteredIndex, collective
    from wdbx_tpu_torch.parallel.mesh import make_mesh2

    label, k = "multiprocess_spanning", 10
    n, d, nlist, bc, nbc = SC_N, SC_D, SC_NLIST, 64, 8
    mix = _mixture(4096, d, seed + 17)

    def chunks():
        for i, lo in enumerate(range(0, n, SC_STEP)):
            yield mix(5000 + i, min(SC_STEP, n - lo))

    c = ShardedClusteredIndex(d, dtype="int8", capacity=n, mesh=make_mesh2(2),
                              nlist=nlist, nprobe=4, train_threshold=1 << 62)
    before = collective.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = c.build_from(chunks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_coll = _coll_since(before)
    if not np.array_equal(slots, np.arange(n)) or not c.is_trained:
        fail(f"{label}/clustered: the build")
    c.batch_flat_fallback = False
    q_all = mix(9999, nbc * bc)
    qstack_c = q_all.reshape(nbc, bc, d)
    q64 = q_all[:bc]
    stage1, merges = _span_expect(c, bc)
    body3 = want_body("int8", "bfloat16", d, bc // 2, k)
    with _K3Recorder() as rec:
        before = collective.stats()
        ans["span_clustered"] = _sc_call(rec, label, lambda: c.search(q64, k),
                                         counts, stage1, merges, body3)
        search_coll = _coll_since(before)
        err, _ = _check_k3_launches(f"{label}/clustered", rec.last, errs)
        ans["span_clustered_pipelined"] = _sc_call(
            rec, label, lambda: c.search_pipelined(qstack_c, k), counts,
            stage1 * nbc, merges * nbc, body3)
        e, _ = _check_k3_launches(f"{label}/clustered pipelined", rec.last,
                                  errs)
        err = max(err, e)
    if {kind: s["calls"] for kind, s in search_coll.items()} != \
            {"all_gather": 1}:
        fail(f"{label}/clustered: collectives {search_coll}")
    pick = np.random.default_rng(seed).choice(n, n // 100, replace=False)
    mask = np.zeros(c.capacity, bool)
    mask[pick] = True
    if not c._filter_plan(mask, 4, nlist)[2]:
        fail(f"{label}/clustered: the 1% filter did not take the exact route")
    with _K1Recorder() as k1:
        ans["span_clustered_filtered"], e = _span_call(
            k1, label, c, lambda: c.search(q64, k, slot_mask=mask), counts,
            errs, bc, dtype="int8")
        err = max(err, e)
    ans["span_filter_pick"] = (pick, pick)
    out = {"n": n, "d": d, "nlist": nlist, "b": bc, "k": k, "nprobe": 4,
           "build_s": build_s, "build_collectives": build_coll,
           "search_collectives": search_coll,
           "search_b64_ms": _wall_ms(lambda: c.search(q64, k), reps=10,
                                     warm=3),
           "pipelined_ms_per_batch": _wall_ms(
               lambda: c.search_pipelined(qstack_c, k), reps=3) / nbc,
           "filtered_1pct_ms": _wall_ms(
               lambda: c.search(q64, k, slot_mask=mask), reps=5, warm=1)}
    t0 = time.perf_counter()
    c.save(os.path.join(tmp, "sp_clu"))
    out["npz_save_s"] = time.perf_counter() - t0
    out["max_abs_err_vs_plain"] = err
    del c
    torch.cuda.empty_cache()
    return out


def _check_mp_spanning(reps, ans, qs, truth, q_all, truth_src, t_src,
                       paths, errs, tmp):
    """The 4-rank spawn: one process's 8-position index on the same
    layout (``make_mesh2(2, 4)``) loaded from the ranks' npz; every
    flat answer (spanning, facade, each emptied step) against the plain
    version over the whole slab and against that index; the clustered
    answers against it (its launches against their plain version) and
    the 1% filter against K2's plain version; recall@10 of the pipelined
    answers against the float32 oracles."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.parallel import (
        ShardedClusteredIndex,
        ShardedFlatIndex,
    )
    from wdbx_tpu_torch.parallel.mesh import make_mesh2

    label, k = "multiprocess_spanning", 10
    nb, b = qs.shape[0], qs.shape[1]
    single = ShardedFlatIndex(384, dtype="bfloat16", capacity=N_ROWS,
                              mesh=make_mesh2(2, 4))
    t0 = time.perf_counter()
    if not single.load(os.path.join(tmp, "sp_flat")):
        fail(f"{label}: the ranks' npz did not load")
    load_s = time.perf_counter() - t0
    view = _slot_view(single)
    err = _check_sharded(f"{label}/search", single, view, qs[0],
                         ans["span_search"])
    err = max(err, _check_sharded(f"{label}/b1", single, view, qs[1][:1],
                                  ans["span_b1"]))
    for i in range(nb):
        err = max(err, _check_sharded(
            f"{label}/pipelined batch{i}", single, view, qs[i],
            (ans["span_pipelined"][0][i], ans["span_pipelined"][1][i])))
    err = max(err, _same_answers(f"{label}/single process",
                                 single.search(qs[0], k), ans["span_search"]))
    err = max(err, _same_answers(f"{label}/facade", ans["span_search"],
                                 ans["span_facade"]))
    recall = _recall_slots(ans["span_pipelined"][1].reshape(nb * b, k), truth)
    e_err = 0.0
    for step in ("mesh3", "mesh2x2", "heal_down", "heal_back"):
        got = ans[f"emptied_{step}"]
        e_err = max(e_err, _check_sharded(f"multiprocess_emptied/{step}",
                                          single, view, qs[0], got))
        e_err = max(e_err, _same_answers(
            f"multiprocess_emptied/{step} as spanning", ans["span_search"],
            got))
    del single, view
    torch.cuda.empty_cache()
    csingle = ShardedClusteredIndex(SC_D, dtype="int8", capacity=SC_N,
                                    mesh=make_mesh2(2, 4), nlist=SC_NLIST,
                                    nprobe=4, train_threshold=1 << 62)
    if not csingle.load(os.path.join(tmp, "sp_clu")):
        fail(f"{label}: the ranks' clustered npz did not load")
    csingle.batch_flat_fallback = False
    q64 = q_all[:64]
    with _K3Recorder() as rec:
        ref = csingle.search(q64, k)
        c_err = _check_sc_calls(f"{label}/clustered single", csingle,
                                rec.take(), ref, errs)
        refp = csingle.search_pipelined(q_all.reshape(-1, 64, SC_D), k)
        c_err = max(c_err, _check_sc_calls(
            f"{label}/clustered single pipelined", csingle, rec.take(), refp,
            errs))
    c_err = max(c_err, _same_answers(f"{label}/clustered", ref,
                                     ans["span_clustered"]))
    c_err = max(c_err, _same_answers(f"{label}/clustered pipelined", refp,
                                     ans["span_clustered_pipelined"]))
    pick = ans["span_filter_pick"][0]
    mask = np.zeros(csingle.capacity, bool)
    mask[pick] = True
    pm = csingle._filter_plan(mask, 4, SC_NLIST)[0]
    c_err = max(c_err, _check_sc_flat(f"{label}/clustered filtered 1%",
                                      csingle, q64, pm,
                                      ans["span_clustered_filtered"], errs))
    del csingle
    torch.cuda.empty_cache()
    recall_c = _slot_recall(torch.as_tensor(
        ans["span_clustered_pipelined"][1].reshape(-1, k)), truth_src.cpu())
    recall_f = _slot_recall(torch.as_tensor(
        ans["span_clustered_filtered"][1]), t_src.cpu())
    sp = [r["spanning"] for r in reps]
    sc = [r["spanning_clustered"] for r in reps]
    emit({"phase": "multiprocess", "path": label, "ranks": MP_SPAN_RANKS,
          "positions_per_rank": MP_SPAN_POSITIONS, "replicas": 2,
          "shards": 4, "owners": [0, 0, 1, 1, 2, 2, 3, 3],
          "dtype": "bfloat16", "n": N_ROWS, "b": b, "k": k, "nb": nb,
          **{key: [r[key] for r in sp] for key in (
              "add_s", "search_b128_ms", "search_b1_ms",
              "pipelined_ms_per_batch", "split_b128", "search_collectives",
              "b1_collectives", "pipelined_collectives", "npz_save_s",
              "facade_bulk_load_s", "facade_search_b128_ms")},
          "earlier_runs_b128_ms": EARLIER_B128_MS,
          "npz_load_single_process_s": load_s,
          "recall_at_10_raw": recall, "bar": RECALL_BAR,
          "clustered": {
              **{key: sc[0][key] for key in ("n", "d", "nlist", "b", "k",
                                             "nprobe")},
              **{key: [r[key] for r in sc] for key in (
                  "build_s", "build_collectives", "search_collectives",
                  "search_b64_ms", "pipelined_ms_per_batch",
                  "filtered_1pct_ms", "npz_save_s")},
              "recall_at_10_nprobe4": recall_c,
              "recall_at_10_filtered_1pct": recall_f, "bar": FACADE_BAR},
          "collectives": [r["collectives"] for r in reps],
          "max_abs_err_vs_plain": max(err, c_err, *(
              r["max_abs_err_vs_plain"] for r in sp + sc)), "tol": ATOL,
          "launches": _nonzero(paths[label]),
          "launches_by_rank": [_nonzero(r["counts"][label]) for r in reps]})
    em = [r["emptied"] for r in reps]
    emit({"phase": "multiprocess", "path": "multiprocess_emptied",
          "ranks": MP_SPAN_RANKS, "dtype": "bfloat16", "n": N_ROWS, "b": b,
          "k": k, **{step: {
              "owners": em[0][step]["owners"],
              **{key: [r[step][key] for r in em] for key in (
                  "local_positions", "search_b128_ms", "remesh") +
                 (("heal_s",) if step.startswith("heal") else ())}}
              for step in ("mesh3", "mesh2x2", "heal_down", "heal_back")},
          "max_abs_err_vs_plain": max(e_err, *(r["max_abs_err_vs_plain"]
                                               for r in em)), "tol": ATOL,
          "launches": _nonzero(paths["multiprocess_emptied"]),
          "launches_by_rank": [_nonzero(r["counts"]["multiprocess_emptied"])
                               for r in reps]})
    if recall < RECALL_BAR:
        fail(f"{label}: recall@10 {recall} < {RECALL_BAR}")
    if recall_c < FACADE_BAR or recall_f < FACADE_BAR:
        fail(f"{label}: clustered recall@10 {recall_c} / {recall_f} < "
             f"{FACADE_BAR}")


def _mp_load(tmp, rank, prefix="mp"):
    import numpy as np

    with open(os.path.join(tmp, f"{prefix}_rank{rank}.json")) as f:
        rep = json.load(f)
    ans = {}
    with np.load(os.path.join(tmp, f"{prefix}_ans{rank}.npz")) as data:
        for name in data.files:
            key, j = name.split("|")
            ans.setdefault(key, [None, None])[int(j)] = data[name]
    return rep, ans


def _same_answers(name, ref, got, tol=MATCH_TOL) -> float:
    """Two answers (host scores and slots, (..., B, k)) hold the same hits
    row by row (``_same_hits``)."""
    import numpy as np

    rs, ri = (np.asarray(a).reshape(-1, np.asarray(a).shape[-1])
              for a in ref)
    gs, gi = (np.asarray(a).reshape(rs.shape) for a in got)
    err = 0.0
    for row in range(rs.shape[0]):
        r = [(int(i), float(v)) for i, v in zip(ri[row], rs[row]) if i >= 0]
        g = [(int(i), float(v)) for i, v in zip(gi[row], gs[row]) if i >= 0]
        err = max(err, _same_hits(f"{name}/row{row}", r, g, tol))
    return err


def _run_mp_ranks(tmp, seed, world=MP_RANKS, entry="_rank_main",
                  prefix="mp"):
    """Start ``world`` ranks, each ``entry`` in its own interpreter on the
    card; when one fails or the deadline passes, stop them all and fail.
    Returns the seconds they took."""
    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(world):
        log = open(os.path.join(tmp, f"{prefix}_rank{rank}.log"), "w")
        logs.append(log)
        env = dict(os.environ, PYTHONPATH=here,
                   CUDA_VISIBLE_DEVICES=os.environ.get(
                       "CUDA_VISIBLE_DEVICES", "0"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.{entry}({rank}, "
             f"{world}, {port}, {tmp!r}, {seed})"],
            cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT))
    end = time.monotonic() + MP_DEADLINE_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > end:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        rcs = [p.wait() for p in procs]
        for log in logs:
            log.close()
    if any(rcs):
        for rank in range(world):
            with open(os.path.join(tmp, f"{prefix}_rank{rank}.log")) as f:
                tail = f.read()[-3000:]
            print(f"--- {entry} rank {rank} (rc {rcs[rank]}) ---\n{tail}",
                  file=sys.stderr, flush=True)
        fail(f"multiprocess: {entry} ranks exited {rcs}")
    return time.perf_counter() - t0


def _check_mp_replicated(seed, reps, ans, single, whole, qs, truth, paths,
                         tmp):
    """The replicated flat path's answers against the unreplicated
    ranks' on the same rows and queries, B=1 against the plain version
    over the whole slab (``single``: one process's index of the
    unreplicated ranks' checkpoint), the written rows as stored, the
    counts, recall, and the replicated npz in one process."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.parallel import ShardedFlatIndex, make_mesh

    label = "multiprocess_replicated"
    nb, b, k = qs.shape[0], qs.shape[1], 10
    err = 0.0
    for key, ref in (("rep_bfloat16", "search"),
                     ("rep_pipelined", "pipelined"),
                     ("rep_removed", "removed"), ("rep_int8", "int8")):
        err = max(err, _same_answers(f"{label}/{key}", ans[ref], ans[key]))
    err = max(err, _check_sharded(f"{label}/b1", single, whole, qs[1][:1],
                                  ans["rep_b1"]))
    new = torch.from_numpy(_written_rows(seed)).to(torch.bfloat16)
    stored = float(np.abs(ans["rep_written"][0]
                          - new.to(torch.float32).numpy()).max())
    if stored:
        fail(f"{label}: a written row reads back {stored} off")
    want = N_ROWS - MP_REMOVED + 32
    if list(ans["rep_count"][0]) != [want, want] or \
            list(ans["rep_count"][1]) != [want, 2]:
        fail(f"{label}: counts {ans['rep_count']}, want {want}")
    recall = _recall_slots(ans["rep_pipelined"][1].reshape(nb * b, k), truth)
    one = ShardedFlatIndex(384, dtype="bfloat16", capacity=N_ROWS,
                           mesh=make_mesh(SHARDS))
    if not one.load(os.path.join(tmp, "mp_rep_npz")):
        fail(f"{label}: the replicated ranks' npz did not load")
    err = max(err, _same_answers(f"{label}/npz", one.search(qs[2], k),
                                 ans["rep_final"]))
    del one
    rr = [r["replicated"] for r in reps]
    emit({"phase": "multiprocess", "path": label, "ranks": MP_RANKS,
          "replicas": 2, "shards": MP_POSITIONS, "dtype": "bfloat16",
          "b": b, "k": k, "nb": nb,
          **{key: [r["bfloat16"][key] for r in rr] for key in (
              "add_s", "search_b128_ms", "search_b1_ms",
              "pipelined_ms_per_batch", "answers_gather_ms",
              "checkpoints")},
          "unreplicated_search_b128_ms": [r["flat"]["search_b128_ms"]
                                          for r in reps],
          "unreplicated_pipelined_ms_per_batch":
              [r["flat"]["pipelined_ms_per_batch"] for r in reps],
          "int8_search_b128_ms": [r["int8"]["search_b128_ms"] for r in rr],
          "recall_at_10_raw": recall, "bar": RECALL_BAR,
          "max_abs_err_vs_plain": max(err, *(r[dt]["max_abs_err_vs_plain"]
                                             for r in rr
                                             for dt in ("bfloat16", "int8"))),
          "tol": ATOL, "launches": _nonzero(paths[label]),
          "launches_by_rank": [_nonzero(r["counts"][label]) for r in reps]})
    if recall < RECALL_BAR:
        fail(f"{label}: recall@10 {recall} < {RECALL_BAR}")


def _check_mp_ivf(seed, reps, ans, paths, tmp):
    """The sharded IVF path: one process's 8-position index loaded from
    the ranks' npz (written after the tuning) replays the ranks' calls
    and must give their answers (slots equal off ties, scores within
    ``ATOL``); every returned score must be q . row of the slab; recall
    against the float32 oracle at ``DENSE_BAR`` unfiltered and at both
    filters."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.ops.normalize import l2_normalize
    from wdbx_tpu_torch.parallel import ShardedIVFIndex, make_mesh

    label, k, d = "multiprocess_ivf", 10, 384
    xi, held = _ivf_data(seed)
    n = len(xi)
    held_np = held.cpu().numpy()
    single = ShardedIVFIndex(d, dtype="bfloat16", capacity=n,
                             mesh=make_mesh(SHARDS), nlist=1024,
                             train_threshold=1 << 62)
    t0 = time.perf_counter()
    if not single.load(os.path.join(tmp, "mp_ivf")) or \
            not single.is_trained:
        fail(f"{label}: the ranks' npz did not load")
    load_s = time.perf_counter() - t0
    picks = tuple(ans["ivf_picks"])
    removed = ans["ivf_removed_slots"][0]
    ref = _ivf_calls(single, held_np, picks, removed, lambda run: run(),
                     lambda run: run())
    err = 0.0
    for key, pair in ref.items():
        err = max(err, _same_answers(f"{label}/{key}", pair, ans[key], ATOL))
    # every returned score is q . row (bf16 queries, bf16 rows)
    qn = l2_normalize(held).to(torch.bfloat16).float()
    off = 0.0
    for key in ref:
        scores, slots = (np.asarray(a).reshape(-1, k) for a in ans[key])
        if (slots < 0).any():
            fail(f"{label}/{key}: fewer than {k} hits")
        rows = torch.as_tensor(single.get_vectors(slots.reshape(-1)),
                               device="cuda").reshape(len(slots), k, d)
        true = (qn[:len(slots)][:, None, :] * rows).sum(-1)
        off = max(off, float(np.abs(true.cpu().numpy() - scores).max()))
    if off > ATOL:
        fail(f"{label}: a returned score is {off} off q . row")
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = held @ xi.T
    truth = torch.topk(sc, k, dim=1).indices.cpu().numpy()
    rec = _slot_sets_recall(ans["ivf_search"][1], truth)
    rec_f = []
    for pick, key in zip(picks, ("ivf_f10", "ivf_f1")):
        keep = torch.zeros(n, dtype=torch.bool, device="cuda")
        keep[torch.as_tensor(pick, device="cuda")] = True
        t = torch.topk(sc[:128].masked_fill(~keep, float("-inf")), k,
                       dim=1).indices.cpu().numpy()
        rec_f.append(_slot_sets_recall(ans[key][1], t))
    _check_mp_heal(reps, ans, paths, tmp, held, sc, picks)
    del sc, xi
    iv = [r["ivf"] for r in reps]
    emit({"phase": "multiprocess", "path": label, "ranks": MP_RANKS,
          "shards": SHARDS, "dtype": "bfloat16", "b": 128, "k": k,
          **{key: iv[0][key] for key in ("n", "nlist", "cap_b", "nprobe",
                                         "tuned_recall_vs_index_exact")},
          **{key: [r[key] for r in iv] for key in (
              "bulk_load_s", "build_s", "build_all_to_all_bytes",
              "build_collectives", "tune_s", "npz_save_s", "search_b128_ms",
              "pipelined_ms_per_batch", "split_b128", "checkpoints")},
          "npz_load_single_process_s": load_s,
          "recall_at_10": rec, "recall_at_10_filtered_10pct": rec_f[0],
          "recall_at_10_filtered_1pct": rec_f[1], "bar": DENSE_BAR,
          "rescore_max_off": off,
          "max_abs_err_vs_plain": max(err, *(r["max_abs_err_vs_plain"]
                                             for r in iv)), "tol": ATOL,
          "launches": _nonzero(paths[label])})
    if min(rec, *rec_f) < DENSE_BAR:
        fail(f"{label}: recall@10 {rec} / {rec_f} < {DENSE_BAR}")
    del single
    torch.cuda.empty_cache()


def _check_mp_remesh(reps, ans, qs, truth, paths, tmp):
    """The remeshed flat index: one process's 7-position index of the
    ranks' npz gives the slot-order view; every answer on 7 positions
    against the plain version over it, the slots those of the same
    index before the remesh (off ties), recall@10 at ``RECALL_BAR``."""
    from wdbx_tpu_torch.parallel import ShardedFlatIndex, make_mesh

    label, k = "multiprocess_remesh", 10
    nb, b = qs.shape[0], qs.shape[1]
    single = ShardedFlatIndex(384, dtype="bfloat16", capacity=N_ROWS,
                              mesh=make_mesh(7))
    if not single.load(os.path.join(tmp, "mp_remesh7")):
        fail(f"{label}: the ranks' npz did not load")
    view = _slot_view(single)
    err = _check_sharded(f"{label}/search", single, view, qs[0],
                         ans["remesh_search"])
    err = max(err, _check_sharded(f"{label}/b1", single, view, qs[1][:1],
                                  ans["remesh_b1"]))
    for i in range(nb):
        err = max(err, _check_sharded(
            f"{label}/pipelined batch{i}", single, view, qs[i],
            (ans["remesh_pipelined"][0][i], ans["remesh_pipelined"][1][i])))
    err = max(err, _same_answers(f"{label}/as before the remesh",
                                 ans["remesh_before"], ans["remesh_search"]))
    recall = _recall_slots(ans["remesh_pipelined"][1].reshape(nb * b, k),
                           truth)
    del single, view
    rr = [r["remesh"] for r in reps]
    emit({"phase": "multiprocess", "path": label, "ranks": MP_RANKS,
          "dtype": "bfloat16", "n": N_ROWS, "positions": "8 -> 7 (4 + 3)",
          "b": b, "k": k, "nb": nb,
          **{f"{key}_{to}": [r[to][key] for r in rr]
             for to in ("to7", "to8")
             for key in ("s", "all_to_all_mb", "rows_sent", "bytes_sent",
                         "all_to_all_calls")},
          "adopt_reload_s": [r["adopt_reload_s"] for r in rr],
          "search_b128_ms": [r["search_b128_ms"] for r in rr],
          "on_8_search_b128_ms": [r["flat"]["search_b128_ms"] for r in reps],
          "recall_at_10_raw": recall, "bar": RECALL_BAR,
          "max_abs_err_vs_plain": max(err, *(r["max_abs_err_vs_plain"]
                                             for r in rr)), "tol": ATOL,
          "launches": _nonzero(paths[label]),
          "launches_by_rank": [_nonzero(r["counts"][label]) for r in reps]})
    if recall < RECALL_BAR:
        fail(f"{label}: recall@10 {recall} < {RECALL_BAR}")


def _check_mp_heal(reps, ans, paths, tmp, held, sc, picks):
    """The healed production_serving deployment: one process's
    7-position index of the ranks' npz (written after the heal and the
    re-tuning) replays ``_heal_calls`` and must give the ranks' answers;
    every returned score is q . row; recall@10 against the float32 oracle
    ``sc`` (held x the corpus) without the removed slots, unfiltered and
    at both filters, at ``DENSE_BAR``. The same for the heal onto rank 0
    alone (one process's 4-position index replays it) and the heal back
    onto the 8 positions (one process's 8-position index)."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.ops.normalize import l2_normalize
    from wdbx_tpu_torch.parallel import ShardedIVFIndex, make_mesh

    label, k, d = "multiprocess_heal", 10, 384
    n = sc.shape[1]
    held_np = held.cpu().numpy()
    qn = l2_normalize(held).to(torch.bfloat16).float()
    removed = torch.as_tensor(ans["ivf_removed_slots"][0], device="cuda")
    sc[:, removed] = float("-inf")
    truth = torch.topk(sc, k, dim=1).indices.cpu().numpy()
    truth_f = []
    for pick in picks:
        keep = torch.zeros(n, dtype=torch.bool, device="cuda")
        keep[torch.as_tensor(pick, device="cuda")] = True
        truth_f.append(torch.topk(sc[:128].masked_fill(~keep, float("-inf")),
                                  k, dim=1).indices.cpu().numpy())
    err = off = 0.0
    out = {}
    for step, shards, path in (("", 7, "mp_heal"),
                               ("heal_one/", 4, "mp_heal_one"),
                               ("heal_back/", 8, "mp_heal_back")):
        single = ShardedIVFIndex(d, dtype="bfloat16", capacity=n,
                                 mesh=make_mesh(shards), nlist=1024,
                                 train_threshold=1 << 62)
        t0 = time.perf_counter()
        if not single.load(os.path.join(tmp, path)) or \
                not single.is_trained:
            fail(f"{label}/{step}: the ranks' npz did not load")
        load_s = time.perf_counter() - t0
        ref = _heal_calls(single, held_np, picks, lambda run: run(),
                          lambda run: run())
        for key, pair in ref.items():
            got = ans[step + key]
            err = max(err, _same_answers(f"{label}/{step}{key}", pair, got,
                                         ATOL))
            scores, slots = (np.asarray(a).reshape(-1, k) for a in got)
            if (slots < 0).any():
                fail(f"{label}/{step}{key}: fewer than {k} hits")
            rows = torch.as_tensor(single.get_vectors(slots.reshape(-1)),
                                   device="cuda").reshape(len(slots), k, d)
            true = (qn[:len(slots)][:, None, :] * rows).sum(-1)
            off = max(off, float(np.abs(true.cpu().numpy() - scores).max()))
        rec = _slot_sets_recall(ans[step + "heal_search"][1], truth)
        rec_f = [_slot_sets_recall(ans[step + key][1], t)
                 for key, t in zip(("heal_f10", "heal_f1"), truth_f)]
        out[step or "heal_7/"] = {
            "shards": shards, "npz_load_single_process_s": load_s,
            "recall_at_10": rec, "recall_at_10_filtered_10pct": rec_f[0],
            "recall_at_10_filtered_1pct": rec_f[1]}
        if min(rec, *rec_f) < DENSE_BAR:
            fail(f"{label}/{step}: recall@10 {rec} / {rec_f} < {DENSE_BAR}")
        del single
    if off > ATOL:
        fail(f"{label}: a returned score is {off} off q . row")
    hv = [r["ivf"]["heal"] for r in reps]
    first = out.pop("heal_7/")
    emit({"phase": "multiprocess", "path": label, "ranks": MP_RANKS,
          "dtype": "bfloat16", "n": n, "b": 128, "k": k,
          **{key: hv[0][key] for key in (
              "rehost", "remeshed_to", "nlist", "nprobe",
              "tuned_recall_vs_index_exact")},
          **{key: [h[key] for h in hv] for key in (
              "heal_s", "tune_s", "store_save_s", "checkpoint_heal_s",
              "search_b128_ms")},
          **first,
          "one_rank": {step[:-1]: dict(out[step], **{
              key: [h["one_rank"][step[:-1]][key] for h in hv]
              for key in ("heal_s", "local_positions", "nlist", "nprobe",
                          "tuned_recall_vs_index_exact", "tune_s",
                          "search_b128_ms", "remesh")})
              for step in out},
          "bar": DENSE_BAR, "rescore_max_off": off,
          "max_abs_err_vs_plain": max(err, *(h["max_abs_err_vs_plain"]
                                             for h in hv)), "tol": ATOL,
          "launches": _nonzero(paths[label]),
          "launches_by_rank": [_nonzero(r["counts"][label]) for r in reps]})


def _bg_truth(chunks, q, k, src_mask, extra_rows, extra_slots):
    """Float32 top-k slots of ``q`` over the regenerated corpus (source
    row r is slot r) where ``src_mask`` keeps it, and the rows the window
    wrote (``extra_rows`` at ``extra_slots``). A yardstick."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    best_v = torch.full((q.shape[0], k), float("-inf"), device="cuda")
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64,
                        device="cuda")

    def fold(s, ids):
        nonlocal best_v, best_i
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        v = torch.cat([best_v, v], 1)
        i = torch.cat([best_i, ids[i]], 1)
        best_v, sel = torch.topk(v, k, dim=1)
        best_i = torch.gather(i, 1, sel)

    lo = 0
    for x in chunks():
        m = x.shape[0]
        fold((q @ x.T).masked_fill(~src_mask[None, lo:lo + m],
                                   float("-inf")),
             torch.arange(lo, lo + m, device="cuda"))
        lo += m
    if len(extra_slots):
        fold(q @ extra_rows.T, torch.as_tensor(extra_slots, device="cuda"))
    return best_i.cpu()


def _check_mp_background(reps, ans, chunks, mix, q64, paths):
    """The background rebuild across the ranks: both swapped at the same
    foreground call; recall@10 after the swap (and after the remesh to
    7), unfiltered and at the 1% filter, against the float32 oracle over
    the corpus as the window's writes left it."""
    import numpy as np
    import torch

    label, k, n = "multiprocess_background", 10, SC_N
    bgs = [r["background"] for r in reps]
    if len({(b["open_call"], b["swap_call"], b["agreements"]) for b in bgs}) \
            != 1:
        fail(f"{label}: the ranks' windows differ: {bgs}")
    removed, upd = (torch.as_tensor(a, device="cuda")
                    for a in ans["bg_removed"])
    written = ans["bg_write_slots"][0]
    new = mix(7777, 320)
    keep = torch.ones(n, dtype=torch.bool, device="cuda")
    keep[removed] = False
    keep[upd] = False
    truth = _bg_truth(chunks, q64, k, keep, new, written)
    pick = torch.as_tensor(ans["filter_pick"][0], device="cuda")
    in_pick = torch.zeros(n, dtype=torch.bool, device="cuda")
    in_pick[pick] = True
    sel = np.isin(written, ans["filter_pick"][0])
    truth_f = _bg_truth(chunks, q64, k, keep & in_pick,
                        new[torch.as_tensor(sel, device="cuda")],
                        written[sel])
    rec = {key: _slot_recall(torch.as_tensor(ans[key][1]), t)
           for key, t in (("bg_final", truth), ("bg_remesh7", truth),
                          ("bg_final_f1", truth_f), ("bg_f1", truth_f),
                          ("bg_s1", truth))}
    emit({"phase": "multiprocess", "path": label, "ranks": MP_RANKS,
          "n": n, "d": SC_D, "nlist": SC_NLIST, "nprobe": 4, "b": 64,
          "k": k, "dtype": "int8",
          **{key: bgs[0][key] for key in ("outcome", "open_call",
                                          "swap_call", "agreements",
                                          "extra_searches")},
          **{key: [b[key] for b in bgs] for key in (
              "window_s", "window_wall_s", "phase2_s", "agreement_ms",
              "background_group", "remesh7_s", "remesh7_all_to_all_mb")},
          "remesh7_rows_sent": [b["remesh7_move"]["rows_sent"] for b in bgs],
          **{f"recall_at_10_{key[3:]}": v for key, v in rec.items()},
          "bar": FACADE_BAR,
          "max_abs_err_vs_plain": max(b["max_abs_err_vs_plain"]
                                      for b in bgs), "tol": ATOL,
          "launches": _nonzero(paths[label]),
          "launches_by_rank": [_nonzero(r["counts"][label]) for r in reps]})
    gated = ("bg_final", "bg_remesh7", "bg_final_f1")
    if min(rec[key] for key in gated) < FACADE_BAR:
        fail(f"{label}: recall@10 {rec} < {FACADE_BAR}")


def phase_multiprocess(seed, truth, paths, timings, errs, tmp):
    """Two ranks on the one card (``_rank_main``) over a global mesh of
    8 positions, unreplicated and as ``make_mesh2(2)``; then, here, both
    ranks' answers against each other, the plain version over the whole
    slab, the unreplicated answers, the single-process 8-position index
    loaded from the ranks' checkpoints, and the float32 oracle."""
    import numpy as np
    import torch

    from wdbx_tpu_torch.parallel import (
        ShardedClusteredIndex,
        ShardedFlatIndex,
        make_mesh,
    )

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks_s = _run_mp_ranks(tmp, seed)
    span_s = _run_mp_ranks(tmp, seed, MP_SPAN_RANKS, "_span_main", "sp")
    runs = {}
    for prefix, world in (("mp", MP_RANKS), ("sp", MP_SPAN_RANKS)):
        reps, answers = zip(*(_mp_load(tmp, r, prefix)
                              for r in range(world)))
        for other in answers[1:]:
            for key, pair in answers[0].items():
                if not (np.array_equal(pair[0], other[key][0])
                        and np.array_equal(pair[1], other[key][1])):
                    fail(f"multiprocess: the ranks answer {key} otherwise")
        for rep in reps:
            for label, c in rep["counts"].items():
                _tally(paths, label, c)
            for key, e in rep["errs"].items():
                errs[key] = max(errs.get(key, 0.0), e)
        runs[prefix] = (reps, answers[0])
    reps, ans = runs["mp"]
    x, qs = _data(N_ROWS, seed)
    nb, b, k = qs.shape[0], qs.shape[1], 10

    # flat: the ranks' npz into one process's 8 positions, then the plain
    # version over the whole slab (every row live before the removal)
    single = ShardedFlatIndex(384, dtype="bfloat16", capacity=N_ROWS,
                              mesh=make_mesh(SHARDS))
    t0 = time.perf_counter()
    if not single.load(os.path.join(tmp, "mp_flat")):
        fail("multiprocess_flat: the ranks' npz did not load")
    load_s = time.perf_counter() - t0
    view = _slot_view(single)
    whole = (view[0], torch.ones_like(view[1]), view[2])
    err = _check_sharded("multiprocess_flat/search", single, whole, qs[0],
                         ans["search"])
    for i in range(nb):
        err = max(err, _check_sharded(
            f"multiprocess_flat/pipelined batch{i}", single, whole, qs[i],
            (ans["pipelined"][0][i], ans["pipelined"][1][i])))
    err = max(err, _check_sharded("multiprocess_flat/removed", single, view,
                                  qs[0], ans["removed"]))
    err = max(err, _same_answers("multiprocess_flat/npz", single.search(
        qs[0], k), ans["removed"]))
    recall = _recall_slots(ans["pipelined"][1].reshape(nb * b, k), truth)
    fl = reps[0]["flat"]
    emit({"phase": "multiprocess", "path": "multiprocess_flat",
          "ranks": MP_RANKS, "dtype": "bfloat16", **{
              key: fl[key] for key in ("n", "positions", "rows_per_shard",
                                       "b", "k", "nb")},
          "search_b128_ms": [r["flat"]["search_b128_ms"] for r in reps],
          "single_process_search_b128_ms":
              timings["sharded"]["bfloat16"]["search_b128_ms"],
          "pipelined_ms_per_batch":
              [r["flat"]["pipelined_ms_per_batch"] for r in reps],
          "single_process_pipelined_ms_per_batch":
              timings["sharded"]["bfloat16"]["ms_per_batch"],
          "split_b128": [r["flat"]["split_b128"] for r in reps],
          "search_collectives": [r["flat"]["search_collectives"]
                                 for r in reps],
          "add_s": fl["add_s"], "removed": fl["removed"],
          "orbax_save_s": fl["orbax_save_s"],
          "orbax_load_s": fl["orbax_load_s"], "npz_save_s": fl["npz_save_s"],
          "npz_load_single_process_s": load_s,
          "recall_at_10_raw": recall, "bar": RECALL_BAR,
          "max_abs_err_vs_plain": max(err, *(r["flat"][
              "max_abs_err_vs_plain"] for r in reps)), "tol": ATOL,
          "ranks_s": ranks_s,
          "launches": _nonzero(paths["multiprocess_flat"])})
    if recall < RECALL_BAR:
        fail(f"multiprocess_flat: recall@10 {recall} < {RECALL_BAR}")
    _check_mp_replicated(seed, reps, ans, single, whole, qs, truth, paths,
                         tmp)
    del single, view, whole
    torch.cuda.empty_cache()
    _check_mp_remesh(reps, ans, qs, truth, paths, tmp)
    torch.cuda.empty_cache()

    # int8: the plain version on one process's index of the same rows
    single8 = ShardedFlatIndex(384, dtype="int8", capacity=N_ROWS,
                               mesh=make_mesh(SHARDS))
    single8.add_batch(x)
    del x
    err8 = _check_sharded("multiprocess_int8/search", single8,
                          _slot_view(single8), qs[0], ans["int8"])
    emit({"phase": "multiprocess", "path": "multiprocess_int8",
          "search_b128_ms": [r["int8"]["search_b128_ms"] for r in reps],
          "single_process_search_b128_ms":
              timings["sharded"]["int8"]["search_b128_ms"],
          "max_abs_err_vs_plain": max(err8, *(r["int8"][
              "max_abs_err_vs_plain"] for r in reps)), "tol": ATOL,
          "launches": _nonzero(paths["multiprocess_int8"])})
    del single8
    torch.cuda.empty_cache()

    # sharded clustered: the ranks' checkpoint into one process's 8
    # positions (the same layout), its launches against the plain version,
    # the ranks' answers against its; recall against the float32 oracle
    n, d, nlist, bc, nbc = SC_N, SC_D, SC_NLIST, 64, 8
    mix = _mixture(4096, d, seed + 17)

    def chunks():
        for i, lo in enumerate(range(0, n, SC_STEP)):
            yield mix(5000 + i, min(SC_STEP, n - lo))

    q_all = mix(9999, nbc * bc)
    q64 = q_all[:bc]
    single = ShardedClusteredIndex(d, dtype="int8", capacity=n,
                                   mesh=make_mesh(SHARDS), nlist=nlist,
                                   nprobe=4, train_threshold=1 << 62)
    t0 = time.perf_counter()
    if not single.load(os.path.join(tmp, "mp_clu")):
        fail("multiprocess_clustered: the ranks' npz did not load")
    c_load_s = time.perf_counter() - t0
    single.batch_flat_fallback = False
    with _K3Recorder() as rec:
        ref = single.search(q64, k)
        err3 = _check_sc_calls("multiprocess_clustered/single", single,
                               rec.take(), ref, errs)
        refp = single.search_pipelined(q_all.reshape(nbc, bc, d), k)
        err3 = max(err3, _check_sc_calls(
            "multiprocess_clustered/single pipelined", single, rec.take(),
            refp, errs))
    err3 = max(err3, _same_answers("multiprocess_clustered/search", ref,
                                   ans["clustered"]))
    err3 = max(err3, _same_answers("multiprocess_clustered/pipelined",
                                   refp, ans["clustered_pipelined"]))
    pick = ans["filter_pick"][0]
    mask = np.zeros(single.capacity, bool)
    mask[pick] = True
    pm = single._filter_plan(mask, 4, nlist)[0]
    err3 = max(err3, _check_sc_flat("multiprocess_clustered/filtered 1%",
                                    single, q64, pm,
                                    ans["clustered_filtered"], errs))
    truth_src, _ = _stream_truth(chunks, q_all, k)
    recall_c = _slot_recall(torch.as_tensor(
        ans["clustered_pipelined"][1].reshape(nbc * bc, k)), truth_src.cpu())
    src_mask = torch.zeros(n, dtype=torch.bool, device="cuda")
    src_mask[torch.as_tensor(pick, device="cuda")] = True
    t_src, _ = _stream_truth(chunks, q64, k, src_mask=src_mask)
    recall_f = _slot_recall(torch.as_tensor(ans["clustered_filtered"][1]),
                            t_src.cpu())
    cl = reps[0]["clustered"]
    emit({"phase": "multiprocess", "path": "multiprocess_clustered",
          "ranks": MP_RANKS, **{key: cl[key] for key in (
              "n", "d", "nlist", "b", "k", "nprobe", "c", "rows_per_shard")},
          "build_s": [r["clustered"]["build_s"] for r in reps],
          "build_collectives": [r["clustered"]["build_collectives"]
                                for r in reps],
          "search_b64_ms": [r["clustered"]["search_b64_ms"] for r in reps],
          "single_process_search_b64_ms":
              timings["sharded_clustered"]["search_b64_ms"],
          "pipelined_ms_per_batch":
              [r["clustered"]["pipelined_ms_per_batch"] for r in reps],
          "single_process_pipelined_ms_per_batch":
              timings["sharded_clustered"]["pipelined_ms_per_batch"],
          "filtered_1pct_ms": [r["clustered"]["filtered_1pct_ms"]
                               for r in reps],
          "split_b64": [r["clustered"]["split_b64"] for r in reps],
          "search_collectives": [r["clustered"]["search_collectives"]
                                 for r in reps],
          "npz_save_s": cl["npz_save_s"], "npz_load_s": cl["npz_load_s"],
          "npz_load_single_process_s": c_load_s,
          "recall_at_10_nprobe4": recall_c, "recall_at_10_filtered_1pct":
              recall_f, "bar": FACADE_BAR,
          "max_abs_err_vs_plain": max(err3, *(r["clustered"][
              "max_abs_err_vs_plain"] for r in reps)), "tol": ATOL,
          "launches": _nonzero(paths["multiprocess_clustered"])})
    if recall_c < FACADE_BAR or recall_f < FACADE_BAR:
        fail(f"multiprocess_clustered: recall@10 {recall_c} / {recall_f} "
             f"< {FACADE_BAR}")
    del single
    torch.cuda.empty_cache()
    _check_mp_background(reps, ans, chunks, mix, q64, paths)

    # replicated clustered: the unreplicated ranks' layout loaded on the
    # replicated mesh answers as they did; the replicated build's recall
    label = "multiprocess_replicated_clustered"
    err_r = 0.0
    for key, ref in (("rep_clu_loaded", "clustered"),
                     ("rep_clu_loaded_pipelined", "clustered_pipelined")):
        err_r = max(err_r, _same_answers(f"{label}/{key}", ans[ref],
                                         ans[key]))
    recall_rc = _slot_recall(torch.as_tensor(
        ans["rep_clustered_pipelined"][1].reshape(nbc * bc, k)),
        truth_src.cpu())
    recall_rf = _slot_recall(torch.as_tensor(
        ans["rep_clustered_filtered"][1]), t_src.cpu())
    rc = [r["replicated_clustered"] for r in reps]
    emit({"phase": "multiprocess", "path": label, "ranks": MP_RANKS,
          "replicas": 2, **{key: rc[0][key] for key in (
              "n", "d", "nlist", "b", "k", "nprobe")},
          **{key: [r[key] for r in rc] for key in (
              "build_s", "build_collectives", "search_b64_ms",
              "pipelined_ms_per_batch", "filtered_1pct_ms", "npz_load_s")},
          "unreplicated_search_b64_ms": [r["clustered"]["search_b64_ms"]
                                         for r in reps],
          "recall_at_10_nprobe4": recall_rc,
          "recall_at_10_filtered_1pct": recall_rf, "bar": FACADE_BAR,
          "max_abs_err_vs_plain": max(err_r, *(r["max_abs_err_vs_plain"]
                                               for r in rc)), "tol": ATOL,
          "launches": _nonzero(paths[label])})
    if recall_rc < FACADE_BAR or recall_rf < FACADE_BAR:
        fail(f"{label}: recall@10 {recall_rc} / {recall_rf} < {FACADE_BAR}")
    sp_reps, sp_ans = runs["sp"]
    _check_mp_spanning(sp_reps, sp_ans, qs, truth, q_all, truth_src, t_src,
                       paths, errs, tmp)
    emit({"phase": "multiprocess", "ranks_s": ranks_s,
          "spanning_ranks_s": span_s})
    del truth_src, t_src
    torch.cuda.empty_cache()
    _check_mp_ivf(seed, reps, ans, paths, tmp)


def _recall_slots(slots, truth) -> float:
    return float(sum(len(set(a.tolist()) & set(t.tolist()))
                     for a, t in zip(slots, truth)) / truth.size)


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


# -- the serving surfaces: REST server, QueryBatcher, CLI --------------------


def _same_hits(name, ref, got, tol=MATCH_TOL) -> float:
    """Two hit lists of (id, score) agree: the same length, scores within
    ``tol``, the same ids except where two candidates' scores lie within
    ``tol`` of the k-th place (two stage-1 bodies sum in other orders).
    Returns the largest score difference."""
    if len(ref) != len(got):
        fail(f"{name}: {len(got)} hits against {len(ref)}")
    if not ref:
        return 0.0
    err = max(abs(float(r[1]) - float(g[1])) for r, g in zip(ref, got))
    if err > tol:
        fail(f"{name}: scores differ by {err} > {tol}")
    rs = {r[0]: float(r[1]) for r in ref}
    gs = {g[0]: float(g[1]) for g in got}
    kth = min(rs.values())
    for vid in set(rs) ^ set(gs):
        score = rs.get(vid, gs.get(vid))
        if abs(score - kth) > tol:
            fail(f"{name}: id {vid} differs off a tie")
    return err


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _session():
    import aiohttp

    return aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=300))


async def _request(session, method, url, body=None):
    """One request on ``session``: (status, body bytes, seconds)."""
    t0 = time.perf_counter()
    async with session.request(method, url, json=body) as resp:
        raw = await resp.read()
    return resp.status, raw, time.perf_counter() - t0


def _http(method, url, body=None):
    """One request from this thread: (status, body bytes)."""
    import asyncio

    async def run():
        async with _session() as session:
            return await _request(session, method, url, body)

    status, raw, _ = asyncio.run(run())
    return status, raw


def _http_json(method, url, body=None):
    status, raw = _http(method, url, body)
    if status != 200:
        fail(f"{method} {url}: status {status}: {raw[:300]!r}")
    return json.loads(raw)


def _http_load(url, bodies, threads):
    """POST every body to ``url`` at once: ``threads`` client threads,
    each with one session sending its share concurrently. Returns
    ``[(status, json, seconds)]`` in body order and the wall seconds of
    the whole load."""
    import asyncio
    import threading

    out = [None] * len(bodies)

    def worker(share):
        async def run():
            async with _session() as session:
                return await asyncio.gather(
                    *(_request(session, "POST", url, bodies[i])
                      for i in share))

        for i, (status, raw, sec) in zip(share, asyncio.run(run())):
            out[i] = (status, json.loads(raw), sec)

    workers = [threading.Thread(target=worker,
                                args=(range(t, len(bodies), threads),))
               for t in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(w.is_alive() for w in workers) or any(o is None for o in out):
        fail(f"POST {url}: the client threads did not finish")
    return out, wall


def _ms_stats(seconds) -> dict:
    import numpy as np

    ms = np.sort(np.asarray(seconds, np.float64)) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95)),
            "p99_ms": float(np.percentile(ms, 99))}


def _timed_flushes(store):
    """Wrap the store's submit / resolve, as the QueryBatcher calls them
    from its worker threads: each flush records its queries, its answers
    and the wall ms from submit to the end of resolve. Returns the record
    list and a function that removes the wrappers."""
    sub, res = store.search_batch_submit, store.search_batch_resolve
    flushes = []

    def submit(queries, *args, **kw):
        t0 = time.perf_counter()
        return sub(queries, *args, **kw), t0, queries.copy()

    def resolve(handle):
        inner, t0, queries = handle
        out = res(inner)
        flushes.append({"b": len(queries), "queries": queries, "hits": out,
                        "wall_ms": (time.perf_counter() - t0) * 1e3})
        return out

    store.search_batch_submit, store.search_batch_resolve = submit, resolve

    def remove():
        del store.search_batch_submit, store.search_batch_resolve

    return flushes, remove


class DeviceBusy:
    """Kernel time on the card over a window, from a torch.profiler
    trace of CUDA activity only (CUPTI, process-wide: the kernels the
    batcher's worker threads launch count too). ``busy_ms`` is the sum
    of the kernels' device time (None where the trace shows none)."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.wall_ms = (time.perf_counter() - self._t0) * 1e3
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        us = 0.0
        for event in self._prof.key_averages():
            us += getattr(event, "self_device_time_total",
                          getattr(event, "self_cuda_time_total", 0.0))
        self.busy_ms = us / 1e3 if us > 0 else None
        return False

    def stats(self, flushes: int) -> dict:
        if self.busy_ms is None:
            return {"device_busy_ms": "not measured (no CUDA activity "
                    "in the trace)", "window_ms": self.wall_ms}
        return {"device_busy_ms": self.busy_ms, "window_ms": self.wall_ms,
                "device_busy_share": self.busy_ms / self.wall_ms,
                "device_busy_ms_per_flush": self.busy_ms / max(1, flushes)}


def _flush_stats(flushes) -> dict:
    import numpy as np

    return {"flushes": len(flushes),
            "avg_batch": float(np.mean([f["b"] for f in flushes])),
            "wall_ms_per_flush": float(np.mean([f["wall_ms"]
                                                for f in flushes]))}


def _add_counts(a, b):
    return {name: a.get(name, 0) + b.get(name, 0) for name in {*a, *b}}


def phase_server(x, qs, truth, paths, tmp, errs):
    """The REST path at benchmarks/RESULTS.md:730-743's point: a
    WDBX(INDEX_DTYPE=bfloat16) with its other arguments at their
    defaults (the card, plugins, batching) bulk-loads the 1,048,576 x 384
    rows, WDBXAPIServer serves it from a thread on 127.0.0.1, and every
    request goes over HTTP. Each flush of the load and the batch route
    are held against the kernels' plain version (K1 bf16's error).
    Returns what the cli phase checks against."""
    import asyncio

    import aiohttp
    import numpy as np
    import torch

    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.api.server import WDBXAPIServer
    from wdbx_tpu_torch.index.flat import FlatIndex

    n_rows, d = x.shape
    data_dir = os.path.join(tmp, "server")
    # room for the posted rows past the bulk load (no copy-grow); the
    # demo embedder is the provider (no model files, no network)
    cfg = {"INDEX_DTYPE": "bfloat16", "INDEX_CAPACITY": n_rows + 1024,
           "SENTENCETRANSFORMERS_DEMO": True}
    db = WDBX(data_dir=data_dir, config=cfg)
    index = db.store.indices[0]
    if not isinstance(index, FlatIndex) or index.device.type != "cuda" or \
            index.dtype_name != "bfloat16":
        fail(f"server: WDBX gave {type(index).__name__} on {index.device}")
    if "sentencetransformers" not in db.plugins or \
            not db.plugins["sentencetransformers"]._demo():
        fail(f"server: the demo embedder did not load: {sorted(db.plugins)}")
    t0 = time.perf_counter()
    db.store.bulk_load([str(i) for i in range(n_rows)], x)
    load_s = time.perf_counter() - t0

    port = _free_port()
    server = WDBXAPIServer(db, host="127.0.0.1", port=port)
    if server.batcher is None or server.batcher.max_batch != 128 or \
            server.batcher.max_wait_ms != 3.0:
        fail("server: batching is not on at its defaults")
    server.start_in_thread()
    base = f"http://127.0.0.1:{port}/api/v1"
    for _ in range(600):
        try:
            if _http("GET", base + "/health")[0] == 200:
                break
        except aiohttp.ClientConnectionError:
            pass  # not listening yet
        time.sleep(0.05)
    else:
        fail("server: /health did not answer")
    loop = server._thread_loop
    asyncio.run_coroutine_threadsafe(db.initialize(), loop).result(120)
    widths = asyncio.run_coroutine_threadsafe(
        server.warmup(), loop).result(300)

    q_all = qs.reshape(-1, d)
    n_req, n_batch = 320, 32
    single = list(range(n_req))
    batch = list(range(3 * qs.shape[1], 3 * qs.shape[1] + n_batch))
    flushes, unwrap = _timed_flushes(db.store)
    _reset()
    bodies = [{"query_vector": q_all[i].tolist(), "limit": 10}
              for i in single]
    with DeviceBusy() as busy:
        answers, wall = _http_load(base + "/vectors/search", bodies, 16)
    t0 = time.perf_counter()
    batch_body = _http_json("POST", base + "/vectors/search/batch", {
        "query_vectors": q_all[batch].tolist(), "limit": 10})
    batch_s = time.perf_counter() - t0
    counts = _counts()
    load_flushes = list(flushes)
    if any(status != 200 for status, _, _ in answers):
        fail(f"server: statuses {sorted({a[0] for a in answers})}")

    # each HTTP answer against the facade's direct call for its query
    hits = [[(h["vector_id"], h["similarity"]) for h in a[1]["results"]]
            for a in answers]
    hits += [[(h["vector_id"], h["similarity"]) for h in row]
             for row in batch_body["results"]]
    err = 0.0
    for i, got in zip(single + batch, hits):
        ref = db.vector_search(q_all[i].tolist(), limit=10)
        err = max(err, _same_hits(f"server/query {i}", ref, got))
    rec = _recall(hits, truth[single + batch])
    # each flush and the batch route against the plain version
    plain_err = check_facade("server/batch route", db, q_all[batch], [
        [(h["vector_id"], h["similarity"], None) for h in row]
        for row in batch_body["results"]])
    for j, f in enumerate(load_flushes):
        plain_err = max(plain_err, check_facade(
            f"server/flush {j}", db, f["queries"], f["hits"]))
    key = "fused_topk_partial[bfloat16]"
    errs[key] = max(errs[key], plain_err)

    # writes, embeddings, ops routes (their launches count too)
    _reset()
    rng = np.random.default_rng(4242)
    posted = rng.standard_normal((4, d)).astype(np.float32)
    posted /= np.linalg.norm(posted, axis=1, keepdims=True)
    for j, v in enumerate(posted):
        _http_json("POST", base + "/vectors", {
            "vector": v.tolist(), "id": f"posted-{j}",
            "metadata": {"source": "chip_smoke", "j": j}})
    for j, v in enumerate(posted):
        top = _http_json("POST", base + "/vectors/search", {
            "query_vector": v.tolist(), "limit": 3})["results"][0]
        if top["vector_id"] != f"posted-{j}" or top["similarity"] < 0.99 \
                or top["metadata"] != {"source": "chip_smoke", "j": j}:
            fail(f"server: posted-{j} was not found: {top}")
    text = "a vector database on the card"
    emb = _http_json("POST", base + "/embeddings", {"text": text})
    emb = emb["embedding"]
    if len(emb) != d or abs(np.linalg.norm(emb) - 1.0) > 1e-5:
        fail("server: /embeddings gave no unit vector of the store's width")
    _http_json("POST", base + "/vectors",
               {"vector": emb, "id": "embedded-0", "metadata": {"text": text}})
    top = _http_json("POST", base + "/vectors/search",
                     {"query_vector": emb, "limit": 1})["results"]
    if [h["vector_id"] for h in top] != ["embedded-0"]:
        fail(f"server: the embedded text was not found: {top}")
    stats = _http_json("GET", base + "/stats")
    if stats["vector_count"] != n_rows + 5:
        fail(f"server: /stats counts {stats['vector_count']}")
    status, raw = _http("GET", base + "/metrics")
    metrics = dict(line.rsplit(" ", 1) for line in raw.decode().splitlines()
                   if line.startswith("wdbx_batcher_"))
    coalesced = float(metrics["wdbx_batcher_batched_queries"]) / \
        float(metrics["wdbx_batcher_batches"])
    if status != 200 or coalesced <= 1:
        fail(f"server: /metrics shows no coalescing ({metrics})")
    plugins = {p["name"] for p in
               _http_json("GET", base + "/plugins")["plugins"]}
    if "sentencetransformers" not in plugins:
        fail(f"server: /plugins lists {sorted(plugins)}")
    t0 = time.perf_counter()
    spec = _http_json("GET", base + "/visualize?format=json")
    viz_s = time.perf_counter() - t0
    pts = np.asarray(spec["points"])
    if pts.shape != (500, 2) or not np.isfinite(pts).all():
        fail(f"server: /visualize gave points of shape {pts.shape}")
    # the query the cli phase asks, answered over HTTP on the saved store
    cli_ref = _http_json("POST", base + "/vectors/search", {
        "query_vector": q_all[0].tolist(), "limit": 10})["results"]
    t0 = time.perf_counter()
    if not _http_json("POST", base + "/save")["saved"]:
        fail("server: /save did not save")
    save_s = time.perf_counter() - t0
    paths["server"] = _add_counts(counts, _counts())
    unwrap()
    server.stop_thread()
    server._thread.join(timeout=30)
    if paths["server"]["fused_topk_partial[bfloat16]"] < 1 or \
            paths["server"]["fused_topk_partial.bodies.wgmma"] + \
            paths["server"]["fused_topk_partial.bodies.mma_pipe"] < 1 or \
            paths["server"]["topk_merge_partials"] < 1:
        fail(f"server: K1 bf16 (wgmma / mma_pipe) and the merge did not run: "
             f"{_nonzero(paths['server'])}")
    emit({"phase": "server", "n": n_rows, "dtype": "bfloat16",
          "bulk_load_s": load_s, "warmed_widths": widths,
          "requests": n_req, "client_threads": 16,
          "requests_per_s": n_req / wall, "load_wall_s": wall,
          **_ms_stats([a[2] for a in answers]),
          "batch_route_s": batch_s, "batch_route_queries": n_batch,
          **_flush_stats(load_flushes), **busy.stats(len(load_flushes)),
          "flush_sizes": sorted(f["b"] for f in load_flushes),
          "phase_flushes": len(flushes),
          "batcher_batched_per_batch": coalesced,
          "max_abs_err_vs_direct": err, "tol": MATCH_TOL,
          "max_abs_err_vs_plain": plain_err, "plain_tol": ATOL,
          "recall_at_10": rec, "recall_bar": RECALL_BAR,
          "visualize_s": viz_s, "save_s": save_s, "card_stats": {
              key: stats[key] for key in ("vector_count", "plugins")},
          "launches": _nonzero(paths["server"])})
    if rec < RECALL_BAR:
        fail(f"server: recall@10 {rec} < {RECALL_BAR}")
    del db, index, server
    torch.cuda.empty_cache()
    return {"data_dir": data_dir, "config": cfg, "query": q_all[0],
            "answer": [(h["vector_id"], h["similarity"]) for h in cli_ref],
            "count": n_rows + 5, "save_s": save_s}


# the cli phase's process: ``python -m wdbx_tpu_torch.cli`` by runpy (what
# -m does), with the facade's construction timed and the kernels' launch
# counters printed to stderr at exit
_CLI_RUNNER = r"""
import json, runpy, sys, time
sys.path.insert(0, sys.argv.pop(1))
from wdbx_tpu_torch.core import wdbx as facade
init = facade.WDBX.__init__
timed = {}
def timed_init(self, *args, **kw):
    t0 = time.perf_counter()
    init(self, *args, **kw)
    timed["load_s"] = time.perf_counter() - t0
facade.WDBX.__init__ = timed_init
code = 0
try:
    runpy.run_module("wdbx_tpu_torch.cli", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    code = e.code or 0
import chip_smoke
print("CLI_RUN " + json.dumps({**timed, "launches": chip_smoke._counts()}),
      file=sys.stderr, flush=True)
sys.exit(code)
"""


def phase_cli(served, paths):
    """``python -m wdbx_tpu_torch.cli`` in a subprocess on the card,
    ``--data-dir`` at the server phase's saved store: ``stats``,
    ``plugins`` and ``search --vector`` through its interactive mode, the
    hits held against the server's answer for that query."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    for key, value in served["config"].items():
        env[f"WDBX_{key}"] = json.dumps(value)
    vec = json.dumps(served["query"].tolist(), separators=(",", ":"))
    commands = f"stats\nplugins\nsearch --vector '{vec}' --limit 10\nexit\n"
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", _CLI_RUNNER, here, "--data-dir",
         served["data_dir"]],
        input=commands, capture_output=True, text=True, timeout=600,
        cwd=here, env=env,
    )
    wall = time.perf_counter() - t0
    tail = [line for line in run.stderr.splitlines()
            if line.startswith("CLI_RUN ")]
    if run.returncode != 0 or not tail:
        fail(f"cli: exit {run.returncode}: {run.stderr[-2000:]}")
    info = json.loads(tail[-1][len("CLI_RUN "):])
    parts = run.stdout.split("wdbx> ")
    if len(parts) != 5:
        fail(f"cli: unexpected output: {run.stdout[-2000:]}")
    stats, plugins, search = parts[1], parts[2], parts[3]
    stats = json.loads(stats)
    if stats["vector_count"] != served["count"] or \
            stats["indices"][0]["device"] != "cuda":
        fail(f"cli: stats {stats['vector_count']} on "
             f"{stats['indices'][0]['device']}")
    if "sentencetransformers" not in plugins:
        fail(f"cli: plugins printed {plugins!r}")
    hits = []
    for line in search.strip().splitlines():
        vid, score, _ = line.split("  ", 2)
        hits.append((vid, float(score.split("=")[1])))
    # the cli prints 4 decimals
    err = _same_hits("cli/search", served["answer"], hits,
                     tol=5e-5 + MATCH_TOL)
    paths["cli"] = info["launches"]
    if paths["cli"]["fused_topk_partial[bfloat16]"] < 1 or \
            paths["cli"]["topk_merge_partials"] < 1:
        fail(f"cli: K1 bf16 and the merge did not run: "
             f"{_nonzero(paths['cli'])}")
    emit({"phase": "cli", "commands": ["stats", "plugins", "search"],
          "save_s": served["save_s"], "load_s": info.get("load_s"),
          "process_wall_s": wall, "count": stats["vector_count"],
          "max_abs_err_vs_server": err, "tol": 5e-5 + MATCH_TOL,
          "launches": _nonzero(paths["cli"])})


def phase_batcher_clustered(seed, paths, errs):
    """benchmarks/store_serving.py's point: 256 client coroutines send
    single queries through QueryBatcher(max_batch=128) into a 262,144 x
    384 ivf_clustered int8 store (nlist 256, nprobe 1, no raw copies) for
    BATCHER_SECONDS; every flush's answers against the store's direct
    search_batch of the same queries and, where the flush took the kernel
    route, against K3's plain version on the same block list (K3 int8 /
    bf16's error)."""
    import asyncio

    import torch

    from wdbx_tpu_torch.api.batching import QueryBatcher
    from wdbx_tpu_torch.core.config import WDBXConfig
    from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex, _next_pow2
    from wdbx_tpu_torch.store.vector_store import VectorStore

    n, d, clients = BATCHER_ROWS, 384, 256
    cfg = WDBXConfig({
        "VECTOR_DIMENSION": d, "NUM_SHARDS": 1,
        "INDEX_TYPE": "ivf_clustered", "INDEX_DTYPE": "int8",
        "IVF_NLIST": min(4096, max(64, n // 1024)), "IVF_NPROBE": 1,
        "IVF_TRAIN_THRESHOLD": 4096, "VECTOR_STORE_KEEP_RAW": False,
        "VECTOR_STORE_AUTOSAVE_INTERVAL": 1 << 62,
    })
    with tempfile.TemporaryDirectory(prefix="wdbx_batcher_") as tmp:
        store = VectorStore(cfg, data_dir=tmp)
        index = store.indices[0]
        if not isinstance(index, ClusteredIVFIndex):
            fail(f"batcher_clustered: got {type(index).__name__}")
        mix = _mixture(1024, d, seed + 23)
        t0 = time.perf_counter()
        store.bulk_load([f"v{i}" for i in range(n)],
                        mix(3000, n).cpu().numpy())
        index.build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        queries = mix(9999, 4096).cpu().numpy()
        widths = store.warm(max_batch=128)
        flushes, unwrap = _timed_flushes(store)
        lat = []

        async def run():
            batcher = QueryBatcher(store, max_batch=128, max_wait_ms=2.0)
            stop = time.perf_counter() + BATCHER_SECONDS

            async def client(cid):
                r = cid
                while time.perf_counter() < stop:
                    t1 = time.perf_counter()
                    hits = await batcher.search(queries[r % len(queries)],
                                                limit=10)
                    lat.append(time.perf_counter() - t1)
                    if len(hits) != 10:
                        fail(f"batcher_clustered: {len(hits)} hits")
                    r += clients

            t1 = time.perf_counter()
            await asyncio.gather(*(client(c) for c in range(clients)))
            return time.perf_counter() - t1, batcher.get_stats()

        _reset()
        with DeviceBusy() as busy:
            wall, bstats = asyncio.run(run())
        paths["batcher_clustered"] = _counts()
        unwrap()
        key = clu_name(cs_key("v2", "int8", "bf16"))
        # each kernel-route flush against the plain version on the same
        # block list, hit ids mapped to slab positions
        reg = store.registries[0]
        pos_of = torch.as_tensor(index._pos_of, device="cuda").long()
        routes = {"kernel": 0, "ranges": 0}
        plain_err = 0.0
        for j, f in enumerate(flushes):
            pad_b = _next_pow2(f["b"])
            if index._use_ranges(pad_b, 1):
                routes["ranges"] += 1
                continue
            routes["kernel"] += 1
            ref, rescore, _ = _block_plain(
                index, torch.as_tensor(f["queries"], device="cuda"), 10,
                pad_b, index._valid, 1)
            got_v = torch.tensor([[h[1] for h in row] for row in f["hits"]],
                                 device="cuda")
            slots = torch.tensor([[reg.lookup(h[0]) for h in row]
                                  for row in f["hits"]], device="cuda")
            plain_err = max(plain_err, check_topk(
                f"batcher_clustered/flush {j}", ref, (got_v, pos_of[slots]),
                rescore))
        errs[key] = max(errs[key], plain_err)
        if paths["batcher_clustered"][key] < 1 or paths["batcher_clustered"][
                "clustered_block_partial.bodies.mma_pipe"] < 1:
            fail(f"batcher_clustered: K3 did not run: "
                 f"{_nonzero(paths['batcher_clustered'])}")
        # a direct search of a batch whose blocks cover the corpus would
        # take the exact flat scan; the pipelined path never does: hold
        # the flushes against the same route
        index.batch_flat_fallback = False
        err = 0.0
        for j, f in enumerate(flushes):
            direct = store.search_batch(f["queries"], limit=10)
            for r, (ref, got) in enumerate(zip(direct, f["hits"])):
                err = max(err, _same_hits(
                    f"batcher_clustered/flush {j} row {r}",
                    [(h[0], h[1]) for h in ref],
                    [(h[0], h[1]) for h in got]))
        emit({"phase": "batcher_clustered", "n": n, "d": d, "dtype": "int8",
              "nlist": int(index._centroids.shape[0]), "nprobe": 1,
              "block_rows": index._c, "build_s": build_s,
              "warmed_widths": widths, "clients": clients,
              "seconds": wall, "requests": len(lat),
              "qps": len(lat) / wall, **_ms_stats(lat),
              "batcher": bstats, **_flush_stats(flushes),
              **busy.stats(len(flushes)),
              "routes": routes,
              "max_abs_err_vs_direct": err, "tol": MATCH_TOL,
              "max_abs_err_vs_plain": plain_err, "plain_tol": ATOL,
              "launches": _nonzero(paths["batcher_clustered"])})
        del store, index
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
    k1_10m = phase_k1_10m(args.seed, errs)
    phase_merge(args.seed, errs)
    phase_clustered_kernels(args.seed, errs)
    phase_block_dedup(args.seed)
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
        phase_sharded(x, qs, x_dev, truth, paths, timings, errs, tmp,
                      args.seed)
        del x_dev
        torch.cuda.empty_cache()
        served = phase_server(x, qs, truth, paths, tmp, errs)
        del x
        phase_cli(served, paths)
        phase_clustered(args.seed, paths, timings, errs)
        phase_clustered_facade(args.seed, paths, timings, errs, tmp)
        phase_sharded_clustered(args.seed, paths, timings, errs, tmp)
        phase_multiprocess(args.seed, truth, paths, timings, errs, tmp)
        phase_dense_ivf(args.seed, paths, timings, errs, tmp)
        phase_batcher_clustered(args.seed, paths, errs)
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
        if dtype == "bfloat16":
            kernels[-1]["at_10m_x_768"] = {
                key: k1_10m[key] for key in (
                    "body", "ms", "score_only_ms", "pipe_ms",
                    "pipe_score_only_ms", "bound_ms", "plain_ms",
                    "library_ms")}
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
