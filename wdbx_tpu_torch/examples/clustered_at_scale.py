"""Clustered-slab index at scale: streaming bulk load, tuning, serving.

The port's counterpart of ``examples/clustered_at_scale.py``, the
memory-flagship workflow at a laptop-friendly size:

  1. ``build_from`` — two-pass streaming bulk load straight into
     cluster order (peak memory = final slab + one chunk; the source is
     consumed twice, so readers over disk shards work naturally);
  2. ``tune()`` — smallest nprobe hitting a recall target against the
     index's own exact oracle;
  3. pipelined serving — (NB, B, d) query stacks in one call;
  4. live mutation — fresh adds are instantly searchable (residual
     scan), deletes vanish immediately (tombstones), and the overlay
     absorbs churn at the next build with STABLE external ids;
  5. save/load round trip.

    python -m wdbx_tpu_torch.examples.clustered_at_scale [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from wdbx_tpu_torch.index import ClusteredIVFIndex

DIM = 64
N_CHUNKS = 8


def chunk_source(chunk: int):
    """Re-iterable corpus source (stands in for disk shards / a feature
    pipeline). build_from consumes it twice: assign, then scatter."""
    def source():
        rng = np.random.default_rng(7)
        centers = rng.standard_normal((256, DIM)).astype(np.float32)
        centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
        for i in range(N_CHUNKS):
            r = np.random.default_rng(100 + i)
            ids = r.integers(0, 256, chunk)
            yield centers[ids] + 0.08 * r.standard_normal(
                (chunk, DIM)
            ).astype(np.float32)

    return source


def run(device: str | None, chunk: int) -> None:
    source = chunk_source(chunk)
    index = ClusteredIVFIndex(
        DIM, dtype="int8", nlist=64, nprobe=8, train_threshold=1 << 30,
        device=device,
    )

    # 1. streaming bulk load (the index must be empty)
    t0 = time.perf_counter()
    slots = index.build_from(source, train_chunks=2)
    print(f"bulk-loaded {len(slots)} rows in {time.perf_counter() - t0:.1f}s "
          f"({index.get_stats()['hbm_bytes'] / 1e6:.0f} MB slab, "
          f"nlist={index.nlist})")

    # 2. recall tuning against the built-in exact oracle
    # (sample from the first chunk only — never materialize the corpus)
    sample = next(iter(source()))[:64]
    index.batch_flat_fallback = False  # exercise the real block scan
    recall = index.tune(sample, k=10, target_recall=0.95)
    print(f"tuned nprobe={index.nprobe} -> recall@10 {recall:.3f}")

    # 3. pipelined serving: NB batches in one call
    rng = np.random.default_rng(0)
    qstack = rng.standard_normal((4, 32, DIM)).astype(np.float32)
    t0 = time.perf_counter()
    index.search_pipelined(qstack, k=10)
    dt = time.perf_counter() - t0
    print(f"served {4 * 32} queries in one call "
          f"({4 * 32 / dt:,.0f} q/s incl. first-call set-up)")

    # 4. live mutation with stable ids
    fresh = rng.standard_normal((5, DIM)).astype(np.float32)
    fresh_slots = index.add_batch(fresh)
    _, hit = index.search(fresh[:1], k=1)
    assert hit[0, 0] == fresh_slots[0], "fresh row must be instantly visible"
    index.remove_slots(slots[:3])
    _, gone = index.search(next(iter(source()))[:3], k=1)
    assert not set(gone.ravel().tolist()) & set(slots[:3].tolist())
    index.build()  # absorb churn; external ids survive the permutation
    _, hit2 = index.search(fresh[:1], k=1)
    assert hit2[0, 0] == fresh_slots[0], "ids are stable across rebuilds"
    print("mutation + rebuild: fresh rows visible, deletes gone, ids stable")

    # 5. persistence round trip
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus")
        index.save(path)
        restored = ClusteredIVFIndex(
            DIM, dtype="int8", nlist=64, nprobe=index.nprobe,
            train_threshold=1 << 30, device=device,
        )
        assert restored.load(path)
        restored.batch_flat_fallback = False
        _, hit3 = restored.search(fresh[:1], k=1)
        assert hit3[0, 0] == fresh_slots[0]
        print(f"save/load round trip OK ({restored.count()} rows)")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--chunk", type=int, default=4_096,
                    help="rows a chunk of the streamed corpus (8 chunks)")
    args = ap.parse_args(argv)
    run(args.device, args.chunk)


if __name__ == "__main__":
    main()
