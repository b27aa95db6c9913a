"""Basic usage — store, search, filter, persist.

The port's counterpart of ``examples/basic_usage.py``: create a DB,
store vectors with metadata, similarity-search, read stats, and the
batch paths.

    python -m wdbx_tpu_torch.examples.basic_usage [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio

import numpy as np

from wdbx_tpu_torch import WDBX


async def run(device: str | None, rows: int, data_dir: str) -> None:
    db = WDBX(vector_dimension=384, num_shards=2, data_dir=data_dir,
              device=device)
    await db.initialize()

    rng = np.random.default_rng(42)

    # Store one vector with metadata.
    vec = rng.standard_normal(384).astype(np.float32)
    vid = await db.vector_store_async(vec.tolist(), {"title": "hello", "rank": 1})
    print(f"stored {vid}")

    # Batch-store the corpus: one indexed write per shard.
    vectors = {
        f"doc-{i}": rng.standard_normal(384).astype(np.float32)
        for i in range(rows)
    }
    metadata = {f"doc-{i}": {"rank": i % 100} for i in range(rows)}
    count = await db.batch_store_async(vectors, metadata)
    print(f"batch stored {count} vectors; total {db.count_vectors()}")

    # Top-5 search (flat cosine, top-5).
    hits = await db.vector_search_async(vec.tolist(), limit=5)
    for hit_id, score, meta in hits:
        print(f"  {hit_id}  score={score:.4f}  {meta}")

    # Filtered search: only rank < 10.
    hits = await db.vector_search_async(
        vectors["doc-123"].tolist(), limit=5,
        filter_metadata={"rank": {"$lt": 10}},
    )
    print(f"filtered hits: {[h[0] for h in hits]}")

    # Batched queries: one kernel launch pair for the whole batch.
    queries = np.stack([vectors[f"doc-{i}"] for i in range(64)])
    results = await db.vector_search_batch_async(queries, limit=3)
    print(f"batch search: {len(results)} result lists; "
          f"self-hit rate {sum(r[0][0] == f'doc-{i}' for i, r in enumerate(results)) / 64:.2f}")

    print({k: v for k, v in db.get_stats().items() if k != "indices"})
    await db.shutdown()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--rows", type=int, default=10_000)
    ap.add_argument("--data-dir", default="./wdbx_data_example")
    args = ap.parse_args(argv)
    asyncio.run(run(args.device, args.rows, args.data_dir))


if __name__ == "__main__":
    main()
