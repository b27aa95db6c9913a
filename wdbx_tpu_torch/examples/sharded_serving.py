"""Multi-device serving demo: corpus sharding + replica groups + dynamic
query batching.

The port's counterpart of ``examples/sharded_serving.py``. The mesh is
``--shards`` logical positions (``WDBX_TORCH_MESH_SIZE``; default 8)
over the device: the corpus shards over 4 of them and replicates over 2
replica groups, a query batch splits over the replica groups, and
concurrent REST-style requests coalesce into device batches.

    python -m wdbx_tpu_torch.examples.sharded_serving [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import tempfile

import numpy as np

from wdbx_tpu_torch import WDBX
from wdbx_tpu_torch.api.batching import QueryBatcher
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV


async def run(device: str | None, n_pos: int, rows: int) -> None:
    replicas = 2 if n_pos >= 4 and n_pos % 2 == 0 else 1
    db = WDBX(
        vector_dimension=256,
        num_shards=1,  # the mesh does the sharding below this level
        data_dir=tempfile.mkdtemp(prefix="wdbx_sharded_"),
        enable_plugins=False,
        device=device,
        config={
            "INDEX_TYPE": "sharded_flat",
            "INDEX_DTYPE": "bfloat16",
            "MESH_REPLICAS": replicas,
            "VECTOR_STORE_KEEP_RAW": False,
            "VECTOR_STORE_AUTOSAVE_INTERVAL": 0,
        },
    )
    await db.initialize()
    index = db.store.indices[0]
    print(
        f"mesh: {index.n_devices} shards x {index.replicas} replicas "
        f"({n_pos} positions)"
    )

    rng = np.random.default_rng(0)
    vectors = {
        f"doc-{i}": rng.standard_normal(256).astype(np.float32)
        for i in range(rows)
    }
    await db.batch_store_async(vectors, {k: {"n": i} for i, k in enumerate(vectors)})
    print(f"stored {db.count_vectors()} vectors across the mesh")

    # Concurrent "requests" coalescing into device batches:
    batcher = QueryBatcher(db.store, max_batch=32, max_wait_ms=2.0)

    async def request(i: int):
        hits = await batcher.search(vectors[f"doc-{i}"], limit=3)
        assert hits[0][0] == f"doc-{i}", hits[0]
        return hits[0]

    results = await asyncio.gather(*(request(i) for i in range(64)))
    stats = batcher.get_stats()
    print(
        f"{stats['requests']} concurrent requests served in "
        f"{stats['batches']} device batches "
        f"(avg batch {stats.get('avg_batch_size', 1)})"
    )
    print(f"top hit example: {results[0][0]} score={results[0][1]:.4f}")
    await db.shutdown()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--shards", type=int, default=8,
                    help="logical mesh positions")
    ap.add_argument("--rows", type=int, default=5_000)
    args = ap.parse_args(argv)
    os.environ[MESH_SIZE_ENV] = str(args.shards)
    asyncio.run(run(args.device, args.shards, args.rows))


if __name__ == "__main__":
    main()
