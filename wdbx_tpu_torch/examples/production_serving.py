"""Production-serving walkthrough: sharded IVF, pipelined throughput,
failure recovery, and the live dashboard.

The port's counterpart of ``examples/production_serving.py``, on a mesh
of ``--shards`` logical positions (``WDBX_TORCH_MESH_SIZE``; default 8):
  1. a mesh-sharded IVF corpus (bucket tables split over the shards);
  2. ``search_pipelined``, NB query batches in one call, also kept in
     flight with ``materialize=False``;
  3. ``tune()``, the smallest nprobe hitting a recall target against the
     index's own exact oracle;
  4. checkpoint + ``heal()``, failure detection and re-hosting from the
     last checkpoint;
  5. the interactive dashboard payload served by GET /api/v1/visualize.

    python -m wdbx_tpu_torch.examples.production_serving [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import tempfile

import numpy as np

from wdbx_tpu_torch import WDBX, WDBXConfig
from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV


async def run(device: str | None) -> None:
    rng = np.random.default_rng(0)
    data_dir = tempfile.mkdtemp(prefix="wdbx_prod_")
    db = WDBX(
        vector_dimension=64,
        num_shards=1,  # the mesh shards below this level
        data_dir=data_dir,
        enable_plugins=False,
        enable_distributed=True,  # ShardEngine: health checks + failover
        device=device,
        config=WDBXConfig({
            "INDEX_TYPE": "sharded_ivf",
            "IVF_NLIST": 16,
            "IVF_NPROBE": 4,
            "IVF_TRAIN_THRESHOLD": 512,
        }),
    )
    await db.initialize()

    # -- 1. ingest a clustered corpus (realistic embedding geometry) ----
    centers = rng.standard_normal((16, 64)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    cid = rng.integers(0, 16, 4096)
    vecs = centers[cid] + 0.05 * rng.standard_normal((4096, 64)).astype(
        np.float32
    )
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    db.batch_store({f"doc-{i}": v for i, v in enumerate(vecs)})
    index = db.store.indices[0]
    index.build()
    # the trained bucket count; on a mesh spanning ranks each rank holds
    # only its own shards' tables
    nlist = int(index._centroids.shape[0])
    print(f"corpus: {db.count_vectors()} vectors, "
          f"index: {index.kind}, nlist={nlist}, "
          f"tables split over {index.n_devices} '{index.axis}' "
          f"positions")

    # -- 2. tune nprobe to a recall target ------------------------------
    recall = index.tune(vecs[:64], k=10, target_recall=0.95)
    print(f"tuned: nprobe={index.nprobe} recall@10={recall:.3f}")

    # -- 3. pipelined throughput serving --------------------------------
    qstack = vecs[:256].reshape(8, 32, 64)  # 8 batches x 32 queries
    scores, slots = index.search_pipelined(qstack, k=5)
    correct = int((slots[:, :, 0].reshape(-1) >= 0).sum())
    print(f"pipelined: served {8 * 32} queries in one call "
          f"({correct} hits), top-1 self-match "
          f"{(slots[:, :, 0].reshape(-1) == np.arange(256)).mean():.2%}")

    # Steady-state serving keeps several calls IN FLIGHT: enqueue
    # without blocking (materialize=False), resolve in arrival order;
    # resolve all handles before mutating the index.
    handles = [
        index.search_pipelined(qstack, k=5, materialize=False)
        for _ in range(3)
    ]
    for h in handles:
        _, g_i = index.resolve_pipelined(h)
        assert (g_i == slots).all()
    print(f"in-flight: {len(handles)} calls double-buffered, "
          f"results identical to the blocking path")

    # -- 4. checkpoint, simulated failure, heal -------------------------
    db.store.save()
    db.store.indices[0].clear()  # simulated device loss
    report = db.heal()
    print(f"heal: healthy={report['healthy']} "
          f"recovered shards={report['recovered_shards']}")
    hit = db.vector_search(vecs[7], limit=1)[0]
    print(f"post-heal query: {hit[0]} (expect doc-7)")

    # -- 5. dashboard payload (what GET /api/v1/visualize serves) -------
    from wdbx_tpu_torch.utils.visualization import VectorVisualizer

    html = VectorVisualizer(db).dashboard_html(max_vectors=200)
    out = os.path.join(data_dir, "dashboard.html")
    with open(out, "w") as f:
        f.write(html)
    print(f"dashboard: {len(html)} bytes -> {out}")

    await db.shutdown()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--shards", type=int, default=8,
                    help="logical mesh positions")
    args = ap.parse_args(argv)
    os.environ[MESH_SIZE_ENV] = str(args.shards)
    asyncio.run(run(args.device))


if __name__ == "__main__":
    main()
