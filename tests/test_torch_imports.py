"""The port stands alone: importing every module of wdbx_tpu_torch
(the serving surfaces, the mesh layer and the examples too) loads neither
JAX nor the JAX package, and an index with no device refuses to start
without CUDA."""

import json
import subprocess
import sys

_PROBE = r"""
import importlib, json, pkgutil, sys
import torch
import wdbx_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    wdbx_tpu_torch.__path__, "wdbx_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "wdbx_tpu" or m.startswith("wdbx_tpu."))
raised = None
if not torch.cuda.is_available():
    from wdbx_tpu_torch.index.flat import FlatIndex
    try:
        FlatIndex(8)
    except RuntimeError as e:
        raised = str(e)
print(json.dumps({"modules": names, "jax": "jax" in sys.modules,
                  "leaked": leaked, "cuda": torch.cuda.is_available(),
                  "raised": raised}))
"""


def _probe():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_reference_package():
    got = _probe()
    assert not got["jax"], "a wdbx_tpu_torch module imported jax"
    assert got["leaked"] == []
    for mod in (
        "wdbx_tpu_torch.ops.normalize", "wdbx_tpu_torch.ops.exact_search",
        "wdbx_tpu_torch.ops.topk", "wdbx_tpu_torch.kernels.quant",
        "wdbx_tpu_torch.kernels.fused_topk", "wdbx_tpu_torch.kernels.build",
        "wdbx_tpu_torch.utils.rwlock", "wdbx_tpu_torch.index.base",
        "wdbx_tpu_torch.index.flat", "wdbx_tpu_torch.native",
        "wdbx_tpu_torch.store.filters", "wdbx_tpu_torch.store.metastore",
        "wdbx_tpu_torch.store.rawstore", "wdbx_tpu_torch.store.atomic",
        "wdbx_tpu_torch.utils.metrics", "wdbx_tpu_torch.store.vector_store",
        "wdbx_tpu_torch.core.config", "wdbx_tpu_torch.utils.config_loader",
        "wdbx_tpu_torch.core.wdbx", "wdbx_tpu_torch.convert",
        "wdbx_tpu_torch.ops.kmeans", "wdbx_tpu_torch.kernels.clustered_scan",
        "wdbx_tpu_torch.index.ivf", "wdbx_tpu_torch.index.clustered",
        "wdbx_tpu_torch.kernels.ivf_scan",
        "wdbx_tpu_torch.plugins", "wdbx_tpu_torch.plugins.base",
        "wdbx_tpu_torch.plugins.local_embeddings",
        "wdbx_tpu_torch.plugins.ollama", "wdbx_tpu_torch.plugins.lmstudio",
        "wdbx_tpu_torch.plugins.webscraper",
        "wdbx_tpu_torch.plugins.social_media", "wdbx_tpu_torch.api",
        "wdbx_tpu_torch.api.batching", "wdbx_tpu_torch.api.server",
        "wdbx_tpu_torch.utils.logging", "wdbx_tpu_torch.utils.security",
        "wdbx_tpu_torch.utils.data_utils",
        "wdbx_tpu_torch.utils.visualization", "wdbx_tpu_torch.cli",
        "wdbx_tpu_torch.parallel", "wdbx_tpu_torch.parallel.mesh",
        "wdbx_tpu_torch.parallel.shard_engine",
        "wdbx_tpu_torch.parallel.sharded_flat",
        "wdbx_tpu_torch.parallel.sharded_ivf",
        "wdbx_tpu_torch.store.persist", "wdbx_tpu_torch.examples",
        "wdbx_tpu_torch.examples.basic_usage",
        "wdbx_tpu_torch.examples.rag_implementation",
        "wdbx_tpu_torch.examples.clustered_at_scale",
        "wdbx_tpu_torch.examples.sharded_serving",
        "wdbx_tpu_torch.examples.production_serving",
    ):
        assert mod in got["modules"], mod
    if not got["cuda"]:
        assert got["raised"] and "device='cpu'" in got["raised"]


def test_sharded_engines_are_exported():
    import wdbx_tpu_torch
    import wdbx_tpu_torch.index as index
    import wdbx_tpu_torch.parallel as parallel
    from wdbx_tpu_torch.parallel.sharded_flat import ShardedFlatIndex
    from wdbx_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    for name, cls in (("ShardedFlatIndex", ShardedFlatIndex),
                      ("ShardedIVFIndex", ShardedIVFIndex)):
        assert getattr(wdbx_tpu_torch, name) is cls
        assert getattr(index, name) is cls
        assert getattr(parallel, name) is cls
        assert name in wdbx_tpu_torch.__all__ and name in parallel.__all__
    assert {"make_mesh", "make_mesh2", "ShardEngine"} <= set(parallel.__all__)


def test_root_exports_the_dense_ivf_index():
    from wdbx_tpu_torch import IVFIndex
    from wdbx_tpu_torch.index.ivf import IVFIndex as dense

    import wdbx_tpu_torch

    assert IVFIndex is dense
    assert "IVFIndex" in wdbx_tpu_torch.__all__
