"""The port stands alone: importing every module of wdbx_tpu_torch
loads neither JAX nor the JAX package, and an index with no device
refuses to start without CUDA."""

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
    ):
        assert mod in got["modules"], mod
    if not got["cuda"]:
        assert got["raised"] and "device='cpu'" in got["raised"]


def test_root_exports_the_dense_ivf_index():
    from wdbx_tpu_torch import IVFIndex
    from wdbx_tpu_torch.index.ivf import IVFIndex as dense

    import wdbx_tpu_torch

    assert IVFIndex is dense
    assert "IVFIndex" in wdbx_tpu_torch.__all__
