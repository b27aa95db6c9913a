"""wdbx_tpu_torch — the PyTorch / CUDA port of wdbx_tpu.

The same vector database as ``wdbx_tpu`` (same config keys, slot
contract and on-disk format), with the device slabs held as torch
tensors and the kernels written by hand in CUDA C++ for Hopper
(``csrc/``: the fused score + top-k, the clustered block scan and the
IVF bucket scan). Entry points run on the CUDA
device unless the caller passes ``device="cpu"``:

    from wdbx_tpu_torch import WDBX
    db = WDBX(vector_dimension=384, enable_plugins=False)      # cuda
    db = WDBX(vector_dimension=384, enable_plugins=False, device="cpu")
"""

__version__ = "0.1.0"

__all__ = ["WDBX", "WDBXConfig", "VectorStore", "FlatIndex", "IVFIndex",
           "__version__"]

_LAZY = {
    "WDBX": ("wdbx_tpu_torch.core.wdbx", "WDBX"),
    "WDBXConfig": ("wdbx_tpu_torch.core.config", "WDBXConfig"),
    "VectorStore": ("wdbx_tpu_torch.store.vector_store", "VectorStore"),
    "FlatIndex": ("wdbx_tpu_torch.index.flat", "FlatIndex"),
    "IVFIndex": ("wdbx_tpu_torch.index.ivf", "IVFIndex"),
}


def __getattr__(name):  # lazy: keep `import wdbx_tpu_torch.ops` light
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'wdbx_tpu_torch' has no attribute {name!r}")
