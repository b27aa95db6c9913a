"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, keyed by a hash of the sources and flags,
into ``build/kernels`` at the checkout root (git-ignored), so a fresh
checkout builds on its first call and later calls reuse it.
Nothing here runs at import: this module imports on machines without
``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lineinfo",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures of each library's entry points: name -> (restype, argtypes)
SIGNATURES = {
    "fused_topk": {
        "wdbx_fused_topk_partial": (
            _I, [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 _P, _P, _P],
        ),
        "wdbx_topk_merge_partials": (
            _I, [_P, _P, _I, _I, _I, _I, _P, _P, _P],
        ),
        "wdbx_fused_topk_partial_smem": (
            ctypes.c_size_t, [_I, _I, _I, _I, _I]),
    },
    "clustered_scan": {
        "wdbx_clustered_block_partial": (
            _I, [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
        ),
        "wdbx_clustered_block_partial_smem": (
            ctypes.c_size_t, [_I, _I, _I, _I, _I, _I]),
    },
    "ivf_scan": {
        "wdbx_ivf_bucket_partial": (
            _I, [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                 _P, _P, _P],
        ),
        "wdbx_ivf_bucket_partial_warps": (_I, []),
        "wdbx_ivf_group_pairs": (
            _I, [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
        "wdbx_ivf_grouped_warps": (_I, [_I, _I, _I, _I]),
        "wdbx_ivf_grouped_scan": (
            _I, [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                 _I, _I, _P, _P, _P, _P],
        ),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_mu = threading.Lock()
#: name -> {"seconds": build wall time (0.0 when cached), "log": ptxas}
build_info: dict[str, dict] = {}


BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build on a machine with the CUDA "
        "toolkit (PATH or /usr/local/cuda/bin)"
    )


def _target(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith((".cuh", ".h")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source (None when the library is built)."""
    out = _target(name)
    if os.path.exists(out):
        build_info.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}


def build_all() -> dict[str, dict]:
    """Compile every ``csrc/*.cu`` at once (one nvcc each, in parallel)
    and load them. Returns ``build_info``."""
    names = sorted(
        fn[:-3] for fn in os.listdir(CSRC) if fn.endswith(".cu")
    )
    with _mu:
        started = {n: _start(n) for n in names if n not in _libs}
        for n, s in started.items():
            _finish(n, s)
    for n in names:
        load(n)
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed. Raises when the build fails: there is no fallback."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _mu:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _finish(name, _start(name))
        lib = ctypes.CDLL(_target(name))
        for fn, (res, args) in SIGNATURES.get(name, {}).items():
            f = getattr(lib, fn)
            f.restype = res
            f.argtypes = args
        _libs[name] = lib
        return lib
