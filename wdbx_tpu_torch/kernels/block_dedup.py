"""The clustered scan's block-list dedup on the card: the wrapper of
``csrc/block_dedup.cu``.

``index.clustered._dedup_blocks`` calls ``block_dedup`` for CUDA
tensors: one launch (one CTA) in place of the ~30 PyTorch operations of
``_dedup_blocks_plain``, each a launch and a round through the
interpreter that concurrent callers share. Same function, entry for
entry: the distinct live blocks of the probed buckets, most-probed
first (the count capped as the JAX ranking caps it), ties by block id,
then ``nblocks - 1`` with ``ok`` false. The kernel takes up to
``MAX_BLOCKS`` blocks (its counts and sort keys live in shared memory);
beyond that, or on other tensors, ``block_dedup`` returns None and the
caller runs the plain version.
"""

from __future__ import annotations

import torch

from wdbx_tpu_torch.kernels import fused_topk as _ft

#: the most blocks one launch takes (``kMaxBlocks`` of the kernel)
MAX_BLOCKS = 16384


def block_dedup(probe: torch.Tensor, blk_lo: torch.Tensor,
                blk_hi: torch.Tensor, nblocks: int, u: int, m: int,
                valid: torch.Tensor | None = None, c: int | None = None):
    """``(uniq, ok)``: (min(u, probes * m),) int64 block ids and bool
    flags, as ``index.clustered._dedup_blocks`` returns them, from one
    launch; None where the kernel's rule does not hold (not CUDA
    tensors, more than ``MAX_BLOCKS`` blocks, a ranking whose int32
    clamp leaves no count)."""
    from wdbx_tpu_torch.kernels import build

    r = probe.numel()
    bp = r * m
    u = min(u, bp)
    cap_count = (2**31 - 1 - bp) // max(1, bp)
    tensors = (probe, blk_lo, blk_hi) + ((valid,) if valid is not None
                                         else ())
    if (not all(t.is_cuda for t in tensors) or r < 1 or m < 1 or u < 1
            or not 1 <= nblocks <= MAX_BLOCKS or cap_count < 1
            or (valid is not None and (c is None or c < 1
                                       or valid.numel() < nblocks * c))):
        return None
    probe = probe.reshape(-1).to(torch.int64).contiguous()
    blk_lo = blk_lo.to(torch.int64).contiguous()
    blk_hi = blk_hi.to(torch.int64).contiguous()
    if valid is not None:
        valid = valid.reshape(-1)
        if valid.dtype not in (torch.bool, torch.uint8, torch.int8):
            valid = valid != 0
        valid = valid.contiguous()
    uniq = torch.empty(u, dtype=torch.int64, device=probe.device)
    ok = torch.empty(u, dtype=torch.bool, device=probe.device)
    lib = build.load("block_dedup")
    with _ft._on(probe):
        rc = lib.wdbx_block_dedup(
            probe.data_ptr(), r, blk_lo.data_ptr(), blk_hi.data_ptr(), m,
            valid.data_ptr() if valid is not None else None, c or 1,
            nblocks, cap_count, u, uniq.data_ptr(), ok.data_ptr(),
            _ft._stream(probe),
        )
    if rc != 0:
        raise RuntimeError(f"block_dedup launch failed: CUDA error {rc}")
    block_dedup.launches += 1
    return uniq, ok


block_dedup.launches = 0
