"""k1.roofline_share: K1's stage 1 (``csrc/fused_topk.cu``) against its
roofline: the least time of each launch in the window, summed, over the
stage-1 kernels' device time summed from the trace. A launch's least
time (``roofline.flat_stage1_s``) counts the slab's valid rows, their
validity flags, the queries and the partials written, over the card's
HBM rate, or its products over the bf16 peak, whichever is larger; the
launch's shapes come from the wrapper's call."""

import sys

from portbench import roofline

STAGE1 = r"fused_topk_(partial|tiled|pipe)_kernel"


def _launch(args, kwargs, out):
    db, queries = args[0], args[1]
    k = args[3] if len(args) > 3 else kwargs["k"]
    slab = "int4" if kwargs.get("int4") else str(db.dtype).split(".")[-1]
    return {"slab": slab, "b": int(queries.shape[0]),
            "d": int(queries.shape[1]), "k": int(k),
            "parts": int(out[0].shape[1])}


SPANS = [("wdbx_tpu_torch.kernels.fused_topk:fused_topk_partial", _launch)]


def read(ctx):
    if ctx.spans is None or ctx.trace is None:
        return None
    launches = ctx.spans.named("fused_topk_partial")
    device_s = ctx.trace.kernel_s(STAGE1)
    if not launches or device_s <= 0:
        return None
    least, bound = 0.0, set()
    for s in launches:
        m = s.meta
        t, by = roofline.flat_stage1_s(m["slab"], ctx.n_rows, m["d"],
                                       m["b"], m["k"], m["parts"])
        least += t
        bound.add(by)
    print(f"portbench: k1.roofline_share: {len(launches)} launches, least "
          f"{least:.6f} s ({'/'.join(sorted(bound))} bound, "
          f"{roofline.HBM_BYTES_S:.3g} B/s, bf16 "
          f"{roofline.PEAK_OPS_S['bfloat16']:.3g} op/s), device "
          f"{device_s:.6f} s", file=sys.stderr)
    return 100.0 * least / device_s
