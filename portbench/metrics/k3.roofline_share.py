"""k3.roofline_share: K3's stage 1 (``csrc/clustered_scan.cu``) against
its roofline: the least time of each launch in the window, summed, over
the stage-1 kernels' device time summed from the trace. A launch's least
time (``roofline.block_scan_s``) counts its live blocks' rows, their
validity flags and scales, the block list, the queries in the kernel's
type and the results, over the card's HBM rate, or its products over
the query type's peak, whichever is larger. The shapes and the live
block count come from the program's ``kernel.k3`` spans (``live`` is
read from the device when the tracer is drained, after the window); a
program without them gives None."""

import sys

from portbench import progtrace, roofline

STAGE1 = r"clustered_(pipe|tiled|block_partial)_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    spans = progtrace.named(ctx, "kernel.k3")
    launches = [s for s in spans if "live" in s.attrs]
    device_s = ctx.trace.kernel_s(STAGE1)
    if not launches or device_s <= 0:
        return None
    least, bound, live = 0.0, set(), 0
    for s in launches:
        a = s.attrs
        t, by = roofline.block_scan_s(a["slab"], a["qtype"], a["live"],
                                      a["c"], a["d"], a["b"], a["k"], a["u"])
        least += t
        bound.add(by)
        live += a["live"]
    qtypes = sorted({s.attrs["qtype"] for s in launches})
    peaks = ", ".join(f"{q} {roofline.PEAK_QOPS_S[q]:.3g} op/s"
                      for q in qtypes)
    print(f"portbench: k3.roofline_share: {len(launches)} launches "
          f"({len(spans) - len(launches)} without a live count), "
          f"{live / len(launches):.1f} live blocks a launch, least "
          f"{least:.6f} s ({'/'.join(sorted(bound))} bound, "
          f"{roofline.HBM_BYTES_S:.3g} B/s, {peaks}), device "
          f"{device_s:.6f} s", file=sys.stderr)
    return 100.0 * least / device_s
