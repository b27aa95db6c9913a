"""device.idle_in_index_share: the share of the window in which the card
is idle while at least one caller is inside ``index.search``: that
caller's K1 is not yet enqueued or already done, so the host's index
path or the interpreter holds back work that is ready. Device gaps from
the trace (``devtrace.py``, host clock), the program's spans from its
tracer. Prints to stderr the idle seconds by the most advanced state of
any thread (``progtrace.STATES``), the launch count and clock check
against the trace, and ``store.search_batch`` less ``index.search``."""

import sys

from portbench import progtrace


def read(ctx):
    got = progtrace.spans(ctx)
    if ctx.trace is None or not got or \
            not any(s.name == "index.search" for s in got):
        return None
    w0, w1 = progtrace.window(ctx)
    by, in_index = progtrace.idle_by_state(
        got, progtrace.gaps_ns(ctx.trace, w0, w1))
    n_k1, n_kernels, leads = progtrace.clock_check(got, ctx.trace, w0, w1)
    leads = sorted(leads) or [0]
    host = {s.id: s.t1 - s.t0
            for s in progtrace.named(ctx, "store.search_batch")}
    for s in got:
        if s.name == "index.search" and s.parent in host:
            host[s.parent] -= s.t1 - s.t0
    table = ", ".join(f"{k} {v * 1e-9:.3f}" for k, v in by.items())
    print(f"portbench: device.idle_in_index_share: idle s by state: {table}; "
          f"idle in index {in_index * 1e-9:.3f} s of {(w1 - w0) * 1e-9:.3f}; "
          f"kernel.k1 spans {n_k1}, stage-1 kernels {n_kernels}, a kernel "
          f"ahead of its launch by at most {leads[-1] * 1e-3:.1f} us "
          f"(median {leads[len(leads) // 2] * 1e-3:.1f}); "
          f"store.search_batch less index.search "
          f"{1e-6 * sum(host.values()) / max(1, len(host)):.3f} ms over {len(host)} "
          f"calls; spans dropped {progtrace.TRACER.dropped}", file=sys.stderr)
    return 100.0 * in_index / (w1 - w0)
