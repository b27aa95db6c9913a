"""store.merge_offcpu_ms_per_call: the mean of each ``store.merge``
span's wall time less its thread CPU time, inside the window. The merge
does no I/O without metadata or a raw re-rank, so this is mostly time it
was runnable while another thread held the interpreter."""

from portbench import progtrace


def read(ctx):
    merges = progtrace.named(ctx, "store.merge")
    if not merges:
        return None
    off = sum(s.t1 - s.t0 - s.cpu_ns for s in merges)
    return 1e-6 * off / len(merges)
