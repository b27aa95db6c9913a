"""store.merge_cpu_ms_per_call: the mean thread CPU time of the
program's ``store.merge`` spans (``VectorStore._merge_hits``) inside the
window: the merge's own work, whatever the other threads do."""

from portbench import progtrace


def read(ctx):
    merges = progtrace.named(ctx, "store.merge")
    if not merges:
        return None
    return 1e-6 * sum(s.cpu_ns for s in merges) / len(merges)
