"""host.lock_wait_ms_per_call: per ``store.search_batch`` span inside
the window, the ``lock_wait_ns`` of its ``store.prep`` spans (taking the
store's lock) and of its ``index.search`` spans (taking the index's read
lock), summed; the mean over the calls."""

from portbench import progtrace

WAITS = ("store.prep", "index.search")


def read(ctx):
    calls = progtrace.named(ctx, "store.search_batch")
    if not calls:
        return None
    waited = {s.id: 0 for s in calls}
    for s in progtrace.spans(ctx):
        if s.name in WAITS and s.call in waited:
            waited[s.call] += s.attrs.get("lock_wait_ns", 0)
    return 1e-6 * sum(waited.values()) / len(waited)
