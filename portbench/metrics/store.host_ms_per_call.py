"""store.host_ms_per_call: the host's own time in each
``VectorStore.search_batch`` call: its span less the index call inside
it (``FlatIndex.search`` or the IVF engines' ``IVFIndex.search``, which
hold the device's work and the wait for it)."""

from portbench.spans import self_time

INDEX_CALLS = {"FlatIndex.search", "IVFIndex.search"}
SPANS = ["wdbx_tpu_torch.store.vector_store:VectorStore.search_batch",
         "wdbx_tpu_torch.index.flat:FlatIndex.search",
         "wdbx_tpu_torch.index.ivf:IVFIndex.search"]


def read(ctx):
    if ctx.spans is None:
        return None
    calls = ctx.spans.named("VectorStore.search_batch")
    if not calls:
        return None
    kids = ctx.spans.children()
    own = [self_time(s, kids, INDEX_CALLS) for s in calls]
    return 1e3 * sum(own) / len(own)
