"""With the timed path broken underneath, the rest of a run sees
``correct`` come out false: once for each fault a search cell can have.

* a state left unchanged: the store answers every batch with the first
  answers it produced (a stale result cache);
* half of the batch left out: the store searches the first half of each
  batch and hands its answers to the other half too;
* an answer altered where it is produced: one hit's id in each merged
  batch names another row.

The exchange between chips does not exist in these one-chip cells.
The faults are planted in the store, under the facade, so the entry
carries them to its callers.
"""

import pytest
from portbench import harness
from wdbx_tpu_torch.store.vector_store import VectorStore

BENCH = harness.spec()
CELLS = [w["name"] for w in BENCH["workloads"]]
MERGE = VectorStore._merge_hits


def stale(monkeypatch):
    first = {}

    def merge(self, per_shard, id_tables, queries, b, *args):
        out = MERGE(self, per_shard, id_tables, queries, b, *args)
        return first.setdefault(b, out)

    monkeypatch.setattr(VectorStore, "_merge_hits", merge)


def half_left_out(monkeypatch):
    def merge(self, per_shard, id_tables, queries, b, *args):
        keep = max(1, b // 2)
        per_shard = [(s[:keep], sl[:keep]) for s, sl in per_shard]
        out = MERGE(self, per_shard, id_tables, queries[:keep], keep, *args)
        return [out[i % keep] for i in range(b)]

    monkeypatch.setattr(VectorStore, "_merge_hits", merge)


def altered(monkeypatch):
    def merge(self, *args):
        out = MERGE(self, *args)
        vid, score, meta = out[0][0]
        out[0][0] = (str((int(vid) + 1) % 16384), score, meta)
        return out

    monkeypatch.setattr(VectorStore, "_merge_hits", merge)


@pytest.mark.parametrize("fault", [stale, half_left_out, altered],
                         ids=["state_unchanged", "half_left_out", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault, tiny,
                                      seed):
    fault(monkeypatch)
    line, _ = harness.run_cell(workload, seed, 1.0, False, device="cpu",
                               overrides=tiny, bench=BENCH)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
