"""clustered.enqueue_ms_per_call: the host time the clustered engine
takes to queue a batch: the mean wall time of the window's
``index.search`` spans of ``ClusteredIVFIndex`` less the ``index.d2h``
spans inside them (the result copy, which waits for the device). What
is left is the read lock, the probe, the block dedup, K3's enqueue, the
stage-2 merge and the residual merge, each of which only queues device
work (a batch the engine hands to its flat scan brings that scan's copy
inside a nested ``index.search``). A program whose clustered engine has
no ``index.d2h`` span inside its search cannot split the wait off, and
gives None. Prints the mean wall and thread CPU time of the search and
of each span inside it beside it."""

import sys

from portbench import progtrace

ENGINE = "ClusteredIVFIndex"
INSIDE = ("index.probe", "index.dedup", "kernel.k3", "index.residual_merge",
          "index.d2h")


def read(ctx):
    calls = {s.id: s for s in progtrace.named(ctx, "index.search")
             if s.attrs.get("engine") == ENGINE}
    if not calls:
        return None
    got = progtrace.spans(ctx)
    parent = {s.id: s.parent for s in got}
    inside: dict[str, list] = {name: [] for name in INSIDE}
    cpu: dict[str, int] = dict.fromkeys(INSIDE, 0)
    d2h = dict.fromkeys(calls, 0)
    for s in got:
        if s.name not in inside:
            continue
        up = s.parent
        while up and up not in calls:
            up = parent.get(up, 0)
        if up:
            inside[s.name].append(s.t1 - s.t0)
            cpu[s.name] += s.cpu_ns
            if s.name == "index.d2h":
                d2h[up] += s.t1 - s.t0
    own = [s.t1 - s.t0 - d2h[i] for i, s in calls.items() if d2h[i]]
    if not own:
        return None
    means = ", ".join(
        f"{name} {1e-6 * sum(v) / len(v):.3f} ms (cpu "
        f"{1e-6 * cpu[name] / len(v):.3f}) x{len(v)}"
        for name, v in inside.items() if v)
    whole = [s for i, s in calls.items() if d2h[i]]
    print(f"portbench: clustered.enqueue_ms_per_call: {len(own)} of "
          f"{len(calls)} calls with a result copy, index.search "
          f"{1e-6 * sum(s.t1 - s.t0 for s in whole) / len(whole):.3f} ms "
          f"(cpu {1e-6 * sum(s.cpu_ns for s in whole) / len(whole):.3f}); "
          f"inside them: {means}", file=sys.stderr)
    return 1e-6 * sum(own) / len(own)
