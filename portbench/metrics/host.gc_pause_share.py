"""host.gc_pause_share: the union of the interpreter's collections
(``gc.collect`` spans, on any thread) inside the window, over the
window. Every thread waits for a collection. Prints to stderr the
collections' count and seconds by generation."""

import sys

from portbench import progtrace


def read(ctx):
    got = progtrace.spans(ctx)
    pauses = [s for s in got or () if s.name == "gc.collect"]
    if not pauses:
        return None
    w0, w1 = progtrace.window(ctx)
    by: dict[int, list] = {}
    for s in pauses:
        n_s = by.setdefault(s.attrs["generation"], [0, 0])
        n_s[0] += 1
        n_s[1] += s.t1 - s.t0
    print("portbench: host.gc_pause_share: collections by generation: "
          + ", ".join(f"gen{g} {n} in {t * 1e-9:.3f} s"
                      for g, (n, t) in sorted(by.items())), file=sys.stderr)
    return 100.0 * progtrace.union_ns([(s.t0, s.t1) for s in pauses],
                                      w0, w1) / (w1 - w0)
