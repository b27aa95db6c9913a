"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload flat10m.bulk --seed 7 \
        --seconds 51 --trace 0

Run from the root of a checkout on a machine with the cards the cell
asks for. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, then ``checks``); the last lines of
standard error give each number the check compared beside its limit.
Without a card, with fewer cards than the cell asks for, or with a
forbidden module loaded after the window, it prints no result and exits
with another code than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)
# the port's kernel build directory is inside the checkout already; keep
# any kernel cache of torch itself there too, at a fixed path
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                      os.path.join(ROOT, "build", "torch_kernels"))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "wdbx_tpu_torch")):
        print("portbench: the program (wdbx_tpu_torch/) is not in this "
              "checkout", file=sys.stderr)
        return 4
    from portbench import harness

    import torch

    cell = harness.cell_of(harness.spec(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace))
    leaked = harness.leaked_modules()
    if leaked:
        print(f"portbench: forbidden modules loaded: {leaked}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for text in checks:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
