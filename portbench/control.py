"""Read the numbers a cell's limits are set from: the program's, and
its control's, the program with its own path one precision below the
configuration's switched on (the configuration's ``control``: for the
bf16 flat slab, ``INDEX_DTYPE=int8``).

    python3 portbench/control.py --workload flat10m.bulk --seconds 13 \
        --seeds 1 2 3 --control-seeds 1 2 3

Each reading is one run of the cell through the harness, at the cell's
own size and load, with every call of a short window checked
(``check_share`` 1), in one process, so the kernels build once. Prints
one JSON line a run with every number ``check.py`` reads, beside the
configuration's limits: the program's have to read below them, the
control's above. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def reading(workload: str, seed: int, seconds: float, control: bool,
            device: str = "cuda", overrides: dict | None = None,
            bench: dict | None = None) -> dict:
    """One run of ``workload``, as configured or with its control on."""
    from portbench import harness

    bench = bench or harness.spec()
    config = harness.config_of(bench, harness.cell_of(bench, workload)["config"])
    over = harness.merge({"traffic": {"check_share": 1.0}}, overrides)
    if control:
        over = harness.merge(over, {"config": config["control"]})
    got: dict = {}
    line, _ = harness.run_cell(workload, seed, seconds, False, device=device,
                               overrides=over, bench=bench, readings=got)
    return {"correct": line["correct"], "attempted": line["attempted"],
            "readings": got, "checks": line["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench: the readings run on a CUDA card", file=sys.stderr)
        return 2
    runs = [(s, True) for s in args.control_seeds] + \
        [(s, False) for s in args.seeds]
    for seed, control in runs:
        t = time.perf_counter()
        got = reading(args.workload, seed, args.seconds, control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control" if control else "program",
                          **got, "seconds": time.perf_counter() - t,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
