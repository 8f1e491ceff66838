"""The control of a cell's correctness check, and the program's readings
beside it, over several seeds.

    python3 portbench/control.py --workload chr21.pe150 --seeds 1,2,3 \
        --seconds 30 [--fault norescue]

For each seed it makes one run of the cell, as `run.py` does (the same
`run_cell`, the same child, the same metrics), and judges the sampled
records twice: as the program wrote them (the lower readings), and with
each mapped primary's AS taken from the plain reference's DP run on
8-bit cells (the step below the 16-bit cells the configuration states),
in the program's place (the upper readings). With --fault, the program
runs with that fault of `tests/fault_child.py` planted in its timed path,
and its own readings are the fault's. Prints a JSON line per seed with
the run's result and both readings and, last, the largest program
reading and the smallest control reading of each number. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from pbcore import reference, registry  # noqa: E402
from pbcore.cell import BASE, run_cell  # noqa: E402

# the step below the configuration's 16-bit DP cells
CONTROL_BITS = 8


def readings(out, bits: int) -> tuple[dict, dict]:
    prog = {k: v["value"] for k, v in out.result["checks"].items()}
    ctl = reference.judge(out.genome, out.sample, out.scoring,
                          replace_as=reference.control_as(
                              out.genome, out.sample, out.scoring, bits))
    ctl["order_wrong"] = prog["order_wrong"]
    return prog, {k: ctl.get(k, 0) for k in prog}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    child = None
    if args.fault:
        os.environ["PORTBENCH_FAULT"] = args.fault
        child = BASE / "tests" / "fault_child.py"
    lower: dict = {}
    upper: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(bench, args.workload, seed, args.seconds, False,
                       child_script=child)
        prog, ctl = readings(out, CONTROL_BITS)
        for k in prog:
            lower[k] = max(lower.get(k, 0), prog[k])
            upper[k] = min(upper.get(k, ctl[k]), ctl[k])
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "program": prog, "control": ctl,
                          "result": out.result}), flush=True)
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
