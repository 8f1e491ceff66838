"""The PyTorch/CUDA port's benchmark: one run of one cell.

    python3 portbench/run.py --workload chr21.pe150 --seed 7 --seconds 30 \
        --trace 0

Runs `python -m bwamem_tpu_torch align` (through portbench/child.py) on
the cell's configuration, feeds it the cell's reads through a pipe for
--seconds after a one-chunk warm-up, checks a sample of the SAM records
against the plain reference (pbcore/reference.py), and prints one JSON
line: the cell's end-to-end metrics (--trace 0) or its per-layer metrics
(--trace 1), `correct`, the device, and last the numbers compared with
their limits. The same numbers close standard error. Exits non-zero with
no result when the card is missing, the program fails, or JAX was loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from pbcore import registry  # noqa: E402
from pbcore.cell import RunFailed, run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(registry.benchmark(), args.workload, args.seed,
                       args.seconds, bool(args.trace))
    except (RunFailed, KeyError) as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 2
    for k, v in out.result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
