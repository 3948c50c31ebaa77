"""Readings that the limits of a cell's check are set from (run on the card
at the cell's own size):

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --stand_in_seeds 3 [--out FILE]

- the program, on `--seeds` seeds: set-up (the check steps), then the check
  against the reference, as a run makes it but without a measured window;
- each stand-in of the cell's driver (STAND_INS) on `--stand_in_seeds` seeds:
  the reference put in the program's place in the precision below the
  configuration's (the control), or with a fault planted.

Every reading is printed as one JSON line and appended to `--out`.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness.main import Context, fix_environment  # noqa: E402
from perfbench.harness.manifest import Cell  # noqa: E402
from perfbench.harness.spans import NoSpans  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--stand_in_seeds", type=int, default=3)
    p.add_argument("--first_seed", type=int, default=3_000_000_000)
    p.add_argument("--kinds", default="", help="comma-separated: program and stand-ins (default: all)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    fix_environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    dev = torch.device("cuda:0")
    kinds = args.kinds.split(",") if args.kinds else ["program", *cell.driver.STAND_INS]
    for kind in kinds:
        n = args.seeds if kind == "program" else args.stand_in_seeds
        for i in range(n):
            seed = args.first_seed + 7919 * i + (0 if kind == "program" else 1)
            ctx = Context(seed, dev, cell.config, cell.traffic, NoSpans())
            t0 = time.perf_counter()
            if kind == "program":
                drv = cell.driver.Driver(ctx)
                drv.setup()
                drv.release()
                torch.cuda.empty_cache()
                readings = drv.check()
            else:
                readings = cell.driver.stand_in_readings(ctx, kind)
            torch.cuda.empty_cache()
            line = {"cell": args.workload, "kind": kind, "seed": seed, "readings": readings,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
