"""Read the control's numbers on the card, at a cell's own size, on many seeds.

    python3 benchmarks_cuda/control.py --workload <name> --seeds 1,2,3 \\
        [--seconds 10] [--precision tf32]

Each seed is one run of the cell (``harness/cell.py`` ``run_cell``) with
the plain reference, its dense products in TF32, in the program's place:
the program serves every batch of the window, so its own certificate
decides which rows are held, and the control's rows are judged by the
run's own comparison. One line of JSON a seed: ``correct`` (a sound limit
makes it false) and the checks. The benchmark's own runs never do this;
its readings set the upper end of each limit (PERF.md).
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--precision", default="tf32")
    args = ap.parse_args(argv)

    import torch

    from harness.cell import Bench, run_cell

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_cell(bench, args.workload, seed, args.seconds, False, dev, t,
                       control=args.precision)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision, "correct": out["correct"],
                          "checks": out["checks"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
