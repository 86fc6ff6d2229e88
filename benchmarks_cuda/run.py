"""Run one cell of the benchmark of ``hybridsearch_tpu_torch`` once.

    python3 benchmarks_cuda/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The cell's
configuration, traffic, encoder and query kinds, limits and metrics are
found by name from ``BENCHMARK.json`` (``harness/cell.py``). The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number the check compared beside its limit); the last lines of standard
error repeat the checks. Without a card, or with fewer cards than the cell
asks for, the run exits with code 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
# the routes are the cell's layout's defaults; a library that would load
# JAX on its own is kept from doing so
for _gate in ("HST_SUPER_HYBRID", "HST_TILE_HYBRID"):
    os.environ.pop(_gate, None)
os.environ["USE_FLAX"] = "0"


def set_host_threads(workload: str) -> None:
    """The threads of the host's library pools (OpenMP, MKL, OpenBLAS), as
    the cell's configuration states them (``host.threads``), set before
    any of them loads."""
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"run.py: no workload {workload!r}")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    threads = json.loads((HERE.parent / c["file"]).read_text())["host"]["threads"]
    for pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[pool] = str(int(threads))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them (a
    card below 700 W runs slower under load), or what kept it from
    answering."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 else p.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"not read: {e!r}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_host_threads(args.workload)

    import torch

    from harness.cell import Bench, forbidden_modules, run_cell

    bench = Bench()
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: needs {chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"run.py: modules that may not load were loaded: {found}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   dev, T0)
    out["device"]["power_limit"] = power_limit()
    print(f"card: {out['device']['power_limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}, a {c['bound']})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
