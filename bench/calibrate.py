"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 bench/calibrate.py --workload <name> --seconds <s> --seeds <n> [<n> ...] [--out <file>]

For each seed, one run of the cell as the benchmark runs it (a short
window at the cell's own load), with the reference's comparison read
three ways in the same process:

* ``program``: the numbers the run compares, the program against the
  float32 reference (the lower readings);
* ``control``: the reference itself in the program's place, computed in
  float8 (e4m3, a scale a tensor), one step below the bfloat16 that the
  configurations state (the upper readings);
* ``half_batch`` (training): the reference in the program's place with
  half of each batch left out, the mean over the rest.

A served cell's control is read at the same prompts and served tokens:
at each position, the gap of the token that float8 puts first.  One JSON
line a seed goes to standard output and to ``--out``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.run import Context  # noqa: E402  (first: it sets the allocator's environment)
from bench.harness import Cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("calibration reads the card", file=sys.stderr)
        return 2
    cell = Cell.load(args.workload)
    readings = ("control", "half_batch") if cell.traffic["loop"] == "train_steps" else ("control",)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = Context(config=cell.config, traffic=cell.traffic, limits=cell.limits, seed=seed, seconds=args.seconds,
                      trace=False, device="cuda", t_start=t0, readings=readings)
        rec = cell.loop()(ctx)
        line = {"workload": args.workload, "seed": seed, "program": {n: v for n, v, _ in rec.checks}, **rec.readings,
                "e2e": rec.e2e, "setup_s": rec.setup_s, "window_s": rec.window_s, "counters": rec.counters,
                "memory_peak_bytes": rec.memory_peak_bytes, "run_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
