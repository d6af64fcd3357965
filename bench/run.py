"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, limits and metric readers are files found by
name (``bench/harness.py``).  The run needs as many CUDA devices as the
cell asks for, and exits non-zero without a result otherwise.  Its last
line on standard output is one JSON object; the numbers compared for
``correct`` are its last lines on standard error too.

The program's kernels build once into ``build/`` inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
# In fixed-size segments the caching allocator fragments under these cells'
# memory: a train step failed to allocate 3 GiB with 38 GiB reserved and
# free, and serving decode steps stalled in cudaMalloc.  Read at the first
# allocation, so set before torch is imported.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from bench.harness import Cell, device_info, forbidden_modules, result  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a loop is handed: the cell's files, the seed, the window."""

    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    # Readings for setting limits (``bench/calibrate.py``), never taken by
    # the benchmark's own runs: "control" (the reference in float8 in the
    # program's place) and, for training, "half_batch".
    readings: tuple[str, ...] = ()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = Cell.load(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    ctx = Context(config=cell.config, traffic=cell.traffic, limits=cell.limits, seed=args.seed % (1 << 63),
                  seconds=args.seconds, trace=bool(args.trace), device="cuda", t_start=T_START)
    rec = cell.loop()(ctx)
    held = forbidden_modules()
    if held:
        print(f"modules of JAX or the JAX package were loaded: {held}", file=sys.stderr)
        return 3
    line = result(cell, rec, bool(args.trace), device_info(chips, rec.memory_peak_bytes))
    for name, v, lim in rec.checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
