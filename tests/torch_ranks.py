"""Run a script on N CPU ranks of one ``gloo`` process group, for the
port's multi-device tests.

Each rank is its own subprocess (``python <script> RANK WORLD INIT TMP``)
with a ``file://`` rendezvous under the test's ``tmp_path``, so concurrent
test workers never share a port; the whole launch has one timeout.  The
script's body sees ``RANK``, ``WORLD``, ``TMP`` (a ``Path``) and ``emit(obj)``,
which prints one JSON line; ``run_ranks`` returns each rank's last one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PREAMBLE = """\
import json, sys
from pathlib import Path
import torch
import torch.distributed as dist

RANK, WORLD, TMP = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + sys.argv[3], rank=RANK, world_size=WORLD)


def emit(obj):
    print(json.dumps(obj), flush=True)


"""


def run_ranks(tmp_path: Path, world: int, body: str, timeout: float = 240.0) -> list[dict]:
    """Run ``body`` on ``world`` ranks; each rank's last JSON line, by rank."""
    tag = f"{world}_{time.monotonic_ns()}"
    script = tmp_path / f"ranks_{tag}.py"
    # The barrier: a rank that leaves while a slower one still reads its
    # last collective resets the slower one's connection.
    script.write_text(PREAMBLE + textwrap.dedent(body) + "\ndist.barrier()\ndist.destroy_process_group()\n")
    init = tmp_path / f"pg_{tag}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    # Each rank writes to files, not pipes: a rank blocked on a full pipe
    # that is not read yet would hold the others at the final barrier.
    logs = [(tmp_path / f"out_{tag}_{r}.txt", tmp_path / f"err_{tag}_{r}.txt") for r in range(world)]
    procs = []
    for r, (out_path, err_path) in enumerate(logs):
        with open(out_path, "w") as out, open(err_path, "w") as err:
            procs.append(subprocess.Popen([sys.executable, str(script), str(r), str(world), str(init), str(tmp_path)],
                                          env=env, stdout=out, stderr=err, text=True))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [(out.read_text(), err.read_text()) for out, err in logs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
