#!/usr/bin/env python3
"""Time another version of the chunkwise mLSTM kernel's source against this
one on the card, in one process.  Needs one NVIDIA GPU and nvcc.

    git show HEAD~1:src/repro_torch/csrc/mlstm.cu > build/old.cu
    python3 mlstm_card.py build/old.cu

OLD.cu is built with ``ops.NVCC_FLAGS`` under ``build/mlstm_card/``; its C
entry may take the value tile (this source's ABI, bound by ``ops._bind`` and
given the tile the current plan picks) or not (the ABI before the tile was a
launch argument).  Both run xlstm-125m's prefill case (B = H = 4, S = 2048,
D = 384, the empty history) in fp32 and in bf16, in the order old, new, new,
old, with CUDA events.  Every result is one JSON line; the card's name and
power limit come first.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "mlstm_card"
B, H, S, D = 4, 4, 2048, 384  # chip_smoke.py's mlstm serve case


def old_launcher(src: Path, ins, outs):
    """A no-argument launch of ``src``'s kernel on ``ins`` into ``outs``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.mlstm import plan_tile_v

    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / "libmlstm_old.so"
    r = subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib_path), str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    if re.search(r"int D, int TV, int dtype", src.read_text()):
        ops._bind(lib, "mlstm")
        tile = (plan_tile_v(D, B * H, ops.sm_count(ins[0].device)),)
    else:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.mlstm_chunkwise_launch.argtypes = [P] * 12 + [I] * 4 + [P]
        lib.mlstm_chunkwise_launch.restype = I
        tile = ()
    dt = 0 if ins[0].dtype == torch.float32 else 1

    def go():
        err = lib.mlstm_chunkwise_launch(*(t.data_ptr() for t in ins), None, None, None,
                                         *(t.data_ptr() for t in outs), B * H, S, D, *tile, dt,
                                         torch.cuda.current_stream().cuda_stream)
        ops.check(err, "old mlstm_chunkwise")
    return go


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("mlstm_card: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.mlstm import mlstm_chunkwise_fwd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    src = Path(sys.argv[1]).resolve()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    f32 = dict(dtype=torch.float32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = rnd(B, H, S, D).to(dtype), (rnd(B, H, S, D) / D**0.5).to(dtype), rnd(B, H, S, D).to(dtype)
        ins = (q, k, v, 0.5 * rnd(B, H, S), F.logsigmoid(rnd(B, H, S) + 2.0))
        want = (torch.empty_like(q), torch.empty((B, H, D, D), **f32), torch.empty((B, H, D), **f32),
                torch.empty((B, H), **f32))
        run_old, run_new = old_launcher(src, ins, want), lambda: mlstm_chunkwise_fwd(*ins)
        run_old()
        got_h, got_carry = run_new()
        torch.cuda.synchronize()
        diff = max((a.float() - b.float()).abs().max().item() for a, b in zip((got_h, *got_carry), want))
        times = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            times[who].append(chip_smoke.time_ms(run_old if who == "old" else run_new, iters=20))
        print(json.dumps({"old_source": str(sys.argv[1]), "dtype": str(dtype).split(".")[1], "B": B, "H": H,
                          "S": S, "D": D, "tile_v": mlstm_chunkwise_fwd.last_grid[0], "old_ms": times["old"],
                          "new_ms": times["new"], "max_abs_diff": diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
