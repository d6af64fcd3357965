"""The held experts' product of an expert share on Hopper — the launcher of
``csrc/moe_grouped.cu``, the kernels behind ``ops.moe_grouped_ffn``.

No TPU kernel stands behind it: the JAX package computes MoE as a
capacity-padded einsum over every expert's slots.  An expert share
computes only the assignments routed to the experts this device holds, a
few rows an expert at decode and some hundreds at a prefill, so a padded
batched product would read every expert for slots that are mostly empty.
The design is vLLM's ``fused_moe``: ``nn.layers.route_share`` sorts the
held assignments by expert and pads each expert's run to a tile of 16 or
128 rows, and a tile-to-expert table on the device tells each block whose
weights to read.  Two launches an op (see the source note): gate-up
(``silu(x Wg) * (x Wu)`` over a tile's gathered token rows, stored in the
compute dtype) and down (that intermediate times ``Wd``, each row scaled
by its gate).

The plain version is ``ref.moe_grouped_ref``; ``ops`` chooses.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TILES = (16, 128)  # the tile heights the source is built for


def check_operands(x, w_gate, w_up, w_down, rows, tile_expert, gate) -> int:
    """Raise unless the kernels take these operands; return the tile
    height.  x (T, d) and the experts (E, d, f), (E, f, d) in one dtype of
    ``_DTYPES``, d and f multiples of 8; rows (R,) int64, tile_expert
    (R / tile,) int32, gate (R,) fp32, with R / tile a built tile height;
    all contiguous, 16-byte aligned, on one CUDA device."""
    if x.ndim != 2 or w_gate.ndim != 3 or w_up.shape != w_gate.shape or w_down.shape != (
            w_gate.shape[0], w_gate.shape[2], w_gate.shape[1]) or w_gate.shape[1] != x.shape[1]:
        raise ValueError(f"moe grouped kernels take x (T, d), w_gate / w_up (E, d, f), w_down (E, f, d); got "
                         f"{tuple(x.shape)}, {tuple(w_gate.shape)}, {tuple(w_up.shape)}, {tuple(w_down.shape)}")
    if x.shape[0] == 0 or x.shape[1] % 8 or w_gate.shape[2] % 8:
        raise ValueError(f"moe grouped kernels take d and f multiples of 8 and some tokens; got x {tuple(x.shape)}, "
                         f"f {w_gate.shape[2]}")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in (w_gate, w_up, w_down)):
        raise TypeError(f"moe grouped kernels take bf16, fp16 or fp32 tokens and experts of one dtype; got "
                        f"{x.dtype}, {w_gate.dtype}, {w_up.dtype}, {w_down.dtype}")
    if rows.dtype != torch.int64 or tile_expert.dtype != torch.int32 or gate.dtype != torch.float32:
        raise TypeError("moe grouped kernels take int64 rows, an int32 tile table and fp32 gates")
    n_tiles = tile_expert.shape[0]
    if rows.ndim != 1 or gate.shape != rows.shape or n_tiles == 0 or rows.shape[0] % n_tiles \
            or rows.shape[0] // n_tiles not in TILES:
        raise ValueError(f"{rows.shape[0]} rows in {n_tiles} tiles: tiles of {TILES} rows only")
    tensors = (x, w_gate, w_up, w_down, rows, tile_expert, gate)
    if not all(t.is_cuda and t.device == x.device and t.is_contiguous() for t in tensors):
        raise ValueError("moe grouped kernels take contiguous operands on one CUDA device")
    if any(t.data_ptr() % 16 for t in (x, w_gate, w_up, w_down)):
        raise ValueError("moe grouped kernels take 16-byte aligned tokens and experts")
    return rows.shape[0] // n_tiles


def moe_grouped_ffn_fwd(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                        rows: torch.Tensor, tile_expert: torch.Tensor, gate: torch.Tensor,
                        top_k: int) -> torch.Tensor:
    """Launch both kernels on PyTorch's current stream; no synchronisation.
    Returns (R, d) in x's dtype; rows of unused tiles are left unwritten
    (no assignment maps to them)."""
    from repro_torch.kernels.ops import check, load

    tile = check_operands(x, w_gate, w_up, w_down, rows, tile_expert, gate)
    t, d = x.shape
    held, _, f = w_gate.shape
    n_rows, n_tiles = rows.shape[0], tile_expert.shape[0]
    h = torch.empty((n_rows, f), dtype=x.dtype, device=x.device)
    y = torch.empty((n_rows, d), dtype=x.dtype, device=x.device)
    err = load("moe_grouped").moe_grouped_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), rows.data_ptr(),
        tile_expert.data_ptr(), gate.data_ptr(), h.data_ptr(), y.data_ptr(), t, d, f, held, top_k, n_tiles, tile,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(err, "moe_grouped_ffn")
    return y
