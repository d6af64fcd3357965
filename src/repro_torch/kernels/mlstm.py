"""Chunkwise mLSTM on Hopper — the launcher of ``csrc/mlstm.cu``, the port
of ``repro/kernels/mlstm.py``.

The mLSTM recurrence (matrix memory ``C``, normaliser ``n``, max stabiliser
``m``) closed chunk by chunk with dense (L, L) and (L, D) products, from an
optional carry-in ``(C0, n0, m0)`` to the carry-out.  One block of 256
threads per (value tile of ``TV`` columns, b*h) holds its ``TV x D`` tile of
the fp32 carry ``C`` in shared memory for the whole sequence and runs every
product on the CUDA cores from register micro-tiles: the scores and
``C_prev q`` split D over four thread groups (4 x 4 and 4 x TV/8 tiles a
thread, partials summed through shared memory), the carry update gives each
thread a (D/32) x (TV/8) tile (see the source note for the thread-to-tile
mapping).  What bounds it now: the products' load-to-use latency with two
warps a scheduler, and the chunk's loads (each of a head's value-tile
blocks reads the whole chunk of q and k).

``plan_tile_v`` chooses TV (pure Python, tested on the CPU) so that the
``D / TV x B*H`` blocks fill the SMs in one wave when they can: TV 48 at
xlstm-125m's D = 384, B*H = 16 gives 128 blocks on the H100's 132 SMs, and
TV 32 at batch 1 (B*H = 4: 48 blocks, each with less to do).
``chip_smoke.py``'s ``mlstm_tiles`` rows time both tiles at D = 384 for
the batches on each side of that choice.  ``smem_bytes`` mirrors the
kernel's shared memory; ``TILE_VS`` lists the (D, TV) pairs built: D < 384
has one, as no model of the port runs those head dims through mLSTM.
``mlstm_chunkwise_fwd.last_grid`` is the (TV, blocks) of its last launch.

The plain version is ``ref.mlstm_ref``; ``ops`` chooses.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256, 384)
CHUNK = 32  # the kernel's chunk length (kChunk in csrc/mlstm.cu)
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (227 KB)
# The value tiles built for each D (csrc/mlstm.cu::launch_d).
TILE_VS = {32: (32,), 64: (32,), 128: (32,), 256: (32,), 384: (32, 48)}


def smem_bytes(d: int, tv: int, chunk: int = CHUNK) -> int:
    """Shared memory of one block (csrc/mlstm.cu::smem_bytes): the C tile,
    q and k rows padded to D + 4, v and its weighted copy, four groups'
    partials, the decayed scores, n and the per-row gate vectors."""
    return 4 * (d * tv + 2 * chunk * (d + 4) + 2 * chunk * tv + 4 * chunk * tv
                + chunk * (chunk + 4) + d + 6 * chunk + 4)


def plan_tile_v(d: int, bh: int, sms: int) -> int:
    """The value tile TV for head dim ``d`` and ``bh`` = B*H heads on ``sms``
    SMs (one block an SM): the built TV whose waves of ``d / TV x bh``
    blocks take the least time, a block's work taken as L D (L + 2 TV) (the
    scores it recomputes, then C_prev q and the carry update on its tile);
    on a tie the wider tile, which recomputes the scores fewer times."""
    def cost(tv: int) -> int:
        waves = -(-(d // tv) * bh // sms)
        return waves * (CHUNK + 2 * tv)

    return min(TILE_VS[d], key=lambda tv: (cost(tv), -tv))


def mlstm_chunkwise_fwd(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,  # (B, H, S)
    f_log: torch.Tensor,  # (B, H, S)
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    tile_v: int | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Launch the kernel on PyTorch's current stream; no synchronisation.
    ``tile_v`` forces a built value tile (``plan_tile_v`` picks it if None).
    Returns (h (B,H,S,D) in q's dtype, (C (B,H,D,D), n (B,H,D), m (B,H)) fp32)."""
    from repro_torch.kernels.ops import check, load, sm_count

    b, h, s, d = q.shape
    qkv = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in (*qkv, i_pre, f_log)):
        raise ValueError("mlstm kernel: every operand must be on one CUDA device")
    if not all(t.dtype == q.dtype for t in qkv) or q.dtype not in _DTYPES:
        raise TypeError(f"mlstm kernel takes float32 or bfloat16 q, k, v of one dtype, got {[t.dtype for t in qkv]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in qkv):
        raise ValueError("mlstm kernel takes contiguous q, k, v on 16-byte boundaries")
    if d not in HEAD_DIMS:
        raise ValueError(f"mlstm kernel built for D in {HEAD_DIMS}, got {d}")
    if tile_v is None:
        tile_v = plan_tile_v(d, b * h, sm_count(q.device))
    elif tile_v not in TILE_VS[d]:
        raise ValueError(f"mlstm kernel built for value tiles {TILE_VS[d]} at D {d}, got {tile_v}")
    if k.shape != q.shape or v.shape != q.shape or i_pre.shape != (b, h, s) or f_log.shape != (b, h, s) or s == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"gates {tuple(i_pre.shape)} {tuple(f_log.shape)}")
    gates = [t.float().contiguous() for t in (i_pre, f_log)]
    if state is None:
        carry_in = (None, None, None)
    else:
        want = ((b, h, d, d), (b, h, d), (b, h))
        carry_in = tuple(t.float().contiguous() for t in state)
        if tuple(tuple(t.shape) for t in carry_in) != want or not all(t.device == q.device for t in carry_in):
            raise ValueError(f"carry-in must be (C, n, m) of shapes {want} on {q.device}")
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    carry_out = (torch.empty((b, h, d, d), **f32), torch.empty((b, h, d), **f32), torch.empty((b, h), **f32))
    ptr = lambda t: None if t is None else t.data_ptr()
    err = load("mlstm").mlstm_chunkwise_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *(g.data_ptr() for g in gates),
        *(ptr(t) for t in carry_in), out.data_ptr(), *(t.data_ptr() for t in carry_out),
        b * h, s, d, tile_v, _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "mlstm_chunkwise")
    mlstm_chunkwise_fwd.last_grid = (tile_v, d // tile_v * b * h)
    return out, carry_out


mlstm_chunkwise_fwd.last_grid = None
