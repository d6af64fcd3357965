"""Chunkwise mLSTM on Hopper — the launcher of ``csrc/mlstm.cu``, the port
of ``repro/kernels/mlstm.py``.

The mLSTM recurrence (matrix memory ``C``, normaliser ``n``, max stabiliser
``m``) closed chunk by chunk with dense (L, L) and (L, D) products, from an
optional carry-in ``(C0, n0, m0)`` to the carry-out.  One block per
(64-wide value tile, b*h) holds its tile of the fp32 carry ``C`` in shared
memory for the whole sequence (see the source note).

The plain version is ``ref.mlstm_ref``; ``ops`` chooses.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256, 384)
CHUNK = 32  # the kernel's chunk length (kChunk in csrc/mlstm.cu)


def mlstm_chunkwise_fwd(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,  # (B, H, S)
    f_log: torch.Tensor,  # (B, H, S)
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Launch the kernel on PyTorch's current stream; no synchronisation.
    Returns (h (B,H,S,D) in q's dtype, (C (B,H,D,D), n (B,H,D), m (B,H)) fp32)."""
    from repro_torch.kernels.ops import check, load

    b, h, s, d = q.shape
    qkv = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in (*qkv, i_pre, f_log)):
        raise ValueError("mlstm kernel: every operand must be on one CUDA device")
    if not all(t.dtype == q.dtype for t in qkv) or q.dtype not in _DTYPES:
        raise TypeError(f"mlstm kernel takes float32 or bfloat16 q, k, v of one dtype, got {[t.dtype for t in qkv]}")
    if not all(t.is_contiguous() for t in qkv):
        raise ValueError("mlstm kernel takes contiguous q, k, v")
    if d not in HEAD_DIMS:
        raise ValueError(f"mlstm kernel built for D in {HEAD_DIMS}, got {d}")
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
        b * h, s, d, _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "mlstm_chunkwise")
    return out, carry_out
