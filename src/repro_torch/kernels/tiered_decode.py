"""Two-level decode attention on Hopper — the launcher of
``csrc/tiered_decode.cu``, the port of ``repro/kernels/tiered_decode.py``.

The paper's tiered read at the device level: the hot tier is the last
``W`` tokens' KV in a ring, the cold tier the paged history staged from
host memory; one fp32 online softmax merges both.  The kernel reads each
K/V row once for all query heads of its kv head and stops at ``cold_len``
(see the source note for the design).  Lengths are plain launch arguments,
so one built kernel serves every decode step.

The plain version is ``ref.tiered_ring_attention_ref``; ``ops`` chooses.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
GROUPS = (1, 2, 4, 8)


def tiered_decode_attention_fwd(
    q: torch.Tensor,  # (B, H, 1, D)
    hot_k: torch.Tensor,  # (B, KV, W, D)
    hot_v: torch.Tensor,
    cold_k: torch.Tensor,  # (B, KV, C, D)
    cold_v: torch.Tensor,
    hot_len: int,
    cold_len: int,
    ring_newest: int,
) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream; no synchronisation."""
    from repro_torch.kernels.ops import check, load

    b, h, one, d = q.shape
    _, kv, w, _ = hot_k.shape
    c = cold_k.shape[2]
    tensors = (q, hot_k, hot_v, cold_k, cold_v)
    if one != 1:
        raise ValueError(f"decode takes one query row, got {one}")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("tiered decode kernel: every operand must be on one CUDA device")
    if not all(t.dtype == q.dtype for t in tensors) or q.dtype not in _DTYPES:
        raise TypeError(f"tiered decode kernel takes float32 or bfloat16 operands of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tiered decode kernel takes contiguous operands")
    if d not in HEAD_DIMS or h % kv or h // kv not in GROUPS:
        raise ValueError(f"tiered decode kernel built for D in {HEAD_DIMS}, H/KV in {GROUPS}; got D={d}, H={h}, KV={kv}")
    if hot_v.shape != hot_k.shape or cold_v.shape != cold_k.shape or cold_k.shape[:2] != (b, kv) \
            or hot_k.shape[0] != b or cold_k.shape[3] != d or hot_k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} hot {tuple(hot_k.shape)} cold {tuple(cold_k.shape)}")
    if not (0 <= hot_len <= w and 0 <= cold_len <= c):
        raise ValueError(f"lengths out of range: hot_len={hot_len} (W={w}), cold_len={cold_len} (C={c})")
    out = torch.empty_like(q)
    lib = load("tiered_decode")
    err = lib.tiered_decode_launch(
        q.data_ptr(), hot_k.data_ptr(), hot_v.data_ptr(), cold_k.data_ptr(), cold_v.data_ptr(),
        out.data_ptr(), b, h, kv, w, c, d, int(hot_len), int(cold_len), int(ring_newest),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "tiered_decode_attention")
    return out
