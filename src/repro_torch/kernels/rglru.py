"""Gated linear recurrence (RG-LRU core) on Hopper — the launcher of
``csrc/rglru.cu``, the port of ``repro/kernels/rglru.py``.

``h_t = a_t * h_{t-1} + x_t`` along S of ``(B, S, W)`` inputs from a zero
carry, fp32 inside, output in the inputs' dtype.  One thread per (b, w)
channel walks S with its loads unrolled ahead of the dependent FMAs (see
the source note).

The plain version is ``ref.rglru_ref``; ``ops`` chooses.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan_fwd(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream; no synchronisation."""
    from repro_torch.kernels.ops import check, load

    if not (a.is_cuda and x.is_cuda and a.device == x.device):
        raise ValueError("rglru kernel: both operands must be on one CUDA device")
    if a.dtype != x.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"rglru kernel takes float32 or bfloat16 operands of one dtype, got {a.dtype}, {x.dtype}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("rglru kernel takes contiguous operands")
    if a.ndim != 3 or a.shape != x.shape or 0 in a.shape:
        raise ValueError(f"rglru kernel takes two non-empty (B, S, W) operands, got {tuple(a.shape)}, {tuple(x.shape)}")
    b, s, w = a.shape
    out = torch.empty_like(x)
    err = load("rglru").rglru_scan_launch(
        a.data_ptr(), x.data_ptr(), out.data_ptr(), b, s, w, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(err, "rglru_scan")
    return out
