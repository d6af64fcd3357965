"""Flash attention forward on Hopper — the launcher of
``csrc/flash_attention.cu``, the port of ``repro/kernels/flash_attention.py``.

Causal (right-aligned when T > S), sliding-window and softcapped attention
with GQA; fully masked key tiles are skipped and ragged S/T edges are masked
in the kernel.  A row with no valid key gives the mean of v, as the
reference does.  Forward only.

Two kernels, chosen by ``flash_path`` from (dtype, D) alone:

* ``"tensor_core"`` — bf16 at D in ``TENSOR_CORE_HEAD_DIMS``: 128-row query
  tiles, K/V tiles through a TMA-fed ring, both products by ``wgmma``;
* ``"cuda_core"`` — fp32 (held to 2e-5, which TF32 products cannot) and
  bf16 at the small head dims: 32-row query tiles, fp32 products on the
  CUDA cores.

A head dim below 256 that is not built (the reduced configs' D = 12) runs
at the next built one: the launcher zero-pads q, k and v along D, passes the
score scale 1/sqrt(D) of the caller's D, and cuts the output back (padded
columns add 0 to every score and give 0 in the output).  A built D copies
nothing.  Above 256 it raises.

A launch that fails raises; nothing retries on the other path.  The plain
version is ``ref.attention_ref``; ``ops`` chooses.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.ops import built_head_dim, pad_head_dim

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)


def check_shape(h: int, kv: int, d: int) -> int:
    """Raise unless the kernel takes H query heads over KV kv heads of head
    dim D; return the built head dim it runs D at."""
    if kv <= 0 or h % kv:
        raise ValueError(f"flash kernel: H={h} query heads are not a multiple of KV={kv}")
    return built_head_dim(d, HEAD_DIMS, "flash")


def flash_path(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel takes operands of ``dtype`` and head dim ``head_dim``
    (after padding to a built head dim)."""
    built = built_head_dim(head_dim, HEAD_DIMS, "flash")
    return "tensor_core" if dtype == torch.bfloat16 and built in TENSOR_CORE_HEAD_DIMS else "cuda_core"


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, T, D)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the kernel of ``flash_path`` on PyTorch's current stream; no
    synchronisation."""
    from repro_torch.kernels.ops import check, load

    b, h, s, d = q.shape
    _, kv, t, _ = k.shape
    tensors = (q, k, v)
    if not all(x.is_cuda and x.device == q.device for x in tensors):
        raise ValueError("flash kernel: every operand must be on one CUDA device")
    if not all(x.dtype == q.dtype for x in tensors) or q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16 operands of one dtype, got {[x.dtype for x in tensors]}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in tensors):
        raise ValueError("flash kernel takes contiguous operands on 16-byte boundaries")
    if kv == 0 or h % kv or k.shape[0] != b or k.shape[3] != d or v.shape != k.shape or s == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    dk = check_shape(h, kv, d)
    q, k, v = (pad_head_dim(x, dk) for x in tensors)
    out = torch.empty_like(q)
    lib = load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv, s, t, dk,
            int(bool(causal)), int(window), float(logit_softcap), 1.0 / math.sqrt(d))
    if flash_path(q.dtype, dk) == "tensor_core":
        err = lib.flash_attention_wgmma_launch(*args, stream)
    else:
        err = lib.flash_attention_launch(*args, _DTYPES[q.dtype], stream)
    check(err, "flash_attention")
    return out if dk == d else out[..., :d].contiguous()
