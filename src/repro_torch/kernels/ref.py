"""Plain PyTorch versions of the attention kernels (the correctness ground
truth) — the port of ``repro/kernels/ref.py``.

They repeat the kernels' arithmetic with whole-tensor operations: the CPU
tests hold them against the JAX oracles, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  They are no yardstick of speed.

Shapes follow the kernel conventions (head-major):
    q: (B, H, S, D);  k, v: (B, KV, T, D)
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gqa_softmax_attend(q, k, v, valid, logit_softcap: float = 0.0):
    """softmax(q k^T / sqrt(D)) v with GQA (head h reads kv head h // (H/KV)),
    fp32 scores and softmax, probabilities cast back to q's dtype.

    ``valid`` broadcasts against the (S, T) score matrix."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k).float()
    scores = scores / math.sqrt(d)
    if logit_softcap > 0:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v)
    return out.reshape(b, h, s, d)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Reference attention; causal masking is right-aligned when T > S.

    A row with no valid key gives 0, as the flash kernel does (``l == 0``
    guard); the JAX oracle gives the mean of v there, a case its tests and
    the model never reach (every causal row sees at least its own key)."""
    s, t = q.shape[2], k.shape[2]
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    out = _gqa_softmax_attend(q, k, v, mask, logit_softcap)
    return torch.where(mask.any(dim=1)[:, None], out, 0.0)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, 1, D)
    k: torch.Tensor,  # (B, KV, T, D)
    v: torch.Tensor,
    length: int,  # number of valid keys
) -> torch.Tensor:
    valid = torch.arange(k.shape[2], device=q.device) < length
    return _gqa_softmax_attend(q, k, v, valid)


def tiered_ring_attention_ref(
    q: torch.Tensor,  # (B, H, 1, D)
    hot_k: torch.Tensor,  # (B, KV, W, D) ring buffer (rotated order)
    hot_v: torch.Tensor,
    cold_k: torch.Tensor,  # (B, KV, C, D) paged capacity buffer
    cold_v: torch.Tensor,
    hot_len: int,
    cold_len: int,
    ring_newest: int,
) -> torch.Tensor:
    """Ring-aware two-tier decode: the plain version of the tiered kernel.

    Hot slot ``j`` has age ``(ring_newest - j) mod W`` and is valid iff
    ``age < hot_len``; cold position ``t`` is valid iff ``t < cold_len``.
    With no valid key at all the output is 0 (the kernel's ``l == 0``
    guard)."""
    w = hot_k.shape[2]
    dev = q.device
    age = torch.remainder(ring_newest - torch.arange(w, device=dev), w)
    valid = torch.cat([torch.arange(cold_k.shape[2], device=dev) < cold_len, age < hot_len])
    k = torch.cat([cold_k, hot_k], dim=2)
    v = torch.cat([cold_v, hot_v], dim=2)
    out = _gqa_softmax_attend(q, k, v, valid)
    return out if bool(valid.any()) else torch.zeros_like(out)
