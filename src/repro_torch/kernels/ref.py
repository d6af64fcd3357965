"""Plain PyTorch versions of the kernels (the correctness ground truth) —
the port of ``repro/kernels/ref.py``.

They compute the kernels' functions with whole-tensor operations (the
recurrences step by step): the CPU tests hold them against the JAX oracles,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
They are no yardstick of speed.

Shapes follow the kernel conventions:
    attention   q: (B, H, S, D);  k, v: (B, KV, T, D)   (head-major)
    tiered rows q: (N, H, 1, D); per row i: ring (1, KV, W, D), staging
                (1, KV, C_i, D), lens[i] = (hot_len, cold_len, ring_newest)
    rglru       a, x: (B, S, W) -> h: (B, S, W)
    mlstm       q, k, v: (B, H, S, D); i, f pre-acts: (B, H, S);
                carry (C (B, H, D, D) as C[v, k], n (B, H, D), m (B, H))
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

    A row with no valid key (causal with T < S) softmaxes T equal −1e30
    scores and gives the mean of v over all T keys, as the JAX oracle and
    the Pallas kernel do; the flash kernel takes the same value."""
    s, t = q.shape[2], k.shape[2]
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return _gqa_softmax_attend(q, k, v, mask, logit_softcap)


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


def tiered_rows_attention_ref(
    q: torch.Tensor,  # (N, H, 1, D)
    hot_k,  # N rings (1, KV, W, D)
    hot_v,
    cold_k,  # N staging buffers (1, KV, C_i, D)
    cold_v,
    lens,  # (N, 3): hot_len, cold_len, ring_newest of each row
) -> torch.Tensor:
    """Per-row two-tier decode: row i of q over its own ring, staging buffer
    and lengths — the plain version of the per-row tiered kernel, and the
    counterpart of the JAX session plane's vmapped oracle
    (``repro/serving/scheduler.py``'s ``_batched_attend``)."""
    return torch.cat([tiered_ring_attention_ref(q[i:i + 1], hot_k[i], hot_v[i], cold_k[i], cold_v[i],
                                                *(int(x) for x in lens[i])) for i in range(q.shape[0])])


def rglru_ref(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t along axis 1 from ``h0`` (zeros if None),
    with an fp32 carry; the output takes x's dtype."""
    b, s, w = a.shape
    h = torch.zeros((b, w), dtype=torch.float32, device=a.device) if h0 is None else h0.float()
    out = torch.empty_like(x)  # a DTensor on a mesh, as x is
    for t in range(s):
        h = a[:, t].float() * h + x[:, t].float()
        out[:, t] = h
    return out


def mlstm_step(carry, q, k, v, i_pre, f_log):
    """One mLSTM time step with the max stabiliser (``_mlstm_cell`` of the
    JAX model, which decode runs).  carry: (C (B,H,D,D) as C[v, k], n (B,H,D), m (B,H)), fp32;
    m = -inf is the empty history.  q, k, v: (B,H,D); gates: (B,H).
    Returns (new carry, h (B,H,D) fp32)."""
    C, n, m = carry
    q, k, v, i_pre, f_log = (t.float() for t in (q, k, v, i_pre, f_log))
    no_hist = torch.isinf(m) & (m < 0)
    m_safe = torch.where(no_hist, 0.0, m)  # NaN-free in both where-branches
    m_new = torch.maximum(torch.where(no_hist, i_pre, f_log + m_safe), i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.where(no_hist, 0.0, torch.exp(f_log + m_safe - m_new))
    C = f_g[..., None, None] * C + i_g[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n, q)), min=1.0)
    h = torch.einsum("bhde,bhe->bhd", C, q) / denom[..., None]
    return (C, n, m_new), h


def mlstm_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,  # (B, H, S) log input gate pre-activation
    f_log: torch.Tensor,  # (B, H, S) log forget gate (log sigmoid applied)
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Sequential mLSTM from ``state`` = (C, n, m) (the empty history if
    None).  Returns (h (B,H,S,D) in q's dtype, the final (C, n, m) in fp32)
    — the JAX oracle's h, plus the carry the model keeps for decode.  ``v``
    may hold some of each head's value rows (B,H,S,Dv): C is then (B,H,Dv,D)
    and h (B,H,S,Dv), those rows of the whole heads' (each row of C reads
    only its own value)."""
    b, h, s, d = q.shape
    if state is None:
        state = (
            torch.zeros((b, h, v.shape[-1], d), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h), float("-inf"), dtype=torch.float32, device=q.device),
        )
    carry = tuple(t.float() for t in state)
    out = torch.empty_like(v)  # q's dtype (and, where v has q's shape, q's placement on a mesh)
    for t in range(s):
        carry, out[:, :, t] = mlstm_step(carry, q[:, :, t], k[:, :, t], v[:, :, t], i_pre[:, :, t], f_log[:, :, t])
    return out, carry


def moe_grouped_ref(
    x: torch.Tensor,  # (T, d) tokens
    w_gate: torch.Tensor,  # (E_held, d, f)
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # (E_held, f, d)
    rows: torch.Tensor,  # (R,) flat assignment token * k + j of each padded row; T * k on padding
    tile_expert: torch.Tensor,  # (R / tile,) local expert of each tile; E_held past the last used one
    gate: torch.Tensor,  # (R,) fp32 gate of each row
    top_k: int,
) -> torch.Tensor:
    """Each padded row's gated expert output (R, d) in x's dtype: for a row
    of token t in a tile of expert e, ``gate * (silu(x_t Wg_e) * (x_t Wu_e))
    Wd_e``, with fp32 sums, the product before ``Wd`` rounded to x's dtype
    (as the kernel stores it); 0 on padding and in unused tiles."""
    n_assign = x.shape[0] * top_k
    tile = rows.shape[0] // tile_expert.shape[0]
    valid = rows < n_assign
    expert = tile_expert.long().repeat_interleave(tile)
    out = torch.zeros((rows.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    for e in range(w_gate.shape[0]):
        pick = valid & (expert == e)
        if not bool(pick.any()):
            continue
        a = x[rows[pick] // top_k].float()
        h = (torch.nn.functional.silu(a @ w_gate[e].float()) * (a @ w_up[e].float())).to(x.dtype)
        out[pick] = ((h.float() @ w_down[e].float()) * gate[pick, None]).to(x.dtype)
    return out
