"""Dense layer library of the port: norms, projections, RoPE, GQA attention
(sliding window, qk-norm, dict or two-level KV cache) and MLPs — the port of
``repro/nn/layers.py`` up to its MLA and MoE sections, which wait for their
slice.  Every apply function is differentiable on the plain path; training
attends through ``_attend`` (``attn_impl="xla"``, as the reference trains),
since the flash kernel has no backward.

Conventions (as in the JAX package):
* compute runs in ``cfg.dtype``; softmax, normalisers and logits in fp32;
* init functions take a ``Scope``; apply functions take the params subtree;
* attention has three modes: ``train`` (full causal, no cache), ``prefill``
  (full causal, fills the cache), ``decode`` (one new token against it);
* activations inside attention are ``(B, S, H, D)``; kernels take the
  heads-major ``(B, H, S, D)``;
* the dict KV cache is ``(batch, max_seq, n_kv, head_dim)``.  Unlike JAX,
  the port updates cache tensors in place on decode (the eager loop owns
  them; no copy of the whole cache per token).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.nn.module import Scope

Params = Any
NEG_INF = -1e30


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(scope: Scope, name: str, dim: int) -> None:
    scope.child(name).param("scale", (dim,), ("embed",), init="ones")


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm_init(scope: Scope, name: str, dim: int) -> None:
    c = scope.child(name)
    c.param("scale", (dim,), ("embed",), init="ones")
    c.param("bias", (dim,), ("embed",), init="zeros")


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def norm_init(scope: Scope, name: str, dim: int, cfg: ArchConfig) -> None:
    (rmsnorm_init if cfg.norm_type == "rmsnorm" else layernorm_init)(scope, name, dim)


def norm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    fn = rmsnorm_apply if cfg.norm_type == "rmsnorm" else layernorm_apply
    return fn(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Projections & embeddings
# ---------------------------------------------------------------------------


def linear_init(scope: Scope, name: str, d_in: int, d_out: int,
                axes: tuple[str | None, str | None], use_bias: bool = False) -> None:
    c = scope.child(name)
    c.param("w", (d_in, d_out), axes, init="fan_in")
    if use_bias:
        c.param("b", (d_out,), (axes[1],), init="zeros")


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_init(scope: Scope, name: str, vocab: int, dim: int) -> None:
    scope.child(name).param("table", (vocab, dim), ("vocab", "embed"), init="normal", scale=0.02)


def embedding_apply(p: Params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    # F.embedding, not table[tokens]: its backward on CUDA sums each row's
    # gradients in a fixed order, where indexing's accumulates with atomics,
    # so a training run and its restart from a checkpoint agree bit for bit.
    x = F.embedding(tokens, p["table"]).to(cdtype(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def logits_apply(embed_p: Params, head_p: Params | None, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Final LM head; fp32 logits. Tied -> embedding transpose."""
    w = (embed_p["table"] if head_p is None else head_p["w"]).float()
    return x.float() @ (w.T if head_p is None else w)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (any leading shape), head-dim ``dim``."""
    if dim % 2:
        raise ValueError("rope dim must be even")
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta**exponent)
    angles = positions.float()[..., None] * freqs  # (..., dim/2)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    dt = x.dtype
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    if cos.ndim == 2:  # (S, D/2) -> broadcast batch
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, D/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA; sliding window; qk-norm; KV cache)
# ---------------------------------------------------------------------------


def attention_init(scope: Scope, name: str, cfg: ArchConfig) -> None:
    c = scope.child(name)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    c.param("wq", (d, cfg.n_heads, hd), ("embed", "heads", "head_dim"), init="fan_in")
    c.param("wk", (d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"), init="fan_in")
    c.param("wv", (d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"), init="fan_in")
    c.param("wo", (cfg.n_heads, hd, d), ("heads", "head_dim", "embed"), init="fan_in")
    if cfg.use_bias:
        c.param("bq", (cfg.n_heads, hd), ("heads", "head_dim"), init="zeros")
        c.param("bk", (cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
        c.param("bv", (cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        c.param("q_norm", (hd,), ("head_dim",), init="ones")
        c.param("k_norm", (hd,), ("head_dim",), init="ones")


def _head_rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


def make_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, device="cuda") -> dict:
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def _attend(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, K, D)
    v: torch.Tensor,  # (B, T, K, D)
    mask: torch.Tensor,  # (B or 1, S, T) boolean, True = attend
    cfg: ArchConfig,
) -> torch.Tensor:
    b, s, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(dh)
    if cfg.attn_logit_softcap > 0:
        cap = cfg.attn_logit_softcap
        scores = cap * torch.tanh(scores / cap)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def _causal_window_mask(s: int, t: int, offset: int, window: int, device=None) -> torch.Tensor:
    """(1, S, T) mask: query i (global pos offset+i) may see key j<=pos and,
    with a window, j > pos - window."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None]


def _is_tiered(cache) -> bool:
    return cache is not None and not isinstance(cache, dict)


def attention_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    window: int = 0,
    cache: Any = None,
    mode: str = "train",
    positions: torch.Tensor | None = None,
    use_rope: bool = True,
) -> tuple[torch.Tensor, Any]:
    """Self-attention with an optional dict or two-level KV cache."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    dev = x.device

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)

    if cfg.qk_norm:
        q = _head_rms(q, p["q_norm"], cfg.norm_eps)
        k = _head_rms(k, p["k_norm"], cfg.norm_eps)

    tiered = _is_tiered(cache)
    if tiered and (window > 0 or cfg.attn_logit_softcap > 0):
        # The two-level backend serves full-attention layers (windowed
        # layers already hold only O(window) keys in their ring page).
        raise ValueError("tiered KV backend requires window=0 and no logit softcap")

    if mode == "decode" and tiered:
        # Two-level serving backend: hot device ring + paged host cold tier.
        if positions is not None:
            pos = positions.reshape(1, -1)
        elif hasattr(cache, "row_positions"):
            # Continuous batching: a per-layer adapter over sessions at
            # different lengths gives (B, 1) positions, one a row, so each
            # session's RoPE phase is its own.
            pos = cache.row_positions()
        else:
            # torch.full fills on the device: no host-to-device copy per layer.
            pos = torch.full((1, 1), cache.length, device=dev)
        if use_rope:
            cos, sin = rope_tables(pos, hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        cache.append(k[:, 0], v[:, 0])  # the (B, KV, hd) token
        out = cache.attend(q.transpose(1, 2).contiguous()).transpose(1, 2).to(dt)
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
        return y, cache

    if mode == "decode":
        if cache is None:
            raise ValueError("decode mode requires a cache")
        idx = cache["index"]
        page = cache["k"].shape[1]
        pos = torch.full((1,), idx, device=dev) if positions is None else positions
        if use_rope:
            cos, sin = rope_tables(pos.reshape(1, -1), hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        # Windowed layers use a ring page of size `window`: slot = pos % page.
        write_at = idx % page
        ck, cv = cache["k"], cache["v"]
        ck[:, write_at : write_at + s] = k.to(ck.dtype)  # in place (see module doc)
        cv[:, write_at : write_at + s] = v.to(cv.dtype)
        kslot = torch.arange(page, device=dev)[None, None, :]
        mask = kslot <= idx
        if window > 0 and page > window:
            # Page larger than the window: real positions equal slots here.
            mask &= kslot > idx - window
        out = _attend(q, ck.to(dt), cv.to(dt), mask, cfg)
        new_cache = {"k": ck, "v": cv, "index": idx + s}
    else:
        if positions is None:
            positions = torch.arange(s, device=dev)
        if use_rope:
            cos, sin = rope_tables(positions, hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        if cfg.attn_impl == "flash":
            # Hopper kernel on CUDA, its plain version on CPU; heads-major in/out.
            out = ops.flash_attention(
                q.transpose(1, 2).contiguous(),
                k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(),
                causal=True,
                window=window,
                logit_softcap=cfg.attn_logit_softcap,
            ).transpose(1, 2)
        else:
            out = _attend(q, k, v, _causal_window_mask(s, s, 0, window, dev), cfg)
        new_cache = cache
        if mode == "prefill" and tiered:
            if cache.length:
                # The causal mask above only covers this chunk's tokens, so
                # prefill-on-top-of-history would silently drop the cache.
                raise ValueError("tiered KV backend supports fresh prefill only")
            # Bulk write-through into the two-level cache.
            cache.append_block(k.transpose(1, 2), v.transpose(1, 2))
        elif mode == "prefill":
            if cache is None:
                raise ValueError("prefill mode requires a pre-allocated cache")
            ck, cv = cache["k"], cache["v"]
            page = ck.shape[1]
            if s > page:
                # Keep only the last `page` keys, rolled so that
                # slot == position % page (ring invariant for decode).
                ck = torch.roll(k[:, -page:], s % page, dims=1).to(ck.dtype)
                cv = torch.roll(v[:, -page:], s % page, dims=1).to(cv.dtype)
            else:
                ck[:, :s] = k.to(ck.dtype)
                cv[:, :s] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv, "index": s}

    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(scope: Scope, name: str, cfg: ArchConfig, d_ff: int | None = None) -> None:
    c = scope.child(name)
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        c.param("w_gate", (d, ff), ("embed", "ff"), init="fan_in")
        c.param("w_up", (d, ff), ("embed", "ff"), init="fan_in")
    else:
        c.param("w_up", (d, ff), ("embed", "ff"), init="fan_in")
        if cfg.use_bias:
            c.param("b_up", (ff,), ("ff",), init="zeros")
    c.param("w_down", (ff, d), ("ff", "embed"), init="fan_in")
    if cfg.use_bias:
        c.param("b_down", (d,), ("embed",), init="zeros")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def mlp_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        h = act(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    else:
        h = x @ p["w_up"].to(dt)
        if "b_up" in p:
            h = h + p["b_up"].to(dt)
        h = _gelu(h)
    y = h @ p["w_down"].to(dt)
    if "b_down" in p:
        y = y + p["b_down"].to(dt)
    return y
