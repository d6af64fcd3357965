"""Recurrent blocks of the port: RG-LRU (Griffin/RecurrentGemma) and the
xLSTM cells — the port of ``repro/nn/recurrent.py``.

Each block has a full-sequence path (train, prefill) and a one-step decode
path over an explicit state dict (the recurrent analogue of the KV cache,
O(1) in sequence length), with the JAX package's key paths, layouts and
dtype rules.

The JAX model closes the recurrences with an associative scan (RG-LRU) and
``lax.scan`` (mLSTM, sLSTM).  Here, over S > 1 steps, the RG-LRU and mLSTM
recurrences go through ``kernels.ops`` when ``cfg.attn_impl == "flash"``:
the Hopper kernels on a CUDA tensor (``csrc/rglru.cu``, ``csrc/mlstm.cu``,
the ports of the Pallas kernels written for these recurrences), their plain
versions on a CPU tensor.  With ``"xla"`` they run the plain versions on
any device, as ``"xla"`` runs plain masked-softmax attention.  Under
autograd (training) they run the plain versions whatever ``attn_impl``
says: the kernels are forward only, and the reference trains through its
own scans.  One decode step is plain arithmetic either way
(``ref.mlstm_step`` is the JAX model's ``_mlstm_cell``), and sLSTM (no
Pallas kernel) is a plain step loop.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.nn.layers import _gelu
from repro_torch.nn.module import Scope, constrain, splits

Params = Any

RGLRU_C = 8.0  # Griffin's fixed recurrence sharpness
# Matrices the blocks read in fp32 (the JAX layers cast them to fp32 at use):
# serving keeps them in their master dtype (``cast_matrices``'s ``keep``).
FP32_MATRICES = ("w_a", "w_x", "r_i", "r_f", "r_z", "r_o")


# ---------------------------------------------------------------------------
# Temporal conv (both Griffin and xLSTM use a short depthwise conv)
# ---------------------------------------------------------------------------


def conv1d_init(scope: Scope, name: str, width: int, dim: int) -> None:
    c = scope.child(name)
    c.param("w", (width, dim), ("conv", "rnn"), init="fan_in")
    c.param("b", (dim,), ("rnn",), init="zeros")


def conv1d_apply(p: Params, x: torch.Tensor, state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv. x: (B,S,D). state: (B,width-1,D) history.

    Returns (y, new_state); new_state carries the last width-1 inputs (a
    copy, so it does not hold the concatenated sequence alive)."""
    w = p["w"].to(x.dtype)
    width = w.shape[0]
    s = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i : i + s, :] * w[i] for i in range(width))
    y = y + p["b"].to(x.dtype)
    new_state = xp[:, -(width - 1) :, :].clone() if width > 1 else state
    return y, new_state


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def rglru_init(scope: Scope, name: str, cfg: ArchConfig) -> None:
    r = cfg.recurrent
    assert r is not None
    w = r.lru_width or cfg.d_model
    d = cfg.d_model
    c = scope.child(name)
    c.param("w_in", (d, w), ("embed", "rnn"), init="fan_in")  # recurrence branch
    c.param("w_gate_branch", (d, w), ("embed", "rnn"), init="fan_in")  # gelu gate branch
    conv1d_init(c, "conv", r.conv_width, w)
    c.param("w_a", (w, w), ("rnn", None), init="fan_in")  # recurrence gate
    c.param("b_a", (w,), ("rnn",), init="zeros")
    c.param("w_x", (w, w), ("rnn", None), init="fan_in")  # input gate
    c.param("b_x", (w,), ("rnn",), init="zeros")
    c.param("lam", (w,), ("rnn",), init="uniform", scale=1.0)  # Λ -> a in (0,1)
    c.param("w_out", (w, d), ("rnn", "embed"), init="fan_in")


def rglru_scan(p: Params, u: torch.Tensor, h0: torch.Tensor | None, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The gated linear recurrence.

    u: (B,S,W) post-conv inputs. h0: (B,W) carry-in or None.
    Returns (h_all (B,S,W) in u's dtype, h_last (B,W) fp32)."""
    dt = u.dtype
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(uf @ p["w_x"].float() + p["b_x"].float())
    log_a = -RGLRU_C * F.softplus(p["lam"].float()) * r  # (B,S,W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    if h0 is not None:
        # Fold the carry into the first step: h_1 = a_1 h_0 + b_1.
        gated[:, 0, :] += a[:, 0, :] * h0.float()
    if u.shape[1] == 1:
        h = gated  # one step: a h_0 + b, folded above
    elif cfg.attn_impl == "flash" and not ops.tracked(a, gated):
        h = ops.rglru_scan(a, gated)
    else:
        h = ref.rglru_ref(a, gated)
    return h.to(dt), h[:, -1, :]


def rglru_block_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    """Full Griffin recurrent block: gate branch ⊙ RG-LRU branch → out proj.

    state = {"h": (B,W) fp32, "conv": (B,width-1,W)}; None starts from
    zeros (train)."""
    dt = x.dtype
    gate = _gelu(x @ p["w_gate_branch"].to(dt))
    u = x @ p["w_in"].to(dt)
    # Read the conv state in compute dtype; write it back in cache dtype.
    conv_state = None if state is None else state["conv"].to(dt)
    h0 = None if state is None else state["h"]
    u, new_conv = conv1d_apply(p["conv"], u, conv_state)
    if state is not None:
        new_conv = new_conv.to(state["conv"].dtype)
    h, h_last = rglru_scan(p, u, h0, cfg)
    y = (gate * h) @ p["w_out"].to(dt)
    return y, {"h": h_last.float(), "conv": new_conv}


def rglru_make_state(cfg: ArchConfig, batch: int, dtype, device="cuda") -> dict:
    r = cfg.recurrent
    assert r is not None
    w = r.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, r.conv_width - 1, w), dtype=dtype, device=device),
    }


def _by_heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    """``t`` (B, S, nh * dh), and its gradient, placed on a mesh as its
    ``nh`` heads split, each device holding its heads' columns, or whole
    where the heads do not divide over the mesh: a split of the width that
    cuts a head cannot regroup into heads (nor, in the backward, can the
    gradient), and one that the products leave elsewhere would be moved at
    every step of the scan."""
    b, s, w = t.shape
    if splits((nh,), "act_heads"):
        return constrain(t.reshape(b, s, nh, w // nh), "batch", "seq", "act_heads", None).reshape(b, s, w)
    return constrain(t, "batch", "seq", None)


# ---------------------------------------------------------------------------
# mLSTM — matrix memory with exponential gating (xLSTM)
# ---------------------------------------------------------------------------


def mlstm_init(scope: Scope, name: str, cfg: ArchConfig) -> None:
    r = cfg.recurrent
    assert r is not None
    d = cfg.d_model
    dp = int(d * r.mlstm_proj_factor)
    h = cfg.n_heads
    c = scope.child(name)
    c.param("w_up", (d, 2 * dp), ("embed", "ff"), init="fan_in")  # (x_inner, z gate)
    conv1d_init(c, "conv", 4, dp)
    c.param("wq", (dp, dp), ("rnn", None), init="fan_in")
    c.param("wk", (dp, dp), ("rnn", None), init="fan_in")
    c.param("wv", (dp, dp), ("rnn", None), init="fan_in")
    c.param("w_if", (dp, 2 * h), ("rnn", None), init="fan_in")  # i,f gate pre-acts
    c.param("b_if", (2 * h,), (None,), init="zeros")
    c.param("skip", (dp,), ("rnn",), init="ones")  # learnable conv skip
    c.param("w_down", (dp, d), ("ff", "embed"), init="fan_in")


def mlstm_make_state(cfg: ArchConfig, batch: int, device="cuda") -> dict:
    r = cfg.recurrent
    assert r is not None
    dp = int(cfg.d_model * r.mlstm_proj_factor)
    h = cfg.n_heads
    dh = dp // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, h, dh, dh), **f32),
        "n": torch.zeros((batch, h, dh), **f32),
        "m": torch.full((batch, h), float("-inf"), **f32),
        "conv": torch.zeros((batch, 3, dp), **f32),
    }


def mlstm_block_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    """xLSTM mLSTM block (pre-LN residual body handled by the caller)."""
    r = cfg.recurrent
    assert r is not None
    b, s, d = x.shape
    dt = x.dtype
    dp = int(d * r.mlstm_proj_factor)
    nh = cfg.n_heads
    dh = dp // nh

    # (Constrained so that on a mesh its gradient comes back split as w_up's
    # columns are: gathered whole for the slices, it would make every device
    # compute all of w_up's gradient.)
    up = constrain(x @ p["w_up"].to(dt), "batch", "seq", "act_ff")
    x_in, z = up[..., :dp], up[..., dp:]
    conv_state = None if state is None else state["conv"].to(dt)
    x_conv, new_conv = conv1d_apply(p["conv"], x_in, conv_state)
    x_conv = F.silu(x_conv)

    # Heads-major (B, H, S, dh) and (B, H, S), as the kernel takes them; on
    # a mesh, these and h (and h's gradient) are whole sums: the scan writes
    # its steps into a tensor laid out as q, which DTensor cannot do for a
    # partial sum.  Where the heads do not divide over the mesh, the (B, S,
    # dp) values are whole before they regroup into heads (and their
    # gradients before they regroup back): a width split cuts a head.
    whole = (lambda t: t) if splits((nh,), "act_heads") else (lambda t: constrain(t, "batch", "seq", None))
    heads = lambda t: constrain(whole(t).reshape(b, s, nh, dh).float().transpose(1, 2).contiguous(),
                                "batch", "act_heads", None, None)
    q = heads(x_conv @ p["wq"].to(dt))
    k = heads(x_conv @ p["wk"].to(dt)) / math.sqrt(dh)
    v = heads(x_in @ p["wv"].to(dt))
    if_pre = (x_conv @ p["w_if"].to(dt) + p["b_if"].to(dt)).float()
    gates = lambda t: constrain(t.transpose(1, 2).contiguous(), "batch", "act_heads", None)
    ip = gates(if_pre[..., :nh])
    fp = gates(-F.softplus(-if_pre[..., nh:]))  # log sigmoid forget gate

    carry = None if state is None else (state["C"], state["n"], state["m"])
    if s == 1:
        if carry is None:
            carry = tuple(mlstm_make_state(cfg, b, x.device)[key] for key in ("C", "n", "m"))
        carry, h = ref.mlstm_step(carry, q[:, :, 0], k[:, :, 0], v[:, :, 0], ip[:, :, 0], fp[:, :, 0])
        h = h[:, :, None]
    elif cfg.attn_impl == "flash" and not ops.tracked(q, k, v, ip, fp, carry):
        h, carry = ops.mlstm_chunkwise(q, k, v, ip, fp, carry)
    else:
        h, carry = ref.mlstm_ref(q, k, v, ip, fp, carry)
    h = whole(constrain(h, "batch", "act_heads", None, None).transpose(1, 2).reshape(b, s, dp)).to(dt)

    h = h + p["skip"].to(dt) * x_conv
    y = (h * F.silu(z)) @ p["w_down"].to(dt)
    C_f, n_f, m_f = carry
    return y, {"C": C_f, "n": n_f, "m": m_f, "conv": new_conv.float()}


# ---------------------------------------------------------------------------
# sLSTM — scalar memory, block-diagonal recurrence (xLSTM)
# ---------------------------------------------------------------------------


def slstm_init(scope: Scope, name: str, cfg: ArchConfig) -> None:
    r = cfg.recurrent
    assert r is not None
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    c = scope.child(name)
    for g in ("i", "f", "z", "o"):
        c.param(f"w_{g}", (d, d), ("embed", "rnn"), init="fan_in")
        c.param(f"r_{g}", (h, dh, dh), ("heads", None, None), init="fan_in")  # block-diag
        c.param(f"b_{g}", (d,), ("rnn",), init="zeros")
    ff = int(d * r.slstm_proj_factor)
    c.param("w_ff_up", (d, 2 * ff), ("embed", "ff"), init="fan_in")
    c.param("w_ff_down", (ff, d), ("ff", "embed"), init="fan_in")


def slstm_make_state(cfg: ArchConfig, batch: int, device="cuda") -> dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, d), **f32),
        "n": torch.zeros((batch, d), **f32),
        "m": torch.full((batch, d), float("-inf"), **f32),
        "h": torch.zeros((batch, d), **f32),
    }


def slstm_block_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    dt = x.dtype
    nh = cfg.n_heads
    dh = d // nh

    # On a mesh each device steps its own heads' cells (``_by_heads``).
    pre = {g: _by_heads((x @ p[f"w_{g}"].to(dt) + p[f"b_{g}"].to(dt)).float(), nh) for g in "ifzo"}
    if state is None:
        state = slstm_make_state(cfg, b, x.device)
    c, n, m, h = (_by_heads(state[key][:, None], nh)[:, 0] for key in "cnmh")  # (placed as the gates)
    r_mats = {g: p[f"r_{g}"].float() for g in "ifzo"}

    hs = []
    for t in range(s):
        hh = h.reshape(b, nh, dh)
        rec = {g: torch.einsum("bhd,hde->bhe", hh, r_mats[g]).reshape(b, d) for g in "ifzo"}
        ip = pre["i"][:, t] + rec["i"]
        fp = pre["f"][:, t] + rec["f"]
        zp = torch.tanh(pre["z"][:, t] + rec["z"])
        op = torch.sigmoid(pre["o"][:, t] + rec["o"])
        fp = -F.softplus(-fp)  # log sigmoid
        no_hist = torch.isinf(m) & (m < 0)
        m_safe = torch.where(no_hist, 0.0, m)
        m_new = torch.maximum(torch.where(no_hist, ip, fp + m_safe), ip)
        i_g = torch.exp(ip - m_new)
        f_g = torch.where(no_hist, 0.0, torch.exp(fp + m_safe - m_new))
        c = f_g * c + i_g * zp
        n = f_g * n + i_g
        h = op * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    h_seq = _by_heads(torch.stack(hs, dim=1), nh).to(dt)  # (its gradient placed once, not at every step)

    ff = p["w_ff_up"].shape[1] // 2
    up = h_seq @ p["w_ff_up"].to(dt)
    y = (F.silu(up[..., :ff]) * up[..., ff:]) @ p["w_ff_down"].to(dt)
    return y, {"c": c, "n": n, "m": m, "h": h}
