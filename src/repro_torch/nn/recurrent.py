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

On a mesh whose model axis the xLSTM heads do not divide, but which
divides by them, the cells' scans share each head out over its devices
(``_head_share``), as the reference's partitioner does, and run the plain
scans.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.nn.layers import _as_dtensor, _gelu, _local
from repro_torch.nn.module import NamedSharding, Scope, active_spec, constrain, splits

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
    where the heads do not divide over the mesh and ``_head_share`` shares
    none of them out (a decode step, a split that would cut a head): a
    width split that cuts a head cannot regroup into heads (nor, in the
    backward, can the gradient), and one that the products leave elsewhere
    would be moved at every step of the scan."""
    b, s, w = t.shape
    if splits((nh,), "act_heads"):
        return constrain(t.reshape(b, s, nh, w // nh), "batch", "seq", "act_heads", None).reshape(b, s, w)
    return constrain(t, "batch", "seq", None)


class _Share(NamedTuple):
    """A mesh dim that splits a width of heads more ways than there are
    heads: each of its devices holds 1 / s of the width, inside one head,
    the ``r`` devices of a head in a row."""

    mesh: Any
    dim: int
    r: int

    def place(self, b: int, model) -> list:
        """Placements of a value whose dim 0 is the batch: the batch's
        (where the active rules split it) and ``model`` on this dim."""
        batch = NamedSharding(self.mesh, active_spec((b,), "batch")).placements()
        return [model if i == self.dim else p for i, p in enumerate(batch)]

    def reads(self, b: int) -> list:
        """The gradient's placements of a value that every device of this
        dim holds whole and reads only its head of: partial sums here."""
        return self.place(b, Partial())

    def head(self) -> tuple[int, int]:
        """(this device's head, its part of the head)."""
        return divmod(self.mesh.get_local_rank(self.dim), self.r)


def _head_share(x: torch.Tensor, nh: int, width: int) -> _Share | None:
    """Where the active mesh splits ``width`` (``act_ff``) over s devices
    that the ``nh`` heads do not divide but that divide by them (s = r·nh):
    that split, over which the cells' recurrence shares each head out, as
    the reference's partitioner shares it; None elsewhere (off a mesh, on a
    plain tensor, where the heads divide, or where a device's 1 / s of the
    width would cut a head), where ``_by_heads`` places the heads."""
    if not isinstance(x, DTensor) or splits((nh,), "act_heads"):
        return None
    (axis,) = active_spec((width,), "act_ff")
    names = x.device_mesh.mesh_dim_names
    if not isinstance(axis, str) or axis not in names:
        return None
    dim = names.index(axis)
    n = x.device_mesh.size(dim)
    return _Share(x.device_mesh, dim, n // nh) if n % nh == 0 else None


class _GatherColumns(torch.autograd.Function):
    """A block (B, w) of columns gathered over a process group into (B,
    n·w); the gradient, each device's of the whole, summed over the group
    and scattered back to the blocks (a reduce-scatter).  (Both move the
    columns as rows, the dim the collectives concatenate.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        c10d = torch.ops._c10d_functional
        rows = c10d.all_gather_into_tensor(x.t().contiguous(), group.size(), group.group_name)
        return c10d.wait_tensor(rows).t()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        c10d, group = torch.ops._c10d_functional, ctx.group
        rows = c10d.reduce_scatter_tensor(grad.t().contiguous(), "sum", group.size(), group.group_name)
        return c10d.wait_tensor(rows).t(), None


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

    share = _head_share(x, nh, dp) if s > 1 else None
    if share is not None:
        x_in, z = _halves(x, p["w_up"].to(dt), share)
    else:
        # (Constrained so that on a mesh its gradient comes back split as
        # w_up's columns are: gathered whole for the slices, it would make
        # every device compute all of w_up's gradient.)
        up = constrain(x @ p["w_up"].to(dt), "batch", "seq", "act_ff")
        x_in, z = up[..., :dp], up[..., dp:]
    conv_state = None if state is None else state["conv"].to(dt)
    x_conv, new_conv = conv1d_apply(p["conv"], x_in, conv_state)
    x_conv = F.silu(x_conv)

    carry = None if state is None else (state["C"], state["n"], state["m"])
    if share is not None:
        h, carry = _mlstm_shared(p, x_in, x_conv, carry, nh, share)
    else:
        # Heads-major (B, H, S, dh) and (B, H, S), as the kernel takes them;
        # on a mesh, these and h (and h's gradient) are whole sums: the scan
        # writes its steps into a tensor laid out as q, which DTensor cannot
        # do for a partial sum.  Where the heads do not divide over the mesh
        # (a decode step, or a split that would cut a head), the (B, S, dp)
        # values are whole before they regroup into heads (and their
        # gradients before they regroup back).
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


def _every(share: _Share) -> list:
    return [Replicate()] * share.mesh.ndim


def _param_grad(share: _Share, b: int) -> list:
    """The gradient's placements of a param that each device reads a block
    of: a partial sum over the devices of the split and over the batch's."""
    return [Partial() if isinstance(pl, Shard) or i == share.dim else Replicate()
            for i, pl in enumerate(share.place(b, Replicate()))]


def _halves(x: torch.Tensor, w: torch.Tensor, share: _Share) -> tuple[torch.Tensor, torch.Tensor]:
    """(x @ w[:, :n], x @ w[:, n:]) for w of 2·n columns, each split by
    columns as the cells' values are: each device projects its 1 / s of
    either half from x and w gathered whole (a split of w's 2·n columns
    would put one device's columns of a half on another).  x's gradient
    comes back a partial sum over the split (reduce-scattered where x was
    split by columns)."""
    b, n = x.shape[0], w.shape[1] // 2

    def project(xl, wl):
        k = n // share.mesh.size(share.dim)
        i = share.mesh.get_local_rank(share.dim)
        return xl @ wl[:, i * k : (i + 1) * k], xl @ wl[:, n + i * k : n + (i + 1) * k]

    split = share.place(b, Shard(2))
    return _local(project, (split, split), [share.place(b, Replicate()), _every(share)],
                  [x, _as_dtensor(w, share.mesh)], [share.reads(b), _param_grad(share, b)])


def _mlstm_shared(p: Params, x_in: torch.Tensor, x_conv: torch.Tensor, carry: tuple | None, nh: int,
                  share: _Share) -> tuple[torch.Tensor, tuple]:
    """The mLSTM's cells over S > 1 steps on a mesh that shares each head
    out (``_head_share``): each device steps the value rows of its head
    that its 1 / s of the width holds, from its head's whole q, k, gates and
    normaliser n (a row of C[v, k] reads only its own value; the
    denominator |n·q| reads all of k), with the arithmetic of the whole
    heads' scan element for element and no collective inside it.

    q, k and the gates' pre-activations are reduced whole (their gradients,
    each device's of its head, are partial sums), v is reduced to the
    device's columns, and h comes back split as v is, meeting ``skip *
    x_conv`` and ``w_down`` as the ``ff``-split operands do.  Every
    placement is fixed here (``local_map``), none left to DTensor.  The
    carry comes back whole (its rows gathered), as the cache holds it.
    Returns (h (B, S, dp) in x's dtype, (C, n, m))."""
    b, s, dp = x_in.shape
    dh, dt = dp // nh, x_in.dtype
    whole = lambda t: constrain(t, "batch", "seq", None)
    q = whole(x_conv @ p["wq"].to(dt))
    k = whole(x_conv @ p["wk"].to(dt))
    v = constrain(x_in @ p["wv"].to(dt), "batch", "seq", "act_ff")
    if_pre = (whole(x_conv @ p["w_if"].to(dt)) + p["b_if"].to(dt)).float()

    def cells(q, k, v, if_pre, *carry):
        bl = q.shape[0]
        hd, part = share.head()
        cols = slice(hd * dh, (hd + 1) * dh)
        heads = lambda t: t.reshape(bl, s, 1, -1).float().transpose(1, 2).contiguous()
        gate = lambda t: t.transpose(1, 2).contiguous()
        ql, kl, vl = heads(q[..., cols]), heads(k[..., cols]) / math.sqrt(dh), heads(v)
        ip = gate(if_pre[..., hd : hd + 1])
        fp = gate(-F.softplus(-if_pre[..., nh + hd : nh + hd + 1]))  # log sigmoid forget gate
        rows = slice(part * vl.shape[-1], (part + 1) * vl.shape[-1])
        mine = None if not carry else (carry[0][:, hd : hd + 1, rows], *(t[:, hd : hd + 1] for t in carry[1:]))
        h, (C, n, m) = ref.mlstm_ref(ql, kl, vl, ip, fp, mine)
        return h.transpose(1, 2).reshape(bl, s, -1).to(dt), C.reshape(bl, -1, dh), n, m

    held, split, rows = share.place(b, Replicate()), share.place(b, Shard(2)), share.place(b, Shard(1))
    reads, given = share.reads(b), list(carry or ())
    h, C, n, m = _local(cells, (split, rows, rows, rows), [held, held, split, held] + [held] * len(given),
                        [q, k, v, if_pre, *given], [reads, reads, split, reads] + [reads] * len(given))
    # The carry whole: C's rows (B, dp, dh) are the heads' value rows in
    # order; n and m are the same on each of a head's r devices.
    C, n, m = (t.redistribute(share.mesh, held) for t in (C, n, m))
    return h, (C.reshape(b, nh, dh, dh), n[:, :: share.r], m[:, :: share.r])


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

    share = _head_share(x, nh, d) if s > 1 else None
    if share is not None:
        h_seq, (c, n, m, h) = _slstm_shared(p, x, state, nh, share)
        gated = _ff_gate_shared(h_seq, p["w_ff_up"].to(dt), share)
    else:
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
            c, n, m, h = _slstm_cell(c, n, m, {g: pre[g][:, t] for g in "ifzo"}, rec)
            hs.append(h)
        h_seq = _by_heads(torch.stack(hs, dim=1), nh).to(dt)  # (its gradient placed once, not at every step)
        ff = p["w_ff_up"].shape[1] // 2
        up = h_seq @ p["w_ff_up"].to(dt)
        gated = F.silu(up[..., :ff]) * up[..., ff:]
    y = gated @ p["w_ff_down"].to(dt)
    return y, {"c": c, "n": n, "m": m, "h": h}


def _slstm_cell(c, n, m, pre: dict, rec: dict) -> tuple:
    """One sLSTM step from the gates' input and recurrent pre-activations:
    the new (c, n, m, h)."""
    ip = pre["i"] + rec["i"]
    fp = pre["f"] + rec["f"]
    zp = torch.tanh(pre["z"] + rec["z"])
    op = torch.sigmoid(pre["o"] + rec["o"])
    fp = -F.softplus(-fp)  # log sigmoid
    no_hist = torch.isinf(m) & (m < 0)
    m_safe = torch.where(no_hist, 0.0, m)
    m_new = torch.maximum(torch.where(no_hist, ip, fp + m_safe), ip)
    i_g = torch.exp(ip - m_new)
    f_g = torch.where(no_hist, 0.0, torch.exp(fp + m_safe - m_new))
    c = f_g * c + i_g * zp
    n = f_g * n + i_g
    return c, n, m_new, op * c / torch.clamp(n, min=1.0)


def _slstm_shared(p: Params, x: torch.Tensor, state: dict | None, nh: int,
                  share: _Share) -> tuple[torch.Tensor, tuple]:
    """The sLSTM's cells over S > 1 steps on a mesh that shares each head
    out (``_head_share``): each device steps the columns e of its head that
    its 1 / s of the width holds, its block of the block-diagonal
    recurrence r[head][:, e] (every step gathers h's columns, one (B, d)
    fp32 all-gather, and its gradient is reduce-scattered back), as the
    reference's partitioner splits it.  Every placement is fixed here
    (``local_map``), none left to DTensor.  Returns (h_seq (B, S, d) in x's
    dtype and the final (c, n, m, h), all split by columns)."""
    b, s, d = x.shape
    dh, dt = d // nh, x.dtype
    pre = [constrain((x @ p[f"w_{g}"].to(dt) + p[f"b_{g}"].to(dt)).float(), "batch", "seq", "act_ff")
           for g in "ifzo"]
    carry = [] if state is None else [state[key] for key in "cnmh"]
    group = share.mesh.get_group(share.dim)

    def cells(*blocks):
        pre, r, carry = dict(zip("ifzo", blocks[:4])), dict(zip("ifzo", blocks[4:8])), blocks[8:]
        bl, w = pre["i"].shape[0], pre["i"].shape[-1]
        hd, part = share.head()
        cols = slice(hd * dh, (hd + 1) * dh)
        r = {g: t[hd, :, part * w : (part + 1) * w].float() for g, t in r.items()}
        if carry:
            c, n, m, h = carry
        else:
            f32 = dict(dtype=torch.float32, device=pre["i"].device)
            c, n, h = (torch.zeros((bl, w), **f32) for _ in range(3))
            m = torch.full((bl, w), float("-inf"), **f32)
        hs = []
        for t in range(s):
            hh = _GatherColumns.apply(h, group)[:, cols]
            c, n, m, h = _slstm_cell(c, n, m, {g: pre[g][:, t] for g in "ifzo"}, {g: hh @ r[g] for g in "ifzo"})
            hs.append(h)
        return torch.stack(hs, dim=1).to(dt), c, n, m, h

    split, cols = share.place(b, Shard(2)), share.place(b, Shard(1))
    args = [*pre, *(_as_dtensor(p[f"r_{g}"], share.mesh) for g in "ifzo"), *carry]
    out = _local(cells, (split, cols, cols, cols, cols), [split] * 4 + [_every(share)] * 4 + [cols] * len(carry),
                 args, [split] * 4 + [_param_grad(share, b)] * 4 + [cols] * len(carry))
    return out[0], tuple(out[1:])


def _ff_gate_shared(h_seq: torch.Tensor, w: torch.Tensor, share: _Share) -> torch.Tensor:
    """The sLSTM's feed-forward gate, silu(up[:ff]) * up[ff:] with up =
    h_seq @ w, from h_seq split by columns, on a mesh that shares the heads
    out, split as the reference's partitioner splits it: where the mesh
    splits ff, each device gates its 1 / s of ff from h_seq gathered whole
    (its gradient reduce-scattered back); where it does not, each device
    takes its rows of w against its columns of h_seq and the partial sums
    are reduced whole."""
    ff = w.shape[1] // 2
    if splits((ff,), "act_ff"):
        a, g = _halves(h_seq, w, share)
    else:
        b = h_seq.shape[0]

        def project(hl, wl):
            i, n = share.mesh.get_local_rank(share.dim), hl.shape[-1]
            return hl @ wl[i * n : (i + 1) * n]

        split = share.place(b, Shard(2))
        up = _local(project, share.place(b, Partial()), [split, _every(share)],
                    [h_seq, _as_dtensor(w, share.mesh)], [split, _param_grad(share, b)])
        up = constrain(up, "batch", "seq", None)
        a, g = up[..., :ff], up[..., ff:]
    return F.silu(a) * g
