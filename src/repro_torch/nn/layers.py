"""Layer library of the port: norms, projections, RoPE, GQA attention
(sliding window, qk-norm, dict or two-level KV cache, or cross-attention
onto precomputed keys), DeepSeek's MLA with its latent cache, MLPs, the
sort-dispatched MoE and, for the port's own Command A+, an expert share
over a grouped product — the port of ``repro/nn/layers.py``.  Every apply
function is differentiable on the plain path; training attends through ``_attend``
(``attn_impl="xla"``, as the reference trains), since the flash kernel has
no backward.  MLA and the capacity-padded MoE reach no kernel: the
reference has no Pallas kernel for them.

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
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.configs.port import setting
from repro_torch.kernels import ops
from repro_torch.nn.module import Scope, constrain, current_dp_groups
from repro_torch.runtime.trace import span

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
    """The rows of ``tokens`` in the compute dtype (times sqrt(d) where the
    config scales them).  Where a mesh splits the table's vocab dim, each
    device looks up its own row range (``_vocab_parallel_lookup``)."""
    split = vocab_split(p["table"], 0)
    if split:
        return _vocab_parallel_lookup(p["table"], tokens, cfg, split)
    return _lookup(constrain(p["table"], None, "embed"), tokens, cfg)


def _lookup(table: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    # F.embedding, not table[tokens]: its backward on CUDA sums each row's
    # gradients in a fixed order, where indexing's accumulates with atomics,
    # so a training run and its restart from a checkpoint agree bit for bit.
    x = F.embedding(tokens, table).to(cdtype(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def vocab_split(t: torch.Tensor, dim: int) -> list[int]:
    """The mesh dims that split dim ``dim`` of ``t`` (none off a mesh, for a
    plain tensor, on a 1 x 1 mesh, or where the shard-if-divisible rules
    left the dim whole)."""
    if not isinstance(t, DTensor):
        return []
    dim %= t.ndim
    return [i for i, p in enumerate(t.placements) if p.is_shard(dim) and t.device_mesh.size(i) > 1]


def _block_start(t: DTensor, dim: int) -> int:
    """Where this rank's block of ``t`` starts along ``dim`` (split evenly,
    mesh dim by mesh dim in order, as DTensor lays it out)."""
    mesh, length, start = t.device_mesh, t.shape[dim], 0
    coord = mesh.get_coordinate()
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            length //= mesh.size(i)
            start += coord[i] * length
    return start


def _whole(t: DTensor, dims: list[int]) -> DTensor:
    """``t`` reduced over the mesh dims ``dims`` (partial there)."""
    return t.redistribute(t.device_mesh, [Replicate() if i in dims else p for i, p in enumerate(t.placements)])


def _vocab_parallel_lookup(table: DTensor, tokens: torch.Tensor, cfg: ArchConfig, split: list[int]) -> torch.Tensor:
    """The lookup into a table whose vocab dim the mesh dims ``split``
    divide: each device reads its own rows ``[lo, lo + V/m)``, sends the
    tokens outside them to its row 0 and zeroes those rows, and the blocks
    are summed over ``split`` (one all-reduce of the (..., d) output; a sum
    of one row and zeros, so the values are those of the whole table).
    The table's gradient stays on its rows: no gather of the table, and no
    reduce of a V x d tensor over the vocab dims."""
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    lo, rows = _block_start(table, 0), table.to_local().shape[0]

    def lookup(block, tok):
        local = tok - lo
        inside = (local >= 0) & (local < rows)
        return _lookup(block, torch.where(inside, local, 0), cfg).masked_fill(~inside[..., None], 0)

    tok_in = [Replicate() if i in split else p for i, p in enumerate(tokens.placements)]
    table_in = [Shard(0) if i in split else Replicate() for i in range(mesh.ndim)]
    # The table's gradient is a partial sum over the mesh dims that split the tokens.
    table_grad = [Shard(0) if i in split else Partial() if p.is_shard() else Replicate() for i, p in enumerate(tok_in)]
    out = [Partial() if i in split else p for i, p in enumerate(tok_in)]
    x = _local(lookup, out, [table_in, tok_in], [table, tokens], [table_grad, tok_in])
    return _whole(x, split)


def vocab_parallel_logz_gold(logits: DTensor, labels: torch.Tensor, split: list[int]) -> tuple[DTensor, DTensor]:
    """``(logsumexp(logits, -1), logits[..., labels])`` of fp32 logits whose
    vocab dim the mesh dims ``split`` divide, with no gather of the logits:
    the max over the vocab (detached; an all-reduce of max), each device's
    sum of ``exp(x - max)`` over its columns, and the gold logit from the
    device whose columns hold the label (the others give 0), the last two
    summed over ``split``; three all-reduces of a (B, S) tensor."""
    mesh, last = logits.device_mesh, logits.ndim - 1
    labels = _as_dtensor(labels, mesh)
    lo, cols = _block_start(logits, last), logits.to_local().shape[-1]
    x_in = [Replicate() if p.is_partial() else p for p in logits.placements]
    rows_in = [p if p.is_shard() and p.dim < last else Replicate() for p in x_in]
    rows_out = lambda op: [Partial(op) if i in split else p for i, p in enumerate(rows_in)]

    def terms(x, y, m):
        local = y - lo
        inside = (local >= 0) & (local < cols)
        gold = torch.gather(x, -1, torch.where(inside, local, 0)[..., None])[..., 0]
        return torch.exp(x - m[..., None]).sum(-1), torch.where(inside, gold, 0.0)

    m = _whole(_local(lambda x: x.detach().amax(-1), rows_out("max"), [x_in], [logits]), split)
    total, gold = _local(terms, (rows_out("sum"), rows_out("sum")), [x_in, rows_in, rows_in], [logits, labels, m])
    return m + torch.log(_whole(total, split)), _whole(gold, split)


def logits_apply(embed_p: Params, head_p: Params | None, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Final LM head; fp32 logits. Tied -> embedding transpose.  Where a
    mesh splits the vocab, a partial-sum ``x`` (the residual stream DTensor
    left unreduced) is reduced first, so the logits come out split on the
    vocab rather than as a partial sum of (..., V) logits to be reduced."""
    w = (embed_p["table"] if head_p is None else head_p["w"]).float()
    if isinstance(x, DTensor) and vocab_split(w, 0 if head_p is None else 1):
        x = _whole(x, [i for i, p in enumerate(x.placements) if p.is_partial()])
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
    # The scale's gradient sums the output's gradient over every position:
    # made contiguous, it sums in one order whatever layout the attention's
    # backward (plain, or DTensor's) gives it, so a step on a 1 x 1 mesh
    # equals the plain step bit for bit.
    out = (y * scale.float()).to(dt)
    return _ContiguousGrad.apply(out) if out.requires_grad else out


def make_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, device="cuda") -> dict:
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def _shards(x: DTensor, dim: int) -> int:
    """How many ways the DTensor ``x`` splits its dim ``dim``."""
    return math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements) if p.is_shard(dim))


def _attend(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, K, D)
    v: torch.Tensor,  # (B, T, K, D)
    mask: torch.Tensor,  # (B or 1, S, T) boolean, True = attend
    cfg: ArchConfig,
) -> torch.Tensor:
    # On a mesh: the heads split as `out` (and its gradient) hold them.
    q = constrain(q, "batch", None, "act_heads", None)
    if _split(q, k, v):
        if isinstance(q, DTensor) and k.shape[2] % _shards(q, 2):
            # Blocks hold whole KV groups: where the heads' split does not
            # divide KV, k and v are repeated to all H heads first.
            k, v = (t.repeat_interleave(q.shape[2] // k.shape[2], dim=2) for t in (k, v))
        return _on_blocks(lambda *a: _attend(*a, cfg), q, (k, 2), (v, 2), (mask, None))
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


# The card's bf16 peak (989 TFLOP/s) and its NVLink rate a direction (450
# GB/s): what ``_project_kv`` prices a duplicated projection and a moved key at.
PEAK_FLOPS, LINK_BYTES = 989e12, 450e9


def _project_kv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, q: torch.Tensor | None) -> torch.Tensor:
    """Keys or values, ``einsum("bsd,dhk->bshk", x, w)`` (+ ``b``).

    On a mesh whose split of the query heads (over s devices) the KV heads
    do not divide, but divide s, the result has s head slots split as q's
    heads, slot j holding kv head j * KV / s, so each device's attention
    block finds its kv head at home.  A device's slot comes one of two ways:
    - it projects the slot itself from its rows of ``x``, as the
      reference's partitioner places it: each kv head on the s / KV devices
      that read it, so every device repeats (1 - KV / s) of the work;
    - or it projects every kv head for its 1 / s of the sequence, its share
      of the work, and an all-to-all brings each device its slot.
    The second is taken where the FLOPs it saves outlast the bytes it moves
    at the card's rates (``PEAK_FLOPS``, ``LINK_BYTES``; under autograd the
    saving counts three products, the move two).  ``x``'s and ``w``'s
    gradients are partial sums over the devices either way.  Left to
    DTensor, ``w``'s replicated kv dim would make every device project
    every kv head."""
    kv = w.shape[1]
    dims = [i for i, p in enumerate(q.placements) if p.is_shard(2)] if isinstance(q, DTensor) else []
    s = _shards(q, 2) if dims else 1
    if s == 1 or kv % s == 0 or s % kv or not isinstance(x, DTensor):
        y = torch.einsum("bsd,dhk->bshk", x, w)
        return y if b is None else y + b
    mesh, seq, d = x.device_mesh, x.shape[1], x.shape[2]
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    saved = (3 if grad else 1) * 2 * d * (1 - kv / s) / PEAK_FLOPS
    moved = (2 if grad else 1) * x.element_size() * (1 - 1 / s) / LINK_BYTES
    split_seq = seq % s == 0 and saved > moved
    x_in = [Replicate() if i in dims else p for i, p in enumerate(x.placements)]
    x_grad = [Partial() if i in dims else p for i, p in enumerate(x_in)]
    w_grad = [Partial() if i in dims or p.is_shard() else Replicate() for i, p in enumerate(x_in)]
    slots = [Shard(2) if i in dims else p for i, p in enumerate(x_in)]
    params = [w] if b is None else [w, b]
    if split_seq:
        lo, n = _block_start(q, 2) * seq // q.shape[2], seq // s
        heads, rows, out = slice(None), slice(lo, lo + n), [Shard(1) if i in dims else p for i, p in enumerate(x_in)]
    else:
        head = _block_start(q, 2) * kv // q.shape[2]
        heads, rows, out = slice(head, head + 1), slice(None), slots

    def project(xl, wl, bl=None):
        y = torch.einsum("bsd,dhk->bshk", xl[:, rows], wl[:, heads])
        y = y if bl is None else y + bl[heads]
        return y.repeat_interleave(s // kv, dim=2) if split_seq else y

    y = _local(project, out, [x_in] + [[Replicate()] * mesh.ndim] * len(params),
               [x] + [_as_dtensor(t, mesh) for t in params], [x_grad] + [w_grad] * len(params))
    return y.redistribute(mesh, slots) if split_seq else y


def _kv_heads(t: torch.Tensor, kv: int) -> torch.Tensor:
    """The KV heads of keys or values that ``_project_kv`` laid out in head
    slots (every slot gathered; one slot a kv head), for a cache."""
    if t.shape[2] == kv:
        return t
    return constrain(t, "batch", None, None, None)[:, :, :: t.shape[2] // kv]


def _split(*xs) -> bool:
    """Whether any of ``xs`` is a DTensor split on some mesh dim."""
    return any(isinstance(t, DTensor) and not all(p.is_replicate() for p in t.placements) for t in xs)


def _on_blocks(fn, q, *others):
    """``fn(q, *others)`` on a mesh, each device computing its own (batch,
    heads) block of q with the plain attention, as XLA partitions it.
    DTensor's own rules cannot: the products fold batch and heads into one
    dim, which they cannot split on both.  ``others`` are (tensor, its
    heads dim or None) pairs, each brought to q's block (a leading dim of 1,
    a mask's, stays whole)."""
    mesh = next(t.device_mesh for t in (q, *(o for o, _ in others)) if isinstance(t, DTensor))
    q = _as_dtensor(q, mesh)

    def block(t, heads):
        return [Shard(0) if p.is_shard(0) and t.shape[0] > 1 else Shard(heads) if p.is_shard(2) and heads is not None
                else Replicate() for p in q.placements]

    args = [q] + [_as_dtensor(t, mesh) for t, _ in others]
    return _local(fn, block(q, 2), [block(t, h) for t, (_, h) in zip(args, [(q, 2), *others])], args)


def _as_dtensor(t, mesh) -> DTensor:
    return t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _local(fn, out_placements, in_placements, args, grad_placements=None):
    """``fn`` run by ``local_map`` on each device's blocks of ``args``
    (redistributed to ``in_placements``; their gradients placed as
    ``grad_placements`` say, by default as the inputs), its gradients made
    contiguous where they cross the blocks' edges."""
    contig = lambda t: _ContiguousGrad.apply(t) if t.requires_grad else t

    def run(*a):
        out = fn(*map(contig, a))
        return tuple(map(contig, out)) if isinstance(out, tuple) else contig(out)

    return local_map(run, out_placements=out_placements, in_placements=tuple(in_placements),
                     in_grad_placements=None if grad_placements is None else tuple(grad_placements),
                     device_mesh=args[0].device_mesh, redistribute_inputs=True)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: gradients that cross a
    block's edge are strided views (of a replicated gradient, or of a
    permuted product), which DTensor's and the attention's reshapes of them
    cannot take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


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
    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    use_rope: bool = True,
) -> tuple[torch.Tensor, Any]:
    """Self- (or cross-) attention with an optional dict or two-level KV cache.

    ``cross_kv`` switches to cross-attention: (k, v) come precomputed from
    the encoder; no cache/rope/mask beyond all-visible is applied, and it
    attends through ``_attend`` (the reference's flash call serves
    self-attention only)."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    dev = x.device

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)

    if cross_kv is not None:
        k, v = cross_kv
        mask = torch.ones((1, s, k.shape[1]), dtype=torch.bool, device=dev)
        if cfg.qk_norm:
            q = _head_rms(q, p["q_norm"], cfg.norm_eps)
        out = _attend(q, k, v, mask, cfg)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)), cache

    bias = lambda name: p[name].to(dt) if name in p else None
    k = _project_kv(x, p["wk"].to(dt), bias("bk"), q if mode != "decode" else None)
    v = _project_kv(x, p["wv"].to(dt), bias("bv"), q if mode != "decode" else None)

    if cfg.qk_norm:
        q = _head_rms(q, p["q_norm"], cfg.norm_eps)
        k = _head_rms(k, p["k_norm"], cfg.norm_eps)

    tiered = _is_tiered(cache)
    if tiered and (cfg.attn_logit_softcap > 0 or (cache.window != window if cache.sliding else window > 0)):
        # The two-level backend serves full-attention layers; a window
        # layer holds only its window's keys, in a device ring of that size.
        raise ValueError("tiered KV backend takes full-attention layers (a sliding ring a window layer of its "
                         "size) and no logit softcap")

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
        out = constrain(out, "batch", None, "act_heads", None)
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
        if mode == "prefill":
            k, v = _kv_heads(k, cfg.n_kv_heads), _kv_heads(v, cfg.n_kv_heads)
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

    out = constrain(out, "batch", None, "act_heads", None)
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
    h = constrain(h, "batch", None, "act_ff")
    y = h @ p["w_down"].to(dt)
    if "b_down" in p:
        y = y + p["b_down"].to(dt)
    return y


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V3 multi-head latent attention
# ---------------------------------------------------------------------------


def mla_init(scope: Scope, name: str, cfg: ArchConfig) -> None:
    m = cfg.mla or MLAConfig()
    c = scope.child(name)
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    c.param("wq_a", (d, m.q_lora_rank), ("embed", "q_lora"), init="fan_in")
    c.param("q_a_norm", (m.q_lora_rank,), ("q_lora",), init="ones")
    c.param("wq_b", (m.q_lora_rank, h, qk_head), ("q_lora", "heads", "head_dim"), init="fan_in")
    c.param("wkv_a", (d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "kv_lora"), init="fan_in")
    c.param("kv_a_norm", (m.kv_lora_rank,), ("kv_lora",), init="ones")
    c.param(
        "wkv_b",
        (m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim),
        ("kv_lora", "heads", "head_dim"),
        init="fan_in",
    )
    c.param("wo", (h, m.v_head_dim, d), ("heads", "head_dim", "embed"), init="fan_in")


def mla_make_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, device="cuda") -> dict:
    """The latent cache: ``c_kv`` (B, T, kv_lora_rank) and the roped
    ``k_pe`` (B, T, rope dim) a token, updated in place on decode."""
    m = cfg.mla or MLAConfig()
    return {
        "c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype, device=device),
        "k_pe": torch.zeros((batch, max_seq, m.qk_rope_head_dim), dtype=dtype, device=device),
        "index": 0,
    }


def _rms_vec(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


def _mla_attend(q_nope, q_pe, k_nope, k_pe, v, mask, m: MLAConfig) -> torch.Tensor:
    """softmax(mask((q_nope . k_nope + q_pe . k_pe) / sqrt(nope + rope))) v,
    the rope key shared by every head; fp32 scores, probabilities in the
    compute dtype.  On a mesh, each device attends its (batch, heads)
    block (``_on_blocks``)."""
    q_nope = constrain(q_nope, "batch", None, "act_heads", None)
    if _split(q_nope, q_pe, k_nope, k_pe, v):
        return _on_blocks(lambda *a: _mla_attend(*a, m), q_nope, (q_pe, 2), (k_nope, 2), (k_pe, None), (v, 2),
                          (mask, None))
    scores = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_pe, k_pe)).float()
    scores = scores / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_nope.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def mla_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, cache: dict | None = None,
              mode: str = "train") -> tuple[torch.Tensor, dict | None]:
    """MLA: queries, keys and values rebuilt from low-rank latents.

    The decode cache holds only (c_kv, k_pe): kv_lora_rank + rope dim values
    a token (DeepSeek-V3's KV-cache compression); decode rebuilds the keys
    and values of the whole cache from it each step, as the reference does.
    RoPE turns only the rope part of q and k."""
    m = cfg.mla or MLAConfig()
    b, s, d = x.shape
    dt = x.dtype
    dev = x.device

    cq = _rms_vec(x @ p["wq_a"].to(dt), p["q_a_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"].to(dt))
    q_nope, q_pe = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]

    kv_a = x @ p["wkv_a"].to(dt)
    c_kv, k_pe_in = kv_a[..., : m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    c_kv = _rms_vec(c_kv, p["kv_a_norm"], cfg.norm_eps)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode mode requires a cache")
        idx = cache["index"]
        cos, sin = rope_tables(torch.full((1, 1), idx, device=dev), m.qk_rope_head_dim, cfg.rope_theta)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe_r = apply_rope(k_pe_in[:, :, None, :], cos, sin)[:, :, 0, :]
        cc, cp = cache["c_kv"], cache["k_pe"]
        cc[:, idx : idx + s] = c_kv.to(cc.dtype)  # in place (see module doc)
        cp[:, idx : idx + s] = k_pe_r.to(cp.dtype)
        kv = torch.einsum("btr,rhk->bthk", cc.to(dt), p["wkv_b"].to(dt))
        k_nope, v = kv[..., : m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
        mask = (torch.arange(cc.shape[1], device=dev) <= idx)[None, None, :]
        out = _mla_attend(q_nope, q_pe, k_nope, cp.to(dt), v, mask, m)
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
        return y, {"c_kv": cc, "k_pe": cp, "index": idx + s}

    cos, sin = rope_tables(torch.arange(s, device=dev), m.qk_rope_head_dim, cfg.rope_theta)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe_in[:, :, None, :], cos, sin)[:, :, 0, :]
    kv = torch.einsum("btr,rhk->bthk", c_kv, p["wkv_b"].to(dt))
    k_nope, v = kv[..., : m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    out = _mla_attend(q_nope, q_pe, k_nope, k_pe, v, _causal_window_mask(s, s, 0, 0, dev), m)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))

    new_cache = cache
    if mode == "prefill":
        if cache is None:
            raise ValueError("prefill mode requires a pre-allocated cache")
        cc, cp = cache["c_kv"], cache["k_pe"]
        cc[:, :s] = c_kv.to(cc.dtype)
        cp[:, :s] = k_pe.to(cp.dtype)
        new_cache = {"c_kv": cc, "k_pe": cp, "index": s}
    return y, new_cache


# ---------------------------------------------------------------------------
# MoE — sort-based dispatch (static shapes, capacity-bounded)
# ---------------------------------------------------------------------------


def moe_init(scope: Scope, name: str, cfg: ArchConfig) -> None:
    """The router over every expert and the routed experts' weights: all
    ``n_experts`` of them, or under an expert share (``experts_held``)
    this device's experts only, drawn at the fan-in of their inputs."""
    mo = cfg.moe
    assert mo is not None
    c = scope.child(name)
    d, e, f = cfg.d_model, mo.n_experts, mo.expert_ff
    held = setting(cfg, "experts_held")
    # ``fan_in`` scales by the leading dim, the experts' count: a share
    # rescales to each matrix's own fan-in.
    fan = (lambda n: math.sqrt(held / n)) if held else (lambda n: None)
    c.param("router", (d, e), ("embed", "experts"), init="fan_in")
    c.param("w_gate", (held or e, d, f), ("experts", "embed", "expert_ff"), init="fan_in", scale=fan(d))
    c.param("w_up", (held or e, d, f), ("experts", "embed", "expert_ff"), init="fan_in", scale=fan(d))
    c.param("w_down", (held or e, f, d), ("experts", "expert_ff", "embed"), init="fan_in", scale=fan(f))
    if mo.n_shared:
        sh = c.child("shared")
        sh.param("w_gate", (d, mo.n_shared * f), ("embed", "ff"), init="fan_in")
        sh.param("w_up", (d, mo.n_shared * f), ("embed", "ff"), init="fan_in")
        sh.param("w_down", (mo.n_shared * f, d), ("ff", "embed"), init="fan_in")


def moe_capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots an expert has for a dispatch group of ``tokens`` tokens: the
    reference's ``int(max(1, round(T k / E * cf)))`` (Python's round)."""
    mo = cfg.moe
    return int(max(1, round(tokens * mo.top_k / mo.n_experts * mo.capacity_factor)))


def reset_moe_counts() -> None:
    """Zero the (token, expert) assignments routed, held and dropped by
    ``moe_apply`` since the last reset, and the experts the grouped
    product read."""
    moe_apply.routed, moe_apply.held, moe_apply.dropped, moe_apply.experts_read = 0, 0, 0, 0


def moe_counts() -> dict[str, int]:
    """Since the last reset: assignments routed (every (token, choice)),
    held (routed to an expert this device holds: all of them without an
    expert share) and dropped (over capacity; never under a share), and
    ``experts_read``, the held experts with at least one row summed over
    the grouped products.  The share path keeps its counts on the device,
    so a step never waits for them; reading them waits once."""
    return {"routed": int(moe_apply.routed), "held": int(moe_apply.held), "dropped": int(moe_apply.dropped),
            "experts_read": int(moe_apply.experts_read)}


class MoERoute(NamedTuple):
    """The assignments of ``g`` dispatch groups, each stably sorted by
    expert on its own (every field leads with the group dim): ``order``
    maps each sorted position to its flat (token, choice) index
    token * k + j within the group; ``expert``, ``slot``, ``keep`` (slot <
    ``cap``) and the normalised ``gate`` in the compute dtype are in sorted
    order; ``aux`` is the load-balance loss averaged over the groups."""

    order: torch.Tensor
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor
    cap: int


def moe_route(p: Params, xg: torch.Tensor, cfg: ArchConfig) -> MoERoute:
    """Route the tokens ``xg`` (g, Tg, d), each group's on their own: fp32
    router logits; sigmoid or softmax scores, their top k, gates normalised
    (+1e-9); the Switch aux loss E * sum_e f_e p_e of each group from the
    softmax probabilities and the top-1 one-hot, averaged over the groups;
    each group's (token, choice) assignments stably sorted by expert, each
    taking the next slot of its expert's ``moe_capacity(Tg)``, kept below it."""
    if _split(xg):
        return _route_groups(p, xg, cfg)
    mo = cfg.moe
    g, t, _ = xg.shape
    k, e = mo.top_k, mo.n_experts
    logits = (xg @ p["router"].to(xg.dtype)).float()  # (g, t, e)
    scores = torch.sigmoid(logits) if mo.router_type == "sigmoid" else torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(scores, k, dim=-1)  # (g, t, k)
    if mo.normalize_gates:
        gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    me = torch.softmax(logits, dim=-1).mean(dim=1)  # (g, e)
    ce = F.one_hot(expert_idx[..., 0], e).float().mean(dim=1)
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))

    cap = moe_capacity(t, cfg)
    flat_e = expert_idx.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    gidx = torch.arange(g, device=xg.device)[:, None]
    se = flat_e[gidx, order]
    slot = torch.arange(t * k, device=xg.device) - torch.searchsorted(se, se, side="left")
    gate = gate_vals.reshape(g, t * k).to(xg.dtype)[gidx, order]
    return MoERoute(order, se, slot, slot < cap, gate, aux, cap)


def _groups(x: DTensor) -> list:
    """Placements that keep ``x``'s split of its leading (group) dim and
    nothing else."""
    return [p if p.is_shard(0) else Replicate() for p in x.placements]


def _route_groups(p: Params, xg: DTensor, cfg: ArchConfig) -> MoERoute:
    """``moe_route`` on a mesh: each device routes its own groups (the
    group dim split over (pod, data)) with the plain routing, since
    DTensor's index rules cannot take a dim split on two mesh dims; the
    router is read whole.  ``aux``, a mean over groups, is the mean of the
    devices' means."""
    rows = _groups(xg)
    whole = [Replicate()] * xg.device_mesh.ndim
    aux = [Partial("avg") if p.is_shard(0) else Replicate() for p in rows]

    def route(xl, router):
        r = moe_route({"router": router}, xl, cfg)
        return r.order, r.expert, r.slot, r.keep, r.gate, r.aux

    out = _local(route, (rows,) * 5 + (aux,), [rows, whole], [xg, _as_dtensor(p["router"], xg.device_mesh)])
    return MoERoute(*out, moe_capacity(xg.shape[1], cfg))


def _dispatch(xg, order, expert, slot, keep, e: int, cap: int, k: int) -> torch.Tensor:
    """Each group's kept assignments into their (expert, slot) rows of a
    (g, E, C, d) buffer; the dropped ones all into a scratch row past the
    end, which is cut off."""
    g, _, d = xg.shape
    gidx = torch.arange(g, device=xg.device)[:, None]
    dest = torch.where(keep, expert * cap + slot, e * cap)  # (g, tk)
    buf = torch.zeros((g, e * cap + 1, d), dtype=xg.dtype, device=xg.device)
    buf = buf.index_put((gidx, dest), xg[gidx, order // k])  # group-local gather
    return buf[:, :-1].reshape(g, e, cap, d)


def _combine(y_buf, order, expert, slot, keep, gate, k: int) -> torch.Tensor:
    """Each token's kept expert outputs (g, E, C, d), gated, added to zero
    one by one in ascending expert order: (g, Tg, d)."""
    g, e, cap, d = y_buf.shape
    tk = order.shape[1]
    tg = tk // k
    dt = y_buf.dtype
    y_buf = y_buf.reshape(g, e * cap, d)
    gidx = torch.arange(g, device=y_buf.device)[:, None]
    src = torch.where(keep, expert * cap + slot, 0)
    gathered = y_buf[gidx, src] * (keep.to(dt) * gate)[..., None]  # (g, tk, d), sorted order
    # A token's k assignments sit in the sorted order by ascending expert;
    # their sorted positions (the inverse of ``order``), ascending, give
    # that order token by token.
    pos = torch.argsort(order, dim=-1).reshape(g, tg, k).sort(dim=-1).values
    contrib = gathered[gidx, pos.reshape(g, tk)].reshape(g, tg, k, d)
    y = torch.zeros((g, tg, d), dtype=dt, device=y_buf.device)
    for j in range(k):
        y = y + contrib[:, :, j]
    return y


def _per_group(fn, *args):
    """``fn(*args)`` with every arg's leading dim a group: on a mesh each
    device runs it on its own groups (DTensor's index rules cannot take a
    dim split on two mesh dims), else as it is."""
    if not _split(*args):
        return fn(*args)
    rows = _groups(args[0])
    mesh = args[0].device_mesh
    return _local(fn, rows, [rows] * len(args), [_as_dtensor(a, mesh) for a in args])


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts + optional shared experts, group-local dispatch.
    Returns (output, aux load-balance loss).

    The B*S tokens split into ``g`` dispatch groups — one per data-parallel
    shard of the active mesh (``current_dp_groups``), else one group; a
    token count that ``g`` does not divide takes one group, as the
    reference does.  Within a group: ``moe_route``'s assignments, the kept
    ones dispatched into (E, C) slots and dropped past them; the expert FFN
    a batched product over the (g, E, C) slots; gates cast to the compute
    dtype before the combine; shared experts added after it.  On a mesh the
    group dim shards over (pod, data) and the expert (or expert ff) dim
    over model, as the reference's constraints place them.

    The combine is deterministic: each token gathers the outputs of its
    kept assignments and adds them to zero one by one in ascending expert
    order — the order of the reference's scatter-add over the sorted
    assignments — with no atomics, so a run on the card repeats bit for bit.
    """
    mo = cfg.moe
    assert mo is not None
    if setting(cfg, "experts_held"):
        return moe_share_apply(p, x, cfg)
    b, s, d = x.shape
    dt = x.dtype
    t, k, e = b * s, mo.top_k, mo.n_experts
    # DTensor cannot regroup a token dim that it has split over the model
    # axis as well (XLA can): the tokens come in split over (pod, data) only.
    xf = constrain(x, "batch", None, None).reshape(t, d)
    g = current_dp_groups()
    if g <= 1 or t % g:
        g = 1
    tg = t // g
    xg = constrain(xf.reshape(g, tg, d), "dispatch", None, None)
    r = moe_route(p, xg, cfg)
    cap = r.cap
    moe_apply.routed += t * k
    moe_apply.held += t * k
    dropped = (~r.keep).sum()
    moe_apply.dropped = moe_apply.dropped + (dropped.full_tensor() if isinstance(dropped, DTensor) else dropped)

    buf = _per_group(lambda *a: _dispatch(*a, e, cap, k), xg, r.order, r.expert, r.slot, r.keep)
    buf = constrain(buf, "dispatch", "experts", None, None)

    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt))) * torch.einsum(
        "gecd,edf->gecf", buf, p["w_up"].to(dt))
    # Both candidate shardings: experts over model where E divides it
    # (deepseek), else the expert ff dim (grok).
    h = constrain(h, "dispatch", "experts", None, "expert_ff")
    y_buf = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    y_buf = constrain(y_buf, "dispatch", "experts", None, None)
    y = _per_group(lambda *a: _combine(*a, k), y_buf, r.order, r.expert, r.slot, r.keep, r.gate)
    # (and its gradient comes back split over (pod, data) only, for the same reason)
    y = constrain(constrain(y, "dispatch", None, None).reshape(t, d), "batch", None)

    if mo.n_shared:
        sp = p["shared"]
        hs = F.silu(xf @ sp["w_gate"].to(dt)) * (xf @ sp["w_up"].to(dt))
        y = y + hs @ sp["w_down"].to(dt)
    return y.reshape(b, s, d), r.aux.float()


# ---------------------------------------------------------------------------
# MoE — an expert share: route over every expert, compute the held ones
# ---------------------------------------------------------------------------

# Tokens a share's product takes at once: bounds its (rows, width)
# temporaries at a long prefill (the experts act on each token alone).
MOE_SHARE_CHUNK = 4096


def moe_tile(tokens: int, cfg: ArchConfig) -> int:
    """Rows a tile of the grouped product: 16 where an expert expects few
    rows (decode), 128 where it expects a prefill's many."""
    mo = cfg.moe
    return 128 if tokens * mo.top_k >= 64 * mo.n_experts else 16


class ExpertRows(NamedTuple):
    """A share's assignments laid out for the grouped product, built on the
    device with no host read.  The held assignments sort by expert, each
    expert's run padded to a multiple of ``tile`` rows, so every tile holds
    one expert's rows; the layout has room for every assignment held.

    ``rows`` (R,): each padded row's flat assignment index token * k + j,
    or T * k on padding; ``tile_expert`` (R / tile,) int32: each tile's
    local expert, ``experts_held`` past the last used tile; ``gate`` (R,)
    fp32: each row's normalised gate, 0 on padding; ``where`` (T, k): each
    assignment's padded row, R where its expert is not held; ``held`` and
    ``active``: the held assignments and the held experts with a row."""

    rows: torch.Tensor
    tile_expert: torch.Tensor
    gate: torch.Tensor
    where: torch.Tensor
    held: torch.Tensor
    active: torch.Tensor


def route_share(p: Params, x: torch.Tensor, cfg: ArchConfig, tile: int) -> ExpertRows:
    """Route the tokens x (T, d) over all ``n_experts`` with fp32 router
    logits: sigmoid or softmax scores, the top k, gates normalised over the
    k (+1e-9); then lay out the assignments to the held experts
    ``[experts_lo, experts_lo + experts_held)`` (``ExpertRows``).  Nothing
    is dropped: the layout is sized for every assignment."""
    mo = cfg.moe
    t, k, e = x.shape[0], mo.top_k, mo.n_experts
    held, lo = setting(cfg, "experts_held"), setting(cfg, "experts_lo")
    dev = x.device
    logits = x.float() @ p["router"].float()
    scores = torch.sigmoid(logits) if mo.router_type == "sigmoid" else torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(scores, k, dim=-1)
    if mo.normalize_gates:
        gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    local = expert_idx.reshape(-1) - lo
    local = torch.where((local >= 0) & (local < held), local, held)  # ``held``: not this device's
    counts = torch.zeros(held + 1, dtype=torch.int64, device=dev).scatter_add_(0, local, torch.ones_like(local))
    counts = counts[:held]
    padded = (counts + tile - 1) // tile * tile
    pad_end = torch.cumsum(padded, 0)
    n_rows = -(-(t * k + held * (tile - 1)) // tile) * tile  # room for every assignment, each run padded
    order = torch.argsort(local, stable=True)  # by expert; the not-held bucket last
    by_expert = local[order]
    mine = by_expert < held
    e_of = torch.where(mine, by_expert, 0)
    first = torch.cumsum(counts, 0) - counts  # each expert's first sorted position
    dest = (pad_end - padded)[e_of] + torch.arange(t * k, device=dev) - first[e_of]
    dest = torch.where(mine, dest, n_rows)  # past the end: cut off below
    rows = torch.full((n_rows + 1,), t * k, dtype=torch.int64, device=dev).index_put_((dest,), order)[:n_rows]
    gate = torch.zeros(n_rows + 1, dtype=torch.float32, device=dev).index_put_(
        (dest,), gate_vals.reshape(-1)[order])[:n_rows]
    where = torch.empty(t * k, dtype=torch.int64, device=dev).index_put_((order,), dest).reshape(t, k)
    starts = torch.arange(0, n_rows, tile, device=dev)
    tile_expert = torch.searchsorted(pad_end, starts, right=True).to(torch.int32)
    return ExpertRows(rows, tile_expert, gate, where, counts.sum(), (counts > 0).sum())


def moe_share_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert share of one device under expert parallelism: every token
    routed over all ``n_experts`` (``route_share``), only the assignments
    to the held experts computed, none dropped, plus the mean of the shared
    experts (Command A's ``"average"``, the one model on this path), which
    every device computes alike.  What the other devices' experts would
    add is left out: this device's part of the layer's output.

    The held experts' product is ``ops.moe_grouped_ffn`` over each
    expert's own rows (``ExpertRows``: sorted by expert, padded to a tile,
    a tile-to-expert table on the device); each token then sums its
    assignments' gated outputs in fp32 in its choices' order.  Tokens go
    through in chunks of ``MOE_SHARE_CHUNK``.  No load-balance loss (the
    share serves; it does not train): aux is 0."""
    mo = cfg.moe
    b, s, d = x.shape
    dt = x.dtype
    xf = x.reshape(b * s, d)
    outs = []
    for c0 in range(0, b * s, MOE_SHARE_CHUNK):
        xc = xf[c0 : c0 + MOE_SHARE_CHUNK]
        t = xc.shape[0]
        with span("moe.route"):
            r = route_share(p, xc, cfg, moe_tile(t, cfg))
        moe_apply.routed += t * mo.top_k
        moe_apply.held = moe_apply.held + r.held
        moe_apply.experts_read = moe_apply.experts_read + r.active
        with span("moe.experts"):
            y_rows = ops.moe_grouped_ffn(xc, p["w_gate"].to(dt), p["w_up"].to(dt), p["w_down"].to(dt), r.rows,
                                         r.tile_expert, r.gate, mo.top_k)
            y_rows = torch.cat([y_rows, y_rows.new_zeros((1, d))])  # the row of assignments not held
            y = y_rows[r.where].sum(dim=1, dtype=torch.float32).to(dt)
        if mo.n_shared:
            with span("moe.shared"):
                sp = p["shared"]
                hs = F.silu(xc @ sp["w_gate"].to(dt)) * (xc @ sp["w_up"].to(dt))
                y = y + (hs @ sp["w_down"].to(dt)) * (1.0 / mo.n_shared)
        outs.append(y)
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    return y.reshape(b, s, d), torch.zeros((), dtype=torch.float32, device=x.device)


reset_moe_counts()
