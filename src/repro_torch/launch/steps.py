"""The port's steps — ``repro/launch/steps.py``: the loss (with
the MoE aux and MTP terms) and train step of the training plane, greedy
prefill/decode steps, two-level (tiered KV) serving, the cells' abstract
inputs on the ``meta`` device, and sharding resolution for states, batches
and caches.

Everything here is mesh-agnostic until ``*_shardings`` binds a mesh via the
shard-if-divisible rules (``repro_torch.nn.module``).  A sharded state is a
tree of DTensors (``shard_state``): placement rides on the leaves, so the
one ``make_train_step`` runs on one process or on a ``DeviceMesh``;
``on_mesh`` only enters the mesh's ``axis_rules``, and
``make_sharded_train_step`` also keeps the new state on its shardings, as
the reference's ``out_shardings`` do.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.launch.mesh import dp_axis_names
from repro_torch.models.lm import make_layer_cache
from repro_torch.nn import layers as L
from repro_torch.nn.module import NamedSharding, axis_rules, constrain, logical_to_pspec, mesh_shape
from repro_torch.optim.adamw import AdamW, apply_updates
from repro_torch.runtime.trace import span
from repro_torch.serving import SlidingKVRing, TieredKVCache
from repro_torch.tree import map_with_path, tree_map

PyTree = Any

MOE_AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3
Z_LOSS_WEIGHT = 1e-4
IGNORE_INDEX = -100


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored positions + z-loss. logits fp32 (B,S,V)."""
    mask = (labels != IGNORE_INDEX).to(torch.float32)
    safe = torch.where(labels == IGNORE_INDEX, 0, labels).long()
    split = L.vocab_split(logits, -1)
    if split:  # logits split on vocab by a mesh: read where they lie
        logz, gold = L.vocab_parallel_logz_gold(logits, safe, split)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(constrain(logits, "batch", "seq", None), -1, safe[..., None])[..., 0]
    ce = (logz - gold) * mask
    n = torch.clamp(mask.sum(), min=1.0)
    loss = ce.sum() / n
    zloss = Z_LOSS_WEIGHT * ((logz * mask) ** 2).sum() / n
    return loss + zloss, loss


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def make_loss_fn(model, cfg: ArchConfig) -> Callable:
    """The reference's loss: CE + z-loss over the logits (the encoder-decoder's
    given ``batch["frames"]``, a VLM's at its text positions given
    ``batch["patches"]``), plus ``MOE_AUX_WEIGHT`` x the MoE layers'
    load-balance loss and, with the MTP head, ``MTP_WEIGHT`` x its loss at
    predicting t+2 (from every hidden state but the last and the inputs
    shifted by one)."""

    def loss_fn(params: PyTree, batch: dict) -> tuple[torch.Tensor, dict]:
        if cfg.encdec is not None:
            logits, aux = model.train_logits(params, batch["frames"], batch["inputs"])
        elif cfg.vlm is not None:
            logits, aux = model.train_logits(params, batch["inputs"], batch["patches"])
        elif cfg.mtp:
            hidden, aux = model.train_hidden(params, batch["inputs"])
            x = L.norm_apply(params["final_norm"], hidden, cfg)
            logits = L.logits_apply(params["embed"], params.get("head"), x, cfg)
        else:
            logits, aux = model.train_logits(params, batch["inputs"])
        total, ce = cross_entropy(logits, batch["labels"])
        metrics = {"ce": ce.detach()}
        if cfg.moe is not None:
            total = total + MOE_AUX_WEIGHT * aux
            metrics["moe_aux"] = aux.detach()
        if cfg.mtp and cfg.encdec is None and cfg.vlm is None:
            mtp_logits = model.mtp_logits(params, batch["inputs"][:, 1:], hidden[:, :-1])
            mtp_total, mtp_ce = cross_entropy(mtp_logits, batch["labels"][:, 1:])
            total = total + MTP_WEIGHT * mtp_total
            metrics["mtp_ce"] = mtp_ce.detach()
        return total, metrics

    return loss_fn


def make_train_step(model, cfg: ArchConfig, optimizer: AdamW, accum_steps: int = 1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum_steps > 1`` runs the batch as that many microbatches one after
    another, accumulating grads in fp32 — the global batch at a bounded
    activation memory.  The grads are those of the params as the state
    holds them (fp32 masters); the layers cast to the compute dtype inside
    the graph, as the reference's do.
    """
    loss_fn = make_loss_fn(model, cfg)

    def grad_fn(params: PyTree, batch: dict) -> tuple[torch.Tensor, dict, PyTree]:
        with span("train.forward_backward"):
            tracked = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
            with torch.enable_grad():
                total, metrics = loss_fn(tracked, batch)
                total.backward()
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, tracked)
            return total.detach(), metrics, tree_map(_reduced_like, grads, params)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        if accum_steps == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(accum_steps):
                mb_loss, metrics, mb_grads = grad_fn(params, {k: v[i] for k, v in micro.items()})
                grads = tree_map(lambda a, g: a + g.to(torch.float32) / accum_steps, grads, mb_grads)
                loss = loss + mb_loss / accum_steps
                del mb_grads

        with span("train.optimizer"):
            updates, opt_state, opt_metrics = optimizer.update(grads, state["opt"], params)
            new_params = apply_updates(params, updates)
        new_state = {"params": new_params, "opt": opt_state, "step": state["step"] + 1}
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return new_state, metrics

    return train_step


def _reduced_like(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """On a mesh, a gradient that is a partial sum (a param replicated over
    the data-parallel ranks gets one) is reduced here, once, onto its
    param's placements; left partial, DTensor would reduce it again at
    each of AdamW's reads (the norm, both moments, the update)."""
    if isinstance(grad, DTensor) and any(p.is_partial() for p in grad.placements):
        return grad.redistribute(grad.device_mesh, param.placements)
    return grad


def on_mesh(fn: Callable, mesh, rules=None) -> Callable:
    """``fn`` run on DTensor arguments: under the mesh's ``axis_rules`` (the
    activation constraints and the MoE's dispatch groups) and
    ``implicit_replication``, so the plain tensors it makes (RoPE tables,
    masks, zeros, the learning rate) join the DTensors as replicated.  This
    is the only place that enters it."""

    def run(*args):
        with axis_rules(mesh, rules), implicit_replication():
            return fn(*args)

    return run


def make_sharded_train_step(model, cfg: ArchConfig, optimizer: AdamW, shardings: PyTree, rules=None) -> Callable:
    """``make_train_step``'s step on a DTensor state laid out by ``shardings``
    (``state_shardings``) and a DTensor batch (``batch_shardings``), run
    ``on_mesh``.  The new state is redistributed onto ``shardings`` and the
    metrics come back as plain (replicated) tensors."""
    step = make_train_step(model, cfg, optimizer)

    def place(x, sh: NamedSharding):
        want = sh.placements()
        return x.redistribute(sh.mesh, want) if tuple(x.placements) != want else x

    def placed_step(state: dict, batch: dict) -> tuple[dict, dict]:
        new_state, metrics = step(state, batch)
        return tree_map(place, new_state, shardings), metrics

    sharded = on_mesh(placed_step, shardings["step"].mesh, rules)

    def sharded_step(state: dict, batch: dict) -> tuple[dict, dict]:
        new_state, metrics = sharded(state, batch)
        return new_state, {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in metrics.items()}

    return sharded_step


def init_state(model, cfg: ArchConfig, optimizer: AdamW, seed: int = 0, device="cuda") -> tuple[dict, PyTree]:
    """(state, axes) — params in ``cfg.param_dtype`` drawn from ``seed`` by the
    port's own generator (``nn.module.init_with_axes``, as serving's
    ``init_params``), zero moments, step 0.  Axes only cover the params.

    ``device="meta"`` is the reference's ``abstract=True``: every leaf, the
    moments and the scalar counts included, is a meta tensor of its shape
    and dtype, and nothing is allocated."""
    from repro_torch.nn.module import init_with_axes

    params, axes = init_with_axes(model.init, seed, device=device, dtype=getattr(torch, cfg.param_dtype))
    step = torch.zeros((), dtype=torch.int32, device=device)
    return {"params": params, "opt": optimizer.init(params), "step": step}, axes


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def make_prefill_step(model, cfg: ArchConfig) -> Callable:
    """prefill_step(params, batch, caches) -> (greedy token, caches): the
    encoder-decoder reads ``batch["frames"]``, a VLM ``batch["patches"]``
    (without them it prefills its text alone, as the reference's tiered
    loop does)."""

    def prefill_step(params, batch, caches):
        if cfg.encdec is not None:
            logits, caches = model.prefill(params, batch["frames"], batch["inputs"], caches)
        elif cfg.vlm is not None:
            logits, caches = model.prefill(params, batch["inputs"], caches, patches=batch.get("patches"))
        else:
            logits, caches = model.prefill(params, batch["inputs"], caches)
        return _last_token(logits), caches

    return prefill_step


def _last_token(logits: torch.Tensor) -> torch.Tensor:
    """The last position's argmax token.  On a mesh it reads
    vocab-replicated logits: DTensor's argmax over a vocab-sharded dim
    fails at batch 1."""
    return torch.argmax(constrain(logits[:, -1, :], "batch", None), dim=-1).to(torch.int32)


def make_serve_step(model, cfg: ArchConfig) -> Callable:
    def serve_step(params, token: torch.Tensor, caches) -> tuple[torch.Tensor, PyTree]:
        logits, caches = model.decode_step(params, token, caches)
        return _last_token(logits)[:, None], caches

    return serve_step


def make_tiered_caches(
    model, cfg: ArchConfig, batch: int, max_len: int, window: int, page: int | None,
    dtype=torch.bfloat16, device="cuda", impl: str = "kernel", store=None,
    store_prefix: str = "serving/kv", pages=None,
) -> dict:
    """Caches for the two-level serving backend: every full-attention GQA
    layer gets a ``TieredKVCache`` (device hot ring + paged host cold tier),
    every windowed GQA layer a ``SlidingKVRing`` of its window (device
    only: what leaves it is never read again); MLA and recurrent layers
    keep their latent caches and O(1) states (``make_layer_cache``).
    ``impl`` is the tiered caches' and rings' attend path (``"kernel"`` or
    ``"plain"``).

    ``store`` (a :class:`~repro_torch.core.store.TwoLevelStore`) adds the
    third level: completed cold pages persist under
    ``<store_prefix>/prefix_<i>/``, so the KV history survives host-memory
    loss; ``pages`` (a ``SharedPageRegistry``) stores each page once by
    content instead."""
    hd = cfg.resolved_head_dim
    caches: dict[str, Any] = {}
    for i, spec in enumerate(model.prefix):
        if spec.mixer == "gqa" and spec.window == 0:
            caches[f"prefix_{i}"] = TieredKVCache(
                batch, cfg.n_kv_heads, hd, window=window, max_len=max_len,
                dtype=dtype, page=page, device=device, impl=impl,
                store=store, store_prefix=store_prefix, name=f"prefix_{i}", pages=pages,
            )
        elif spec.mixer == "gqa":
            caches[f"prefix_{i}"] = SlidingKVRing(batch, cfg.n_kv_heads, hd, spec.window, dtype, device, impl)
        else:
            caches[f"prefix_{i}"] = make_layer_cache(spec, cfg, batch, max_len, dtype, device)
    return caches


def sync_device(device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so a host clock
    around it measures the work, not its enqueueing."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dense_serve_loop(
    model,
    cfg: ArchConfig,
    params: PyTree,
    prompts: torch.Tensor,  # (B, S) int
    tokens: int,
    dtype=torch.bfloat16,
    extra: dict | None = None,
) -> tuple[torch.Tensor, float, float, dict]:
    """Batched prefill + greedy decode over the model's own caches (dict KV
    pages, windowed ring pages, recurrent states, the encoder-decoder's
    self and cross caches), on the device ``prompts`` lie on.  ``extra``
    holds the prefill batch's other inputs (whisper's ``frames``, a VLM's
    ``patches``, whose positions the caches hold too).  Returns (generated,
    prefill_s, decode_s, caches)."""
    batch, prompt_len = prompts.shape
    n_patches = extra["patches"].shape[1] if extra and "patches" in extra else 0
    caches = model.init_caches(batch, n_patches + prompt_len + tokens + 1, dtype, prompts.device)
    return _greedy(model, cfg, params, prompts, tokens, caches, extra)


def _greedy(model, cfg, params, prompts, tokens, caches, extra: dict | None = None):
    """Prefill ``prompts`` (and the batch's ``extra`` inputs) into
    ``caches``, then ``tokens`` greedy decode steps; each phase is timed up
    to a synchronise of the device."""
    prefill = make_prefill_step(model, cfg)
    step = make_serve_step(model, cfg)

    t0 = time.perf_counter()
    tok, caches = prefill(params, {"inputs": prompts, **(extra or {})}, caches)
    tok = tok[:, None]
    sync_device(prompts.device)
    prefill_s = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for _ in range(tokens):
        tok, caches = step(params, tok, caches)
        out.append(tok)
    sync_device(prompts.device)
    decode_s = time.perf_counter() - t0
    return torch.cat(out, dim=1), prefill_s, decode_s, caches


def tiered_serve_loop(
    model,
    cfg: ArchConfig,
    params: PyTree,
    prompts: torch.Tensor,  # (B, S) int
    tokens: int,
    window: int,
    page: int | None = None,
    dtype=torch.bfloat16,
    impl: str = "kernel",
    store=None,
    store_prefix: str = "serving/kv",
    max_len: int | None = None,
) -> tuple[torch.Tensor, float, float, dict]:
    """Batched prefill + greedy decode routed through the two-level KV
    cache, on the device ``prompts`` lie on; with ``store``, completed cold
    pages persist into it (``make_tiered_caches``).  The caches hold
    ``max_len`` tokens (by default the prompt, the new tokens and one; more
    for a caller that decodes on with the returned caches).  Returns
    (generated, prefill_s, decode_s, caches) — read per-layer
    ``TieredKVStats`` off the caches."""
    batch, prompt_len = prompts.shape
    caches = make_tiered_caches(
        model, cfg, batch, max_len or prompt_len + tokens + 1, window, page, dtype, prompts.device, impl,
        store=store, store_prefix=store_prefix,
    )
    return _greedy(model, cfg, params, prompts, tokens, caches)


def tiered_cache_stats(caches: dict) -> dict:
    """Aggregate ``TieredKVStats`` across the tiered layers of a cache dict
    (hot fraction, staged H2D bytes, write-through flushes, direct copies and
    host waits, pages and bytes persisted into the store)."""
    tiered = [c for c in caches.values() if isinstance(c, TieredKVCache)]
    if not tiered:
        return {"layers": 0}
    return {
        "layers": len(tiered),
        "length": tiered[0].length,
        "window": tiered[0].window,
        "page": tiered[0].page,
        "hot_fraction": sum(c.stats.hot_fraction() for c in tiered) / len(tiered),
        "bytes_staged": sum(c.stats.bytes_staged for c in tiered),
        "pages_staged": sum(c.stats.pages_staged for c in tiered),
        "bytes_written_through": sum(c.stats.bytes_written_through for c in tiered),
        "d2h_flushes": sum(c.stats.d2h_flushes for c in tiered),
        "dma_copies": sum(c.stats.dma_copies for c in tiered),
        "host_waits": sum(c.stats.host_waits for c in tiered),
        "pages_persisted": sum(c.stats.pages_persisted for c in tiered),
        "bytes_persisted": sum(c.stats.bytes_persisted for c in tiered),
        "hot_device_bytes": sum(c.hot_device_bytes() for c in tiered),
        "host_bytes": sum(c.host_bytes() for c in tiered),
    }


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
                       device="meta")


def batch_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """Train/prefill batch of one shape cell, as meta tensors."""
    b, s = cell.global_batch, cell.seq_len
    if cfg.encdec is not None:
        spec = {
            "frames": _meta((b, cfg.encdec.n_frames, cfg.encdec.frame_dim), cfg.dtype),
            "inputs": _meta((b, s), torch.int32),
        }
    elif cfg.vlm is not None:
        spec = {
            "inputs": _meta((b, s - cfg.vlm.n_patches), torch.int32),
            "patches": _meta((b, cfg.vlm.n_patches, cfg.vlm.patch_dim), cfg.dtype),
        }
    else:
        spec = {"inputs": _meta((b, s), torch.int32)}
    if cell.kind == "train":
        spec["labels"] = _meta((b, spec["inputs"].shape[1]), torch.int32)
    return spec


def cache_specs(model, cfg: ArchConfig, cell: ShapeCell) -> PyTree:
    """The KV-cache / recurrent-state tree of a decode or prefill cell on
    ``meta``, laid out per layer as the port's caches are; an
    encoder-decoder's also holds each layer's cross (k, v), which decode
    reads from prefill."""
    b = cell.global_batch
    dtype = getattr(torch, cfg.dtype)
    caches = model.init_caches(b, cell.seq_len, dtype, device="meta")
    if cfg.encdec is not None:
        kv = (b, cfg.encdec.n_frames, cfg.n_kv_heads, cfg.resolved_head_dim)
        caches = {"self": caches["self"],
                  "cross": {f"prefix_{i}": {"k": _meta(kv, dtype), "v": _meta(kv, dtype)}
                            for i in range(cfg.n_layers)}}
    return caches


def token_specs(cfg: ArchConfig, cell: ShapeCell) -> torch.Tensor:
    return _meta((cell.global_batch, 1), torch.int32)


def input_specs(model, cfg: ArchConfig, cell: ShapeCell) -> dict:
    """All abstract inputs for the cell's step function (the dry-run entry).

    train  -> {"batch": ...}
    prefill-> {"batch": ..., "caches": ...}
    decode -> {"token": ..., "caches": ...}
    """
    if cell.kind == "train":
        return {"batch": batch_specs(cfg, cell)}
    if cell.kind == "prefill":
        return {"batch": batch_specs(cfg, cell), "caches": cache_specs(model, cfg, cell)}
    return {"token": token_specs(cfg, cell), "caches": cache_specs(model, cfg, cell)}


# ---------------------------------------------------------------------------
# Sharding resolution
# ---------------------------------------------------------------------------


def _shard_if(dim: int, axes: tuple[str, ...], mesh):
    sizes = mesh_shape(mesh)
    size = math.prod(sizes[a] for a in axes) if axes else 1
    if size > 1 and dim % size == 0:
        return axes if len(axes) > 1 else axes[0]
    return None


def state_shardings(state_shapes: PyTree, axes: PyTree, mesh, rules=None) -> PyTree:
    """``NamedSharding``s for {params, opt, step} from the params axes tree."""
    params_sh = tree_map(lambda spec: NamedSharding(mesh, spec),
                         logical_to_pspec(axes, state_shapes["params"], mesh, rules))
    return {
        "params": params_sh,
        "opt": {"m": params_sh, "v": params_sh, "count": replicated(mesh)},
        "step": replicated(mesh),
    }


def batch_shardings(batch_shapes: PyTree, mesh) -> PyTree:
    """Shard the leading batch dim over (pod, data); replicate the rest."""
    dp = dp_axis_names(mesh)
    return tree_map(lambda leaf: NamedSharding(mesh, (_shard_if(leaf.shape[0], dp, mesh), *([None] * (leaf.ndim - 1)))),
                    batch_shapes)


def cache_shardings(cache_shapes: PyTree, cfg: ArchConfig, mesh, seq_shard: bool = False) -> PyTree:
    """Cache sharding: batch over DP, head-like dims over 'model' when
    divisible. ``seq_shard=True`` shards the cache sequence dim over 'model'
    instead (long-context lever for kv=1 archs).

    The reference's per-name rules on the port's per-layer layout: its
    caches stack layers under ``periods`` / ``self`` / ``cross`` along a
    leading dim, the port's never do, so no leaf here has that offset.
    ``index`` (a step count, a host int here) replicates."""
    dp = dp_axis_names(mesh)

    def one(path, leaf):
        name = path[-1]
        shape = tuple(getattr(leaf, "shape", ()))
        rank = len(shape)
        spec: list = [None] * rank
        if name == "index" or rank == 0:
            return NamedSharding(mesh, tuple(spec))
        spec[0] = _shard_if(shape[0], dp, mesh)
        if name in ("k", "v"):  # (B, S, KV, hd)
            if seq_shard and rank >= 2:
                spec[1] = _shard_if(shape[1], ("model",), mesh)
            elif rank >= 3:
                spec[2] = _shard_if(shape[2], ("model",), mesh)
        elif name in ("c_kv", "k_pe"):
            if seq_shard and rank >= 2:
                spec[1] = _shard_if(shape[1], ("model",), mesh)
        elif name in ("h", "conv"):  # rglru states: (..., W) width last
            spec[rank - 1] = _shard_if(shape[rank - 1], ("model",), mesh)
        elif name in ("C", "n"):  # mlstm: (B, H, dh[, dh])
            if rank >= 2:
                spec[1] = _shard_if(shape[1], ("model",), mesh)
        return NamedSharding(mesh, tuple(spec))

    return map_with_path(one, cache_shapes)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_state(state: PyTree, shardings: PyTree) -> PyTree:
    """Each tensor leaf of ``state`` as a DTensor on its sharding's mesh and
    placements.  Every rank holds the same full leaf (one seed, or one
    checkpoint), so each copies only its own block to its device and
    nothing is sent between ranks (``NamedSharding.shard``); a non-tensor
    leaf (a cache's host ``index``) stays as it is."""
    return tree_map(lambda leaf, sh: sh.shard(leaf) if isinstance(leaf, torch.Tensor) else leaf, state, shardings)
