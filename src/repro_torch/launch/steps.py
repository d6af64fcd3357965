"""Step builders of the port — ``repro/launch/steps.py`` but its input
specs and sharding (no mesh here): the loss (with the MoE aux and MTP
terms) and train step of the training plane, greedy prefill/decode steps,
and two-level (tiered KV) serving."""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import make_layer_cache
from repro_torch.nn import layers as L
from repro_torch.optim.adamw import AdamW, apply_updates
from repro_torch.serving import TieredKVCache
from repro_torch.tree import tree_map

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
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
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
        tracked = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
        with torch.enable_grad():
            total, metrics = loss_fn(tracked, batch)
            total.backward()
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, tracked)
        return total.detach(), metrics, grads

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

        updates, opt_state, opt_metrics = optimizer.update(grads, state["opt"], params)
        new_params = apply_updates(params, updates)
        new_state = {"params": new_params, "opt": opt_state, "step": state["step"] + 1}
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return new_state, metrics

    return train_step


def init_state(model, cfg: ArchConfig, optimizer: AdamW, seed: int = 0, device="cuda") -> tuple[dict, PyTree]:
    """(state, axes) — params in ``cfg.param_dtype`` drawn from ``seed`` by the
    port's own generator (``nn.module.init_with_axes``, as serving's
    ``init_params``), zero moments, step 0.  Axes only cover the params."""
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
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32), caches

    return prefill_step


def make_serve_step(model, cfg: ArchConfig) -> Callable:
    def serve_step(params, token: torch.Tensor, caches) -> tuple[torch.Tensor, PyTree]:
        logits, caches = model.decode_step(params, token, caches)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None], caches

    return serve_step


def make_tiered_caches(
    model, cfg: ArchConfig, batch: int, max_len: int, window: int, page: int | None,
    dtype=torch.bfloat16, device="cuda", impl: str = "kernel", store=None,
    store_prefix: str = "serving/kv", pages=None,
) -> dict:
    """Caches for the two-level serving backend: every full-attention GQA
    layer gets a ``TieredKVCache`` (device hot ring + paged host cold tier);
    windowed, MLA and recurrent layers keep their O(window) ring pages,
    latent caches and O(1) states (``make_layer_cache``).  ``impl`` is the
    tiered caches' attend path (``"kernel"`` or ``"plain"``).

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
    (hot fraction, staged H2D bytes, write-through flushes, pages and bytes
    persisted into the store)."""
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
        "pages_persisted": sum(c.stats.pages_persisted for c in tiered),
        "bytes_persisted": sum(c.stats.bytes_persisted for c in tiered),
        "hot_device_bytes": sum(c.hot_device_bytes() for c in tiered),
        "host_bytes": sum(c.host_bytes() for c in tiered),
    }
