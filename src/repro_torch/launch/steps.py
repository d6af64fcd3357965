"""Serving steps of the port — the serving half of ``repro/launch/steps.py``:
greedy prefill/decode steps, and two-level (tiered KV) serving."""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import make_layer_cache
from repro_torch.serving import TieredKVCache

PyTree = Any


def make_prefill_step(model, cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch, caches):
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
    windowed and recurrent layers keep their O(window) and O(1) caches
    (``make_layer_cache``).  ``impl`` is the
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
) -> tuple[torch.Tensor, float, float, dict]:
    """Batched prefill + greedy decode over the model's own caches (dict KV
    pages, windowed ring pages, recurrent states), on the device ``prompts``
    lie on.  Returns (generated, prefill_s, decode_s, caches)."""
    batch, prompt_len = prompts.shape
    device = prompts.device
    caches = model.init_caches(batch, prompt_len + tokens + 1, dtype, device)
    return _greedy(model, cfg, params, prompts, tokens, caches)


def _greedy(model, cfg, params, prompts, tokens, caches):
    """Prefill ``prompts`` into ``caches``, then ``tokens`` greedy decode
    steps; each phase is timed up to a synchronise of the device."""
    prefill = make_prefill_step(model, cfg)
    step = make_serve_step(model, cfg)

    t0 = time.perf_counter()
    tok, caches = prefill(params, {"inputs": prompts}, caches)
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
