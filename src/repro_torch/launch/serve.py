"""Serving driver of the port: batched prefill + greedy decode, on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --batch 4 --prompt-len 1024 --tokens 64 --kv-window 256 --kv-page 128

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --batch 4 --prompt-len 4096 --tokens 64

``--kv-window W`` routes every full-attention layer's KV through the
two-level ``TieredKVCache`` (device hot ring of W tokens + paged pinned host
cold tier); ``--kv-page`` sets the cold staging page.  ``--store-root DIR``
adds the durable third level: completed cold pages persist through a
``repro_torch.core.TwoLevelStore`` at DIR (memory tier in front of a
striped file tier), and the run prints the pages and bytes persisted.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --reduced \
        --batch 2 --prompt-len 48 --tokens 24 --kv-window 32 --kv-page 16 \
        --store-root /tmp/kvstore --device cpu

Without ``--kv-window`` the dense
dict-cache loop runs: windowed attention keeps its O(window) ring page and
the recurrent layers (recurrentgemma-9b, xlstm-125m) their O(1) states.
Prefill runs the kernels (flash attention, the RG-LRU scan, the chunkwise
mLSTM) unless ``--attn-impl xla`` asks for their plain versions.  Weights
are random, drawn from ``--seed``; the decoder's matrices are held in the
compute dtype (see ``init_params``).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced, make_model
from repro_torch.launch.steps import dense_serve_loop, tiered_cache_stats, tiered_serve_loop
from repro_torch.nn.layers import cdtype
from repro_torch.nn.module import cast_matrices, init_with_axes
from repro_torch.nn.recurrent import FP32_MATRICES


def init_params(model, seed: int, device):
    """Random weights from ``seed`` on ``device``: fp32 masters, then the
    matrices cast once to the compute dtype.  What the layers read in fp32
    stays fp32: the LM head, the embedding table when the head is tied to it
    (a bf16 table would be copied to fp32 at every step), and the recurrent
    blocks' fp32 matrices (``nn.recurrent.FP32_MATRICES``)."""
    params, _ = init_with_axes(model.init, seed, device=device, dtype=torch.float32)
    keep = ("head", *FP32_MATRICES) + (("embed",) if model.cfg.tie_embeddings else ())
    return cast_matrices(params, cdtype(model.cfg), keep)


def _prompts(cfg, batch: int, prompt_len: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)), dtype=torch.int64, device=device)


def serve_loop(cfg, batch: int, prompt_len: int, tokens: int, seed: int = 0, device="cuda"):
    """Prefill + decode over the model's own caches (dict KV pages, windowed
    ring pages, recurrent states). Returns (generated, prefill_s, decode_s)."""
    model = make_model(cfg)
    params = init_params(model, seed, device)
    prompts = _prompts(cfg, batch, prompt_len, seed, device)
    gen, prefill_s, decode_s, _ = dense_serve_loop(model, cfg, params, prompts, tokens)
    return gen, prefill_s, decode_s


def tiered_serve(cfg, batch: int, prompt_len: int, tokens: int, window: int,
                 page: int | None, seed: int = 0, device="cuda", attn_impl: str = "flash", store=None):
    """Decode loop routed through the two-level KV cache, prefill attention
    by ``attn_impl`` (the flash kernel by default); ``store`` adds the
    durable third level (completed cold pages persist into it).
    Returns (generated, prefill_s, decode_s, stats)."""
    cfg = dataclasses.replace(cfg, scan_layers=False, attn_impl=attn_impl)
    if cfg.attn_logit_softcap > 0:
        raise SystemExit("--kv-window: tiered KV does not support logit-softcap archs")
    model = make_model(cfg)
    params = init_params(model, seed, device)
    prompts = _prompts(cfg, batch, prompt_len, seed, device)
    gen, prefill_s, decode_s, caches = tiered_serve_loop(
        model, cfg, params, prompts, tokens, window=window, page=page, store=store
    )
    return gen, prefill_s, decode_s, tiered_cache_stats(caches)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--kv-window", type=int, default=0,
                    help="route full-attention KV through the tiered cache (hot ring size)")
    ap.add_argument("--kv-page", type=int, default=0,
                    help="cold-tier staging page in tokens (default min(window, 512))")
    ap.add_argument("--attn-impl", choices=("xla", "flash"), default="flash",
                    help="prefill: 'flash' (default) runs the kernels, 'xla' their plain versions")
    ap.add_argument("--store-root", default="",
                    help="with --kv-window: persist cold KV pages through a two-level store at this root")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.kv_window > 0:
        store = None
        if args.store_root:
            from repro_torch.core import TwoLevelStore

            store = TwoLevelStore(args.store_root)
        try:
            gen, prefill_s, decode_s, st = tiered_serve(
                cfg, args.batch, args.prompt_len, args.tokens, window=args.kv_window,
                page=args.kv_page or None, seed=args.seed, device=args.device,
                attn_impl=args.attn_impl, store=store,
            )
        finally:
            if store is not None:
                store.close()
    else:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
        gen, prefill_s, decode_s = serve_loop(
            cfg, args.batch, args.prompt_len, args.tokens, seed=args.seed, device=args.device,
        )
        st = None
    print(f"prefill {args.batch}x{args.prompt_len}: {prefill_s:.3f}s "
          f"({args.batch*args.prompt_len/prefill_s:,.0f} tok/s)")
    print(f"decode {args.tokens} steps: {decode_s:.3f}s "
          f"({args.batch*args.tokens/decode_s:,.0f} tok/s)")
    if st is not None and st["layers"]:
        steps = max(1, args.tokens)
        print(f"tiered KV ({st['layers']} layers, window {st['window']}, page {st['page']}): "
              f"hot fraction f={st['hot_fraction']:.3f}, "
              f"staged {st['bytes_staged']/steps:,.0f} B/step over {steps} steps "
              f"({st['pages_staged']} pages, each uploaded once), "
              f"{st['d2h_flushes']} batched write-through flushes")
        if args.store_root:
            print(f"store {args.store_root}: {st['pages_persisted']} pages persisted "
                  f"({st['bytes_persisted']:,} bytes)")
    print(f"generated (row 0): {gen[0].tolist()[:24]}")


if __name__ == "__main__":
    main()
