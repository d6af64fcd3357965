"""Serving driver of the port: batched prefill + greedy decode, on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --batch 4 --prompt-len 1024 --tokens 64 --kv-window 256 --kv-page 128

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --batch 4 --prompt-len 4096 --tokens 64

Every decoder LM of the registry serves: the MoE archs (grok-1-314b through
dense caches, as its logit softcap keeps it off the tiered cache;
deepseek-v3-671b through its MLA latent caches) print the (token, expert)
assignments their capacity dropped; under ``--kv-window`` gemma3-1b's
global layers go tiered and its local layers decode from sliding rings of
their window.
``--layers N`` serves the first N layers, a depth one card holds:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b --layers 2 \
        --batch 4 --prompt-len 1024 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --batch 4 --prompt-len 2048 --tokens 64 --kv-window 256 --kv-page 128

``--kv-window W`` routes every full-attention layer's KV through the
two-level ``TieredKVCache`` (device hot ring of W tokens + paged pinned host
cold tier); ``--kv-page`` sets the cold staging page.  ``--store-root DIR``
adds the durable third level: completed cold pages persist through a
``repro_torch.core.TwoLevelStore`` at DIR (memory tier in front of a
striped file tier), and the run prints the pages and bytes persisted;
with ``--distributed`` it joins DIR as host ``--host-id`` of a
``DistributedStore`` and the pages ride that shard's store.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --reduced \
        --batch 2 --prompt-len 48 --tokens 24 --kv-window 32 --kv-page 16 \
        --store-root /tmp/kvstore --device cpu

``--sessions N`` switches to the multi-session serving plane: N sessions
under a continuous-batching ``SessionScheduler``, each with its own tiered
KV caches, decoded together through the per-row tiered kernel.
``--max-batch`` bounds the sessions a decode step takes; ``--hbm-budget-kb``
/ ``--host-budget-kb`` bound the sessions' aggregate device / host KV bytes
(over the device budget staging buffers are dropped, over the host budget
idle sessions are evicted into the ``--store-root`` store and resumed
bit-identical); ``--shared-prefix`` gives the sessions a common prompt
prefix, whose cold pages the store then holds once.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --reduced \
        --sessions 8 --max-batch 2 --prompt-len 48 --tokens 16 \
        --kv-window 16 --kv-page 8 --shared-prefix 32 \
        --store-root /tmp/kvstore --host-budget-kb 256 --device cpu

whisper-large-v3 and internvl2-1b's dense loops take inputs the CLI has
none of, as in the reference's CLI (audio frames, image patches): it exits
naming them.  internvl2-1b serves its text under ``--kv-window`` (the
reference's tiered loop prefills no patches); whisper-large-v3 serves
through ``launch.steps.dense_serve_loop(..., extra={"frames": ...})``.

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
from repro_torch.nn.layers import cdtype, moe_counts, reset_moe_counts
from repro_torch.nn.module import init_with_axes, matrix_cast
from repro_torch.nn.recurrent import FP32_MATRICES


def init_params(model, seed: int, device):
    """Random weights from ``seed`` on ``device``: fp32 draws, each matrix
    cast to the compute dtype as soon as it is drawn (``nn.module.matrix_cast``:
    the values of casting the fp32 tree afterwards, at a peak of the cast
    model plus one fp32 leaf).  What the layers read in fp32 stays fp32: the
    LM head, the embedding table when the head is tied to it (a bf16 table
    would be copied to fp32 at every step), and the recurrent blocks' fp32
    matrices (``nn.recurrent.FP32_MATRICES``)."""
    keep = ("head", *FP32_MATRICES) + (("embed",) if model.cfg.tie_embeddings else ())
    params, _ = init_with_axes(model.init, seed, device=device, dtype=torch.float32,
                               cast=matrix_cast(cdtype(model.cfg), keep))
    return params


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


def session_serve(cfg, n_sessions: int, max_batch: int, prompt_len: int, tokens: int, window: int,
                  page: int | None, seed: int = 0, store=None, shared_prefix: int = 0,
                  hbm_bytes: int | None = None, host_bytes: int | None = None, device="cuda",
                  attn_impl: str = "flash") -> dict:
    """Continuous batching over ``n_sessions`` tiered sessions (eager), the
    prompts drawn from ``seed`` as the JAX package draws them; returns the
    scheduler's report."""
    from repro_torch.serving import SessionScheduler

    cfg = dataclasses.replace(cfg, scan_layers=False, attn_impl=attn_impl)
    model = make_model(cfg)
    params = init_params(model, seed, device)
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, min(shared_prefix, prompt_len))
    sched = SessionScheduler(
        model, cfg, params, window=window, page=page, max_batch=max_batch,
        store=store, hbm_bytes=hbm_bytes, host_bytes=host_bytes, device=device,
    )
    for _ in range(n_sessions):
        tail = rng.integers(0, cfg.vocab, prompt_len - len(shared))
        sched.submit(np.concatenate([shared, tail]).astype(np.int32), tokens)
    report = sched.run()
    sched.close()
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the first N layers only (0 = all): a depth that fits one card")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--kv-window", type=int, default=0,
                    help="route full-attention KV through the tiered cache (hot ring size)")
    ap.add_argument("--kv-page", type=int, default=0,
                    help="cold-tier staging page in tokens (default min(window, 512))")
    ap.add_argument("--sessions", type=int, default=0,
                    help="continuous-batching serving plane over N sessions (needs --kv-window)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="with --sessions: per-step decode batch bound")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="with --sessions: common prompt prefix length (page dedup)")
    ap.add_argument("--hbm-budget-kb", type=int, default=0,
                    help="with --sessions: aggregate device KV budget (0 = unbounded)")
    ap.add_argument("--host-budget-kb", type=int, default=0,
                    help="with --sessions: aggregate host KV budget (0 = unbounded; "
                         "overflow evicts idle sessions into --store-root)")
    ap.add_argument("--attn-impl", choices=("xla", "flash"), default="flash",
                    help="prefill: 'flash' (default) runs the kernels, 'xla' their plain versions")
    ap.add_argument("--store-root", default="",
                    help="with --kv-window: persist cold KV pages through a two-level store at this root")
    ap.add_argument("--distributed", action="store_true",
                    help="with --store-root: join it as a DistributedStore host shard")
    ap.add_argument("--host-id", type=int, default=1,
                    help="host id for --distributed (unique per process)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    reset_moe_counts()
    if cfg.encdec is not None:
        raise SystemExit(f"{cfg.name}: the serve CLI has no audio frames for its encoder (as the reference's CLI "
                         f"passes none); call launch.steps.dense_serve_loop with extra={{'frames': ...}}")
    if cfg.vlm is not None and args.kv_window <= 0:
        raise SystemExit(f"{cfg.name}: the dense serve loop needs image patches, which the CLI has none of (as the "
                         f"reference's); --kv-window serves its text alone")
    if args.sessions > 0 and args.kv_window <= 0:
        raise SystemExit("--sessions requires --kv-window")
    if args.kv_window > 0:
        store = dstore = None
        if args.store_root and args.distributed:
            from repro_torch.core import DistributedStore

            dstore = DistributedStore(args.host_id, args.store_root)
            store = dstore.store  # the KV pages ride this shard's write path
        elif args.store_root:
            from repro_torch.core import TwoLevelStore

            store = TwoLevelStore(args.store_root)
        try:
            if args.sessions > 0:
                rep = session_serve(
                    cfg, args.sessions, args.max_batch, args.prompt_len, args.tokens,
                    window=args.kv_window, page=args.kv_page or None, seed=args.seed, store=store,
                    shared_prefix=args.shared_prefix, hbm_bytes=args.hbm_budget_kb * 1024 or None,
                    host_bytes=args.host_budget_kb * 1024 or None, device=args.device,
                    attn_impl=args.attn_impl,
                )
                print(f"sessions {rep['sessions']} (retired {rep['retired']}) over "
                      f"{rep['steps']} steps, max_batch {args.max_batch}")
                print(f"decode {rep['decoded_tokens']} tokens: {rep['decode_s']:.3f}s "
                      f"({rep['decode_tok_per_s']:,.0f} tok/s aggregate), "
                      f"{rep['decode_wait_s']:.3f}s of it waiting for tokens")
                print(f"ttft p50 {rep['ttft_p50_s']*1e3:.1f}ms  p99 {rep['ttft_p99_s']*1e3:.1f}ms, "
                      f"cache allocation {rep['alloc_s']:.3f}s over {rep['prefills']} admissions")
                print(f"tier overflow: {rep['demotions']} demotions, "
                      f"{rep['evictions']} evictions, {rep['resumes']} resumes; "
                      f"host tier: {rep['dma_copies']} direct copies, {rep['host_waits']} host waits")
                if "dedup_ratio" in rep:
                    print(f"shared pages: {rep['pages_logical']} logical / "
                          f"{rep['pages_stored']} stored (dedup {rep['dedup_ratio']:.2f}x)")
                return
            gen, prefill_s, decode_s, st = tiered_serve(
                cfg, args.batch, args.prompt_len, args.tokens, window=args.kv_window,
                page=args.kv_page or None, seed=args.seed, device=args.device,
                attn_impl=args.attn_impl, store=store,
            )
        finally:
            if store is not None:
                (dstore or store).close()
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
    if cfg.moe is not None:
        moe = moe_counts()
        print(f"moe: {moe['dropped']} of {moe['routed']} (token, expert) assignments dropped over capacity")
    print(f"generated (row 0): {gen[0].tolist()[:24]}")


if __name__ == "__main__":
    main()
