#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line (``{"phase": ...}``):

1. device        the card's name, and its name and power limit from nvidia-smi
2. build         the four CUDA kernels built by nvcc for sm_90a from
                 src/repro_torch/csrc, one nvcc per source, all started together
3. tiered_decode the decode kernel against its plain version at the serving
                 shape (B=4, H=32, KV=8, D=128, W=256, C=1024), at the edge
                 cases and at a long history (cold 7936 of C=8192), then at the
                 other configs' groups and head dims (H/KV/D 24/2/128, 48/8/128,
                 14/2/64, 4/1/256, 16/1/256, 5/1/128) over both tiers, no key,
                 hot only, cold only and a wrapped ring, each in bf16 and again
                 in fp32; the split count, head tile, error, the whole op's ms
                 (both launches), plain / SDPA ms and the bound; then a sweep
                 of every group 1..16 and head dim 16..256 the kernel takes
                 (20 shapes at B=2, W=16, C=64, each at six edge cases, in
                 bf16 and fp32), error only
4. flash         the flash kernel against its plain version at S=T=1024 causal,
                 T > S, window 64, softcap 30, ragged S=200, rows with no key
                 (T < S, at D=32 and D=128), D=64, recurrentgemma's D=256 MQA
                 window-2048 S=4096 prefill and a ragged D=256 case, each in
                 bf16 and again in fp32; which kernel each took (bf16 at
                 D=64/128/256: the tensor cores), and SDPA as yardstick, with
                 the mask as a tensor and, where the mask is plain causal,
                 with is_causal
5. rglru         the RG-LRU scan kernel against its plain version at the serving
                 shape (B=4, S=4096, W=4096) and at S=1, ragged S=300, W=50,
                 each in fp32 (the model's dtype) and again in bf16
6. mlstm         the chunkwise mLSTM kernel against its plain version, h and
                 carry-out, at B=4, H=4, S=2048, D=384, from a carry-in, and at
                 ragged S=300, each in fp32 and again in bf16
7. serve         qwen3-8b at full width and depth, attn_impl="flash", through
                 ``repro_torch.launch.steps.tiered_serve_loop`` (batch 4, prompt
                 1024, 64 new tokens, kv window 256, page 128), then profiled
8. serve_check   2 qwen3 layers at full width in fp32: greedy tokens through the
                 kernels equal tokens through the plain versions
8b. serve_store  the serve phase's qwen3-8b run again with the store level
                 (``repro_torch.core.TwoLevelStore`` under build/): every
                 completed page of every layer persisted once, the same launch
                 counts, tokens and host tiers as a run without the store; then
                 every layer evicted to the store and resumed bit-identical and
                 8 more greedy tokens, and every layer's tiers after them, equal
                 to those of the run without the round trip; then one layer's
                 host tier lost and restored from the
                 store; persist MB/s, evict / resume / restore s, decode tok/s
9. serve_recurrentgemma  recurrentgemma-9b, 38 layers, bf16, through
                 ``steps.dense_serve_loop`` (batch 4, prompt 4096, 64 new tokens),
                 then profiled
10. serve_xlstm  xlstm-125m, 12 layers, bf16 (batch 4, prompt 2048, 64 new
                 tokens), then profiled
11. serve_check_recurrentgemma / serve_check_xlstm  one period at full width
                 in fp32 (3 and 4 layers): kernel tokens equal plain tokens,
                 and prefill logits agree within 5e-3
12. kernels      one entry per kernel: launches in the serve phases that run
                 it, max error, times, bound

Each serve phase zeroes the kernels' launch counts just before it serves and
reads them just after, and asserts them, and that every bf16 flash launch
took the tensor-core kernel.  Every phase runs, at the configs' full depth.  The nvidia-smi line comes
first; the last line is the contract line ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before it, as does a machine without CUDA or a
directory without the repository's sources.
With ``--out DIR``, the compiler logs (``-Xptxas -v``) and the serve
profile's tables are written there as well.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; fp32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # rtol = atol, as tests/test_kernels.py
MLSTM_TOL = {"bfloat16": 2e-2, "float32": 2e-4}  # tests/test_kernels.py's mLSTM bar
DTYPES = ("bfloat16", "float32")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def within_tol(got, want, dtype: str, tol: dict = TOL) -> tuple[float, bool]:
    """(max abs error, allclose at rtol = atol = tol[dtype]) — the tests' criterion."""
    import torch

    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol[dtype] * (1 + want.float().abs())).all()) and bool(torch.isfinite(got).all())
    return diff.max().item(), ok


def bound(bytes_moved: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- tiered decode


def tiered_decode_phase(record: dict) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import load
    from repro_torch.kernels.tiered_decode import (_DTYPES, blocks_per_sm, head_tile, plan_splits,
                                                   tiered_decode_attention_fwd)

    B, W, qwen = 4, 256, (32, 8, 128)  # qwen3-8b's H, KV, D
    # Serving at prompt 1024 + 64 tokens with page 128 keeps cold_len = 896 and
    # hot_len in [129, 192]; the last step is the "serve" case.  "long_history"
    # is a 8192-token history (cold 7936 in an 8192-row buffer, hot 256), where
    # the split has the most keys to spread.  Each case runs in bf16 (the
    # serving dtype) and again in fp32, where rtol = atol = 2e-5 catches a mask
    # off by one key (a weight near 1/1000 of the output).
    shapes = [  # name, (H, KV, D), hot_len, cold_len, newest, C
        ("serve", qwen, 192, 896, 63, 1024),
        ("hot_len=0", qwen, 0, 896, 63, 1024),
        ("cold_len=0", qwen, 200, 0, 199, 1024),
        ("ring_wrap_full", qwen, 256, 512, 100, 1024),
        ("cold_len_ragged", qwen, 150, 700, 20, 1024),
        ("long_history", qwen, 256, 7936, 255, 8192),
    ]
    # The groups and head dims of the other configs' GQA layers, and an odd
    # group (a padded head tile): starcoder2_3b, grok_1_314b, internvl2_1b,
    # gemma3_1b's global layers, recurrentgemma_9b's local attention.
    for arch, hkd in (("starcoder2", (24, 2, 128)), ("grok1", (48, 8, 128)), ("internvl2", (14, 2, 64)),
                      ("gemma3", (4, 1, 256)), ("h16_kv1_d256", (16, 1, 256)), ("h5_kv1", (5, 1, 128))):
        shapes += [(f"{arch}_both_tiers", hkd, 192, 896, 63, 1024), (f"{arch}_no_key", hkd, 0, 0, 0, 1024),
                   (f"{arch}_hot_only", hkd, 200, 0, 199, 1024), (f"{arch}_cold_only", hkd, 0, 896, 63, 1024),
                   (f"{arch}_ring_wrap", hkd, 256, 512, 100, 1024)]
    cases = [(name if dt == "bfloat16" else name + "_fp32", dt, *rest) for dt in DTYPES for name, *rest in shapes]
    lib = load("tiered_decode")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    copies = 4  # rotate inputs so the K/V of one launch is not L2-resident for the next
    for name, dt_name, (H, KV, D), hot_len, cold_len, newest, C in cases:
        dt = getattr(torch, dt_name)
        sets = []
        for _ in range(copies):
            sets.append([torch.randn(s, generator=gen, device="cuda").to(dt) for s in
                         ((B, H, 1, D), (B, KV, W, D), (B, KV, W, D), (B, KV, C, D), (B, KV, C, D))])
        args = (hot_len, cold_len, newest)
        got = tiered_decode_attention_fwd(*sets[0], *args)
        want = ref.tiered_ring_attention_ref(*sets[0], *args)
        torch.cuda.synchronize()
        err, ok = within_tol(got, want, dt_name)

        # The whole op, both launches (one C call), on pre-made outputs and scratch.
        gt, tiles = head_tile(H // KV)
        n_split = plan_splits(hot_len + cold_len, B * KV * tiles, sms, blocks_per_sm(H // KV))
        outs = [torch.empty_like(s[0]) for s in sets]
        scratch = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        raw = [(s[0].data_ptr(), s[1].data_ptr(), s[2].data_ptr(), s[3].data_ptr(), s[4].data_ptr(),
                o.data_ptr(), scratch.data_ptr(), B, H, KV, W, C, D, hot_len, cold_len, newest, n_split,
                gt, _DTYPES[dt], stream)
               for s, o in zip(sets, outs)]
        it = iter(range(1 << 30))
        ms = time_ms(lambda: lib.tiered_decode_launch(*raw[next(it) % copies]), iters=40)
        plain_ms = time_ms(lambda: ref.tiered_ring_attention_ref(*sets[next(it) % copies], *args))

        # Yardstick only: one SDPA call over the concatenated keys with the tiers' mask.
        age = torch.remainder(newest - torch.arange(W, device="cuda"), W)
        valid = torch.cat([torch.arange(C, device="cuda") < cold_len, age < hot_len])
        lib_in = [(s[0], torch.cat([s[3], s[1]], 2), torch.cat([s[4], s[2]], 2)) for s in sets]
        mask = valid[None, None, None, :]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            *lib_in[next(it) % copies], attn_mask=mask, enable_gqa=True)) if (hot_len + cold_len) else None

        # Each K/V row is counted once.  With tiles > 1 the kernel reads it
        # once per head tile, but the tiles of a (row, split) are neighbours
        # in the grid and resident in the same wave, so the re-reads come
        # from L2 (kv_reads says how many there are).
        isz = torch.finfo(dt).bits // 8
        n_keys = hot_len + cold_len
        moved = 2 * B * KV * n_keys * D * isz + 2 * B * H * D * isz
        flops = 4 * B * H * n_keys * D
        bound_ms, bound_by = bound(moved, flops, dt_name)
        row = dict(case=name, dtype=dt_name, H=H, KV=KV, D=D, G=H // KV, head_tile=gt, kv_reads=tiles,
                   hot_len=hot_len, cold_len=cold_len, newest=newest, C=C,
                   n_split=n_split, blocks=B * KV * tiles * n_split, max_abs_err=err, tol=TOL[dt_name], ok=ok,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit("tiered_decode", **row)
        if not ok:
            raise AssertionError(f"tiered_decode {name}: not within rtol=atol={TOL[dt_name]} (max abs err {err})")
        if row["blocks"] > sms * blocks_per_sm(H // KV):
            raise AssertionError(f"tiered_decode {name}: {row['blocks']} pass-1 blocks are more than one wave")
        record.setdefault("tiered_decode", []).append(row)
        del sets, lib_in, outs, scratch
    tiered_sweep(record, sms)


# Every group 1..16 and head dim 16..256 the kernel is built for, as
# tests/test_torch_cuda.py's sweep: (H, KV, D) ...
TIERED_SWEEP_SHAPES = [(1, 1, 16), (2, 1, 32), (3, 1, 64), (8, 2, 128), (5, 1, 128), (12, 2, 64), (14, 2, 64),
                       (7, 1, 256), (8, 1, 32), (9, 1, 128), (20, 2, 16), (11, 1, 64), (24, 2, 128), (48, 8, 128),
                       (13, 1, 32), (28, 2, 256), (15, 1, 64), (16, 1, 256), (4, 1, 256), (6, 1, 256)]
# ... each at (hot_len, cold_len, newest, n_split or None for the planner's)
# over hot 16 slots and cold capacity 64: both tiers and a wrapped ring, no
# key, hot only, cold only, and forced splits, some with no key.
TIERED_SWEEP_CASES = [(16, 40, 15, None), (0, 0, 0, None), (12, 0, 11, None), (0, 40, 7, None), (16, 64, 5, 3),
                      (3, 2, 1, 8)]


def tiered_sweep(record: dict, sms: int) -> None:
    """The tiered kernel at every (G, D) it takes against its plain version,
    one row per shape and dtype with the largest error over its cases; the
    planner's launches must be one wave."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.tiered_decode import (GROUPS, HEAD_DIMS, blocks_per_sm, head_tile, plan_splits,
                                                   tiered_decode_attention_fwd)

    B, W, C = 2, 16, 64
    if {(h // kv) for h, kv, _ in TIERED_SWEEP_SHAPES} != set(GROUPS) or \
            {d for *_, d in TIERED_SWEEP_SHAPES} != set(HEAD_DIMS):
        raise AssertionError("tiered sweep: the shapes do not cover the kernel's groups and head dims")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dt_name in DTYPES:
        dt = getattr(torch, dt_name)
        for H, KV, D in TIERED_SWEEP_SHAPES:
            rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
            q, hk, hv, ck, cv = rnd(B, H, 1, D), rnd(B, KV, W, D), rnd(B, KV, W, D), rnd(B, KV, C, D), rnd(B, KV, C, D)
            gt, tiles = head_tile(H // KV)
            worst, splits = 0.0, []
            for hot_len, cold_len, newest, n_split in TIERED_SWEEP_CASES:
                got = tiered_decode_attention_fwd(q, hk, hv, ck, cv, hot_len, cold_len, newest, n_split=n_split)
                want = ref.tiered_ring_attention_ref(q, hk, hv, ck, cv, hot_len, cold_len, newest)
                err, ok = within_tol(got, want, dt_name)
                if not ok:
                    raise AssertionError(f"tiered sweep H={H} KV={KV} D={D} {dt_name} "
                                         f"lens={(hot_len, cold_len, newest, n_split)}: max abs err {err}")
                worst = max(worst, err)
                planned = n_split is None
                if planned:
                    n_split = plan_splits(hot_len + cold_len, B * KV * tiles, sms, blocks_per_sm(H // KV))
                    if B * KV * tiles * n_split > sms * blocks_per_sm(H // KV):
                        raise AssertionError(f"tiered sweep H={H} KV={KV} D={D}: more than one wave")
                splits.append(n_split)
            row = dict(dtype=dt_name, H=H, KV=KV, D=D, G=H // KV, head_tile=gt, kv_reads=tiles,
                       cases=len(TIERED_SWEEP_CASES), n_splits=splits, max_abs_err=worst, tol=TOL[dt_name])
            emit("tiered_decode_sweep", **row)
            record.setdefault("tiered_decode_sweep", []).append(row)
    torch.cuda.synchronize()


# ------------------------------------------------------------------------ flash


def flash_phase(record: dict) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_path

    qwen = (4, 32, 8, 128)  # B, H, KV, D of qwen3-8b's prefill
    shapes = [  # name, (B, H, KV, D), S, T, window, softcap; each in bf16, then in fp32
        ("prefill_causal", qwen, 1024, 1024, 0, 0.0),
        ("t_gt_s", qwen, 512, 1024, 0, 0.0),
        ("window_64", qwen, 1024, 1024, 64, 0.0),
        ("softcap_30", qwen, 1024, 1024, 0, 30.0),
        ("ragged_200", qwen, 200, 200, 0, 0.0),
        ("rows_without_key", (1, 2, 2, 32), 40, 24, 0, 0.0),  # rows 0-15 see no key: mean of v
        ("rows_without_key_d128", (1, 4, 1, 128), 300, 100, 0, 0.0),  # rows 0-199, on the tensor cores in bf16
        ("d64_causal", (4, 16, 4, 64), 1000, 1000, 0, 0.0),
        ("recurrentgemma_d256", (4, 16, 1, 256), 4096, 4096, 2048, 0.0),  # its local-attention prefill
        ("ragged_d256", (2, 16, 1, 256), 1500, 1500, 700, 0.0),
    ]
    cases = [(name if dt == "bfloat16" else name + "_fp32", dt, *rest) for dt in DTYPES for name, *rest in shapes]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, dt_name, (B, H, KV, D), S, T, window, cap in cases:
        dt = getattr(torch, dt_name)
        q = torch.randn((B, H, S, D), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, KV, T, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, KV, T, D), generator=gen, device="cuda").to(dt)
        kw = dict(causal=True, window=window, logit_softcap=cap)
        got = flash_attention_fwd(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = within_tol(got, want, dt_name)
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters=10)
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, **kw), iters=5)

        # Yardsticks only: SDPA with the mask as a tensor, and, where the mask is
        # exactly causal over S == T, SDPA's is_causal call (which can reach its
        # flash backend; the masked call cannot); library_ms is the faster.
        qpos = torch.arange(S, device="cuda")[:, None] + (T - S)
        kpos = torch.arange(T, device="cuda")[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        library_masked_ms = None if cap else time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True), iters=5)
        library_causal_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True), iters=5) \
            if S == T and not window and not cap else None
        library_ms = min((t for t in (library_masked_ms, library_causal_ms) if t is not None), default=None)

        isz = torch.finfo(dt).bits // 8
        pairs = int(mask.sum().item())
        moved = (2 * B * H * S * D + 2 * B * KV * T * D) * isz
        flops = 4 * B * H * pairs * D
        bound_ms, bound_by = bound(moved, flops, dt_name)
        row = dict(case=name, dtype=dt_name, path=flash_path(dt, D), B=B, H=H, KV=KV, D=D, S=S, T=T,
                   window=window, softcap=cap, max_abs_err=err, tol=TOL[dt_name], ok=ok, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_masked_ms=library_masked_ms,
                   library_causal_ms=library_causal_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        emit("flash", **row)
        if not ok:
            raise AssertionError(f"flash {name}: not within rtol=atol={TOL[dt_name]} (max abs err {err})")
        record.setdefault("flash", []).append(row)
        del q, k, v, got, want, mask


# ------------------------------------------------------------------- rglru


def rglru_phase(record: dict) -> None:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru import rglru_scan_fwd

    shapes = [  # name, B, S, W; each in fp32 (the model's dtype), then in bf16
        ("serve", 4, 4096, 4096),  # recurrentgemma-9b's prefill: B 4, prompt 4096, lru_width 4096
        ("s=1", 4, 1, 4096),
        ("ragged_s300", 4, 300, 4096),
        ("w=50", 4, 1000, 50),
    ]
    cases = [(name if dt == "float32" else name + "_bf16", dt, *rest)
             for dt in ("float32", "bfloat16") for name, *rest in shapes]
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, dt_name, B, S, W in cases:
        dt = getattr(torch, dt_name)
        a = (0.5 + 0.5 * torch.rand((B, S, W), generator=gen, device="cuda")).to(dt)
        x = torch.randn((B, S, W), generator=gen, device="cuda").to(dt)
        got = rglru_scan_fwd(a, x)
        want = ref.rglru_ref(a, x)
        torch.cuda.synchronize()
        err, ok = within_tol(got, want, dt_name)
        ms = time_ms(lambda: rglru_scan_fwd(a, x), iters=20)
        plain_ms = time_ms(lambda: ref.rglru_ref(a, x), iters=3, warmup=1)
        isz = torch.finfo(dt).bits // 8
        bound_ms, bound_by = bound(3 * B * S * W * isz, 2 * B * S * W, dt_name)
        row = dict(case=name, dtype=dt_name, B=B, S=S, W=W, max_abs_err=err, tol=TOL[dt_name], ok=ok,
                   ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        emit("rglru", **row)
        if not ok:
            raise AssertionError(f"rglru {name}: not within rtol=atol={TOL[dt_name]} (max abs err {err})")
        record.setdefault("rglru", []).append(row)
        del a, x, got, want


# ------------------------------------------------------------------- mlstm


def mlstm_flops(B: int, H: int, S: int, D: int, chunk: int) -> int:
    """Operations of the chunkwise algorithm at ``chunk``: per (b, h) and
    chunk of L steps, C_prev q and the carry update (4 L D^2), the causal
    scores and their weighted sum (2 L (L + 1) D) and the normaliser (4 L D)."""
    total = 0
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        total += 4 * L * D * D + 2 * L * (L + 1) * D + 4 * L * D
    return B * H * total


def mlstm_phase(record: dict) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.mlstm import CHUNK, mlstm_chunkwise_fwd

    B, H, D = 4, 4, 384  # xlstm-125m: 4 heads of 1536 / 4
    shapes = [  # name, S, carry-in; each in fp32 (the model's dtype), then in bf16
        ("serve", 2048, False),  # xlstm-125m's prefill: B 4, prompt 2048, from the empty history
        ("carry_in", 512, True),  # continues from the serve case's carry-out
        ("ragged_s300", 300, False),
    ]
    cases = [(name if dt == "float32" else name + "_bf16", dt, *rest)
             for dt in ("float32", "bfloat16") for name, *rest in shapes]
    gen = torch.Generator(device="cuda").manual_seed(3)
    carry = None
    for name, dt_name, S, with_carry in cases:
        dt = getattr(torch, dt_name)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        q, k, v = rnd(B, H, S, D).to(dt), (rnd(B, H, S, D) / D**0.5).to(dt), rnd(B, H, S, D).to(dt)
        ip, fl = (0.5 * rnd(B, H, S)).to(dt), F.logsigmoid(rnd(B, H, S) + 2.0).to(dt)
        state = carry if with_carry else None
        got, got_carry = mlstm_chunkwise_fwd(q, k, v, ip, fl, state)
        want, want_carry = ref.mlstm_ref(q, k, v, ip, fl, state)
        torch.cuda.synchronize()
        checks = [within_tol(g, w, dt_name, MLSTM_TOL) for g, w in zip((got, *got_carry), (want, *want_carry))]
        err, ok = max(e for e, _ in checks), all(o for _, o in checks)
        if name == "serve":
            carry = want_carry
        ms = time_ms(lambda: mlstm_chunkwise_fwd(q, k, v, ip, fl, state), iters=10)
        plain_ms = time_ms(lambda: ref.mlstm_ref(q, k, v, ip, fl, state), iters=2, warmup=1)
        isz = torch.finfo(dt).bits // 8
        carry_bytes = B * H * (D * D + D + 1) * 4
        moved = (4 * B * H * S * D + 2 * B * H * S) * isz + carry_bytes * (2 if with_carry else 1)
        bound_ms, bound_by = bound(moved, mlstm_flops(B, H, S, D, CHUNK), dt_name)
        row = dict(case=name, dtype=dt_name, B=B, H=H, S=S, D=D, chunk=CHUNK, carry_in=with_carry,
                   max_abs_err=err, tol=MLSTM_TOL[dt_name], ok=ok, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        emit("mlstm", **row)
        if not ok:
            raise AssertionError(f"mlstm {name}: h or carry-out not within rtol=atol={MLSTM_TOL[dt_name]} "
                                 f"(max abs err {err})")
        record.setdefault("mlstm", []).append(row)
        del q, k, v, got, want, got_carry, want_carry


# ------------------------------------------------------------------------ serve


def serve_phase(record: dict, out_dir: Path | None) -> None:
    import torch

    from repro_torch.configs import get_config, make_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import make_tiered_caches, tiered_cache_stats, tiered_serve_loop

    B, prompt_len, tokens, window, page = 4, 1024, 64, 256, 128
    cfg = dataclasses.replace(get_config("qwen3_8b"), attn_impl="flash", scan_layers=False)
    layers = cfg.n_layers
    model = make_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (B, prompt_len), generator=gen, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, prefill_s, decode_s, caches = tiered_serve_loop(
        model, cfg, params, prompts, tokens, window=window, page=page)
    launches, paths = ops.launches(), ops.flash_path_launches()
    st = tiered_cache_stats(caches)
    row = dict(arch=cfg.name, layers=layers, batch=B, prompt_len=prompt_len,
               tokens=tokens, kv_window=window, kv_page=page, init_s=init_s, prefill_s=prefill_s,
               prefill_tok_per_s=B * prompt_len / prefill_s, decode_s=decode_s,
               decode_tok_per_s=B * tokens / decode_s, hot_fraction=st["hot_fraction"],
               pages_staged=st["pages_staged"], h2d_bytes_per_step=st["bytes_staged"] / tokens,
               d2h_flushes=st["d2h_flushes"], launches=launches, flash_paths=paths,
               peak_device_bytes=torch.cuda.max_memory_allocated())
    emit("serve", **row)
    want = {"tiered_decode": layers * tokens, "flash_attention": layers, "rglru": 0, "mlstm": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if paths != {"tensor_core": layers, "cuda_core": 0}:
        raise AssertionError(f"bf16 flash launches off the tensor-core path: {paths}")
    if not st["hot_fraction"] < 1.0 or st["pages_staged"] <= 0:
        raise AssertionError(f"cold tier not exercised: {st}")
    if tuple(out.shape) != (B, tokens + 1) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"bad generated tokens: shape {tuple(out.shape)}")
    record["serve"] = row
    del caches
    caches = make_tiered_caches(model, cfg, B, prompt_len + 9, window, page, torch.bfloat16, "cuda")
    profile_serve(model, cfg, params, prompts, caches, out_dir, "serve")
    del params, caches
    torch.cuda.empty_cache()


def profile_serve(model, cfg, params, prompts, caches, out_dir: Path | None, phase: str) -> None:
    """Where the time goes: a short profiled rerun (prefill, then 8 decode
    steps) into fresh ``caches``, outside the timed and counted run."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    step = make_serve_step(model, cfg)
    state = {}

    def prefill():
        tok, state["caches"] = make_prefill_step(model, cfg)(params, {"inputs": prompts}, caches)
        state["tok"] = tok[:, None]

    def decode():
        for _ in range(8):
            state["tok"], state["caches"] = step(params, state["tok"], state["caches"])

    for name, fn in (("prefill", prefill), ("decode_8_steps", decode)):
        table = out_dir / f"profile_{phase}_{name}.txt" if out_dir else None
        emit(f"{phase}_profile", part=name, **profile_breakdown(fn, table))


def profile_breakdown(fn, table: Path | None, top: int = 6) -> dict:
    """Wall time of ``fn`` (ending in a synchronise) under torch.profiler, the
    device time its kernels took, their share of the wall time, and the
    kernels with the most device time.  The profiler's table by host time
    goes to ``table`` when one is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    if table is not None:
        table.write_text(averages.table(sort_by="self_cpu_time_total", row_limit=40))
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total / 1e3  # us -> ms
    device_ms = sum(dev(e) for e in kernels)
    kernels.sort(key=dev, reverse=True)
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
                top_kernels=[dict(name=e.key[:60], ms=dev(e), calls=e.count) for e in kernels[:top]])


def serve_check_phase(record: dict) -> None:
    import torch

    from repro_torch.configs import get_config, make_model
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import tiered_serve_loop

    B, prompt_len, tokens, window, page = 4, 300, 16, 128, 64
    base = dataclasses.replace(get_config("qwen3_8b"), n_layers=2, dtype="float32", scan_layers=False)
    kern_cfg = dataclasses.replace(base, attn_impl="flash")
    plain_cfg = dataclasses.replace(base, attn_impl="xla")  # masked-softmax prefill, no kernel
    model = make_model(kern_cfg)
    params = init_params(model, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, base.vocab, (B, prompt_len), generator=gen, device="cuda")
    kern, *_ = tiered_serve_loop(model, kern_cfg, params, prompts, tokens, window, page, torch.float32, "kernel")
    plain, *_ = tiered_serve_loop(make_model(plain_cfg), plain_cfg, params, prompts, tokens, window, page,
                                  torch.float32, "plain")
    same = bool(torch.equal(kern, plain))
    emit("serve_check", layers=2, dtype="float32", batch=B, prompt_len=prompt_len, tokens=tokens,
         kv_window=window, kv_page=page, tokens_equal=same, kernel_row0=kern[0].tolist())
    if not same:
        raise AssertionError("kernel tokens differ from plain tokens")
    record["serve_check"] = same


def serve_store_phase(record: dict) -> None:
    """The serve phase's qwen3-8b run with the store level under its KV cache
    (a ``TwoLevelStore`` under build/), beside the same run without it."""
    import tempfile

    import torch

    from repro_torch.configs import get_config, make_model
    from repro_torch.core import TwoLevelStore
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import make_serve_step, tiered_cache_stats, tiered_serve_loop

    B, prompt_len, tokens, window, page, more = 4, 1024, 64, 256, 128, 8
    cfg = dataclasses.replace(get_config("qwen3_8b"), attn_impl="flash", scan_layers=False)
    layers = cfg.n_layers
    model = make_model(cfg)
    params = init_params(model, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (B, prompt_len), generator=gen, device="cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="serve_store_", dir=ROOT / "build")
    store = TwoLevelStore(root)
    try:
        ops.reset_launches()
        room = prompt_len + tokens + more + 1  # the 8 tokens decoded after the round trip
        out, prefill_s, decode_s, caches = tiered_serve_loop(
            model, cfg, params, prompts, tokens, window=window, page=page, store=store, max_len=room)
        launches, paths = ops.launches(), ops.flash_path_launches()
        t0 = time.perf_counter()
        store.drain()  # the write-back of the persisted pages reaches the file tier
        drain_s = time.perf_counter() - t0
        want = {"tiered_decode": layers * tokens, "flash_attention": layers, "rglru": 0, "mlstm": 0}
        if launches != want or paths != {"tensor_core": layers, "cuda_core": 0}:
            raise AssertionError(f"serve_store: launch counts {launches} {paths} != {want}")
        ref_out, _, ref_decode_s, ref_caches = tiered_serve_loop(
            model, cfg, params, prompts, tokens, window=window, page=page, max_len=room)  # the same run, no store

        tiered = [caches[f"prefix_{i}"] for i in range(layers)]
        refs = [ref_caches[f"prefix_{i}"] for i in range(layers)]
        for c in tiered + refs:
            c.flush_host()  # the pending tail to the host tier; pages already persisted go once
        st = tiered_cache_stats(caches)
        length = tiered[0].length
        page_bytes = 2 * B * cfg.n_kv_heads * page * cfg.resolved_head_dim * 2
        pages_want = layers * (length // page)
        missing = [(i, p) for i in range(layers) for p in range(length // page)
                   if not store.exists(f"serving/kv/prefix_{i}/page_{p:06d}")]
        if st["pages_persisted"] != pages_want or st["bytes_persisted"] != pages_want * page_bytes or missing:
            raise AssertionError(f"serve_store: persisted {st['pages_persisted']} pages / {st['bytes_persisted']} "
                                 f"bytes, want {pages_want} / {pages_want * page_bytes}; missing {missing[:4]}")
        differ = [i for i, (c, r) in enumerate(zip(tiered, refs)) if not (
            torch.equal(c.cold_k[:, :, :length], r.cold_k[:, :, :length]) and
            torch.equal(c.cold_v[:, :, :length], r.cold_v[:, :, :length]))]
        if not torch.equal(out, ref_out) or differ:
            raise AssertionError(f"serve_store: tokens equal {torch.equal(out, ref_out)}, host tiers of layers "
                                 f"{differ} differ from the run without the store")

        # Evict every layer to the store, then resume: bit-identical tiers, and
        # 8 more greedy tokens equal to those of the run without the round trip.
        t0 = time.perf_counter()
        for c in tiered:
            c.evict_to_store()
        evict_s = time.perf_counter() - t0
        parked = sum(c.device_bytes() + c.host_bytes() for c in tiered)
        t0 = time.perf_counter()
        for c in tiered:
            c.resume_from_store()
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resumed = all(c.length == length and torch.equal(c.cold_k[:, :, :length], r.cold_k[:, :, :length]) and
                      torch.equal(c.cold_v[:, :, :length], r.cold_v[:, :, :length]) and
                      torch.equal(c.hot_k, r.hot_k) and torch.equal(c.hot_v, r.hot_v) and c.cold_k.is_pinned()
                      for c, r in zip(tiered, refs))
        if parked != 0 or not resumed:
            raise AssertionError(f"serve_store: {parked} bytes held while parked, or resume not bit-identical")
        step = make_serve_step(model, cfg)
        tok, ref_tok = out[:, -1:], ref_out[:, -1:]
        extra, ref_extra = [], []
        for _ in range(more):
            tok, caches = step(params, tok, caches)
            ref_tok, ref_caches = step(params, ref_tok, ref_caches)
            extra.append(tok)
            ref_extra.append(ref_tok)
        extra, ref_extra = torch.cat(extra, 1), torch.cat(ref_extra, 1)
        if not torch.equal(extra, ref_extra):
            raise AssertionError(f"serve_store: tokens after resume {extra.tolist()} != {ref_extra.tolist()}")
        # With random weights every greedy token is the same, so the tiers are
        # the check: layer i + 1's K/V of those 8 steps come from layer i's
        # attention over the resumed ring and the re-staged host tier.
        after = [caches[f"prefix_{i}"] for i in range(layers)]
        refs = [ref_caches[f"prefix_{i}"] for i in range(layers)]
        for c in after + refs:
            c.flush_host()
        grown = after[0].length
        differ = [i for i, (c, r) in enumerate(zip(after, refs)) if not (
            c.length == r.length == grown and
            torch.equal(c.cold_k[:, :, :grown], r.cold_k[:, :, :grown]) and
            torch.equal(c.cold_v[:, :, :grown], r.cold_v[:, :, :grown]) and
            torch.equal(c.hot_k, r.hot_k) and torch.equal(c.hot_v, r.hot_v))]
        if grown != length + more or differ:
            raise AssertionError(f"serve_store: after resume and {more} steps ({grown} tokens), the tiers of "
                                 f"layers {differ} differ from the run without the round trip")
        tiered = after

        # Host-memory loss of one layer: restore its durable prefix from the store.
        c = tiered[0]
        c.flush_host()
        durable = c.length // page * page  # the completed pages, all persisted
        before_k, before_v = c.cold_k[:, :, :durable].clone(), c.cold_v[:, :, :durable].clone()
        c.cold_k.zero_()
        c.cold_v.zero_()
        t0 = time.perf_counter()
        restored = c.restore_cold_from_store()
        restore_s = time.perf_counter() - t0
        if restored != durable or not (torch.equal(c.cold_k[:, :, :durable], before_k) and
                                       torch.equal(c.cold_v[:, :, :durable], before_v)):
            raise AssertionError(f"serve_store: restored {restored} tokens of {durable}, or not bit-identical")
        row = dict(arch=cfg.name, layers=layers, batch=B, prompt_len=prompt_len, tokens=tokens,
                   kv_window=window, kv_page=page, store_root="build/" + Path(root).name,
                   prefill_s=prefill_s, decode_s=decode_s, decode_tok_per_s=B * tokens / decode_s,
                   decode_tok_per_s_without_store=B * tokens / ref_decode_s,
                   decode_tok_per_s_serve_phase=record["serve"]["decode_tok_per_s"],
                   pages_persisted=st["pages_persisted"], bytes_persisted=st["bytes_persisted"], drain_s=drain_s,
                   persist_mb_per_s=st["bytes_persisted"] / 1e6 / (prefill_s + decode_s + drain_s),
                   launches=launches, flash_paths=paths, tokens_equal_without_store=True,
                   evict_s=evict_s, resume_s=resume_s, resume_mb_per_s=st["bytes_persisted"] / 1e6 / resume_s,
                   bytes_parked=parked, tokens_after_resume_equal=True, tokens_after_resume=extra[0].tolist(),
                   tiers_after_resume_steps_equal=True,
                   restore_layer_s=restore_s, restored_tokens=restored, restore_bit_identical=True)
        emit("serve_store", **row)
        record["serve_store"] = row
        for c in tiered:
            c.close()
        del caches, ref_caches, tiered, refs, params
    finally:
        store.close()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# ------------------------------------------------------------ recurrent serve


def recurrent_serve_phase(record: dict, out_dir: Path | None, arch: str, B: int, prompt_len: int,
                          tokens: int) -> None:
    """One recurrent arch at full width and depth, bf16, attn_impl="flash",
    through ``steps.dense_serve_loop`` (recurrent states and windowed ring
    pages); each layer's prefill launches its mixer's kernel once."""
    import torch

    from repro_torch.configs import get_config, make_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import dense_serve_loop

    phase = f"serve_{arch.split('_')[0]}"
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    model = make_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (B, prompt_len), generator=gen, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, prefill_s, decode_s, caches = dense_serve_loop(model, cfg, params, prompts, tokens)
    launches, paths = ops.launches(), ops.flash_path_launches()
    kinds = [spec.mixer for spec in model.prefix]
    row = dict(arch=cfg.name, layers=cfg.n_layers, mixers={k: kinds.count(k) for k in sorted(set(kinds))},
               batch=B, prompt_len=prompt_len, tokens=tokens, init_s=init_s, prefill_s=prefill_s,
               prefill_tok_per_s=B * prompt_len / prefill_s, decode_s=decode_s,
               decode_tok_per_s=B * tokens / decode_s, launches=launches, flash_paths=paths,
               cache_device_bytes=sum(t.numel() * t.element_size() for c in caches.values()
                                      for t in c.values() if torch.is_tensor(t)),
               peak_device_bytes=torch.cuda.max_memory_allocated())
    emit(phase, **row)
    want = {"tiered_decode": 0, "flash_attention": kinds.count("gqa"), "rglru": kinds.count("rglru"),
            "mlstm": kinds.count("mlstm")}
    if launches != want:
        raise AssertionError(f"{phase}: launch counts {launches} != {want}")
    if paths != {"tensor_core": want["flash_attention"], "cuda_core": 0}:
        raise AssertionError(f"{phase}: bf16 flash launches off the tensor-core path: {paths}")
    if tuple(out.shape) != (B, tokens + 1) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"{phase}: bad generated tokens: shape {tuple(out.shape)}")
    record[phase] = row
    del caches
    profile_serve(model, cfg, params, prompts, model.init_caches(B, prompt_len + 9, torch.bfloat16, "cuda"),
                  out_dir, phase)
    del params
    torch.cuda.empty_cache()


def recurrent_serve_check_phase(record: dict, arch: str, B: int, prompt_len: int, tokens: int) -> None:
    """One period of ``arch`` at full width in fp32: greedy tokens through the
    kernels (attn_impl "flash") equal tokens through the plain versions
    ("xla": masked-softmax attention, the sequential recurrences), and the
    prefill logits agree within the model bar (relative error < 5e-3).

    With random weights the sLSTM recurrence amplifies a difference of a few
    ulps at its input over its steps (PERF.md), so the xLSTM check keeps its
    prompt and decode short enough for the tokens to stay comparable."""
    import torch

    from repro_torch.configs import get_config, make_model
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import dense_serve_loop

    torch.cuda.empty_cache()
    full = get_config(arch)
    r = full.recurrent
    period = r.attn_every if r.kind == "rglru" else r.slstm_every
    base = dataclasses.replace(full, n_layers=period, dtype="float32")
    kern_cfg = dataclasses.replace(base, attn_impl="flash")
    plain_cfg = dataclasses.replace(base, attn_impl="xla")
    model = make_model(kern_cfg)
    params = init_params(model, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, base.vocab, (B, prompt_len), generator=gen, device="cuda")
    plain_model = make_model(plain_cfg)
    kern, *_ = dense_serve_loop(model, kern_cfg, params, prompts, tokens, torch.float32)
    plain, *_ = dense_serve_loop(plain_model, plain_cfg, params, prompts, tokens, torch.float32)
    same = bool(torch.equal(kern, plain))

    def prefill_rel_err(n: int) -> float:
        tok = torch.randint(0, base.vocab, (B, n), generator=gen, device="cuda")
        lk, lp = (m.prefill(params, tok, m.init_caches(B, n + 1, torch.float32, "cuda"))[0]
                  for m in (model, plain_model))
        return float((lk - lp).abs().max() / lp.abs().max())

    rel = prefill_rel_err(prompt_len)
    phase = f"serve_check_{arch.split('_')[0]}"
    # Not asserted: how far kernel and plain prefill logits part at a 300-token
    # prompt (the sLSTM's sensitivity shows there).
    emit(phase, arch=base.name, layers=period, mixers=[spec.mixer for spec in model.prefix], dtype="float32",
         batch=B, prompt_len=prompt_len, tokens=tokens, tokens_equal=same, prefill_logits_rel_err=rel,
         prefill_logits_rel_err_at_300=prefill_rel_err(300), kernel_row0=kern[0].tolist(),
         plain_row0=plain[0].tolist())
    if not same or not rel < 5e-3:
        raise AssertionError(f"{phase}: kernel tokens differ from plain tokens, or prefill logits "
                             f"(relative error {rel})")
    record[phase] = same
    del params


# ------------------------------------------------------------------------- main


SERVE_PHASES = ("serve", "serve_store", "serve_recurrentgemma", "serve_xlstm")


def kernels_line(record: dict) -> dict:
    """One entry per kernel: its launches summed over the serve phases (each
    counted from zero; ``launches_by_phase`` splits them), its largest error
    over all its cases, and the times and bound of its first case, the
    shape its main path gives it."""
    out = []
    for name, phase, source, replaces in (
        ("tiered_decode", "tiered_decode", "src/repro_torch/csrc/tiered_decode.cu",
         "src/repro/kernels/tiered_decode.py:133"),
        ("flash_attention", "flash", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:111"),
        ("rglru", "rglru", "src/repro_torch/csrc/rglru.cu", "src/repro/kernels/rglru.py:56"),
        ("mlstm", "mlstm", "src/repro_torch/csrc/mlstm.cu", "src/repro/kernels/mlstm.py:104"),
    ):
        rows = record[phase]
        main = rows[0]
        if name == "tiered_decode":
            rows = rows + record["tiered_decode_sweep"]
        by_phase = {p: record[p]["launches"][name] for p in SERVE_PHASES if record[p]["launches"][name]}
        entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=sum(by_phase.values()), launches_by_phase=by_phase,
                     max_abs_err=max(r["max_abs_err"] for r in rows),
                     ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                     bound_by=main["bound_by"], library_ms=main["library_ms"])
        if name == "tiered_decode":
            entry.update(groups=sorted({r["G"] for r in rows}), head_dims=sorted({r["D"] for r in rows}),
                         shapes_run=sorted({(r["G"], r["D"]) for r in rows}))
        if name == "flash_attention":
            entry.update(path=main["path"], library_masked_ms=main["library_masked_ms"],
                         tensor_core_launches=sum(record[p]["flash_paths"]["tensor_core"] for p in SERVE_PHASES))
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None, help="directory for compiler logs and profile tables")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import ops
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = args.out
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    record: dict = {}
    t0 = time.perf_counter()
    paths = ops.build()
    emit("build", seconds=time.perf_counter() - t0, arch="sm_90a",
         libraries={n: str(p.relative_to(ROOT)) for n, p in paths.items()})
    if out_dir:
        for p in paths.values():
            log = p.with_suffix(".log")
            if log.exists():
                shutil.copy(log, out_dir / f"ptxas_{p.stem}.log")
    tiered_decode_phase(record)
    flash_phase(record)
    rglru_phase(record)
    mlstm_phase(record)
    serve_phase(record, out_dir)
    serve_check_phase(record)
    serve_store_phase(record)
    recurrent_serve_phase(record, out_dir, "recurrentgemma_9b", B=4, prompt_len=4096, tokens=64)
    recurrent_serve_phase(record, out_dir, "xlstm_125m", B=4, prompt_len=2048, tokens=64)
    recurrent_serve_check_phase(record, "recurrentgemma_9b", B=2, prompt_len=2100, tokens=16)
    recurrent_serve_check_phase(record, "xlstm_125m", B=2, prompt_len=16, tokens=8)
    print(json.dumps(kernels_line(record)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
