#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line (``{"phase": ...}``):

1. device        the card's name, and its name and power limit from nvidia-smi
2. build         the five CUDA sources built by nvcc for sm_90a from
                 src/repro_torch/csrc, one nvcc per source, all started together
3. tiered_decode the decode kernel against its plain version at the serving
                 shape (B=4, H=32, KV=8, D=128, W=256, C=1024), at the edge
                 cases and at a long history (cold 7936 of C=8192), at
                 gemma3-1b's serving shape (4/1/256, cold 1920) and at D=12
                 (zero-padded to 16 by the launcher), then at the
                 other configs' groups and head dims (H/KV/D 24/2/128, 48/8/128,
                 14/2/64, 4/1/256, 16/1/256, 5/1/128) over both tiers, no key,
                 hot only, cold only and a wrapped ring, each in bf16 and again
                 in fp32; the split count, head tile, error, the whole op's ms
                 (both launches), plain / SDPA ms and the bound; then a sweep
                 of every group 1..16 and head dim 16..256 the kernel takes
                 (20 shapes at B=2, W=16, C=64, each at six edge cases, in
                 bf16 and fp32), error only
3b. tiered_decode_rows  the per-row entry (N sessions, each its own ring,
                 staging buffer of its own capacity and lengths) against its
                 plain version at qwen3-8b's H/KV/D 32/8/128, W=256: four rows
                 of capacities 1024/896/512/128 (both tiers, a wrapped ring,
                 cold only, hot only), the four rows serve_sessions gives, and
                 those with a row of no key, also at G 1, 6, 12 and D 64, 256,
                 each in bf16 and fp32; the op's ms (both launches), the same
                 rows as single-row launches, plain / SDPA ms and the bound
4. flash         the flash kernel against its plain version at S=T=1024 causal,
                 T > S, window 64, softcap 30, ragged S=200, rows with no key
                 (T < S, at D=32 and D=128), D=64, recurrentgemma's D=256 MQA
                 window-2048 S=4096 prefill, a ragged D=256 case, grok-1's
                 prefill (H/KV 48/8, softcap 30), gemma3-1b's (4/1, D=256,
                 S=2048, window 512 and global), D=12 (padded), whisper-large-v3's
                 decoder prefill (MHA 20/20 of D=64, S=224: a partial last
                 tile) and internvl2-1b's (14/2 of D=64, S=1024), each in
                 bf16 and again in fp32; which kernel each took (bf16 at
                 D=64/128/256: the tensor cores), and SDPA as yardstick, with
                 the mask as a tensor and, where the mask is plain causal,
                 with is_causal
5. rglru         the RG-LRU scan kernel against its plain version at the serving
                 shape (B=4, S=4096, W=4096) and at S=1, ragged S=300, W=50,
                 each in fp32 (the model's dtype) and again in bf16
6. mlstm         the chunkwise mLSTM kernel against its plain version, h and
                 carry-out, at B=4, H=4, S=2048, D=384, from a carry-in, and at
                 ragged S=300, each in fp32 and again in bf16; the value tile
                 (tile_v) and blocks each launch took; then (``mlstm_tiles``)
                 both built tiles timed at D=384, S=2048 for B*H 4, 16, 20
                 and 40 beside the tile the plan picks there
6b. moe_grouped  Command A+'s expert share at its cell's widths (d = f =
                 4096, experts 64..71 of 128 held, top 8 of sigmoid scores):
                 ``nn.layers.route_share``'s rows for a 16-token decode step
                 (tiles of 16) and a 4096-token prefill chunk (tiles of 128)
                 through the grouped op, its used rows against the plain twin
                 in bf16 (and the decode step in fp32); launches, ms, plain
                 ms and the bound of the held experts' bytes and operations
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
8c. serve_sessions  qwen3-8b, 36 layers, bf16, through the session plane
                 (``repro_torch.serving.SessionScheduler``): 8 sessions of
                 prompt 1024 sharing their first 512 tokens, 32 new tokens,
                 max_batch 4, a store under build/; a control run, then the
                 same schedule under device and host budgets with a memory
                 arbiter: equal tokens, demotions, evictions and resumes,
                 pages stored once (dedup), one per-row launch a layer a
                 decode step and no single-row one, the pools released
8d. serve_sessions_check  2 qwen3 layers at full width in fp32, 4 sessions:
                 kernel tokens equal plain tokens
9. serve_recurrentgemma  recurrentgemma-9b, 38 layers, bf16, through
                 ``steps.dense_serve_loop`` (batch 4, prompt 4096, 64 new tokens),
                 then profiled
10. serve_xlstm  xlstm-125m, 12 layers, bf16 (batch 4, prompt 2048, 64 new
                 tokens), then profiled at a prompt of 256 (the sLSTM loop's
                 events cost the profiler ≈ 0.07 ms each to post-process)
11. serve_check_recurrentgemma / serve_check_xlstm  one period at full width
                 in fp32 (3 and 4 layers): kernel tokens equal plain tokens,
                 and prefill logits agree within 5e-3
12. train        starcoder2-3b at full width (d_model 3072, 24/2 heads, d_ff
                 12288, vocab 49152), cut to 2 of its 30 layers, bf16 compute
                 and fp32 masters, ``remat="full"`` as published (each layer
                 recomputed in the backward), through ``repro_torch.launch.train.run_training``
                 (batch 8 x seq 1024, 8 steps, sync checkpoints every 4 into a
                 ``TwoLevelStore`` under build/): an uninterrupted run, then one
                 that fails at step 6 and restores step 4 (losses and final
                 params equal to the uninterrupted run's at rtol 1e-5 / atol
                 1e-6); step time, tokens/s, model TFLOP/s (6 N tokens / step),
                 peak memory, data / checkpoint stalls, save MB/s, restore s,
                 no kernel launched; then 2 steps profiled (``train_profile``)
                 and the fp32 LM head's three GEMMs timed alone (``train_head``)
13. train_check  reduced starcoder2 in fp32: 4 steps on the card against the
                 same steps of the port on the CPU (step 1 within 1e-5, all
                 within 1e-4 relative), every gradient finite and non-zero,
                 the four kernel ops refusing CUDA inputs that require grad, a
                 checkpoint of the card's state restoring on the CPU
                 bit-identical
13b. serve_grok / serve_deepseek / serve_gemma3  the MoE, MLA and 5:1
                 local-global families at full width, bf16, batch 4, through the
                 serve loops: grok-1-314b (2 of 64 layers, 8 experts top 2,
                 prompt 1024, 32 tokens, dense caches: its softcap keeps it off
                 the tiered cache), deepseek-v3-671b (4 of 61 layers: 3 dense
                 + 1 of 256 experts top 8, MLA latent caches, prompt 1024, 32
                 tokens, no kernel: the reference has none for MLA or MoE),
                 gemma3-1b (all 26 layers, prompt 2048, 64 tokens, kv window
                 256, page 128 on its 4 global layers, sliding rings of 512
                 on the 22 local ones, all 26 decoding through the tiered
                 kernel); launches per kernel, MoE assignments dropped /
                 routed, peak bytes at init and serving; then profiled
13c. serve_whisper / serve_internvl2  the encoder-decoder and the VLM at
                 full width and depth, bf16, batch 4, 64 new tokens, through
                 ``steps.dense_serve_loop`` (``make_prefill_step`` /
                 ``make_serve_step``, dense caches): whisper-large-v3 (32 + 32
                 layers, 20 heads of 64, 1500 frames of 1280 drawn from the
                 seed, a decoder prompt of 224; 32 flash launches, the
                 decoder's self-attention at prefill) and internvl2-1b (24
                 layers, 14/2 heads of 64, 256 patches of 1024 drawn from the
                 seed before a prompt of 768; 24 flash launches); params,
                 self-cache and cross (k, v) bytes; then profiled
13d. serve_check_families  reduced grok, deepseek, gemma3, command-r (D=12),
                 whisper (D=16, with frames, dense caches) and internvl2
                 (D=14, with patches through dense caches, text alone through
                 the tiered ones at G=2) in fp32: prefill + 4 decode steps on
                 the card against the CPU, logits within 1e-4 relative and
                 the same tokens a step
13e. train_check_families  reduced deepseek (MoE aux + MTP), grok, whisper,
                 internvl2, recurrentgemma and xlstm in fp32: 4 train steps on
                 the card against the CPU (step 1 within 1e-5, all within 1e-4
                 relative)
13f. train_recurrentgemma  recurrentgemma-9b at full width (d_model 4096,
                 lru 4096, 16/1 heads of 256, d_ff 12288, vocab 256,000), cut
                 to one period of 3 of its 38 layers (rec, rec, local attn),
                 ``remat="full"``, bf16 compute and fp32 masters, through
                 ``run_training`` (batch 2 x 1024, 4 steps, no checkpoint):
                 step s, tokens/s, model TFLOP/s, peak bytes, no kernel
                 launched; then one step profiled
13g. train_xlstm  xlstm-125m at full size (12 layers), ``remat="full"``,
                 batch 16 x 64 (at 256 steps the full-width sLSTM's
                 gradient overflows fp32, in the JAX package too), 8 steps, sync saves every 4 through host 1's
                 shard of a ``DistributedStore`` under build/ (as the CLI's
                 ``--distributed`` opens it): an uninterrupted run, then one
                 that fails at step 6 and restores step 4 (losses and params
                 equal at rtol 1e-5 / atol 1e-6); the shard's stats, save
                 MB/s, restore s, step s, peak bytes, no kernel launched
13h. compress    ``topk_compress_with_ef`` at ratio 0.01 over a full xlstm-125m
                 gradient tree drawn on the CPU, 3 rounds with error feedback
                 on the card and on the CPU: equal bit for bit; elements sent,
                 ms a round
13i. mesh_train  the multi-device layer on the card: a one-rank NCCL process
                 group and a 1 x 1 ("data", "model") DeviceMesh; the train
                 phase's configuration (starcoder2-3b, 2 of 30 layers,
                 ``remat="full"``, batch 8 x 1024) for 3 steps of
                 ``steps.make_sharded_train_step`` on ``shard_state``'s DTensor
                 state against 3 plain steps from the same init: losses and
                 every state leaf equal to the bit (a differing leaf named,
                 within 1e-6), each run's step times, no kernel launched
13j. restore_sharded_serve  qwen3-8b at full width, 2 of 36 layers (bf16
                 matrices, fp32 head): its params saved through
                 ``CheckpointManager`` into a ``TwoLevelStore`` under build/ and
                 ``restore_sharded`` onto the card's mesh from a meta template,
                 then served from the restored leaves through
                 ``tiered_serve_loop`` (batch 4, prompt 1024, 64 tokens, kv
                 window 256, page 128): leaves, tokens and prefill logits equal
                 to those of the unsaved params, 128 tiered and 2 flash
                 launches; save MB/s, restore s
13k. dryrun      ``repro_torch.launch.dryrun.run_cell`` (meta tensors; the
                 step run on DTensors over a fake process group of the
                 production world size; in a process of its own on the
                 host, started after the build, so it overlaps the card's
                 phases and its seconds are those of a shared host) for
                 qwen3-8b train_4k and
                 deepseek-v3-671b decode_32k on 16x16 and 2x16x16:
                 per-device argument and temporary bytes (their sum beside
                 the card's), the collectives one device issues (bytes and
                 counts by type, their total; none of qwen3's carries a
                 device's (B, S, V) fp32 logits), dot FLOPs per device
                 (qwen3's at most 1.02 of its share) and for the whole
                 step; and xlstm-125m train_4k on 16x16, its per-device
                 counts fitted in the sequence length
13l. terasort    TeraGen, TeraSort and TeraValidate through the port's
                 ``repro_torch.apps`` on the host, 2,000,000 records (200 MB)
                 in each of fig7's storage modes (tls, ofs, mem): validated,
                 the sorted keys' digest equal to a numpy sort's; seconds
                 and MB/s a phase, beside the nvidia-smi line
14. phase_seconds  each phase's wall seconds, and the total from the build on
15. kernels      one entry per kernel: launches in the serve phases that run
                 it, max error, times, bound

Each serve phase zeroes the kernels' launch counts just before it serves and
reads them just after, and asserts them (the training phases too: they launch none), and that every bf16 flash launch
took the tensor-core kernel (serve_sessions: before each of its two runs).  Every phase runs, at the
configs' full depth but train and mesh_train (2 of 30 layers), train_recurrentgemma (3 of 38), serve_grok,
serve_deepseek and restore_sharded_serve (named above).  The nvidia-smi line comes
first; the last line is the contract line ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before it, as does a machine without CUDA or a
directory without the repository's sources.
With ``--out DIR``, the compiler logs (``-Xptxas -v``) and the serve
profile's tables are written there as well.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
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
    from repro_torch.kernels.tiered_decode import (_DTYPES, HEAD_DIMS, blocks_per_sm, head_tile, plan_splits,
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
    # gemma3-1b's global layers as serve_gemma3 gives them the kernel (prompt
    # 2048 + 64 tokens, window 256, page 128: cold 1920 of 2176 rows), and the
    # reduced command-r's D = 12 (zero-padded to 16; timed through the
    # launcher, the padding copies included).
    shapes += [("gemma3_serve", (4, 1, 256), 192, 1920, 63, 2176), ("d12_both_tiers", (8, 2, 12), 192, 896, 63, 1024)]
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
                gt, _DTYPES[dt], 1.0 / math.sqrt(D), stream)
               for s, o in zip(sets, outs)]
        it = iter(range(1 << 30))
        if D in HEAD_DIMS:
            ms = time_ms(lambda: lib.tiered_decode_launch(*raw[next(it) % copies]), iters=40)
        else:
            ms = time_ms(lambda: tiered_decode_attention_fwd(*sets[next(it) % copies], *args), iters=40)
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


# ------------------------------------------------------------ tiered decode rows


# Rows of the per-row entry at qwen3-8b's ring of 256: (staging capacity C_i,
# hot_len, cold_len, newest).  "sessions_rows", first as the shape the main
# path gives the kernel: what serve_sessions' decode gives four sessions
# (prompt 1024 plus 1-32 tokens at page 128: cold 896 of a 1024-row buffer,
# hot 129-160 with the ring wrapped); "serve_rows": four capacities, one row
# with both tiers, one with a wrapped ring, one cold only, one hot only;
# "rows_no_key": serve_rows and a row with no key, also at the other groups
# and head dims.
ROWS_W = 256
ROWS_MIXED = [(1024, 192, 896, 63), (896, 256, 640, 100), (512, 0, 512, 63), (128, 200, 0, 199)]
ROWS_SESSIONS = [(1024, hot, 896, (896 + hot - 1) % ROWS_W) for hot in (160, 150, 140, 130)]
ROWS_NO_KEY = ROWS_MIXED + [(128, 0, 0, 0)]


def tiered_rows_phase(record: dict) -> None:
    """The per-row entry against ``ref.tiered_rows_attention_ref``; at each
    case the whole op's ms (both launches, one C call on pre-made
    arguments), the same rows as one single-row launch each, the plain
    version, SDPA over the rows stacked and padded with a boolean mask, and
    the bound of the valid keys' bytes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import load
    from repro_torch.kernels.tiered_decode import (_DTYPES, blocks_per_sm, head_tile, plan_splits, rows_launch_args,
                                                   rows_plan, tiered_decode_rows_fwd)

    qwen = (32, 8, 128)
    shapes = [("sessions_rows", qwen, ROWS_SESSIONS), ("serve_rows", qwen, ROWS_MIXED),
              ("rows_no_key", qwen, ROWS_NO_KEY)]
    shapes += [(f"h{h}_kv{kv}_d{d}_rows_no_key", (h, kv, d), ROWS_NO_KEY)
               for h, kv, d in ((8, 8, 128), (48, 8, 128), (24, 2, 128), (32, 8, 64), (16, 4, 256))]
    cases = [(name if dt == "bfloat16" else name + "_fp32", dt, *rest) for dt in DTYPES for name, *rest in shapes]
    lib = load("tiered_decode")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(10)
    stream = torch.cuda.current_stream().cuda_stream
    copies = 4  # rotated input sets, as in the tiered_decode phase
    for name, dt_name, (H, KV, D), rows in cases:
        dt = getattr(torch, dt_name)
        rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
        lens = [r[1:] for r in rows]
        sets = [(rnd(len(rows), H, 1, D), [rnd(1, KV, ROWS_W, D) for _ in rows], [rnd(1, KV, ROWS_W, D) for _ in rows],
                 [rnd(1, KV, c, D) for c, *_ in rows], [rnd(1, KV, c, D) for c, *_ in rows]) for _ in range(copies)]
        got = tiered_decode_rows_fwd(*sets[0], lens)
        want = ref.tiered_rows_attention_ref(*sets[0], lens)
        torch.cuda.synchronize()
        err, ok = within_tol(got, want, dt_name)

        _, n_split = rows_plan(*sets[0], lens)
        N, G = len(rows), H // KV
        gt, tiles = head_tile(G)
        outs = [torch.empty_like(s[0]) for s in sets]
        scratch = torch.empty(N * H * n_split * (D + 2), dtype=torch.float32, device="cuda")
        raw = [rows_launch_args(*s, lens, n_split, o, scratch) for s, o in zip(sets, outs)]
        it = iter(range(1 << 30))
        ms = time_ms(lambda: lib.tiered_decode_rows_launch(*raw[next(it) % copies]), iters=40)

        # The same rows as N single-row launches of the batch entry (B = 1,
        # each row at its own planned split count), one after another.
        singles = []
        for s, o in zip(sets, outs):
            calls = []
            for i, (c, hot_len, cold_len, newest) in enumerate(rows):
                ns = plan_splits(hot_len + cold_len, KV * tiles, sms, blocks_per_sm(G))
                sc = torch.empty(H * ns * (D + 2), dtype=torch.float32, device="cuda")
                calls.append((s[0][i:i + 1].data_ptr(), s[1][i].data_ptr(), s[2][i].data_ptr(), s[3][i].data_ptr(),
                              s[4][i].data_ptr(), o[i:i + 1].data_ptr(), sc.data_ptr(), 1, H, KV, ROWS_W, c, D,
                              hot_len, cold_len, newest, ns, gt, _DTYPES[dt], 1.0 / math.sqrt(D), stream, sc))
            singles.append(calls)
        single_ms = time_ms(lambda: [lib.tiered_decode_launch(*c[:-1]) for c in singles[next(it) % copies]], iters=40)
        plain_ms = time_ms(lambda: ref.tiered_rows_attention_ref(*sets[next(it) % copies], lens), iters=10)

        # Yardstick only: SDPA over the rows stacked (cold padded to the
        # largest capacity, then the ring) with each row's mask.
        cmax = max(c for c, *_ in rows)
        pad = lambda t: F.pad(t, (0, 0, 0, cmax - t.shape[2]))
        age = torch.remainder(torch.tensor([r[3] for r in rows], device="cuda")[:, None]
                              - torch.arange(ROWS_W, device="cuda"), ROWS_W)
        mask = torch.cat([torch.arange(cmax, device="cuda") < torch.tensor([r[2] for r in rows], device="cuda")[:, None],
                          age < torch.tensor([r[1] for r in rows], device="cuda")[:, None]], 1)[:, None, None, :]
        lib_in = [(s[0], torch.cat([torch.cat([pad(t) for t in s[3]]), torch.cat(s[1])], 2),
                   torch.cat([torch.cat([pad(t) for t in s[4]]), torch.cat(s[2])], 2)) for s in sets]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            *lib_in[next(it) % copies], attn_mask=mask, enable_gqa=True))

        isz = torch.finfo(dt).bits // 8
        n_keys = sum(r[1] + r[2] for r in rows)
        bound_ms, bound_by = bound(2 * KV * n_keys * D * isz + 2 * N * H * D * isz, 4 * H * n_keys * D, dt_name)
        row = dict(case=name, dtype=dt_name, H=H, KV=KV, D=D, G=G, head_tile=gt, rows=rows, n_keys=n_keys,
                   n_split=n_split, blocks=N * KV * tiles * n_split, max_abs_err=err, tol=TOL[dt_name], ok=ok, ms=ms,
                   single_row_launches_ms=single_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit("tiered_decode_rows", **row)
        if not ok:
            raise AssertionError(f"tiered_decode_rows {name}: not within rtol=atol={TOL[dt_name]} "
                                 f"(max abs err {err})")
        if row["blocks"] > sms * blocks_per_sm(G):
            raise AssertionError(f"tiered_decode_rows {name}: {row['blocks']} pass-1 blocks are more than one wave")
        record.setdefault("tiered_decode_rows", []).append(row)
        del sets, lib_in, outs, scratch, singles


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
        ("grok_softcap_30", (4, 48, 8, 128), 1024, 1024, 0, 30.0),  # grok-1's prefill: G = 6, softcap 30
        ("gemma3_local_d256", (4, 4, 1, 256), 2048, 2048, 512, 0.0),  # gemma3-1b's prefill, local layers
        ("gemma3_global_d256", (4, 4, 1, 256), 2048, 2048, 0, 0.0),  # and global ones
        ("d12_causal", (4, 8, 2, 12), 512, 512, 0, 0.0),  # the reduced command-r's D, zero-padded to 16
        ("whisper_d64", (4, 20, 20, 64), 224, 224, 0, 0.0),  # whisper-large-v3's decoder prefill: MHA, 224 = 128 + 96
        ("internvl2_d64", (4, 14, 2, 64), 1024, 1024, 0, 0.0),  # internvl2-1b's prefill: G = 7, 256 patches + 768
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


# ------------------------------------------------------------- moe grouped


def moe_grouped_phase(record: dict) -> None:
    """The grouped expert product at ``cmda-moe-rag-c16``'s widths.  bf16's
    error is held to two bf16 steps at the plain output's largest value
    (2**-6 of it: both sides round the intermediate and the output)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.nn import layers as L

    cfg = dataclasses.replace(get_config("command_a_plus_05_2026"), experts_held=8, experts_lo=64)
    d, f, k, held = cfg.d_model, cfg.moe.expert_ff, cfg.moe.top_k, 8
    gen = torch.Generator(device="cuda").manual_seed(31)
    router = torch.randn((d, cfg.moe.n_experts), generator=gen, device="cuda") * 0.02
    w32 = [torch.randn((held, a, b), generator=gen, device="cuda") / a ** 0.5 for a, b in ((d, f), (d, f), (f, d))]
    for name, tokens, dt_name in (("decode", 16, "bfloat16"), ("prefill_chunk", 4096, "bfloat16"),
                                  ("decode_fp32", 16, "float32")):
        dt = getattr(torch, dt_name)
        w = [t.to(dt) for t in w32]
        x = torch.randn((tokens, d), generator=gen, device="cuda").to(dt)
        r = L.route_share({"router": router}, x.float(), cfg, L.moe_tile(tokens, cfg))
        args = (x, *w, r.rows, r.tile_expert, r.gate, k)
        ops.moe_grouped_ffn.launches = 0
        got = ops.moe_grouped_ffn(*args)
        launches = ops.moe_grouped_ffn.launches
        want = ref.moe_grouped_ref(*args)
        used = r.rows < tokens * k
        rows, experts = int(used.sum()), int(r.active)
        if dt_name == "bfloat16":
            err = (got[used].float() - want[used].float()).abs().max().item()
            tol = 2 ** -6 * want[used].float().abs().max().item()
            ok = err <= tol and bool(torch.isfinite(got[used]).all())
        else:
            err, ok = within_tol(got[used], want[used], dt_name)
            tol = TOL[dt_name]
        ms = time_ms(lambda: ops.moe_grouped_ffn(*args), iters=20)
        plain_ms = time_ms(lambda: ref.moe_grouped_ref(*args), iters=3, warmup=1)
        isz = torch.finfo(dt).bits // 8
        bound_ms, bound_by = bound(isz * (3 * d * f * experts + 2 * rows * d), 6 * rows * d * f, dt_name)
        row = dict(case=name, dtype=dt_name, tokens=tokens, tile=L.moe_tile(tokens, cfg), held_rows=rows,
                   experts_read=experts, launches=launches, max_abs_err=err, tol=tol, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        emit("moe_grouped", **row)
        if not ok or launches != 1 or rows != int(r.held):
            raise AssertionError(f"moe_grouped {name}: error {err} over {tol}, {launches} launches, "
                                 f"{rows} rows of {int(r.held)} held")
        record.setdefault("moe_grouped", []).append(row)
        del w, x, got, want


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

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mlstm import CHUNK, TILE_VS, mlstm_chunkwise_fwd, plan_tile_v

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
        tile_v, blocks = mlstm_chunkwise_fwd.last_grid
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
                   tile_v=tile_v, blocks=blocks, max_abs_err=err, tol=MLSTM_TOL[dt_name],
                   ok=ok, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        emit("mlstm", **row)
        if not ok:
            raise AssertionError(f"mlstm {name}: h or carry-out not within rtol=atol={MLSTM_TOL[dt_name]} "
                                 f"(max abs err {err})")
        record.setdefault("mlstm", []).append(row)
        del q, k, v, got, want, got_carry, want_carry

    # The value-tile plan against both tiles at D = 384 (fp32, S = 2048, the
    # empty history), at xlstm-125m's H = 4 and batches 1, 4, 5 and 10: B*H
    # on each side of each of the plan's choices.  The tiles' outputs must
    # agree within the fp32 tolerance; the times are reported, not gated.
    S = 2048
    for b in (1, 4, 5, 10):
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        q, k, v = rnd(b, H, S, D), rnd(b, H, S, D) / D**0.5, rnd(b, H, S, D)
        ip, fl = 0.5 * rnd(b, H, S), F.logsigmoid(rnd(b, H, S) + 2.0)
        ms, blocks, outs = {}, {}, []
        for tv in TILE_VS[D]:
            outs.append(mlstm_chunkwise_fwd(q, k, v, ip, fl, tile_v=tv))
            blocks[tv] = mlstm_chunkwise_fwd.last_grid[1]
            ms[tv] = time_ms(lambda: mlstm_chunkwise_fwd(q, k, v, ip, fl, tile_v=tv), iters=10)
        (h0, c0), (h1, c1) = outs
        checks = [within_tol(x, y, "float32", MLSTM_TOL) for x, y in zip((h1, *c1), (h0, *c0))]
        planned = plan_tile_v(D, b * H, ops.sm_count(q.device))
        row = dict(B=b, H=H, S=S, D=D, dtype="float32", planned_tile_v=planned,
                   blocks_by_tile_v={str(tv): n for tv, n in blocks.items()},
                   ms_by_tile_v={str(tv): t for tv, t in ms.items()},
                   planned_is_fastest=ms[planned] == min(ms.values()),
                   tiles_apart=max(e for e, _ in checks), ok=all(o for _, o in checks))
        emit("mlstm_tiles", **row)
        if not row["ok"]:
            raise AssertionError(f"mlstm_tiles B*H {b * H}: the value tiles' outputs differ by {row['tiles_apart']}")
        record.setdefault("mlstm_tiles", []).append(row)
        del q, k, v, outs, h0, c0, h1, c1


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


def profile_serve(model, cfg, params, prompts, caches, out_dir: Path | None, phase: str,
                  extra: dict | None = None) -> None:
    """Where the time goes: a short profiled rerun (prefill, with the
    ``extra`` inputs of the batch, then 8 decode steps) into fresh
    ``caches``, outside the timed and counted run."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    step = make_serve_step(model, cfg)
    state = {}

    def prefill():
        tok, state["caches"] = make_prefill_step(model, cfg)(params, {"inputs": prompts, **(extra or {})}, caches)
        state["tok"] = tok[:, None]

    def decode():
        for _ in range(8):
            state["tok"], state["caches"] = step(params, state["tok"], state["caches"])

    for name, fn in (("prefill", prefill), ("decode_8_steps", decode)):
        table = out_dir / f"profile_{phase}_{name}.txt" if out_dir else None
        emit(f"{phase}_profile", part=name, **profile_breakdown(fn, table))


def profile_breakdown(fn, table: Path | None, top: int = 6) -> dict:
    """Wall time of ``fn`` (ending in a synchronise) under torch.profiler, the
    summed device time of its operations (overlapping ones and copy-engine
    copies each counted whole), and the kernels with the most device time.
    The profiler's table by host time goes to ``table`` when one is given."""
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
    return dict(wall_ms=wall_ms, device_ms=device_ms,
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


# ------------------------------------------------------------ session serving


class LogitsTap:
    """The model, with every ``decode_step``'s last-position logits kept on
    the device: with random weights the greedy tokens barely vary, so two
    runs of one schedule are held to each other logits for logits."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, token, caches):
        logits, caches = self.model.decode_step(params, token, caches)
        self.logits.append(logits[:, -1, :])
        return logits, caches


def logits_apart(a: list, b: list) -> tuple[bool, float, float]:
    """(bit-identical, max abs difference, that over the largest |logit| of
    ``b``) of two runs' per-dispatch logits; inf when the dispatches differ
    in number or batch."""
    import torch

    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        return False, float("inf"), float("inf")
    diff = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
    return all(torch.equal(x, y) for x, y in zip(a, b)), diff, diff / max(float(y.abs().max()) for y in b)


def drive_sessions(sched, prompts, tokens: int, after_first_step=None) -> tuple[list[list[int]], int]:
    """Submit ``prompts`` and step ``sched`` until every session retires;
    ``after_first_step(sched)`` runs once after the first step.  Returns
    (each session's tokens, the decode dispatches: steps with a batch)."""
    sids = [sched.submit(p, tokens) for p in prompts]
    dispatches = 0
    while True:
        info = sched.step()
        dispatches += info["batch"] > 0
        if after_first_step is not None:
            after_first_step(sched)
            after_first_step = None
        if not info["queued"] and not info["live"]:
            return [sched.session_tokens(s) for s in sids], dispatches


def serve_sessions_phase(record: dict, out_dir: Path | None) -> None:
    """qwen3-8b at full width and depth, bf16, through the session plane: 8
    sessions of prompt 1024 whose first 512 tokens are shared, 32 new tokens
    each, max_batch 4, 2 admitted a step, kv window 256, page 128, a
    ``TwoLevelStore`` under build/ (removed after).  A control run without
    budgets, then the same schedule under a device budget of 4.5 sessions'
    device bytes and a host budget of 6 sessions' host bytes (measured on
    the control run after its first step) with a ``MemoryArbiter``.  Then,
    outside the counted runs, 8 profiled decode steps of 4 admitted sessions
    (no budgets, no store)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config, make_model
    from repro_torch.core import TwoLevelStore
    from repro_torch.core.arbiter import MemoryArbiter
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.serving import SessionScheduler

    n, prompt_len, shared_len, tokens, window, page = 8, 1024, 512, 32, 256, 128
    cfg = dataclasses.replace(get_config("qwen3_8b"), attn_impl="flash", scan_layers=False)
    layers = cfg.n_layers
    model = make_model(cfg)
    params = init_params(model, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, shared_len)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, prompt_len - shared_len)]).astype(np.int32)
               for _ in range(n)]
    (ROOT / "build").mkdir(exist_ok=True)
    per_session = {}

    def measure(sched) -> None:  # one admitted session's bytes after the first step
        caches = list(sched._sessions[0].caches.values())
        per_session.update(device=sum(c.device_bytes() for c in caches), host=sum(c.host_bytes() for c in caches))

    def run(budgets: dict | None, arbiter=None) -> dict:
        root = tempfile.mkdtemp(prefix="serve_sessions_", dir=ROOT / "build")
        store = TwoLevelStore(root)
        try:
            tap = LogitsTap(model)
            sched = SessionScheduler(tap, cfg, params, window=window, page=page, max_batch=4, admit_per_step=2,
                                     store=store, arbiter=arbiter, device="cuda", **(budgets or {}))
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            toks, dispatches = drive_sessions(sched, prompts, tokens, None if budgets else measure)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            out = dict(tokens=toks, logits=tap.logits, dispatches=dispatches, seconds=seconds, report=sched.report(),
                       launches=ops.launches(), flash_paths=ops.flash_path_launches(),
                       rows_launches=ops.tiered_decode_rows_attention.launches)
            releases = arbiter.releases if arbiter is not None else 0
            sched.close()
            if arbiter is not None:
                out["pools_released"] = arbiter.releases - releases == 2 and not (
                    {"serve_hbm", "serve_host"} & set(arbiter.report()["pools"]))
            return out
        finally:
            store.close()
            shutil.rmtree(root, ignore_errors=True)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    control = run(None)
    budgets = dict(hbm_bytes=int(4.5 * per_session["device"]), host_bytes=6 * per_session["host"])
    pressed = run(budgets, MemoryArbiter(total_bytes=64 << 30))
    rc, rp = control["report"], pressed["report"]
    row = dict(arch=cfg.name, layers=layers, sessions=n, prompt_len=prompt_len, shared_prefix=shared_len,
               tokens=tokens, max_batch=4, admit_per_step=2, kv_window=window, kv_page=page,
               session_device_bytes=per_session["device"], session_host_bytes=per_session["host"], **budgets,
               peak_device_bytes=torch.cuda.max_memory_allocated())
    for name, r in (("control", control), ("pressed", pressed)):
        rep = r["report"]
        row[name] = dict(seconds=r["seconds"], dispatches=r["dispatches"], launches=r["launches"],
                         rows_launches=r["rows_launches"], flash_paths=r["flash_paths"],
                         **{k: rep[k] for k in ("steps", "prefills", "decoded_tokens", "prefill_s", "decode_s",
                                                "decode_tok_per_s", "ttft_p50_s", "ttft_p99_s", "evictions",
                                                "resumes", "demotions", "pages_logical", "pages_stored",
                                                "dedup_ratio")})
    row["tokens_equal"] = control["tokens"] == pressed["tokens"]
    row["distinct_tokens"] = len({t for toks in control["tokens"] for t in toks})
    # Demotion, eviction and resume move bytes only: each dispatch has the
    # same rows, keys and split plan in both runs, so its logits (every
    # layer's attention over the re-staged or resumed tiers feeds them) are
    # bit-identical.
    row["logits_equal"], row["logits_max_abs_diff"], _ = logits_apart(pressed["logits"], control["logits"])
    row["logits_dispatches_compared"] = len(control["logits"])
    row["pools_released"] = pressed["pools_released"]
    row["seconds"] = time.perf_counter() - t_phase
    emit("serve_sessions", **row)
    faults = []
    if not row["tokens_equal"] or not row["logits_equal"]:
        faults.append(f"tokens equal {row['tokens_equal']}, logits equal {row['logits_equal']} (max abs diff "
                      f"{row['logits_max_abs_diff']}) between the control and the pressed run")
    if min(rp["demotions"], rp["evictions"], rp["resumes"]) < 1:
        faults.append(f"pressed run: demotions {rp['demotions']}, evictions {rp['evictions']}, "
                      f"resumes {rp['resumes']}")
    for name, r in (("control", control), ("pressed", pressed)):
        rep = r["report"]
        if rep["decoded_tokens"] != n * (tokens - 1) or rep["prefills"] != n:
            faults.append(f"{name}: {rep['decoded_tokens']} tokens decoded, {rep['prefills']} prefills")
        want = {"tiered_decode": 0, "flash_attention": layers * n, "rglru": 0, "mlstm": 0}
        if r["launches"] != want or r["rows_launches"] != layers * r["dispatches"] or not r["dispatches"]:
            faults.append(f"{name}: launches {r['launches']} (want {want}), rows {r['rows_launches']} "
                          f"(want {layers} x {r['dispatches']} dispatches)")
        if r["flash_paths"] != {"tensor_core": layers * n, "cuda_core": 0}:
            faults.append(f"{name}: bf16 flash launches off the tensor-core path: {r['flash_paths']}")
        if any(len(t) != tokens or min(t) < 0 or max(t) >= cfg.vocab for t in r["tokens"]):
            faults.append(f"{name}: bad generated tokens")
    per_layer_pages = prompt_len // page  # the 32 new tokens complete no page
    shared_pages = shared_len // page
    if rc["pages_logical"] != layers * n * per_layer_pages or \
            rc["pages_stored"] != layers * (shared_pages + n * (per_layer_pages - shared_pages)):
        faults.append(f"control: pages {rc['pages_logical']} logical / {rc['pages_stored']} stored")
    if rp["pages_stored"] != rc["pages_stored"] or rc["dedup_ratio"] < 1.3:
        faults.append(f"pressed: {rp['pages_stored']} pages stored; control dedup {rc['dedup_ratio']}")
    if not row["pools_released"]:
        faults.append("arbiter pools not released by close()")
    if faults:
        raise AssertionError("serve_sessions: " + "; ".join(faults))
    both = lambda key: {k: control[key][k] + pressed[key][k] for k in control[key]}
    record["serve_sessions"] = dict(row, launches=both("launches"), flash_paths=both("flash_paths"),
                                    rows_launches=control["rows_launches"] + pressed["rows_launches"])
    del control, pressed

    sched = SessionScheduler(model, cfg, params, window=window, page=page, max_batch=4, admit_per_step=4,
                             device="cuda")
    for p in prompts[:4]:
        sched.submit(p, tokens)
    sched.step()  # the 4 prefills and one decode step, outside the profile
    table = out_dir / "profile_serve_sessions_decode_8_steps.txt" if out_dir else None
    emit("serve_sessions_profile", part="decode_8_steps",
         **profile_breakdown(lambda: [sched.step() for _ in range(8)], table))
    sched.close()
    del params
    torch.cuda.empty_cache()


def serve_sessions_check_phase(record: dict) -> None:
    """2 qwen3 layers at full width in fp32, 4 sessions (prompt 300, 16 new
    tokens, window 128, page 64, admitted 2 a step so they sit at different
    lengths): tokens through the kernels (per-row decode, flash prefill)
    equal tokens through the plain versions, and every decode dispatch's
    logits agree within the fp32 tolerance as a relative error (max abs
    difference over the largest |logit|)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, make_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.serving import SessionScheduler

    t0 = time.perf_counter()
    n, prompt_len, tokens, window, page = 4, 300, 16, 128, 64
    base = dataclasses.replace(get_config("qwen3_8b"), n_layers=2, dtype="float32", scan_layers=False)
    params = init_params(make_model(base), seed=1, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, base.vocab, prompt_len).astype(np.int32) for _ in range(n)]
    out, logits, rows_launches = {}, {}, 0
    for impl, attn_impl in (("kernel", "flash"), ("plain", "xla")):
        cfg = dataclasses.replace(base, attn_impl=attn_impl)
        tap = LogitsTap(make_model(cfg))
        sched = SessionScheduler(tap, cfg, params, window=window, page=page, max_batch=4,
                                 dtype=torch.float32, device="cuda", impl=impl)
        ops.reset_launches()
        out[impl], dispatches = drive_sessions(sched, prompts, tokens)
        logits[impl] = tap.logits
        if impl == "kernel":
            rows_launches = ops.tiered_decode_rows_attention.launches
            if rows_launches != base.n_layers * dispatches or ops.launches()["tiered_decode"]:
                raise AssertionError(f"serve_sessions_check: {rows_launches} rows launches for {dispatches} "
                                     f"dispatches, {ops.launches()}")
        sched.close()
    same = out["kernel"] == out["plain"]
    _, diff, rel = logits_apart(logits["kernel"], logits["plain"])
    emit("serve_sessions_check", layers=2, dtype="float32", sessions=n, prompt_len=prompt_len, tokens=tokens,
         kv_window=window, kv_page=page, rows_launches=rows_launches, tokens_equal=same,
         logits_dispatches_compared=len(logits["plain"]), logits_max_abs_diff=diff, logits_rel_err=rel,
         tol=TOL["float32"], distinct_tokens=len({t for toks in out["kernel"] for t in toks}),
         kernel_session0=out["kernel"][0], seconds=time.perf_counter() - t0)
    if not same or not rel <= TOL["float32"]:
        raise AssertionError(f"serve_sessions_check: kernel tokens equal plain tokens {same}; decode logits "
                             f"relative error {rel} (tolerance {TOL['float32']})")
    record["serve_sessions_check"] = same
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------ recurrent serve


def recurrent_serve_phase(record: dict, out_dir: Path | None, arch: str, B: int, prompt_len: int,
                          tokens: int, profile_len: int | None = None) -> None:
    """One recurrent arch at full width and depth, bf16, attn_impl="flash",
    through ``steps.dense_serve_loop`` (recurrent states and windowed ring
    pages); each layer's prefill launches its mixer's kernel once.  The
    profiled rerun prefills the first ``profile_len`` prompt tokens (all by
    default): the profiler's post-processing costs about 0.07 ms an event,
    and xlstm's sLSTM step loop makes ≈ 1.7 k events a prompt token."""
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
               mlstm_grids=ops.mlstm_grid_launches(),
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
    if sum(g["launches"] for g in row["mlstm_grids"]) != want["mlstm"]:
        raise AssertionError(f"{phase}: mlstm grids {row['mlstm_grids']} do not add up to {want['mlstm']} launches")
    if tuple(out.shape) != (B, tokens + 1) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"{phase}: bad generated tokens: shape {tuple(out.shape)}")
    record[phase] = row
    del caches
    n = profile_len or prompt_len
    profile_serve(model, cfg, params, prompts[:, :n], model.init_caches(B, n + 9, torch.bfloat16, "cuda"),
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


# ------------------------------------------------------- MoE, MLA and gemma3


def family_serve_phase(record: dict, out_dir: Path | None, phase: str, arch: str, n_layers: int, prompt_len: int,
                       tokens: int, window: int = 0, page: int | None = None) -> None:
    """One arch of the MoE / MLA / 5:1 local-global families at full width
    (depth ``n_layers``), bf16, attn_impl="flash", batch 4, random weights
    from seed 0, through ``steps.tiered_serve_loop`` with ``window`` (the
    full-attention layers' KV two-level, the local layers on sliding rings)
    or ``steps.dense_serve_loop`` without: prefill and decode rates,
    launches per kernel (flash once a GQA layer; tiered decode once a GQA
    layer a token), the MoE assignments dropped over
    capacity, peak device bytes at init and serving; then profiled."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config, make_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import dense_serve_loop, make_tiered_caches, tiered_cache_stats, tiered_serve_loop
    from repro_torch.nn import layers as L

    torch.cuda.empty_cache()
    B = 4
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, attn_impl="flash", scan_layers=False)
    model = make_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree.leaves(params)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    largest_fp32_leaf = max(t.numel() * 4 for t in leaves)
    init_peak = torch.cuda.max_memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (B, prompt_len), generator=gen, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    L.reset_moe_counts()
    if window:
        out, prefill_s, decode_s, caches = tiered_serve_loop(model, cfg, params, prompts, tokens, window=window,
                                                             page=page)
    else:
        out, prefill_s, decode_s, caches = dense_serve_loop(model, cfg, params, prompts, tokens)
    launches, paths = ops.launches(), ops.flash_path_launches()
    moe = L.moe_counts() if cfg.moe else None
    st = tiered_cache_stats(caches)
    specs = model.prefix
    gqa = sum(spec.mixer == "gqa" for spec in specs)
    full = sum(spec.mixer == "gqa" and spec.window == 0 for spec in specs)
    dense_bytes = sum(t.numel() * t.element_size() for c in caches.values() if isinstance(c, dict)
                      for t in c.values() if torch.is_tensor(t))
    row = dict(arch=cfg.name, layers=n_layers, of_layers=get_config(arch).n_layers,
               mixers=dict(sorted(collections.Counter(f"{sp.mixer}/{sp.ffn}" for sp in specs).items())),
               batch=B, prompt_len=prompt_len, tokens=tokens, kv_window=window, kv_page=page, init_s=init_s,
               param_bytes=param_bytes, init_peak_bytes=init_peak,
               init_peak_over_params_and_largest_fp32_leaf=init_peak / (param_bytes + largest_fp32_leaf),
               prefill_s=prefill_s, prefill_tok_per_s=B * prompt_len / prefill_s, decode_s=decode_s,
               decode_tok_per_s=B * tokens / decode_s, launches=launches, flash_paths=paths, moe=moe,
               dense_cache_device_bytes=dense_bytes, tiered_layers=st["layers"],
               peak_device_bytes=torch.cuda.max_memory_allocated())
    if cfg.moe:
        row.update(moe_capacity_prefill=L.moe_capacity(B * prompt_len, cfg), moe_capacity_decode=L.moe_capacity(B, cfg))
    if cfg.attn_type == "mla":
        m = cfg.mla
        row["latent_cache_bytes_per_token_layer"] = dense_bytes / (B * (prompt_len + tokens + 1) * n_layers)
        if row["latent_cache_bytes_per_token_layer"] != (m.kv_lora_rank + m.qk_rope_head_dim) * 2:
            raise AssertionError(f"{phase}: latent cache of {row['latent_cache_bytes_per_token_layer']} bytes a "
                                 f"token a layer")
    if window:
        row.update(hot_fraction=st["hot_fraction"], pages_staged=st["pages_staged"],
                   h2d_bytes_per_step=st["bytes_staged"] / tokens)
    emit(phase, **row)
    # Under the tiered backend every GQA layer decodes through the tiered op:
    # full layers over both tiers, window layers over their sliding rings.
    want = {"tiered_decode": gqa * tokens if window else 0, "flash_attention": gqa, "rglru": 0, "mlstm": 0}
    if launches != want:
        raise AssertionError(f"{phase}: launch counts {launches} != {want}")
    if paths != {"tensor_core": gqa, "cuda_core": 0}:
        raise AssertionError(f"{phase}: bf16 flash launches off the tensor-core path: {paths}")
    if window and (st["layers"] != full or not st["hot_fraction"] < 1.0 or st["pages_staged"] <= 0):
        raise AssertionError(f"{phase}: cold tier not exercised: {st}")
    if moe is not None and moe["routed"] != B * (prompt_len + tokens) * cfg.moe.top_k * \
            sum(spec.ffn == "moe" for spec in specs):
        raise AssertionError(f"{phase}: {moe['routed']} MoE assignments routed")
    if tuple(out.shape) != (B, tokens + 1) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"{phase}: bad generated tokens: shape {tuple(out.shape)}")
    del caches
    fresh = (make_tiered_caches(model, cfg, B, prompt_len + 9, window, page, torch.bfloat16, "cuda") if window
             else model.init_caches(B, prompt_len + 9, torch.bfloat16, "cuda"))
    if cfg.moe:  # the prefill's share of the drops: the same prefill again, counted alone
        L.reset_moe_counts()
        model.prefill(params, prompts, fresh)
        row["moe_prefill"] = L.moe_counts()
        emit(f"{phase}_moe_prefill", **row["moe_prefill"])
        fresh = model.init_caches(B, prompt_len + 9, torch.bfloat16, "cuda")
    record[phase] = row
    profile_serve(model, cfg, params, prompts, fresh, out_dir, phase)
    del params, fresh
    torch.cuda.empty_cache()


def multimodal_serve_phase(record: dict, out_dir: Path | None, phase: str, arch: str, prompt_len: int,
                           tokens: int) -> None:
    """The encoder-decoder (whisper-large-v3: ``frames`` of (B, 1500, 1280))
    or the VLM (internvl2-1b: ``patches`` of (B, 256, 1024), prepended to the
    text) at full width and depth, bf16, attn_impl="flash", batch 4, random
    weights and inputs from seed 0, through ``steps.dense_serve_loop``
    (``make_prefill_step`` / ``make_serve_step`` over dense caches): prefill
    and decode rates, launches per kernel (flash once a decoder layer at
    prefill; the encoder and the cross-attention attend through the plain
    ``_attend``, as the reference does), the params', self caches' and
    cross (k, v) bytes, peak device bytes; then profiled."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config, make_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import dense_serve_loop

    torch.cuda.empty_cache()
    B = 4
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash", scan_layers=False)
    model = make_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (B, prompt_len), generator=gen, device="cuda")
    if cfg.encdec is not None:
        extra = {"frames": torch.randn((B, cfg.encdec.n_frames, cfg.encdec.frame_dim), generator=gen, device="cuda")}
    else:
        extra = {"patches": torch.randn((B, cfg.vlm.n_patches, cfg.vlm.patch_dim), generator=gen, device="cuda")}
    seq = prompt_len + (cfg.vlm.n_patches if cfg.vlm is not None else 0)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, prefill_s, decode_s, caches = dense_serve_loop(model, cfg, params, prompts, tokens, extra=extra)
    launches, paths = ops.launches(), ops.flash_path_launches()
    nbytes = lambda node: sum(t.numel() * t.element_size() for t in tree.leaves(node) if torch.is_tensor(t))
    self_caches = caches["self"] if cfg.encdec is not None else caches
    row = dict(arch=cfg.name, layers=cfg.n_layers,
               encoder_layers=cfg.encdec.n_encoder_layers if cfg.encdec is not None else 0,
               G=cfg.n_heads // cfg.n_kv_heads, D=cfg.resolved_head_dim, batch=B, prompt_len=prompt_len,
               inputs={k: list(v.shape) for k, v in extra.items()}, prefill_seq=seq, tokens=tokens, init_s=init_s,
               param_bytes=param_bytes, self_cache_device_bytes=nbytes(self_caches),
               cross_kv_device_bytes=nbytes(caches["cross"]) if cfg.encdec is not None else 0,
               prefill_s=prefill_s, prefill_tok_per_s=B * seq / prefill_s, decode_s=decode_s,
               decode_tok_per_s=B * tokens / decode_s, launches=launches, flash_paths=paths,
               peak_device_bytes=torch.cuda.max_memory_allocated())
    emit(phase, **row)
    want = {"tiered_decode": 0, "flash_attention": cfg.n_layers, "rglru": 0, "mlstm": 0}
    if launches != want:
        raise AssertionError(f"{phase}: launch counts {launches} != {want}")
    if paths != {"tensor_core": cfg.n_layers, "cuda_core": 0}:
        raise AssertionError(f"{phase}: bf16 flash launches off the tensor-core path: {paths}")
    if tuple(out.shape) != (B, tokens + 1) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"{phase}: bad generated tokens: shape {tuple(out.shape)}")
    del caches
    record[phase] = row
    fresh = model.init_caches(B, seq + 9, torch.bfloat16, "cuda")
    profile_serve(model, cfg, params, prompts, fresh, out_dir, phase, extra)
    del params, fresh
    torch.cuda.empty_cache()


# (arch, the prefill's other input): internvl2 with its patches through
# dense caches, and its text alone through the tiered ones (the reference's
# tiered loop prefills no patches).
FAMILY_CHECK_CASES = (("grok_1_314b", None), ("deepseek_v3_671b", None), ("gemma3_1b", None), ("command_r_35b", None),
                      ("whisper_large_v3", "frames"), ("internvl2_1b", "patches"), ("internvl2_1b", None))


def serve_check_families_phase(record: dict) -> None:
    """The reduced grok, deepseek, gemma3, command-r, whisper and internvl2
    in fp32 (TF32 off), attn_impl="flash": prefill and 4 decode steps on the
    card against the same port on the CPU (the kernels there, their plain
    versions here), through the tiered caches where the arch takes them
    (gemma3's global layer, every command-r layer at D = 12, internvl2's
    text-only layers at G = 2, D = 14) and the dense ones else (whisper at
    D = 16 after encoding its frames, internvl2 after its patches); at each
    step the logits' max relative error < 1e-4 and the same greedy tokens."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_reduced, make_model
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_tiered_caches
    from repro_torch.nn.module import init_with_axes

    torch.backends.cuda.matmul.allow_tf32 = False
    B, prompt_len, steps, window, page = 2, 40, 4, 16, 8
    rows = []
    for arch, extra in FAMILY_CHECK_CASES:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32", attn_impl="flash", scan_layers=False)
        model = make_model(cfg)
        params = {"cpu": init_with_axes(model.init, 1, device="cpu")[0]}
        params["cuda"] = tree.tree_map(lambda t: t.to("cuda"), params["cpu"])
        rng = np.random.default_rng(1)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, prompt_len)))
        # The GQA self-attention layers (the encoder-decoder's: its decoder's).
        gqa = cfg.n_layers if cfg.encdec is not None else sum(spec.mixer == "gqa" for spec in model.prefix)
        tiered = extra is None and cfg.attn_type == "gqa" and cfg.attn_logit_softcap == 0
        shapes = {"frames": (B, cfg.encdec.n_frames, cfg.d_model) if cfg.encdec else None,
                  "patches": (B, cfg.vlm.n_patches, cfg.vlm.patch_dim) if cfg.vlm else None}
        x = torch.from_numpy(rng.normal(size=shapes[extra]).astype(np.float32)) if extra else None
        n_patches = cfg.vlm.n_patches if extra == "patches" else 0
        logits, toks = {}, {}
        for dev in ("cpu", "cuda"):
            n = n_patches + prompt_len + steps + 1
            caches = (make_tiered_caches(model, cfg, B, n, window, page, torch.float32, dev) if tiered
                      else model.init_caches(B, n, torch.float32, dev))
            ops.reset_launches()
            if extra == "frames":
                lg, caches = model.prefill(params[dev], x.to(dev), prompts.to(dev), caches)
            else:
                kw = {"patches": x.to(dev)} if extra == "patches" else {}
                lg, caches = model.prefill(params[dev], prompts.to(dev), caches, **kw)
            logits[dev], toks[dev] = [lg[:, -1].cpu()], [lg[:, -1].argmax(-1).cpu()]
            for _ in range(steps):
                lg, caches = model.decode_step(params[dev], toks[dev][-1][:, None].to(dev), caches)
                logits[dev].append(lg[:, -1].cpu())
                toks[dev].append(lg[:, -1].argmax(-1).cpu())
            launches, paths = ops.launches(), ops.flash_path_launches()
        rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(logits["cuda"], logits["cpu"])]
        same = [bool(torch.equal(a, b)) for a, b in zip(toks["cuda"], toks["cpu"])]
        want = {"tiered_decode": gqa * steps if tiered else 0, "flash_attention": gqa, "rglru": 0, "mlstm": 0}
        row = dict(arch=cfg.name, inputs=extra or "text", layers=cfg.n_layers, G=cfg.n_heads // cfg.n_kv_heads,
                   D=cfg.resolved_head_dim, caches="tiered" if tiered else "dense", batch=B, prompt_len=prompt_len,
                   steps=steps, logits_rel_err=rel, tokens_equal=same, launches=launches, flash_paths=paths,
                   tokens=[t[0].item() for t in toks["cuda"]])
        emit("serve_check_families", **row)
        if max(rel) >= 1e-4 or not all(same) or launches != want:
            raise AssertionError(f"serve_check_families {arch} ({extra or 'text'}): logits relative error {rel} "
                                 f"(bar 1e-4), tokens equal {same}, launches {launches} (want {want})")
        rows.append(row)
    record["serve_check_families"] = rows


def train_check_families_phase(record: dict) -> None:
    """The training step of the MoE, MLA, encoder-decoder, VLM and recurrent
    families on the card against the same steps on the CPU: reduced
    deepseek (MoE aux + MTP), grok, whisper (with frames), internvl2 (with
    patches), recurrentgemma and xlstm (their plain scans) in fp32, TF32
    off, the same initial params (drawn on the CPU) and 4
    batches of 4 x 64 (and their frames or patches, drawn with them); step
    1's loss within 1e-5 relative, every step's within 1e-4; ce, moe_aux
    and mtp_ce printed; no kernel launched."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_reduced, make_model
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.optim.adamw import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for arch in ("deepseek_v3_671b", "grok_1_314b", "whisper_large_v3", "internvl2_1b", "recurrentgemma_9b",
                 "xlstm_125m"):
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        model = make_model(cfg)
        opt = AdamW(learning_rate=1e-3)
        states = {"cpu": init_state(model, cfg, opt, seed=0, device="cpu")[0]}
        states["cuda"] = tree.tree_map(lambda t: t.to("cuda"), states["cpu"])
        rng = np.random.default_rng(0)
        batches = []
        for _ in range(4):
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 65)))
            batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
            if cfg.encdec is not None:
                batch["frames"] = torch.from_numpy(rng.normal(size=(4, cfg.encdec.n_frames, cfg.d_model)))
            if cfg.vlm is not None:
                batch["patches"] = torch.from_numpy(rng.normal(size=(4, cfg.vlm.n_patches, cfg.vlm.patch_dim)))
            batches.append({k: v.float() if v.is_floating_point() else v for k, v in batch.items()})
        step = make_train_step(model, cfg, opt)
        metrics = {"cpu": [], "cuda": []}
        ops.reset_launches()
        for dev in ("cpu", "cuda"):
            for batch in batches:
                states[dev], m = step(states[dev], {k: v.to(dev) for k, v in batch.items()})
                metrics[dev].append({k: float(m[k]) for k in ("loss", "ce", "moe_aux", "mtp_ce") if k in m})
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(metrics["cuda"], metrics["cpu"])]
        row = dict(arch=cfg.name, dtype="float32", cuda=metrics["cuda"], cpu=metrics["cpu"], losses_rel_apart=rel,
                   launches=ops.launches())
        emit("train_check_families", **row)
        if rel[0] > 1e-5 or max(rel) > 1e-4 or any(ops.launches().values()):
            raise AssertionError(f"train_check_families {arch}: card losses apart from the CPU's by {rel}, "
                                 f"launches {ops.launches()}")
        rows.append(row)
    record["train_check_families"] = rows


# ----------------------------------------------------------------------- train


TRAIN_LAYERS = 2  # depth cut of starcoder2-3b (30 layers): the checkpoint bytes set the phase's time


def train_phase(record: dict, out_dir: Path | None) -> None:
    """starcoder2-3b at full width, cut to TRAIN_LAYERS layers, bf16 compute
    and fp32 masters, through ``repro_torch.launch.train.run_training``
    (batch 8 x seq 1024, 8 steps, sync checkpoints every 4 into a
    ``TwoLevelStore`` under build/): an uninterrupted run, then one that
    loses its host at step 6 and restores step 4; then 2 steps profiled and
    the fp32 LM head's GEMMs timed alone."""
    import tempfile

    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config, make_model
    from repro_torch.core import TwoLevelStore
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import run_training
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.failure import FailureInjector

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, steps, every, fail_at = 8, 1024, 8, 4, 6
    cfg = dataclasses.replace(get_config("starcoder2_3b"), n_layers=TRAIN_LAYERS)
    store_kw = dict(mem_capacity_bytes=256 * 2**20, block_bytes=4 * 2**20)  # the training CLI's store
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    stamps: list[float] = []
    run_kw = dict(total_steps=steps, global_batch=B, seq_len=S, ckpt_every=every, ckpt_mode="sync",
                  device="cuda", on_step=lambda i, m: stamps.append(time.perf_counter()))
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with TwoLevelStore(str(root / "clean"), **store_kw) as st:
            clean = run_training(cfg, st, **run_kw)
        clean_s = time.perf_counter() - t0
        launches = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        # step i's interval ends at its loss; those after a save hold the save
        intervals = [stamps[i] - stamps[i - 1] for i in range(1, steps) if i % every]
        step_s = sorted(intervals)[len(intervals) // 2]
        shutil.rmtree(root / "clean")
        ckpt_bytes = sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes
                         for x in tree.leaves(clean.state))
        n_params = sum(p.numel() for p in tree.leaves(clean.state["params"]))

        ops.reset_launches()
        t0 = time.perf_counter()
        with TwoLevelStore(str(root / "failed"), **store_kw) as st:
            failed = run_training(cfg, st, injector=FailureInjector([fail_at]), **{**run_kw, "on_step": None})
        failed_s = time.perf_counter() - t0
        launches_failed = ops.launches()
        if any(launches.values()) or any(launches_failed.values()):
            raise AssertionError(f"training launched kernels: {launches} / {launches_failed}")
        if failed.restarts != 1 or len(failed.losses) != steps + fail_at - every:
            raise AssertionError(f"restart: {failed.restarts} restarts, {len(failed.losses)} losses")
        loss_apart = max(abs(a - b) / abs(b) for a, b in zip(failed.losses[-(steps - every):],
                                                            clean.losses[-(steps - every):]))
        same_before = failed.losses[:fail_at] == clean.losses[:fail_at]
        param_apart = 0.0
        for a, b in zip(tree.leaves(failed.state["params"]), tree.leaves(clean.state["params"])):
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                raise AssertionError("the restored run's final params differ from the uninterrupted run's")
            param_apart = max(param_apart, float((a - b).abs().max()))
        if loss_apart > 1e-5:
            raise AssertionError(f"restored losses {failed.losses} vs {clean.losses}")
        if not all(map(math.isfinite, clean.losses)):
            raise AssertionError(f"non-finite losses {clean.losses}")

        stalls = clean.stalls
        tokens = B * S
        row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab, params=n_params,
                   batch=B, seq=S, steps=steps, ckpt_every=every, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                   losses=clean.losses, step_s=step_s, step_intervals_s=intervals, tokens_per_s=tokens / step_s,
                   model_tflops=6 * n_params * tokens / step_s / 1e12,
                   peak_device_bytes=peak, run_s=clean_s, failed_run_s=failed_s,
                   data_stall_s=stalls["data_stall_total_s"], ckpt_stall_s=stalls["ckpt_stall_total_s"],
                   save_critical_s=stalls["ckpt_save_critical_s"], saves=steps // every, ckpt_bytes=ckpt_bytes,
                   save_mb_per_s=steps // every * ckpt_bytes / stalls["ckpt_save_critical_s"] / 1e6,
                   restore_s=failed.stalls["ckpt_restore_total_s"], restarts=failed.restarts,
                   restored_losses=failed.losses, restored_losses_apart=loss_apart,
                   losses_before_failure_equal=same_before, restored_params_max_abs_apart=param_apart,
                   loader=clean.loader_stats, launches=launches)
        emit("train", **row)

        model = make_model(cfg)
        step = make_train_step(model, cfg, AdamW(learning_rate=1e-4))
        gen = torch.Generator(device="cuda").manual_seed(0)
        toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device="cuda")
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        box = {"state": clean.state}
        del clean, failed

        def two_steps():
            for _ in range(2):
                box["state"], _ = step(box["state"], batch)

        two_steps()  # warm
        table = out_dir / "profile_train_2_steps.txt" if out_dir else None
        prof = profile_breakdown(two_steps, table, top=8)
        emit("train_profile", part="2_steps", **prof)
        del box, batch
        head = time_head(B * S, cfg.d_model, cfg.vocab)
        emit("train_head", **head, step_s=step_s, share_of_step=head["ms"] / 1e3 / step_s)
        record["train"] = dict(row, profile=prof, head=head)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


RECURRENTGEMMA_TRAIN_LAYERS = 3  # one period (rec, rec, local attn) of 38: 1.7 B params at 16 B each is ~27 GB


def train_recurrentgemma_phase(record: dict, out_dir: Path | None) -> None:
    """recurrentgemma-9b at full width, cut to one period of 3 layers, as
    published (``remat="full"``, bf16 compute, fp32 masters, the plain
    attention and RG-LRU scan), through ``run_training`` (batch 2 x seq
    1024, 4 steps, no checkpoint: one would be ~20 GB) over a
    ``TwoLevelStore`` under build/; step s, tokens/s, model TFLOP/s, peak
    bytes, no kernel launched; then one step profiled."""
    import tempfile

    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config, make_model
    from repro_torch.core import TwoLevelStore
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import run_training
    from repro_torch.optim.adamw import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, steps = 2, 1024, 4
    cfg = dataclasses.replace(get_config("recurrentgemma_9b"), n_layers=RECURRENTGEMMA_TRAIN_LAYERS)
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="train_rg_", dir=ROOT / "build"))
    stamps: list[float] = []
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with TwoLevelStore(str(root), mem_capacity_bytes=256 * 2**20, block_bytes=4 * 2**20) as st:
            res = run_training(cfg, st, total_steps=steps, global_batch=B, seq_len=S, ckpt_every=steps + 1,
                               ckpt_mode="sync", device="cuda", on_step=lambda i, m: stamps.append(time.perf_counter()))
        run_s = time.perf_counter() - t0
        launches = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        intervals = [stamps[i] - stamps[i - 1] for i in range(1, steps)]
        step_s = sorted(intervals)[len(intervals) // 2]
        n_params = sum(p.numel() for p in tree.leaves(res.state["params"]))
        if any(launches.values()) or not all(map(math.isfinite, res.losses)) or len(res.losses) != steps:
            raise AssertionError(f"train_recurrentgemma: launches {launches}, losses {res.losses}")
        tokens = B * S
        row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, lru_width=cfg.recurrent.lru_width,
                   d_ff=cfg.d_ff, vocab=cfg.vocab, remat=cfg.remat, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                   params=n_params, batch=B, seq=S, steps=steps, losses=res.losses, step_s=step_s,
                   step_intervals_s=intervals, tokens_per_s=tokens / step_s,
                   model_tflops=6 * n_params * tokens / step_s / 1e12, peak_device_bytes=peak, run_s=run_s,
                   data_stall_s=res.stalls["data_stall_total_s"], launches=launches)
        emit("train_recurrentgemma", **row)

        step = make_train_step(make_model(cfg), cfg, AdamW(learning_rate=1e-4))
        gen = torch.Generator(device="cuda").manual_seed(0)
        toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device="cuda")
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        box = {"state": res.state}
        del res

        def one_step():
            box["state"], _ = step(box["state"], batch)

        one_step()  # warm
        table = out_dir / "profile_train_recurrentgemma_1_step.txt" if out_dir else None
        prof = profile_breakdown(one_step, table, top=8)
        emit("train_recurrentgemma_profile", part="1_step", **prof)
        del box, batch
        record["train_recurrentgemma"] = dict(row, profile=prof)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


XLSTM_TRAIN_SEQ = 64  # the sLSTM's gradient grows ~1.45x a step back in time at full width: NaN by 256


def train_xlstm_phase(record: dict) -> None:
    """xlstm-125m at full size (12 layers), ``remat="full"``, bf16 compute,
    through ``run_training`` (batch 16 x seq XLSTM_TRAIN_SEQ, 8 steps, sync
    saves every 4) over host 1's shard of a ``DistributedStore`` under build/, opened as
    the training CLI opens it with ``--distributed``: an uninterrupted run,
    then one that loses its host at step 6 and restores step 4 (losses and
    final params equal to the uninterrupted run's at rtol 1e-5 / atol 1e-6);
    the shard's stats, save MB/s, restore s, step s, peak bytes, no kernel
    launched."""
    import tempfile

    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import DistributedStore
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_training
    from repro_torch.runtime.failure import FailureInjector

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, steps, every, fail_at = 16, XLSTM_TRAIN_SEQ, 8, 4, 6
    cfg = get_config("xlstm_125m")
    store_kw = dict(mem_capacity_bytes=256 * 2**20, block_bytes=4 * 2**20)  # the training CLI's store
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="train_xlstm_", dir=ROOT / "build"))
    stamps: list[float] = []
    run_kw = dict(total_steps=steps, global_batch=B, seq_len=S, ckpt_every=every, ckpt_mode="sync", device="cuda")

    def run(sub: str, **kw):
        dstore = DistributedStore(1, str(root / sub), lease_ttl_s=5.0, **store_kw)
        try:
            return run_training(cfg, dstore.store, **run_kw, **kw), dataclasses.asdict(dstore.stats)
        finally:
            dstore.close()

    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        clean, dstats = run("clean", on_step=lambda i, m: stamps.append(time.perf_counter()))
        clean_s = time.perf_counter() - t0
        launches = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        intervals = [stamps[i] - stamps[i - 1] for i in range(1, steps) if i % every]
        step_s = sorted(intervals)[len(intervals) // 2]
        ckpt_bytes = sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes
                         for x in tree.leaves(clean.state))
        n_params = sum(p.numel() for p in tree.leaves(clean.state["params"]))

        ops.reset_launches()
        t0 = time.perf_counter()
        failed, dstats_failed = run("failed", injector=FailureInjector([fail_at]))
        failed_s = time.perf_counter() - t0
        launches_failed = ops.launches()
        if any(launches.values()) or any(launches_failed.values()):
            raise AssertionError(f"training launched kernels: {launches} / {launches_failed}")
        if failed.restarts != 1 or len(failed.losses) != steps + fail_at - every:
            raise AssertionError(f"restart: {failed.restarts} restarts, {len(failed.losses)} losses")
        loss_apart = max(abs(a - b) / abs(b) for a, b in zip(failed.losses[-(steps - every):],
                                                            clean.losses[-(steps - every):]))
        apart = {tree.keystr(k): float((a - b).abs().max()) for (k, a), b in
                 zip(tree.flatten_with_path(failed.state["params"]), tree.leaves(clean.state["params"]))}
        worst = max(apart, key=apart.get)
        params_close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in
                           zip(tree.leaves(failed.state["params"]), tree.leaves(clean.state["params"])))
        if not params_close or loss_apart > 1e-5 or not all(map(math.isfinite, clean.losses)):
            raise AssertionError(f"train_xlstm: the restored run's params {'equal' if params_close else 'differ'} "
                                 f"(largest gap {apart[worst]} at {worst}); losses {failed.losses} vs "
                                 f"{clean.losses} ({loss_apart} apart)")
        param_apart = apart[worst]
        stalls = clean.stalls
        tokens = B * S
        row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab, remat=cfg.remat,
                   dtype=cfg.dtype, param_dtype=cfg.param_dtype, params=n_params, batch=B, seq=S, steps=steps,
                   ckpt_every=every, losses=clean.losses, step_s=step_s, step_intervals_s=intervals,
                   tokens_per_s=tokens / step_s, model_tflops=6 * n_params * tokens / step_s / 1e12,
                   peak_device_bytes=peak, run_s=clean_s, failed_run_s=failed_s,
                   ckpt_stall_s=stalls["ckpt_stall_total_s"], save_critical_s=stalls["ckpt_save_critical_s"],
                   saves=steps // every, ckpt_bytes=ckpt_bytes,
                   save_mb_per_s=steps // every * ckpt_bytes / stalls["ckpt_save_critical_s"] / 1e6,
                   restore_s=failed.stalls["ckpt_restore_total_s"], restarts=failed.restarts,
                   restored_losses=failed.losses, restored_losses_apart=loss_apart,
                   restored_params_max_abs_apart=param_apart, dstore=dstats, dstore_failed=dstats_failed,
                   launches=launches)
        emit("train_xlstm", **row)
        record["train_xlstm"] = row
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def compress_phase(record: dict) -> None:
    """``topk_compress_with_ef`` at ratio 0.01 over a full xlstm-125m
    gradient tree (drawn once from seed 0 on the CPU), 3 rounds with error
    feedback on the card and on the CPU: sent values and residuals equal bit
    for bit (the k-th value is exact); elements sent and ms a round."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config, make_model
    from repro_torch.nn.module import init_with_axes
    from repro_torch.optim import topk_compress_with_ef

    ratio, rounds = 0.01, 3
    model = make_model(get_config("xlstm_125m"))
    gen = torch.Generator().manual_seed(0)
    grads = tree.tree_map(lambda p: torch.randn(p.shape, generator=gen) * 1e-3,
                          init_with_axes(model.init, 0, device="cpu")[0])
    out = {}
    for dev in ("cpu", "cuda"):
        g = tree.tree_map(lambda t: t.to(dev), grads)
        ef, sent_rounds, ms = None, [], []
        for _ in range(rounds):
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            sent, ef, stats = topk_compress_with_ef(g, ef, ratio)
            if dev == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            sent_rounds.append((tree.leaves(sent), tree.leaves(ef)))
        out[dev] = dict(rounds=sent_rounds, ms=ms, stats=stats)
    equal = all(torch.equal(a.cpu(), b) for (sc, ec), (sp, ep) in zip(out["cuda"]["rounds"], out["cpu"]["rounds"])
                for a, b in zip(sc + ec, sp + ep))
    masks = [sum(int(torch.count_nonzero(t)) for t in sc) for sc, _ in out["cuda"]["rounds"]]
    row = dict(arch="xlstm-125m", ratio=ratio, rounds=rounds, leaves=len(tree.leaves(grads)),
               elements_total=out["cuda"]["stats"]["elements_total"],
               elements_sent=out["cuda"]["stats"]["elements_sent"], mask_elements_by_round=masks,
               cuda_ms_by_round=out["cuda"]["ms"], cpu_ms_by_round=out["cpu"]["ms"],
               cuda_equals_cpu_bitwise=equal)
    emit("compress", **row)
    if not equal or out["cuda"]["stats"] != out["cpu"]["stats"]:
        raise AssertionError("compression on the card differs from the CPU's")
    record["compress"] = row
    del out
    torch.cuda.empty_cache()


def time_head(rows: int, d: int, vocab: int) -> dict:
    """The tied fp32 LM head alone, as training runs it (TF32 off): logits =
    x @ table.T forward, and both gradients backward — three fp32 GEMMs of
    2*rows*d*vocab flops each — timed with CUDA events."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(rows, d, generator=gen, device="cuda").requires_grad_()
    w = (torch.randn(vocab, d, generator=gen, device="cuda") * 0.02).requires_grad_()
    g = torch.randn(rows, vocab, generator=gen, device="cuda")

    def fwd_bwd():
        (x @ w.T).backward(g)

    ms = time_ms(fwd_bwd, iters=5, warmup=1)
    flops = 3 * 2 * rows * d * vocab
    bound_ms, bound_by = bound(4 * (rows * d + vocab * d + rows * vocab) * 2, flops, "float32")
    return dict(rows=rows, d=d, vocab=vocab, ms=ms, tflops=flops / ms / 1e9, bound_ms=bound_ms, bound_by=bound_by)


def train_check_phase(record: dict) -> None:
    """The training step on the card against the same steps of the port on
    the CPU: reduced starcoder2 in fp32, TF32 off, the same initial params
    (drawn on the CPU) and batches; every parameter's gradient after step 1
    finite and non-zero; the four kernel ops refusing CUDA inputs that
    require grad; a checkpoint of the card's state restoring on the CPU
    bit-identical."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_reduced, make_model
    from repro_torch.core import TwoLevelStore
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_state, make_loss_fn, make_train_step
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("starcoder2_3b"), dtype="float32")
    model = make_model(cfg)
    opt = AdamW(learning_rate=1e-3)
    cpu_state, _ = init_state(model, cfg, opt, seed=0, device="cpu")
    cuda_state = tree.tree_map(lambda t: t.to("cuda"), cpu_state)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (4, 65))) for _ in range(4)]

    tracked = tree.tree_map(lambda p: p.detach().requires_grad_(), cuda_state["params"])
    loss, _ = make_loss_fn(model, cfg)(tracked, {"inputs": batches[0][:, :-1].cuda(), "labels": batches[0][:, 1:].cuda()})
    loss.backward()
    bad = [tree.keystr(path) for path, p in tree.flatten_with_path(tracked)
           if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.abs().sum() > 0)]
    if bad:
        raise AssertionError(f"parameters without a finite non-zero gradient: {bad}")
    del tracked

    step = make_train_step(model, cfg, opt)
    losses = {"cpu": [], "cuda": []}
    states = {"cpu": cpu_state, "cuda": cuda_state}
    for dev in ("cpu", "cuda"):
        for toks in batches:
            toks = toks.to(dev)
            states[dev], m = step(states[dev], {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
            losses[dev].append(float(m["loss"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    if rel[0] > 1e-5 or max(rel) > 1e-4:
        raise AssertionError(f"card losses {losses['cuda']} vs CPU {losses['cpu']}")

    refused = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *sh: torch.randn(sh, generator=g, device="cuda").requires_grad_()
    calls = {
        "flash_attention": lambda: ops.flash_attention(rnd(1, 2, 16, 32), rnd(1, 2, 16, 32), rnd(1, 2, 16, 32)),
        "tiered_decode": lambda: ops.tiered_decode_attention(rnd(1, 2, 1, 32), rnd(1, 2, 8, 32), rnd(1, 2, 8, 32),
                                                             rnd(1, 2, 16, 32), rnd(1, 2, 16, 32), 8, 16),
        "rglru": lambda: ops.rglru_scan(torch.rand(1, 16, 32, device="cuda"), rnd(1, 16, 32)),
        "mlstm": lambda: ops.mlstm_chunkwise(rnd(1, 1, 16, 32), rnd(1, 1, 16, 32), rnd(1, 1, 16, 32),
                                             rnd(1, 1, 16), rnd(1, 1, 16)),
    }
    ops.reset_launches()
    for name, call in calls.items():
        try:
            call()
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "no backward" in str(e)
    if not all(refused.values()) or any(ops.launches().values()):
        raise AssertionError(f"kernel ops under autograd: refused {refused}, launches {ops.launches()}")

    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_check_", dir=ROOT / "build")
    try:
        with TwoLevelStore(root) as st:
            CheckpointManager(st, tag="t").save(4, states["cuda"])
        with TwoLevelStore(root) as st:
            _, back = CheckpointManager(st, tag="t").restore(tree.tree_map(torch.zeros_like, cpu_state))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bit_identical = all(torch.equal(a, b.cpu()) and a.device.type == "cpu"
                        for a, b in zip(tree.leaves(back), tree.leaves(states["cuda"])))
    if not bit_identical:
        raise AssertionError("the card's checkpoint did not restore bit-identical on the CPU")
    row = dict(arch=cfg.name, dtype="float32", cuda_losses=losses["cuda"], cpu_losses=losses["cpu"],
               losses_rel_apart=rel, grads_finite_nonzero=True, ops_refused=refused,
               checkpoint_cuda_to_cpu_bit_identical=bit_identical)
    emit("train_check", **row)
    record["train_check"] = row


# ------------------------------------------------------------------- mesh


@contextlib.contextmanager
def card_mesh():
    """A one-rank NCCL process group (``file://`` rendezvous under build/) and
    a 1 x 1 ``("data", "model")`` DeviceMesh on the card; both torn down
    after.  There is no fallback: NCCL failing to start fails the phase."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import _mk

    (ROOT / "build").mkdir(exist_ok=True)
    rendezvous = Path(tempfile.mkdtemp(prefix="pg_", dir=ROOT / "build")) / "init"
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=0, world_size=1)
    try:
        yield _mk((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous.parent, ignore_errors=True)


def mesh_train_phase(record: dict) -> None:
    """The train phase's configuration (starcoder2-3b at full width, 2 of 30
    layers, ``remat="full"``, batch 8 x 1024) on a 1 x 1 mesh: 3 steps of
    ``make_sharded_train_step`` on ``shard_state``'s DTensor state against 3
    plain steps from the same init, interleaved; losses and every state
    leaf equal to the bit (or, where a leaf differs, within 1e-6 of its
    largest value, the leaf named); both step times."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config, make_model
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    B, T, steps = 8, 1024, 3
    cfg = dataclasses.replace(get_config("starcoder2_3b"), n_layers=TRAIN_LAYERS)
    if cfg.remat != "full":
        raise AssertionError(f"starcoder2-3b's remat is {cfg.remat!r}")
    model = make_model(cfg)
    opt = AdamW(learning_rate=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (B, T + 1), generator=gen, device="cuda")
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    with card_mesh() as mesh:
        state, axes = S.init_state(model, cfg, opt, seed=0, device="cuda")
        sh = S.state_shardings(state, axes, mesh)
        dstate = S.shard_state(tree.tree_map(torch.clone, state), sh)
        dbatch = S.shard_state(batch, S.batch_shardings(batch, mesh))
        plain_step = S.make_train_step(model, cfg, opt)
        mesh_step = S.make_sharded_train_step(model, cfg, opt, sh)
        losses = {"plain": [], "mesh": []}
        seconds = {"plain": [], "mesh": []}
        ops.reset_launches()
        for _ in range(steps):
            for name in ("plain", "mesh"):
                t0 = time.perf_counter()
                if name == "plain":
                    state, m = plain_step(state, batch)
                else:
                    dstate, m = mesh_step(dstate, dbatch)
                loss = float(m["loss"])
                seconds[name].append(time.perf_counter() - t0)
                losses[name].append(loss)
        launches = ops.launches()
        worst = ("", 0.0)
        unequal = 0
        for (path, a), (_, b) in zip(tree.flatten_with_path(dstate), tree.flatten_with_path(state)):
            a = a.full_tensor()
            if not torch.equal(a, b):
                unequal += 1
                gap = float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))
                worst = max(worst, ("/".join(path), gap), key=lambda w: w[1])
        placements = sorted({str(x.placements) for x in tree.leaves(dstate)})
    # Each run's steps after its first (which builds the step's caches):
    # the samples themselves, too few for a median.
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=B, seq=T, steps=steps, remat=cfg.remat, mesh="1x1",
               backend="nccl", losses=losses, losses_equal=losses["plain"] == losses["mesh"],
               leaves_unequal=unequal, worst_leaf=worst[0], worst_leaf_rel_gap=worst[1],
               first_step_s={k: v[0] for k, v in seconds.items()},
               plain_step_s=seconds["plain"][1:], mesh_step_s=seconds["mesh"][1:],
               placements=placements, launches=launches)
    emit("mesh_train", **row)
    if any(launches.values()):
        raise AssertionError(f"training launched kernels: {launches}")
    if not all(map(math.isfinite, losses["mesh"])):
        raise AssertionError(f"non-finite losses {losses}")
    if worst[1] > 1e-6 or max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["plain"])) > 1e-6:
        raise AssertionError(f"the mesh steps left the plain ones: {row}")
    record["mesh_train"] = row
    del state, dstate
    torch.cuda.empty_cache()


RESTORE_LAYERS = 2  # of qwen3-8b's 36: the checkpoint is the embedding, the fp32 head and 2 layers


def restore_sharded_serve_phase(record: dict) -> None:
    """qwen3-8b at full width, 2 of 36 layers, bf16 matrices and the fp32 head
    as ``serve`` draws them: the params saved through ``CheckpointManager``
    into a ``TwoLevelStore`` under build/, ``restore_sharded`` onto the
    card's 1 x 1 mesh with ``state_shardings(...)["params"]`` from a meta
    template, then served from the restored leaves' local tensors through
    ``tiered_serve_loop`` (batch 4, prompt 1024, 64 new tokens, kv window
    256, page 128; counted: 2 x 64 tiered and 2 flash launches); the
    restored leaves equal the saved ones to the byte, and the tokens and
    prefill logits those served from the original params."""
    import tempfile

    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config, make_model
    from repro_torch.core import TwoLevelStore
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.launch.serve import init_params
    from repro_torch.nn.layers import cdtype
    from repro_torch.nn.module import init_with_axes, matrix_cast
    from repro_torch.runtime import CheckpointManager

    B, prompt_len, tokens, window, page = 4, 1024, 64, 256, 128
    cfg = dataclasses.replace(get_config("qwen3_8b"), n_layers=RESTORE_LAYERS, attn_impl="flash",
                              scan_layers=False)
    model = make_model(cfg)
    params = init_params(model, seed=0, device="cuda")
    template, axes = init_with_axes(model.init, 0, device="meta", cast=matrix_cast(cdtype(cfg), ("head",)))
    nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    prompts = torch.randint(0, cfg.vocab, (B, prompt_len), generator=torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="restore_", dir=ROOT / "build"))
    try:
        with card_mesh() as mesh, TwoLevelStore(str(root), mem_capacity_bytes=256 * 2**20,
                                                 block_bytes=4 * 2**20) as st:
            cm = CheckpointManager(st, tag="serve", mode="sync")
            t0 = time.perf_counter()
            cm.save(0, params)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            step, restored = cm.restore_sharded(template, S.state_shardings({"params": template}, axes,
                                                                            mesh)["params"])
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            placements = sorted({str(x.placements) for x in tree.leaves(restored)})
            local = tree.tree_map(lambda x: x.to_local(), restored)
        del restored
        same = [torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(tree.leaves(local), tree.leaves(params))]

        torch.cuda.synchronize()
        ops.reset_launches()
        got, prefill_s, decode_s, _ = S.tiered_serve_loop(model, cfg, local, prompts, tokens, window=window,
                                                          page=page)
        launches, paths = ops.launches(), ops.flash_path_launches()
        want, _, _, _ = S.tiered_serve_loop(model, cfg, params, prompts, tokens, window=window, page=page)
        logits = [model.prefill(p, prompts, S.make_tiered_caches(model, cfg, B, prompt_len + 1, window, page,
                                                                torch.bfloat16, "cuda"))[0].float()
                  for p in (local, params)]
        logits_gap = float((logits[0] - logits[1]).abs().max() / logits[1].abs().max())
        row = dict(arch=cfg.name, layers=cfg.n_layers, batch=B, prompt_len=prompt_len, tokens=tokens,
                   kv_window=window, kv_page=page, ckpt_bytes=nbytes, step=step, save_s=save_s,
                   save_mb_per_s=nbytes / save_s / 1e6, restore_s=restore_s, restore_mb_per_s=nbytes / restore_s / 1e6,
                   placements=placements, leaves=len(same), leaves_equal=sum(same),
                   tokens_equal=bool(torch.equal(got, want)), logits_rel_gap=logits_gap, prefill_s=prefill_s,
                   decode_tok_per_s=B * tokens / decode_s, launches=launches, flash_paths=paths)
        emit("restore_sharded_serve", **row)
        want_launches = {"tiered_decode": cfg.n_layers * tokens, "flash_attention": cfg.n_layers, "rglru": 0,
                         "mlstm": 0}
        if launches != want_launches:
            raise AssertionError(f"launch counts {launches} != {want_launches}")
        if paths != {"tensor_core": cfg.n_layers, "cuda_core": 0}:
            raise AssertionError(f"bf16 flash launches off the tensor-core path: {paths}")
        if not all(same) or not row["tokens_equal"] or logits_gap > 1e-6 or step != 0:
            raise AssertionError(f"the restored params serve otherwise: {row}")
        record["restore_sharded_serve"] = row
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


DRYRUN_TIMEOUT_S = 900  # the cells take ~3 min on the card's host, alone
DRYRUN_CELLS = [(arch, shape, multi) for arch, shape in (("qwen3_8b", "train_4k"), ("deepseek_v3_671b", "decode_32k"))
                for multi in (False, True)] + [("xlstm_125m", "train_4k", False)]


def dryrun_cells() -> None:
    """``run_cell``'s record of each of ``DRYRUN_CELLS``, one JSON line each
    (what ``start_dryrun``'s process prints)."""
    from repro_torch.launch.dryrun import run_cell

    for arch, shape, multi in DRYRUN_CELLS:
        print(json.dumps(run_cell(arch, shape, multi)), flush=True)


def start_dryrun(logs: Path) -> subprocess.Popen:
    """``dryrun_cells`` in a process of its own, its output in ``logs``
    (files: a pipe left unread would stall it).  The dry-run runs on the
    host's CPU on meta tensors and never touches the card, so it overlaps
    the card's phases instead of adding minutes to the script."""
    logs.mkdir(parents=True, exist_ok=True)
    with open(logs / "dryrun.out", "w") as out, open(logs / "dryrun.err", "w") as err:
        return subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.dryrun_cells()"], cwd=ROOT,
                                stdout=out, stderr=err)


def dryrun_phase(record: dict, proc: subprocess.Popen, logs: Path) -> None:
    """``repro_torch.launch.dryrun.run_cell`` (meta tensors; the step run
    once on DTensors over a fake process group of the production world
    size, in ``start_dryrun``'s process) for qwen3-8b ``train_4k`` and deepseek-v3-671b
    ``decode_32k`` on the 16x16 and 2x16x16 meshes: per-device bytes of the
    arguments and of the step's temporaries beside this card's memory, the
    collectives one device issues (bytes by type, their total), and the
    step's dot FLOPs per device and whole.  No collective of qwen3's step
    may carry a (B_local, S, V) fp32 tensor: the vocab stays split; and a
    device's dot FLOPs of it are at most 1.02 times the whole step's over
    the devices (every product split).  xlstm-125m ``train_4k`` on 16x16,
    a recurrent cell, has its per-device counts from a fit in the sequence
    length; its 4 heads do not divide over the 16-way model axis, and each
    device steps its share of every head's cells, as the reference's
    partitioner splits them: its dot FLOPs at most 1.05 times its share, at
    most 141 GB of temporaries (1.5 times the reference's 94.3 GB) and 67.1
    GB of collectives (the reference's) a device a step."""
    import torch

    from repro_torch.configs import SHAPES, get_config

    if proc.wait(timeout=DRYRUN_TIMEOUT_S) != 0:
        raise AssertionError(f"the dry-run process exited {proc.returncode}: "
                             f"{(logs / 'dryrun.err').read_text()[-3000:]}")
    records = [json.loads(line) for line in (logs / "dryrun.out").read_text().splitlines() if line.startswith("{")]
    if len(records) != len(DRYRUN_CELLS):
        raise AssertionError(f"{len(records)} dry-run records for {len(DRYRUN_CELLS)} cells")
    card = torch.cuda.get_device_properties(0).total_memory
    rows = []
    for r in records:
        arch, shape = r["arch"], r["shape"]
        mem, coll = r["memory"], r["collectives"]
        per_device = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        row = dict(arch=arch, shape=shape, mesh=r["mesh"], n_devices=r["n_devices"], memory=mem,
                   argument_size_in_bytes=mem["argument_size_in_bytes"],
                   temp_size_in_bytes=mem["temp_size_in_bytes"], per_device_bytes=per_device, card_bytes=card,
                   fits_card=per_device <= card, collectives=coll["bytes_by_type"],
                   collective_counts=coll["counts"], collective_total_bytes=coll["total_bytes"],
                   collective_largest_bytes=coll["largest_bytes"], dot_flops=r["dot_flops"],
                   global_dot_flops=r["global_dot_flops"],
                   dot_flops_share=r["dot_flops"] / (r["global_dot_flops"] / r["n_devices"]),
                   dot_flops_from=r["dot_flops_from"], param_count=r["param_count"], seconds=r["account_s"])
        emit("dryrun", **row)
        if per_device <= 0 or not 0 < r["dot_flops"] <= r["global_dot_flops"] or coll["total_bytes"] <= 0:
            raise AssertionError(f"empty dry-run record: {row}")
        if arch == "qwen3_8b" and row["dot_flops_share"] > 1.02:
            raise AssertionError(f"a device computes more than its share of the step: {row}")
        if arch == "xlstm_125m" and not r["dot_flops_from"].startswith("seq fit"):
            raise AssertionError(f"the recurrent cell was not fitted: {row}")
        if arch == "xlstm_125m" and (row["dot_flops_share"] > 1.05 or mem["temp_size_in_bytes"] > 141e9
                                     or coll["total_bytes"] > 67.1e9):
            raise AssertionError(f"a device computes, holds or sends more than the reference's split: {row}")
        if arch == "qwen3_8b":
            cell, cfg = SHAPES[shape], get_config(arch)
            dp = r["n_devices"] // 16  # the model axis is 16 on both meshes
            logits = cell.global_batch // dp * cell.seq_len * cfg.vocab * 4
            if max(coll["largest_bytes"].values()) >= logits:
                raise AssertionError(f"a collective carries the {logits} B of a device's logits: {row}")
        rows.append(row)
    record["dryrun"] = rows


TERASORT_RECORDS = 2_000_000  # 100-byte records: 200 MB through each storage mode
TERASORT_MODES = ("tls", "ofs", "mem")  # benchmarks/fig7_terasort.py's storage organisations


def terasort_phase(record: dict, smi: str) -> None:
    """TeraGen, TeraSort and TeraValidate through the port's ``apps`` and
    ``core`` on this machine's host (numpy and the host's disk; the card
    is idle) in the three storage modes of ``benchmarks/fig7_terasort.py``:
    ``tls`` (write-through, tiered reads), ``ofs`` (PFS bypass) and ``mem``
    (memory only), each in a fresh store under build/.  TeraValidate
    passes, and the output's sorted keys equal a numpy sort of the
    generated records' (SHA-256 of both); each phase's seconds and MB/s."""
    import hashlib
    import tempfile
    from importlib import import_module

    import numpy as np

    from repro_torch.apps.shuffle import fold_keys
    from repro_torch.core.store import ReadMode, TwoLevelStore, WriteMode

    ts = import_module("repro_torch.apps.terasort")  # the package exports a function of that name
    modes = {"tls": (WriteMode.WRITE_THROUGH, ReadMode.TIERED, WriteMode.WRITE_THROUGH),
             "ofs": (WriteMode.PFS_BYPASS, ReadMode.PFS_BYPASS, WriteMode.PFS_BYPASS),
             "mem": (WriteMode.MEMORY_ONLY, ReadMode.MEMORY_ONLY, WriteMode.MEMORY_ONLY)}
    n, shards, workers = TERASORT_RECORDS, 4, 4
    mb = n * ts.RECORD / 2**20
    (ROOT / "build").mkdir(exist_ok=True)
    rows = []
    for label in TERASORT_MODES:
        wgen, rmap, wred = modes[label]
        with tempfile.TemporaryDirectory(prefix="terasort_", dir=ROOT / "build") as d:
            with TwoLevelStore(str(Path(d) / "pfs"), mem_capacity_bytes=1 << 30, block_bytes=2 << 20,
                               stripe_bytes=512 << 10, n_pfs_servers=4, io_workers=workers) as st:
                gen_s = ts.teragen(st, n, n_shards=shards, write_mode=wgen, workers=workers)
                t = ts.terasort(st, n_shards=shards, n_reducers=shards, read_mode=rmap, write_mode=wred,
                                label=label, workers=workers)
                valid = ts.teravalidate(st, shards, read_mode=rmap)
                keys = {}
                for part, name in (("generated", ts._shard_name), ("sorted", ts._out_name)):
                    raw = b"".join(st.get(name(i), mode=rmap) for i in range(shards))
                    keys[part] = fold_keys(np.frombuffer(raw, dtype=np.uint8).reshape(-1, ts.RECORD), ts.KEY)
                digests = {"numpy_sort": hashlib.sha256(np.sort(keys["generated"]).tobytes()).hexdigest(),
                           "terasort": hashlib.sha256(keys["sorted"].tobytes()).hexdigest()}
        row = dict(mode=label, records=t.records, mb=mb, gen_s=gen_s, map_s=t.map_s, shuffle_s=t.shuffle_s,
                   reduce_s=t.reduce_s, sort_s=t.sort_s, validate_s=t.validate_s, gen_mbps=mb / gen_s,
                   sort_mbps=mb / t.sort_s, validate_mbps=mb / t.validate_s, shuffle_mbps=t.shuffle_mbps,
                   mem_hit_rate=t.mem_hit_rate, spill_files=t.spill_files, spill_bytes=t.spill_bytes,
                   merge_runs_max=t.merge_runs_max, teravalidate=valid, digests=digests, nvidia_smi=smi,
                   host="the card machine's CPU and disk")
        emit("terasort", **row)
        if not valid or t.records != n or digests["numpy_sort"] != digests["terasort"]:
            raise AssertionError(f"TeraSort through the {label} mode is wrong: {row}")
        rows.append(row)
    record["terasort"] = rows


# ------------------------------------------------------------------------- main


SERVE_PHASES = ("serve", "serve_store", "serve_sessions", "serve_recurrentgemma", "serve_xlstm", "serve_grok",
                "serve_deepseek", "serve_gemma3", "serve_whisper", "serve_internvl2", "restore_sharded_serve")


def kernels_line(record: dict) -> dict:
    """One entry per kernel: its launches summed over the serve phases (each
    counted from zero; ``launches_by_phase`` splits them), its largest error
    over all its cases, and the times and bound of its first case, the
    shape its main path gives it."""
    out = []
    rows_by_phase = {p: record[p]["rows_launches"] for p in SERVE_PHASES if record[p].get("rows_launches")}
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
                         shapes_run=sorted({(r["G"], r["D"]) for r in rows}),
                         rows_launches_by_phase=rows_by_phase)
        if name == "mlstm":
            entry.update(tile_v=main["tile_v"], blocks=main["blocks"],
                         grids_by_phase={p: record[p]["mlstm_grids"] for p in by_phase})
        if name == "flash_attention":
            entry.update(path=main["path"], library_masked_ms=main["library_masked_ms"],
                         tensor_core_launches=sum(record[p]["flash_paths"]["tensor_core"] for p in SERVE_PHASES))
        out.append(entry)
    # The expert share's product: launches from its own phase (no serve
    # phase runs an expert share).
    rows = record["moe_grouped"]
    out.append(dict(name="moe_grouped", route="cuda", source="src/repro_torch/csrc/moe_grouped.cu",
                    replaces=None, stands_for="the capacity-padded MoE einsum of src/repro/nn/layers.py (no Pallas kernel)",
                    launches=sum(r["launches"] for r in rows), max_abs_err=max(r["max_abs_err"] for r in rows),
                    ms=[r["ms"] for r in rows], plain_ms=[r["plain_ms"] for r in rows],
                    bound_ms=[r["bound_ms"] for r in rows], bound_by=[r["bound_by"] for r in rows], library_ms=None))
    # The per-row entry of the same source: one launch a layer a session
    # decode step, standing in for the JAX session plane's vmapped oracle.
    rows = record["tiered_decode_rows"]
    main = rows[0]
    out.insert(1, dict(name="tiered_decode_rows", route="cuda", source="src/repro_torch/csrc/tiered_decode.cu",
                       replaces="src/repro/kernels/tiered_decode.py:133",
                       stands_for="src/repro/serving/scheduler.py:64 (jax.vmap of the oracle, no Pallas kernel)",
                       launches=sum(rows_by_phase.values()), launches_by_phase=rows_by_phase,
                       max_abs_err=max(r["max_abs_err"] for r in rows), ms=main["ms"], plain_ms=main["plain_ms"],
                       bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=main["library_ms"],
                       single_row_launches_ms=main["single_row_launches_ms"]))
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
    t_start = t0 = time.perf_counter()
    paths = ops.build()
    logs = ROOT / "build" / "chip_smoke"
    dryrun = start_dryrun(logs)
    emit("build", seconds=time.perf_counter() - t0, arch="sm_90a",
         libraries={n: str(p.relative_to(ROOT)) for n, p in paths.items()})
    if out_dir:
        for p in paths.values():
            log = p.with_suffix(".log")
            if log.exists():
                shutil.copy(log, out_dir / f"ptxas_{p.stem}.log")
    phases = [
        ("tiered_decode", lambda: tiered_decode_phase(record)),
        ("tiered_decode_rows", lambda: tiered_rows_phase(record)),
        ("flash", lambda: flash_phase(record)),
        ("rglru", lambda: rglru_phase(record)),
        ("mlstm", lambda: mlstm_phase(record)),
        ("moe_grouped", lambda: moe_grouped_phase(record)),
        ("serve", lambda: serve_phase(record, out_dir)),
        ("serve_check", lambda: serve_check_phase(record)),
        ("serve_store", lambda: serve_store_phase(record)),
        ("serve_sessions", lambda: serve_sessions_phase(record, out_dir)),
        ("serve_sessions_check", lambda: serve_sessions_check_phase(record)),
        ("serve_recurrentgemma", lambda: recurrent_serve_phase(record, out_dir, "recurrentgemma_9b", B=4,
                                                               prompt_len=4096, tokens=64)),
        ("serve_xlstm", lambda: recurrent_serve_phase(record, out_dir, "xlstm_125m", B=4, prompt_len=2048, tokens=64,
                                                      profile_len=256)),
        ("serve_check_recurrentgemma", lambda: recurrent_serve_check_phase(record, "recurrentgemma_9b", B=2,
                                                                           prompt_len=2100, tokens=16)),
        ("serve_check_xlstm", lambda: recurrent_serve_check_phase(record, "xlstm_125m", B=2, prompt_len=16,
                                                                  tokens=8)),
        ("serve_grok", lambda: family_serve_phase(record, out_dir, "serve_grok", "grok_1_314b", n_layers=2,
                                                  prompt_len=1024, tokens=32)),
        ("serve_deepseek", lambda: family_serve_phase(record, out_dir, "serve_deepseek", "deepseek_v3_671b",
                                                      n_layers=4, prompt_len=1024, tokens=32)),
        ("serve_gemma3", lambda: family_serve_phase(record, out_dir, "serve_gemma3", "gemma3_1b", n_layers=26,
                                                    prompt_len=2048, tokens=64, window=256, page=128)),
        ("serve_whisper", lambda: multimodal_serve_phase(record, out_dir, "serve_whisper", "whisper_large_v3",
                                                         prompt_len=224, tokens=64)),
        ("serve_internvl2", lambda: multimodal_serve_phase(record, out_dir, "serve_internvl2", "internvl2_1b",
                                                           prompt_len=768, tokens=64)),
        ("serve_check_families", lambda: serve_check_families_phase(record)),
        ("train", lambda: train_phase(record, out_dir)),
        ("train_check", lambda: train_check_phase(record)),
        ("train_check_families", lambda: train_check_families_phase(record)),
        ("train_recurrentgemma", lambda: train_recurrentgemma_phase(record, out_dir)),
        ("train_xlstm", lambda: train_xlstm_phase(record)),
        ("compress", lambda: compress_phase(record)),
        ("mesh_train", lambda: mesh_train_phase(record)),
        ("restore_sharded_serve", lambda: restore_sharded_serve_phase(record)),
        ("dryrun", lambda: dryrun_phase(record, dryrun, logs)),
        ("terasort", lambda: terasort_phase(record, smi)),
    ]
    seconds = {}
    try:
        for name, run in phases:
            t0 = time.perf_counter()
            run()
            seconds[name] = time.perf_counter() - t0
    finally:
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.wait()
    emit("phase_seconds", **seconds, total=time.perf_counter() - t_start)
    print(json.dumps(kernels_line(record)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
