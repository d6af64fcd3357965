#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line (``{"phase": ...}``):

1. device        the card's name, and its name and power limit from nvidia-smi
2. build         both CUDA kernels built by nvcc for sm_90a from src/repro_torch/csrc
3. tiered_decode the decode kernel against its plain version at the serving
                 shape (B=4, H=32, KV=8, D=128, W=256, C=1024) and at the edge
                 cases, each in bf16 and again in fp32; error, kernel / plain /
                 SDPA ms and the bound
4. flash         the flash kernel against its plain version at S=T=1024 causal,
                 T > S, window 64, softcap 30 and ragged S=200, each in bf16
                 and again in fp32
5. serve         qwen3-8b at full width and depth, attn_impl="flash", through
                 ``repro_torch.launch.steps.tiered_serve_loop`` (batch 4, prompt
                 1024, 64 new tokens, kv window 256, page 128); the kernels'
                 launch counts are zeroed just before and read just after
6. serve_check   2 layers at full width in fp32: greedy tokens through the
                 kernels equal tokens through the plain versions
7. kernels       one entry per kernel: launches in phase 5, max error, times, bound

Every phase runs, at the config's full depth.  The nvidia-smi line comes
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


def within_tol(got, want, dtype: str) -> tuple[float, bool]:
    """(max abs error, allclose at rtol = atol = TOL[dtype]) — the tests' criterion."""
    import torch

    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= TOL[dtype] * (1 + want.float().abs())).all()) and bool(torch.isfinite(got).all())
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
    from repro_torch.kernels.tiered_decode import _DTYPES, tiered_decode_attention_fwd

    B, H, KV, D, W, C = 4, 32, 8, 128, 256, 1024
    # Serving at prompt 1024 + 64 tokens with page 128 keeps cold_len = 896 and
    # hot_len in [129, 192]; the last step is the "serve" case.  Each case runs
    # in bf16 (the serving dtype) and again in fp32, where rtol = atol = 2e-5
    # catches a mask off by one key (a weight near 1/1000 of the output).
    shapes = [  # name, hot_len, cold_len, newest
        ("serve", 192, 896, 63),
        ("hot_len=0", 0, 896, 63),
        ("cold_len=0", 200, 0, 199),
        ("ring_wrap_full", 256, 512, 100),
        ("cold_len_ragged", 150, 700, 20),
    ]
    cases = [(name if dt == "bfloat16" else name + "_fp32", dt, *rest) for dt in DTYPES for name, *rest in shapes]
    lib = load("tiered_decode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    copies = 4  # rotate inputs so the K/V of one launch is not L2-resident for the next
    for name, dt_name, hot_len, cold_len, newest in cases:
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

        outs = [torch.empty_like(s[0]) for s in sets]
        stream = torch.cuda.current_stream().cuda_stream
        raw = [(s[0].data_ptr(), s[1].data_ptr(), s[2].data_ptr(), s[3].data_ptr(), s[4].data_ptr(),
                o.data_ptr(), B, H, KV, W, C, D, hot_len, cold_len, newest, _DTYPES[dt], stream)
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

        isz = torch.finfo(dt).bits // 8
        n_keys = hot_len + cold_len
        moved = 2 * B * KV * n_keys * D * isz + 2 * B * H * D * isz
        flops = 4 * B * H * n_keys * D
        bound_ms, bound_by = bound(moved, flops, dt_name)
        row = dict(case=name, dtype=dt_name, hot_len=hot_len, cold_len=cold_len, newest=newest,
                   max_abs_err=err, tol=TOL[dt_name], ok=ok, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit("tiered_decode", **row)
        if not ok:
            raise AssertionError(f"tiered_decode {name}: not within rtol=atol={TOL[dt_name]} (max abs err {err})")
        record.setdefault("tiered_decode", []).append(row)


# ------------------------------------------------------------------------ flash


def flash_phase(record: dict) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    B, H, KV, D = 4, 32, 8, 128
    shapes = [  # name, S, T, window, softcap; each in bf16, then in fp32
        ("prefill_causal", 1024, 1024, 0, 0.0),
        ("t_gt_s", 512, 1024, 0, 0.0),
        ("window_64", 1024, 1024, 64, 0.0),
        ("softcap_30", 1024, 1024, 0, 30.0),
        ("ragged_200", 200, 200, 0, 0.0),
    ]
    cases = [(name if dt == "bfloat16" else name + "_fp32", dt, *rest) for dt in DTYPES for name, *rest in shapes]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, dt_name, S, T, window, cap in cases:
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

        qpos = torch.arange(S, device="cuda")[:, None] + (T - S)
        kpos = torch.arange(T, device="cuda")[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        library_ms = None if cap else time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True), iters=5)

        isz = torch.finfo(dt).bits // 8
        pairs = int(mask.sum().item())
        moved = (2 * B * H * S * D + 2 * B * KV * T * D) * isz
        flops = 4 * B * H * pairs * D
        bound_ms, bound_by = bound(moved, flops, dt_name)
        row = dict(case=name, dtype=dt_name, S=S, T=T, window=window, softcap=cap,
                   max_abs_err=err, tol=TOL[dt_name], ok=ok, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit("flash", **row)
        if not ok:
            raise AssertionError(f"flash {name}: not within rtol=atol={TOL[dt_name]} (max abs err {err})")
        record.setdefault("flash", []).append(row)
        del q, k, v, got, want


# ------------------------------------------------------------------------ serve


def serve_phase(record: dict, out_dir: Path | None) -> None:
    import torch

    from repro_torch.configs import get_config, make_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import (
        make_prefill_step,
        make_serve_step,
        make_tiered_caches,
        tiered_cache_stats,
        tiered_serve_loop,
    )

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
    launches = ops.launches()
    st = tiered_cache_stats(caches)
    row = dict(arch=cfg.name, layers=layers, batch=B, prompt_len=prompt_len,
               tokens=tokens, kv_window=window, kv_page=page, init_s=init_s, prefill_s=prefill_s,
               prefill_tok_per_s=B * prompt_len / prefill_s, decode_s=decode_s,
               decode_tok_per_s=B * tokens / decode_s, hot_fraction=st["hot_fraction"],
               pages_staged=st["pages_staged"], h2d_bytes_per_step=st["bytes_staged"] / tokens,
               d2h_flushes=st["d2h_flushes"], launches=launches,
               peak_device_bytes=torch.cuda.max_memory_allocated())
    emit("serve", **row)
    want = {"tiered_decode": layers * tokens, "flash_attention": layers}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not st["hot_fraction"] < 1.0 or st["pages_staged"] <= 0:
        raise AssertionError(f"cold tier not exercised: {st}")
    if tuple(out.shape) != (B, tokens + 1) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"bad generated tokens: shape {tuple(out.shape)}")
    record["serve"] = row
    del caches

    # Where the time goes: a short profiled rerun (prefill, then 8 decode
    # steps), outside the timed and counted run above.
    caches = make_tiered_caches(model, cfg, B, prompt_len + 9, window, page, torch.bfloat16, "cuda")
    step = make_serve_step(model, cfg)
    state = {}

    def prefill():
        tok, state["caches"] = make_prefill_step(model, cfg)(params, {"inputs": prompts}, caches)
        state["tok"] = tok[:, None]

    def decode():
        for _ in range(8):
            state["tok"], state["caches"] = step(params, state["tok"], state["caches"])

    for name, fn in (("prefill", prefill), ("decode_8_steps", decode)):
        table = out_dir / f"profile_{name}.txt" if out_dir else None
        emit("serve_profile", part=name, **profile_breakdown(fn, table))
    del params, caches, state
    torch.cuda.empty_cache()


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


# ------------------------------------------------------------------------- main


def kernels_line(record: dict) -> dict:
    launches = record["serve"]["launches"]
    out = []
    for name, phase, source, replaces in (
        ("tiered_decode", "tiered_decode", "src/repro_torch/csrc/tiered_decode.cu",
         "src/repro/kernels/tiered_decode.py:133"),
        ("flash_attention", "flash", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:111"),
    ):
        rows = record[phase]
        main = rows[0]  # the main-path shape
        out.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                        launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in rows),
                        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                        bound_by=main["bound_by"], library_ms=main["library_ms"]))
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
    serve_phase(record, out_dir)
    serve_check_phase(record)
    print(json.dumps(kernels_line(record)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
