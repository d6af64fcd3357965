"""The plain reference against the port, on the CPU at reduced sizes, through
the harness's own loops, wrapper and comparison; the faults a run can
have come out as not correct, and so does the float8 control; a cell,
traffic mix and metric added as new files run with no file edited.

Each run here is a whole cell run on the CPU: weights from the seed, the
ramp, a window of about a second, the reference after it."""

from __future__ import annotations

import copy
import json
import math
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import Cell, Weights, load_json, load_module, model_config, result  # noqa: E402
from bench.reference import dense_lm  # noqa: E402
from bench.run import Context  # noqa: E402

TINY = dict(n_layers=2, d_model=96, n_heads=8, n_kv_heads=2, head_dim=12, vocab=512)
SERVE_MIX = dict(clients=3, block=4, prompt=dict(mean=60, sigma=1.0, range=[40, 80]),
                 output=dict(mean=9, sigma=1.0, range=[6, 12]), kv_window=32, kv_page=16, max_batch=3,
                 trace_after_s=0.2, trace_steps=3)
TRAIN_MIX = dict(batch=4, seq=64, tokens_per_shard=4096)
# Limits of the tiny cells, from their readings on this CPU (seeds 1-6,
# the bf16 program against the float32 reference, then the float8 control
# and half of each batch in the program's place): served gap 0 on every
# seed, the control 0.041-0.123; training's loss gap at most 4.4e-5 (half
# a batch 2.0e-3 or more), grad gap at most 7.2e-3 (the control 0.0196 or
# more, half a batch 0.082 or more), change gap at most 0.042.
TINY_LIMITS = {"served_gap": {"limit": 0.02},
               "loss_gap": {"limit": 5e-4}, "grad_gap": {"limit": 0.015}, "change_gap": {"limit": 0.1}}


def tiny_cell(kind: str, dtype: str = "bfloat16") -> dict:
    """A cell's files, cut to a CPU's size: the configuration's widths and
    the mix's lengths only."""
    if kind == "serve":
        config = load_json(ROOT / "bench/configs/command-r-08-2024.json")
        config["model"].update(TINY, d_ff=256, dtype=dtype)
        traffic = dict(load_json(ROOT / "bench/traffic/rag-c16.json"), **SERVE_MIX)
    else:
        config = load_json(ROOT / "bench/configs/starcoder2-3b.json")
        config["model"].update(TINY, d_ff=192, dtype=dtype)
        traffic = dict(load_json(ROOT / "bench/traffic/train-8x2048.json"), **TRAIN_MIX)
    return {"config": config, "traffic": traffic, "limits": copy.deepcopy(TINY_LIMITS)}


def run_cell(files: dict, seed: int = 7, seconds: float = 1.0, trace: bool = False, readings: tuple = ()):
    ctx = Context(config=files["config"], traffic=files["traffic"], limits=files["limits"], seed=seed,
                  seconds=seconds, trace=trace, device="cpu", t_start=time.perf_counter(), readings=readings)
    return load_module(ROOT / f"bench/loops/{files['traffic']['loop']}.py", "tiny_loop").run(ctx)


def checks(rec) -> dict[str, float]:
    return {name: v for name, v, _ in rec.checks}


# ----------------------------------------------------------- reference


def _port_logits(files: dict, seed: int, prompt_len: int, steps: int):
    """The port's prefill and decode logits through its two-level cache,
    and the tokens it chose, from the harness's weights."""
    from repro_torch.configs import make_model
    from repro_torch.launch.steps import make_tiered_caches

    cfg = model_config(files["config"])
    model = make_model(cfg)
    params = Weights(model, cfg, seed, "cpu", served=True).tree()
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab, prompt_len))
    caches = make_tiered_caches(model, cfg, 1, prompt_len + steps + 1, 32, 16, getattr(torch, cfg.dtype), "cpu", "kernel")
    logits, caches = model.prefill(params, prompt[None], caches)
    out, toks = [logits[0, -1]], [int(logits[0, -1].argmax())]
    for _ in range(steps - 1):
        logits, caches = model.decode_step(params, torch.tensor([[toks[-1]]]), caches)
        out.append(logits[0, -1])
        toks.append(int(logits[0, -1].argmax()))
    return params, prompt, toks, torch.stack(out)


def test_reference_logits_equal_the_ports_through_both_tiers_in_fp32():
    files = tiny_cell("serve", dtype="float32")
    params, prompt, toks, port = _port_logits(files, seed=3, prompt_len=70, steps=12)  # 82 > 32: cold pages read
    m = files["config"]["model"]
    seq = torch.cat([prompt, torch.tensor(toks[:-1])])
    ref = dense_lm.logits(params, dense_lm.hidden(params, seq, m))[len(prompt) - 1:]
    assert torch.allclose(port.float(), ref, rtol=1e-4, atol=1e-4), (port - ref).abs().max()
    gaps = dense_lm.served_gaps(params, m, prompt, toks)["served"]
    assert max(gaps) < 1e-4


def test_reference_train_step_equals_the_ports_in_fp32():
    from repro_torch.configs import make_model
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW

    files = tiny_cell("train", dtype="float32")
    cfg, m = model_config(files["config"]), files["config"]["model"]
    h = files["traffic"]["adamw"]
    model = make_model(cfg)
    w = Weights(model, cfg, 11, "cpu", served=False)
    step = make_train_step(model, cfg, AdamW(learning_rate=h["lr"], b1=h["b1"], b2=h["b2"], eps=h["eps"],
                                             weight_decay=h["weight_decay"], max_grad_norm=h["max_grad_norm"]))
    params = w.tree()
    state = {"params": params, "opt": AdamW().init(params), "step": torch.zeros((), dtype=torch.int32)}
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 3, 33)), dtype=torch.int32)
    batches = [(t[:, :-1], t[:, 1:]) for t in toks]
    losses = []
    for x, y in batches:
        state, metrics = step(state, {"inputs": x, "labels": y})
        losses.append(float(metrics["loss"]))
    flat0 = lambda: {"/".join(p): v.clone() for c in w.chunks for p, v in w.chunk(c).items()}
    init = flat0()
    ref = dense_lm.train(flat0(), batches, m, h, initial=lambda k: init[k])
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    got = dense_lm.flat(state["params"])
    for k, v in got.items():
        assert float((v - init[k]).norm()) == pytest.approx(ref["change"][k], rel=2e-3, abs=1e-6), k


# ------------------------------------------------------------ the cells


def test_serving_cell_is_correct_through_the_harness():
    rec = run_cell(tiny_cell("serve"))
    assert rec.correct, rec.checks
    assert rec.attempted > 0 and rec.e2e["output_tok_s"] > 0
    assert rec.counters["prefills"] > 0 and rec.counters["bytes_staged"] > 0  # the cold tier is read


def test_training_cell_is_correct_through_the_harness():
    rec = run_cell(tiny_cell("train"))
    assert rec.correct, rec.checks
    assert checks(rec)["rows_off_corpus"] == 0 and rec.attempted > 0


def test_the_float8_control_is_not_correct():
    files = tiny_cell("serve")
    rec = run_cell(files, readings=("control",))
    assert rec.correct, rec.checks
    assert rec.readings["control"]["served_gap"] > files["limits"]["served_gap"]["limit"]

    files = tiny_cell("train")
    rec = run_cell(files, readings=("control", "half_batch"))
    assert rec.correct, rec.checks
    for name in ("control", "half_batch"):
        assert any(rec.readings[name][k] > files["limits"][k]["limit"] for k in ("loss_gap", "grad_gap", "change_gap"))


# -------------------------------------------------------------- faults


def _alter_token(monkeypatch):
    from repro_torch.models.lm import LM

    plain = LM.decode_step

    def altered(self, params, token, caches):
        logits, caches = plain(self, params, token, caches)
        best = logits[:, -1].argmax(-1)
        logits[torch.arange(len(best)), -1, (best + 1) % logits.shape[-1]] += 1e3
        return logits, caches

    monkeypatch.setattr(LM, "decode_step", altered)


def _unchanged_cache(monkeypatch):
    from repro_torch.serving.scheduler import SessionKVBatch

    monkeypatch.setattr(SessionKVBatch, "append", lambda self, k, v: None)


@pytest.mark.parametrize("fault", [_alter_token, _unchanged_cache])
def test_a_faulty_serving_run_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    rec = run_cell(tiny_cell("serve"))
    assert not rec.correct, rec.checks


def _unchanged_state(monkeypatch):
    import repro_torch.launch.steps as steps

    monkeypatch.setattr(steps, "apply_updates", lambda params, updates: params)


def _half_batch(monkeypatch):
    import repro_torch.launch.steps as steps

    plain = steps.make_loss_fn

    def half(model, cfg):
        loss = plain(model, cfg)
        return lambda params, batch: loss(params, {k: v[: len(v) // 2] for k, v in batch.items()})

    monkeypatch.setattr(steps, "make_loss_fn", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_a_faulty_training_run_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    rec = run_cell(tiny_cell("train"))
    assert not rec.correct, rec.checks


# ------------------------------------------------------ data-driven cells


def test_a_cell_traffic_config_and_metric_added_as_files(tmp_path):
    """A throwaway configuration, traffic mix, limits and per-layer metric
    added beside copies of the benchmark's files, with entries added to a
    copy of BENCHMARK.json: the harness finds and runs them by name."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    files = tiny_cell("serve")
    (tmp_path / "bench/configs/tiny.json").write_text(json.dumps(files["config"]))
    (tmp_path / "bench/traffic/tiny-mix.json").write_text(json.dumps(files["traffic"]))
    (tmp_path / "bench/limits/tiny-cell.json").write_text(json.dumps(files["limits"]))
    (tmp_path / "bench/metrics/prompt_tokens.py").write_text(
        "def read(rec, name):\n    return rec.counters.get('prefill_tokens') or None\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "https://example.org/tiny", "file": "bench/configs/tiny.json",
                            "reduced": ["num_hidden_layers"], "why": "a throwaway"})
    spec["workloads"].append({"name": "tiny-cell", "config": "tiny", "traffic": "tiny-mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "prompt_tokens", "unit": "tokens", "better": "higher", "source": "host_clock",
                              "layer": "serving.scheduler", "moves": "output_tok_s", "workloads": ["tiny-cell"]})
    for m in spec["end_to_end"]:
        if "output_tok_s" == m["name"]:
            m["workloads"].append("tiny-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell.load("tiny-cell", bench=tmp_path / "bench", root=tmp_path)
    ctx = Context(config=cell.config, traffic=cell.traffic, limits=cell.limits, seed=5, seconds=1.0, trace=True,
                  device="cpu", t_start=time.perf_counter())
    rec = cell.loop()(ctx)
    device = {"platform": "cpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    line = result(cell, rec, True, device)
    assert line["metrics"]["prompt_tokens"]["value"] == rec.counters["prefill_tokens"]
    assert set(line["metrics"]) == {"prompt_tokens"}  # the cell's per-layer metrics only
    assert list(line)[-1] == "checks" and line["checks"]["served_gap"]["limit"] == TINY_LIMITS["served_gap"]["limit"]
    e2e = result(cell, rec, False, device)["metrics"]
    assert set(e2e) == {"output_tok_s", "setup_s"}
    assert math.isfinite(e2e["output_tok_s"]["value"])


@pytest.mark.cuda
def test_reference_equals_the_port_on_the_card():
    """The port's full-sequence logits on the card against the reference's,
    both float32 with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import make_model

    files = tiny_cell("serve", dtype="float32")
    cfg = model_config(files["config"])
    model = make_model(cfg)
    params = Weights(model, cfg, 3, "cuda", served=True).tree()
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, 70), device="cuda")
    dense_lm.exact_matmuls()
    port = model.train_logits(params, prompt[None])[0][0]
    ref = dense_lm.logits(params, dense_lm.hidden(params, prompt, files["config"]["model"]))
    assert torch.allclose(port.float(), ref, rtol=1e-4, atol=1e-4), (port - ref).abs().max()
