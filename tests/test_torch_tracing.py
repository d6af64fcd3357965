"""The port's trace spans and host-clock counters on the CPU.

``repro_torch.runtime.trace.span`` marks the serving and training steps for
a torch profiler: each span is counted here in a profiled run of a small
session scheduler (reduced qwen3, fp32, tiered caches on the CPU) and of a
small train step, checked to nest as the module's table says, and checked
to cost nothing but a shared null context when no profiler records.  The
scheduler's ``alloc_s`` and ``decode_wait_s`` lie inside its ``prefill_s``
and ``decode_s``; the tokens do not depend on the profiler.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as tcfgs
from repro_torch.launch import steps as tsteps
from repro_torch.launch.serve import init_params
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import trace
from repro_torch.serving import SessionScheduler

PROMPT, NEW, WINDOW, PAGE, SESSIONS = 10, 6, 4, 2, 3
PREFIXES = ("serve.", "kv.", "train.")

# Each span and the program spans it may open directly inside.
PARENTS = {
    "serve.step": {None},
    "serve.admit": {"serve.step"},
    "kv.alloc": {"serve.admit"},
    "serve.prefill": {"serve.admit"},
    "serve.decode": {"serve.step"},
    "serve.decode.wait": {"serve.decode"},
    "kv.append": {"serve.decode"},
    "kv.stage": {"serve.decode"},
    "kv.flush": {"kv.append", "kv.stage", "serve.prefill"},
    "serve.retire": {"serve.step", "serve.admit"},
    "serve.memory": {"serve.step"},
    "train.forward_backward": {None},
    "train.optimizer": {None},
}


@pytest.fixture(scope="module")
def lm():
    cfg = dataclasses.replace(tcfgs.get_reduced("qwen3_8b"), dtype="float32", scan_layers=False)
    model = tcfgs.make_model(cfg)
    return model, cfg, init_params(model, 0, "cpu")


class CountingModel:
    """The model as the scheduler sees it, with its decode dispatches counted."""

    def __init__(self, model):
        self.model, self.dispatches = model, 0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, *args):
        self.dispatches += 1
        return self.model.decode_step(*args)


def serve(lm):
    """Three sessions through a scheduler of two rows: (tokens, report,
    decode dispatches)."""
    model, cfg, params = lm
    counted = CountingModel(model)
    sched = SessionScheduler(counted, cfg, params, window=WINDOW, page=PAGE, max_batch=2, dtype=torch.float32,
                             device="cpu")
    rng = np.random.default_rng(0)
    sids = [sched.submit(rng.integers(1, cfg.vocab, size=PROMPT + 3 * i, dtype=np.int32), NEW)
            for i in range(SESSIONS)]
    rep = sched.run(max_steps=100)
    sched.close()
    return [sched.session_tokens(s) for s in sids], rep, counted.dispatches


def program_spans(prof) -> list[tuple[str, int, int, int]]:
    """(name, start, end, thread) of every program span the profiler holds."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU and ev.name().startswith(PREFIXES):
            out.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.start_thread_id()))
    return out


def parents(spans) -> dict[str, set]:
    """For each span name, the names of the innermost program spans that
    held its instances (``None`` for none)."""
    out: dict[str, set] = {}
    for i, (name, s, e, th) in enumerate(spans):
        holders = [h for j, h in enumerate(spans) if j != i and h[3] == th and h[1] <= s and e <= h[2]]
        inner = min(holders, key=lambda h: h[2] - h[1])[0] if holders else None
        out.setdefault(name, set()).add(inner)
    return out


def count(spans, name: str) -> int:
    return sum(1 for s in spans if s[0] == name)


@pytest.fixture(scope="module")
def profiled(lm):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        toks, rep, dispatches = serve(lm)
    return toks, rep, dispatches, program_spans(prof)


@pytest.mark.parametrize("name", ["serve.admit", "kv.alloc", "serve.prefill", "serve.retire"])
def test_admission_spans_once_a_session(profiled, name):
    *_, spans = profiled
    assert count(spans, name) == SESSIONS


@pytest.mark.parametrize("name", ["serve.decode", "serve.decode.wait"])
def test_decode_spans_once_a_dispatch(profiled, name):
    _, rep, dispatches, spans = profiled
    assert dispatches > SESSIONS and count(spans, name) == dispatches


@pytest.mark.parametrize("name", ["kv.append", "kv.stage"])
def test_cache_spans_once_a_layer_step(profiled, lm, name):
    """Once per layer and dispatch, never once per session's cache."""
    _, cfg, _ = lm
    _, _, dispatches, spans = profiled
    assert count(spans, name) == cfg.n_layers * dispatches


@pytest.mark.parametrize("name", ["serve.step", "serve.memory"])
def test_step_spans_once_a_step(profiled, name):
    _, rep, _, spans = profiled
    assert count(spans, name) == rep["steps"]


def test_flush_spans_only_where_a_flush_copies(profiled):
    """Pages of 2 tokens: each session flushes at least once in prefill and
    again while decoding; every flush span stands for one copy."""
    *_, spans = profiled
    assert count(spans, "kv.flush") >= 2 * SESSIONS


def test_spans_nest_as_the_table_says(profiled):
    *_, spans = profiled
    got = parents(spans)
    assert set(got) == {n for n in PARENTS if n.startswith(("serve.", "kv."))}
    for name, held in got.items():
        assert held <= PARENTS[name], (name, held)


def test_counters_lie_inside_the_clocks_they_split(profiled):
    _, rep, _, _ = profiled
    assert rep["alloc_s"] > 0 and rep["alloc_s"] <= rep["prefill_s"]
    assert 0 <= rep["decode_wait_s"] <= rep["decode_s"]


def test_tokens_do_not_depend_on_the_profiler(profiled, lm):
    toks, rep, _, _ = profiled
    again, rep_off, _ = serve(lm)
    assert again == toks and all(len(t) == NEW for t in toks)
    assert rep_off["decoded_tokens"] == rep["decoded_tokens"]


def test_no_profiler_no_record_function(lm, monkeypatch):
    """Off, a span is the one shared null context: ``record_function`` is
    never reached, and the scheduler runs through it."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert trace.span("kv.append") is trace.span("serve.step")
    toks, rep, _ = serve(lm)
    assert all(len(t) == NEW for t in toks) and rep["alloc_s"] > 0


def test_profiler_on_gives_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        on = trace.span("serve.step")
    assert isinstance(on, torch.profiler.record_function)
    assert trace.span("serve.step") is trace.span("train.optimizer")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans(accum):
    """A train step opens ``train.forward_backward`` once a microbatch and
    ``train.optimizer`` once, neither inside the other."""
    cfg = dataclasses.replace(tcfgs.get_reduced("starcoder2_3b"), n_layers=2, d_model=32, d_ff=64, n_heads=4,
                              n_kv_heads=2, vocab=256, dtype="float32")
    model, opt = tcfgs.make_model(cfg), AdamW(learning_rate=1e-3)
    state, _ = tsteps.init_state(model, cfg, opt, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 9), dtype=np.int64))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    step = tsteps.make_train_step(model, cfg, opt, accum_steps=accum)
    steps = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            state, metrics = step(state, batch)
    spans = program_spans(prof)
    assert count(spans, "train.forward_backward") == accum * steps
    assert count(spans, "train.optimizer") == steps
    assert parents(spans) == {"train.forward_backward": {None}, "train.optimizer": {None}}
    assert int(state["step"]) == steps and np.isfinite(float(metrics["loss"]))


def test_sessions_cli_prints_the_counters(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve as cli

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen3-8b", "--reduced", "--sessions", "2", "--max-batch", "2", "--prompt-len", "8",
        "--tokens", "3", "--kv-window", "4", "--kv-page", "2", "--device", "cpu"])
    cli.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].startswith("decode 4 tokens: ") and lines[1].endswith("s of it waiting for tokens")
    assert lines[2].startswith("ttft p50 ") and lines[2].endswith(" over 2 admissions")
    assert "cache allocation " in lines[2]
