"""Closed-loop serving through the program's session scheduler.

``clients`` callers each hold one request at a time and send the next as
soon as the last one's final token is out, with no think time.  The
program under test is ``repro_torch.serving.SessionScheduler`` driven by
``submit`` and ``step``: every layer's cache a ``TieredKVCache`` (hot
device ring, pinned host history, staged cold pages), decode through the
per-row tiered kernel, prefill through the flash kernel.  No store: the
cells write nothing to disk.

Set-up: weights from the seed, a warm-up scheduler that prefills the
mix's shortest and longest prompts and decodes a few steps, then the ramp:
the first ``clients`` requests sent as sessions evenly spread through
their answers, so that they do not all end together, stepped until every
one of them is admitted.  Then the window: steps until ``seconds`` have
passed.

Timing: a decode token's time is the end of the step that produced it (the
step ends in the program's own wait for the device); a first token's is
the end of its prefill as the scheduler measures it from the send.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from bench import yardstick
from bench.harness import Record, Weights, log, model_config
from bench.reference import dense_lm
from bench.trace import Tracer
from bench.traffic import Sessions


class ModelTap:
    """The program's model as the scheduler sees it, with every prefill's
    length and every decode step's row contexts noted (the benchmark's
    own counts of the work) under host spans that name the trace's gaps."""

    def __init__(self, model):
        self.model = model
        self.prefills: list[tuple[float, int]] = []  # (end time, prompt tokens)
        self.decodes: list[tuple[float, list[int]]] = []  # (end time, each row's position)

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, params, tokens, caches, patches=None):
        with record_function("bench.prefill"):
            out = self.model.prefill(params, tokens, caches)
        self.prefills.append((time.perf_counter(), int(tokens.shape[1])))
        return out

    def decode_step(self, params, token, caches):
        rows = next(iter(caches.values())).caches
        contexts = [c.length for c in rows]
        with record_function("bench.decode"):
            out = self.model.decode_step(params, token, caches)
        self.decodes.append((time.perf_counter(), contexts))
        return out


def _scheduler_class():
    from repro_torch.serving import SessionScheduler, TieredKVCache

    class Scheduler(SessionScheduler):
        """The program's scheduler; only reads each session's cache
        counters before its retirement closes the caches."""

        staged_retired = 0

        def _retire(self, sess):
            self.staged_retired += sum(c.stats.bytes_staged for c in sess.caches.values()
                                       if isinstance(c, TieredKVCache))
            super()._retire(sess)

        def bytes_staged(self) -> int:
            live = sum(c.stats.bytes_staged for s in self._sessions.values() if s.caches is not None
                       for c in s.caches.values() if isinstance(c, TieredKVCache))
            return self.staged_retired + live

    return Scheduler


def run(ctx) -> Record:
    from repro_torch.configs import make_model
    from repro_torch.kernels import ops

    mix, seed, device = ctx.traffic, ctx.seed, ctx.device
    cfg = model_config(ctx.config)
    m = ctx.config["model"]
    model = make_model(cfg)
    log(ctx.t_start, "program imported")
    weights = Weights(model, cfg, seed, device, served=True)
    params = weights.tree()
    log(ctx.t_start, "weights drawn")
    traffic = Sessions(mix, seed, cfg.vocab)
    Scheduler = _scheduler_class()
    kw = dict(window=mix["kv_window"], page=mix["kv_page"], max_batch=mix["max_batch"],
              admit_per_step=mix["admit_per_step"], dtype=getattr(torch, cfg.dtype), device=device, impl="kernel")

    # Warm-up: the mix's shortest and longest prompts, admitted, then a few
    # decode steps of both; closed before they finish.
    lens = [traffic.lengths(i) for i in range(traffic.block)]
    warm = Scheduler(model, cfg, params, **kw)
    rng = np.random.default_rng([seed, 3])
    for s, out in (min(lens), max(lens)):
        warm.submit(rng.integers(0, cfg.vocab, size=s, dtype=np.int32), out)
    while warm.step()["queued"]:
        pass
    for _ in range(mix["warm_decode_steps"]):
        warm.step()
    warm.close()
    del warm
    log(ctx.t_start, "warm-up done")

    tap = ModelTap(model)
    sched = Scheduler(tap, cfg, params, **kw)
    clients = mix["clients"]
    held: dict[int, int] = {}  # client -> sid of the request it waits on
    sessions: dict[int, dict] = {}  # sid -> its request, prompt, answer length, send time, token times
    next_req = 0

    def send(client: int, done: float = 0.0) -> None:
        """The client's next request; ``done`` > 0 sends it as a session
        that share of the way into its answer: the answered tokens join
        the prompt (drawn from the seed), the answer keeps the rest."""
        nonlocal next_req
        req = traffic[next_req]
        next_req += 1
        out = max(1, req.max_new_tokens - int(req.max_new_tokens * done))
        prompt = req.prompt
        if out < req.max_new_tokens:
            extra = np.random.default_rng([seed, req.index, 5]).integers(0, cfg.vocab, req.max_new_tokens - out)
            prompt = np.concatenate([prompt, extra.astype(np.int32)])
        sid = sched.submit(prompt, out)
        held[client] = sid
        sessions[sid] = {"req": req, "prompt": prompt, "out": out, "sent": sched._sessions[sid].submitted_s,
                         "times": []}

    def step() -> float:
        with record_function("bench.step"):
            sched.step()
        now = time.perf_counter()
        for client, sid in list(held.items()):
            sess, rec = sched._sessions[sid], sessions[sid]
            times = rec["times"]
            while len(times) < len(sess.tokens):
                times.append(sess.submitted_s + sess.ttft_s if not times else now)
            if sess.done:
                rec["retired"] = now
                send(client)
        return now

    # The ramp: every client's first request, as sessions evenly spread
    # through their answers, so that they do not all end together.
    for c in range(clients):
        send(c, done=c / clients)
    first_wave = set(held.values())
    while any(sched._sessions[sid].ttft_s is None for sid in first_wave):
        step()

    log(ctx.t_start, f"ramp done: {next_req} requests sent")
    counters0 = dict(prefill_s=sched.prefill_s, decode_s=sched.decode_s, staged=sched.bytes_staged())
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    # What set-up made lives as long as the server: out of the collector's
    # reach, as serving stacks do after warm-up, so that a full collection
    # in the window does not walk it (such a stall held a decode 300 ms).
    gc.freeze()
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t_start
    tracer, traced_span, traced_steps, launched = None, None, 0, {}

    def stop_trace(now: float) -> None:
        nonlocal launched
        tracer.__exit__(None, None, None)
        traced_span[1] = now
        launched = {"flash": ops.flash_attention.launches - launched["flash"],
                    "tiered_rows": ops.tiered_decode_rows_attention.launches - launched["tiered_rows"]}

    now = t_open
    while now - t_open < ctx.seconds:
        # The traced stretch: ``trace_steps`` steps from the first one after
        # ``trace_after_s`` that admits a request, so that it holds a prefill
        # (or fewer, where the window closes first).
        if ctx.trace and tracer is None and now - t_open >= mix["trace_after_s"] and sched._queue:
            launched = {"flash": ops.flash_attention.launches, "tiered_rows": ops.tiered_decode_rows_attention.launches}
            tracer = Tracer().__enter__()
            traced_span = [now, None]
        now = step()
        if traced_span is not None and traced_span[1] is None:
            traced_steps += 1
            if traced_steps == mix["trace_steps"]:
                stop_trace(now)
    t_close = now
    if traced_span is not None and traced_span[1] is None:
        stop_trace(now)
    window_s = t_close - t_open
    counters = dict(prefill_s=sched.prefill_s - counters0["prefill_s"], decode_s=sched.decode_s - counters0["decode_s"],
                    bytes_staged=sched.bytes_staged() - counters0["staged"])
    memory_peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0

    # End to end over the window.
    inside = lambda t: t_open <= t <= t_close
    out_tokens = sum(1 for r in sessions.values() for t in r["times"] if inside(t))
    itl = [(b - a) * 1e3 for r in sessions.values() for a, b in zip(r["times"], r["times"][1:]) if inside(b)]
    sent = [r for r in sessions.values() if inside(r["sent"])]
    ttft = [(r["times"][0] if r["times"] and r["times"][0] <= t_close else t_close) - r["sent"] for r in sent]
    e2e = {"output_tok_s": out_tokens / window_s, "itl_p99_ms": yardstick.percentile(itl, 99)}
    if ttft:
        e2e["ttft_p95_s"] = yardstick.percentile(ttft, 95)
    prefills = [(t, s) for t, s in tap.prefills if inside(t)]
    decodes = [(t, c) for t, c in tap.decodes if inside(t)]
    counters.update(prefill_tokens=sum(s for _, s in prefills), prefills=len(prefills), decode_steps=len(decodes),
                    output_tokens=out_tokens, requests_sent=len(sent),
                    model_flops=sum(yardstick.prefill_flops(m, s) for _, s in prefills)
                    + sum(yardstick.decode_flops(m, c) for _, c in decodes))
    traced = {}
    if traced_span is not None:
        within = lambda t: traced_span[0] <= t <= traced_span[1]
        traced = {"prefill_tokens": [s for t, s in tap.prefills if within(t)],
                  "decode_contexts": [c for t, c in tap.decodes if within(t)], "launches": launched}
        log(ctx.t_start, f"traced {traced_steps} steps, {traced_span[1] - traced_span[0]:.2f} s: "
                         f"{len(traced['prefill_tokens'])} prefills, {len(traced['decode_contexts'])} decodes; "
                         f"launches {launched}, in the trace flash "
                         f"{tracer.summary.kernel_count('flash_wgmma_kernel', 'flash_fwd_kernel')}, rows "
                         f"{tracer.summary.kernel_count('tiered_rows_partial_kernel')}; "
                         f"{sum(tracer.summary.device_n_by_name.values())} device operations")

    # Correctness: a sample of the requests the window finished, the longest in it.
    done = [sid for sid, r in sessions.items() if "retired" in r and inside(r["retired"])]
    done.sort(key=lambda sid: (-sessions[sid]["out"], sid))
    pick = done[:1]
    rest = done[1:]
    if rest:
        take = np.random.default_rng([seed, 4]).choice(len(rest), min(len(rest), mix["check_requests"] - 1),
                                                        replace=False)
        pick += [rest[i] for i in sorted(take)]
    sample = [(sessions[sid]["prompt"], list(sched._sessions[sid].tokens)) for sid in pick]
    sched.close()
    del sched, tap
    gc.unfreeze()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    log(ctx.t_start, f"window closed: {window_s:.2f} s, {out_tokens} tokens, {len(decodes)} decode steps, "
                     f"{len(prefills)} prefills of {counters['prefill_tokens']} tokens, peak {memory_peak} B; "
                     f"reference over {[len(p) + len(t) for p, t in sample]} tokens")
    # The float8 control, where asked for, is read at the same prompts and
    # served tokens: at each position, the gap of the token it puts first.
    precisions = ("fp32", "fp8") if "control" in ctx.readings else ("fp32",)
    gaps: dict[str, list[float]] = {}
    for prompt, served in sample:
        g = dense_lm.served_gaps(params, m, torch.as_tensor(prompt, device=device), served, precisions)
        for k, v in g.items():
            gaps.setdefault(k, []).extend(v)
    widest = lambda k: max(gaps[k]) if gaps.get(k) else math.inf
    log(ctx.t_start, "reference done")
    checks = [("served_gap", widest("served"), ctx.limits["served_gap"]["limit"])]
    readings = {"control": {"served_gap": widest("fp8")}} if "control" in ctx.readings else {}
    return Record(setup_s=setup_s, window_s=window_s, e2e=e2e, attempted=len(sent), failed=0,
                  memory_peak_bytes=memory_peak, checks=checks, counters=counters, traced=traced,
                  trace=tracer.summary if tracer is not None else None, cfg=m, readings=readings)
