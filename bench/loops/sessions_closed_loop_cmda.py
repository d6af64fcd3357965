"""Closed-loop serving of an expert share through the program's session
scheduler: the loop of ``sessions_closed_loop``, run as it is from a
private copy of that module, with what differs for a model whose layers
mix window and global attention and whose MoE layers hold a share of the
experts (``bench/configs/command-a-plus-05-2026.json``):

* the reference is ``bench.reference.cohere2_moe``;
* the model's operations come from ``bench.moe_share`` (window-limited
  attention, the router, the shared experts), plus the routed experts'
  rows that the program's share counters report for the window's calls;
* the routed experts are drawn at their own fan-in (the harness's draw
  scales a leaf by its leading dim, here the experts' count);
* the share's counters are read over the traced stretch, call by call, for
  ``moe_grouped_roofline``;
* two more checks: ``logit_gap``, over the checked positions the mean of
  the largest distance between one of the program's two leading logits and
  the float32 reference's logit of the same token (the served gap alone let
  the float8 control pass on half the seeds: at these random weights its
  leading token rarely changes; a mean over some hundreds of positions
  spreads far less from seed to seed than a largest one), and
  ``moe_dropped``, the assignments the share dropped, at most 0.

Every layer's cache is the scheduler's: a ``TieredKVCache`` for each global
layer, a ``SlidingKVRing`` of the model's window for each window layer.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from bench import moe_share
from bench.harness import Weights, load_module, log, model_config
from bench.reference import cohere2_moe
from bench.trace import Tracer

BASE = Path(__file__).with_name("sessions_closed_loop.py")
LEADING = 2  # the program's leading logits kept at every position
# The configuration file's MoE numbers the reference and the counts read,
# against the program's configuration.
MOE_KEYS = {"moe_experts": "n_experts", "moe_top_k": "top_k", "moe_expert_ff": "expert_ff", "moe_shared": "n_shared"}


class ShareWeights(Weights):
    """The harness's draw, each routed expert's matrix rescaled to N(0,
    1/fan_in) of its own input (the draw scaled by the experts' count)."""

    def chunk(self, name: str) -> dict:
        out = super().chunk(name)
        for path, leaf in out.items():
            if len(path) >= 2 and path[-2] == "ffn" and path[-1] in ("w_gate", "w_up", "w_down"):
                leaf.mul_(math.sqrt(leaf.shape[0] / leaf.shape[1]))
        return out


def _share_counts():
    """The program's cumulative share counters as they stand, without a
    wait: (held assignments, experts read), tensors or ints."""
    from repro_torch.nn import layers as L

    return L.moe_apply.held, L.moe_apply.experts_read


def _tap_class(base):
    class ShareTap(base):
        """The loop's model tap, each prefill and decode step also noting
        the share's counters before and after it (references to the
        program's counters: no copy, no wait), and each row's leading
        logits, by session (its first layer's cache) and position."""

        last = None

        def __init__(self, model):
            super().__init__(model)
            self.calls: list[tuple[float, tuple, tuple]] = []  # (end time, counts before, counts after)
            self.rows: list[tuple] = []  # (session's first cache, position, token fed or None, top values, top ids)
            ShareTap.last = self

        def prefill(self, params, tokens, caches, patches=None):
            before, first = _share_counts(), next(iter(caches.values()))
            logits, caches = super().prefill(params, tokens, caches, patches)
            self.calls.append((self.prefills[-1][0], before, _share_counts()))
            top = logits[0, -1].float().topk(LEADING)
            self.rows.append((first, int(tokens.shape[1]) - 1, None, top.values, top.indices))
            return logits, caches

        def decode_step(self, params, token, caches):
            before, rows = _share_counts(), next(iter(caches.values())).caches
            positions = [c.length for c in rows]
            logits, caches = super().decode_step(params, token, caches)
            self.calls.append((self.decodes[-1][0], before, _share_counts()))
            top = logits[:, -1].float().topk(LEADING, dim=-1)
            for i, (c, n) in enumerate(zip(rows, positions)):
                self.rows.append((c, n, token[i, 0], top.values[i], top.indices[i]))
            return logits, caches

        def leading(self, prompt_len: int, served: list[int]):
            """The program's leading logits (values, ids) at each served
            position of the session that had this prompt length and fed
            these tokens."""
            by_session: dict[int, list] = {}
            for row in self.rows:
                by_session.setdefault(id(row[0]), []).append(row)
            for rows in by_session.values():
                rows = sorted(rows, key=lambda r: r[1])
                fed = [int(r[2]) for r in rows[1:]]
                if rows[0][1] == prompt_len - 1 and rows[0][2] is None and fed[: len(served) - 1] == served[:-1]:
                    rows = rows[: len(served)]
                    return torch.stack([r[3] for r in rows]), torch.stack([r[4] for r in rows])
            raise LookupError(f"no served session of a {prompt_len}-token prompt fed these tokens")

    return ShareTap


class Reference:
    """``cohere2_moe`` as the loop calls its reference, each checked request
    also given the program's leading logits from the tap, and the logit
    gaps kept for the checks."""

    def __init__(self, tap_class):
        self.tap_class, self.gaps = tap_class, {}

    def served_gaps(self, params, m, prompt, served, precisions=("fp32",)):
        program = self.tap_class.last.leading(len(prompt), served)
        out = cohere2_moe.served_gaps(params, m, prompt, served, precisions, program=program)
        for k, v in out.items():
            if k.endswith("_logit"):
                self.gaps.setdefault(k, []).extend(v)
        return out


class ShareTracer(Tracer):
    """The loop's tracer, also noting its stretch's host times and the
    grouped op's launches in it."""

    last = None

    def __enter__(self):
        from repro_torch.kernels import ops

        ShareTracer.last = self
        self.launches = ops.moe_grouped_ffn.launches
        out = super().__enter__()
        self.span = [self._t0, None]
        return out

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        self.launches = ops.moe_grouped_ffn.launches - self.launches
        out = super().__exit__(*exc)
        self.span[1] = self._t0 + self.summary.window_s if self.summary is not None else None
        return out


def _deltas(calls, lo: float, hi: float) -> list[tuple[int, int]]:
    """(held assignments, experts read) of each call that ended in [lo, hi]."""
    return [(int(after[0] - before[0]), int(after[1] - before[1])) for t, before, after in calls if lo <= t <= hi]


def run(ctx):
    from repro_torch.nn import layers as L

    cfg, m = model_config(ctx.config), ctx.config["model"]
    for key, field in MOE_KEYS.items():
        if m[key] != getattr(cfg.moe, field):
            raise ValueError(f"{key} is {m[key]} in the file, the program's moe.{field} {getattr(cfg.moe, field)}")
    base = load_module(BASE, "bench_loop_sessions_closed_loop_for_cmda")
    base.ModelTap = tap_class = _tap_class(base.ModelTap)
    reference = Reference(tap_class)
    base.dense_lm, base.yardstick, base.Weights, base.Tracer = reference, moe_share, ShareWeights, ShareTracer
    L.reset_moe_counts()
    rec = base.run(ctx)

    tap, tracer = tap_class.last, ShareTracer.last
    t_open = ctx.t_start + rec.setup_s
    window = _deltas(tap.calls, t_open, t_open + rec.window_s)
    held = sum(h for h, _ in window)
    rec.counters["model_flops"] += moe_share.expert_flops(m, held)
    rec.counters["moe_held"] = held
    if tracer is not None and tracer.span[1] is not None:
        rec.traced["moe"] = {"calls": _deltas(tap.calls, *tracer.span), "launches": tracer.launches}
    counts = L.moe_counts()
    mean = lambda k: sum(reference.gaps[k]) / len(reference.gaps[k]) if reference.gaps.get(k) else math.inf
    log(ctx.t_start, f"moe counts over the run: {counts}; held in the window {held}; logit gaps over "
                     + ", ".join(f"{k} {len(v)} positions: mean {mean(k)!r}, largest {max(v)!r}"
                                 for k, v in reference.gaps.items()))
    rec.checks[1:1] = [("logit_gap", mean("served_logit"), ctx.limits["logit_gap"]["limit"])]
    rec.checks.append(("moe_dropped", float(counts["dropped"]), 0.0))
    if "control" in rec.readings:
        rec.readings["control"]["logit_gap"] = mean("fp8_logit")
    return rec
