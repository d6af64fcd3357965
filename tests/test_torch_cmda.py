"""Command A+ (``command_a_plus_05_2026``, only the port has it) on the CPU at
its reduced size, against the benchmark's plain float32 reference
(``bench/reference/cohere2_moe.py``): prefill and session decode through
sliding rings beside two-level caches, the global layers' NoPE, the expert
share, and sessions shorter than the tiered ring (Command R too).

Tolerances: fp32 logits at rtol = atol = 1e-4, the sums of the port's
kernels' plain versions and of the reference run in other orders (the
reduced model's logits are of order 1)."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.reference import cohere2_moe as ref  # noqa: E402
from repro_torch.configs import get_reduced, make_model  # noqa: E402
from repro_torch.configs.port import PortArchConfig  # noqa: E402
from repro_torch.nn import layers as L  # noqa: E402
from repro_torch.nn.module import init_with_axes  # noqa: E402
from repro_torch.serving import SessionScheduler  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def reduced(**kw) -> PortArchConfig:
    return dataclasses.replace(get_reduced("command_a_plus_05_2026"), dtype="float32", **kw)


def model_block(cfg: PortArchConfig) -> dict:
    """The reference's ``model`` block for a config, as a configuration file holds it."""
    return dict(n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, window=cfg.window, global_every=cfg.global_every, rope_theta=cfg.rope_theta,
                norm_eps=cfg.norm_eps, experts_held=cfg.experts_held or cfg.moe.n_experts, experts_lo=cfg.experts_lo,
                moe_experts=cfg.moe.n_experts, moe_top_k=cfg.moe.top_k, moe_expert_ff=cfg.moe.expert_ff,
                moe_shared=cfg.moe.n_shared)


def params_of(cfg, seed: int = 0) -> dict:
    return init_with_axes(make_model(cfg).init, seed, device="cpu", dtype=torch.float32)[0]


def ref_logits(params: dict, m: dict, seq) -> torch.Tensor:
    ref.exact_matmuls()
    with torch.no_grad():
        return ref.logits(params, ref.hidden(params, torch.as_tensor(seq, dtype=torch.long), m, block=7))


class LogitsTap:
    """The model as the scheduler sees it, each prefill's and decode row's
    logits kept in the order the rows come."""

    def __init__(self, model):
        self.model, self.rows = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, params, tokens, caches, patches=None):
        logits, caches = self.model.prefill(params, tokens, caches)
        self.rows.append(("prefill", int(tokens.shape[1]), logits[0, -1]))
        return logits, caches

    def decode_step(self, params, token, caches):
        lengths = [c.length for c in next(iter(caches.values())).caches]
        logits, caches = self.model.decode_step(params, token, caches)
        self.rows += [("decode", n, logits[i, -1]) for i, n in enumerate(lengths)]
        return logits, caches


def serve(cfg, params, prompts, new_tokens: int, window: int = 8, page: int = 4, batch: int = 3, tap=False):
    model = make_model(cfg)
    run = LogitsTap(model) if tap else model
    sched = SessionScheduler(run, cfg, params, window=window, page=page, max_batch=batch, dtype=torch.float32,
                             device="cpu", impl="kernel", admit_per_step=len(prompts))
    sids = [sched.submit(p, new_tokens) for p in prompts]
    sched.run()
    out = [sched.session_tokens(s) for s in sids]
    sched.close()
    return out, run


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(attn_impl="flash")
    return cfg, params_of(cfg)


def test_sessions_match_the_reference_logits(setup):
    """Sessions of 5, 23 and 41 prompt tokens (one under the tiered ring of
    8, two past the window of 16: the sliding rings wrap, the global layer
    stages cold pages) decoded together through ``SessionScheduler``: every
    prefill and decode logit equals the reference's full forward over the
    prompt and the served tokens."""
    cfg, params = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 23, 41)]
    tokens, tap = serve(cfg, params, prompts, 9, tap=True)
    m = model_block(cfg)
    want = {}  # by the context a token was chosen after: the sessions' contexts do not overlap
    for p, toks in zip(prompts, tokens):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
        lg = ref_logits(params, m, seq)
        want.update({len(p) + j: lg[len(p) - 1 + j] for j in range(len(toks))})
    assert len(want) == len(tap.rows) == sum(len(t) for t in tokens)
    for kind, n, got in tap.rows:
        # a prefill of n tokens chooses after n; a decode row whose cache
        # holds n tokens before its append, after n + 1
        torch.testing.assert_close(got, want[n if kind == "prefill" else n + 1], **TOL)
    for p, toks in zip(prompts, tokens):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
        assert toks == ref_logits(params, m, seq)[len(p) - 1:].argmax(-1).tolist()


def test_global_layers_take_no_rope(setup):
    """The global layer's NoPE matters: the reference with RoPE on every
    layer (every layer a window wider than the sequence) misses the port's
    logits by far more than the tolerance, the reference as published
    meets them."""
    cfg, params = setup
    seq = np.random.default_rng(2).integers(0, cfg.vocab, 40)
    got = make_model(cfg).train_logits(params, torch.as_tensor(seq)[None])[0][0]
    m = model_block(cfg)
    torch.testing.assert_close(got, ref_logits(params, m, seq), **TOL)
    roped = ref_logits(params, dict(m, global_every=0, window=10**6), seq)
    assert (got - roped).abs().max() > 100 * TOL["atol"]


@pytest.mark.parametrize("held", [2, 4])
def test_expert_shares_sum_to_the_uncut_layer(held):
    """Every share's partial output of one MoE layer, the shared experts
    counted once, sums to the output of the layer holding all 8 experts,
    which equals the reference's uncut layer."""
    cfg = reduced(experts_held=8, experts_lo=0)
    p = params_of(cfg)["prefix_0"]["ffn"]
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 11, cfg.d_model)), dtype=torch.float32)
    whole, _ = L.moe_apply(p, x, cfg)
    no_shared = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_shared=0))
    parts = []
    for lo in range(0, 8, held):
        share = dict(p, **{w: p[w][lo:lo + held] for w in ("w_gate", "w_up", "w_down")})
        c = dataclasses.replace(cfg if lo == 0 else no_shared, experts_held=held, experts_lo=lo)
        parts.append(L.moe_apply(share, x, c)[0])
    torch.testing.assert_close(sum(parts), whole, rtol=1e-5, atol=1e-6)
    ref.exact_matmuls()
    want = ref.moe(x.reshape(-1, cfg.d_model), p, dict(model_block(cfg), experts_held=8, experts_lo=0), "fp32", 16)
    torch.testing.assert_close(whole.reshape(-1, cfg.d_model), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tokens,skew", [(1, False), (16, False), (16, True)], ids=["batch1", "batch16", "skewed"])
def test_share_drops_no_assignment(tokens, skew):
    """Batch 1, 16 and a skewed batch (every token's top experts the same
    held ones, far past any capacity): nothing dropped, every assignment to
    a held expert computed (the counters' held), the reference's output."""
    cfg = reduced()
    p = params_of(cfg)["prefix_0"]["ffn"]
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(1, tokens, cfg.d_model)), dtype=torch.float32)
    if skew:  # positive features and two held experts' router columns raised: every token picks both
        x = x + 3.0
        p = dict(p, router=p["router"] + torch.tensor([0, 0, 0, 0, 0.5, 0.5, 0, 0]))
    L.reset_moe_counts()
    y, _ = L.moe_apply(p, x, cfg)
    counts = L.moe_counts()
    chosen = torch.topk(torch.sigmoid(x.reshape(tokens, -1) @ p["router"]), cfg.moe.top_k).indices
    mine = int(((chosen >= cfg.experts_lo) & (chosen < cfg.experts_lo + cfg.experts_held)).sum())
    assert counts == {"routed": tokens * cfg.moe.top_k, "held": mine, "dropped": 0,
                      "experts_read": int(torch.unique(chosen[(chosen >= 4)]).numel())}
    if skew:
        assert mine >= 2 * tokens and mine > L.moe_capacity(tokens, cfg)
    ref.exact_matmuls()
    torch.testing.assert_close(y[0], ref.moe(x[0], p, model_block(cfg), "fp32", 16), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["grok_1_314b", "deepseek_v3_671b"])
def test_capacity_moe_keeps_its_path(arch):
    """grok's and deepseek's MoE: a config carrying the port-only settings
    at their defaults computes the same layer bit for bit, through the
    capacity-padded dispatch (held = routed; the grouped product unread)."""
    base = dataclasses.replace(get_reduced(arch), dtype="float32", scan_layers=False)
    port = PortArchConfig(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)})
    model = make_model(base)
    params = init_with_axes(model.init, 5, device="cpu", dtype=torch.float32)[0]
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, base.vocab, (2, 13)))
    p = next(v["ffn"] for v in params.values() if isinstance(v, dict) and "router" in v.get("ffn", {}))
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(2, 13, base.d_model)), dtype=torch.float32)
    L.reset_moe_counts()
    a = L.moe_apply(p, x, base)
    b = L.moe_apply(p, x, port)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert L.moe_counts()["held"] == L.moe_counts()["routed"] and L.moe_counts()["experts_read"] == 0
    assert torch.equal(model.train_logits(params, toks)[0], make_model(port).train_logits(params, toks)[0])


@pytest.mark.parametrize("arch", ["command_r_35b", "command_a_plus_05_2026"])
def test_session_shorter_than_the_ring_is_served(arch):
    """A session whose prompt and answer fit in less than the tiered ring
    (32 tokens: 5 + 6) is served, not refused, beside a longer one, and its
    tokens are those of one-shot prefill and greedy decode of the whole
    model."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", scan_layers=False)
    params = params_of(cfg, seed=7)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 40)]
    tokens, _ = serve(cfg, params, prompts, 6, window=32, page=8, batch=2)
    model = make_model(cfg)
    for p, toks in zip(prompts, tokens):
        seq = torch.as_tensor(np.concatenate([p, np.asarray(toks[:-1], np.int32)]))[None]
        assert toks == model.train_logits(params, seq)[0][0, len(p) - 1:].argmax(-1).tolist()


@pytest.mark.parametrize("window,cache", [(16, "tiered"), (0, "ring16"), (16, "ring8")])
def test_attention_refuses_a_cache_of_the_other_kind(setup, window, cache):
    """A window layer takes only a sliding ring of its own window, a global
    layer only a two-level cache."""
    from repro_torch.serving import SlidingKVRing, TieredKVCache

    cfg, params = setup
    c = (TieredKVCache(1, 2, 16, 8, 32, torch.float32, page=4, device="cpu") if cache == "tiered"
         else SlidingKVRing(1, 2, 16, int(cache[4:]), torch.float32, "cpu"))
    x = torch.zeros(1, 5, cfg.d_model)
    with pytest.raises(ValueError, match="sliding ring"):
        L.attention_apply(params["prefix_0"]["mixer"], x, cfg, window=window, cache=c, mode="prefill")
