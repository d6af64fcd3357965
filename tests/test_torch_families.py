"""The port's MoE, MLA and multi-token-prediction layers and the four decoder
configs they complete (grok-1-314b, deepseek-v3-671b, command-r-35b,
gemma3-1b) against the JAX package on the CPU, at reduced sizes in fp32
with TF32 off.

Parameters come from the JAX init (``init_with_axes(PRNGKey(0))``) and reach
the port through ``params_from_jax``; inputs come from a numpy seed.
Tolerances: 2e-5 for the MoE and MLA layers (1e-6 for the aux loss), the
model bar of ``tests/test_serving.py`` (logits relative error < 5e-3, the
same greedy tokens) for the LMs, 1e-4 relative for an 8-step loss
trajectory.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.launch import steps as jsteps
from repro.nn import layers as JL
from repro.nn.module import init_with_axes as jax_init
from repro.optim import adamw as jadamw
from repro.runtime import CheckpointManager as JCheckpointManager
from repro.core import TwoLevelStore as JStore
import repro_torch.configs as tcfgs
from repro_torch import tree as T
from repro_torch.core import TwoLevelStore as TStore
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import port_state, reference_state
from repro_torch.nn import layers as TL
from repro_torch.nn.module import from_reference_layout, params_from_jax, to_reference_layout
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import CheckpointManager

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEW_ARCHS = ["grok_1_314b", "deepseek_v3_671b", "command_r_35b", "gemma3_1b"]
B, S, EXTRA = 2, 24, 3


def cfg32(pkg, arch, **kw):
    return dataclasses.replace(pkg.get_reduced(arch), dtype="float32", **kw)


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def both(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def jax_lm(arch):
    """The JAX model of reduced ``arch`` in fp32 and its params from
    PRNGKey(0) (the init jitted: the same values, drawn in one dispatch)."""
    jm = jcfgs.make_model(cfg32(jcfgs, arch))
    return jm, jax.jit(lambda key: jax_init(jm.init, key, dtype=jnp.float32)[0])(jax.random.PRNGKey(0))


def jax_state(arch):
    """The JAX package's train state of ``jax_lm(arch)`` (``init_state``'s)."""
    _, jp = jax_lm(arch)
    return {"params": jp, "opt": jadamw.AdamW(learning_rate=1e-3).init(jp), "step": jnp.zeros((), jnp.int32)}


def torch_lm(arch):
    """The port's model of reduced ``arch`` in fp32, with its own init."""
    from repro_torch.nn.module import init_with_axes

    tm = tcfgs.make_model(cfg32(tcfgs, arch, scan_layers=False))
    return tm, init_with_axes(tm.init, 0, device="cpu")[0]


@pytest.fixture(scope="module", params=NEW_ARCHS)
def lm_pair(request):
    """(arch, JAX model, JAX params, port model, port params) in fp32."""
    jm, jp = jax_lm(request.param)
    return request.param, jm, jp, tcfgs.make_model(cfg32(tcfgs, request.param)), params_from_jax(jp, device="cpu")


# ------------------------------------------------------------------------ MoE


@pytest.mark.parametrize("arch", ["grok_1_314b", "deepseek_v3_671b"])
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_matches_jax(arch, capacity_factor):
    """moe_apply at the config's capacity (no token dropped) and at a
    capacity factor of 0.5, where assignments are dropped: reduced grok
    (softmax router) and reduced deepseek (sigmoid router + shared expert)."""
    moe = lambda pkg: cfg32(pkg, arch).moe
    cf = {} if capacity_factor is None else dict(capacity_factor=capacity_factor)
    jc = cfg32(jcfgs, arch, moe=dataclasses.replace(moe(jcfgs), **cf))
    tc = cfg32(tcfgs, arch, moe=dataclasses.replace(moe(tcfgs), **cf))
    jp, _ = jax_init(lambda s: JL.moe_init(s, "ffn", jc), jax.random.PRNGKey(1))
    tp = params_from_jax(jp, device="cpu")
    xj, xt = both(np.random.default_rng(0).normal(size=(B, S, tc.d_model)))
    want, jaux = jax.jit(JL.moe_apply, static_argnums=2)(jp["ffn"], xj, jc)
    TL.reset_moe_counts()
    got, aux = TL.moe_apply(tp["ffn"], xt, tc)
    counts = TL.moe_counts()
    close(got, want, 2e-5)
    close(aux, jaux, 1e-6)
    assert counts["routed"] == B * S * tc.moe.top_k
    cap = TL.moe_capacity(B * S, tc)
    assert cap == int(max(1, round(B * S * tc.moe.top_k / tc.moe.n_experts * tc.moe.capacity_factor)))
    assert (counts["dropped"] > 0) == (capacity_factor is not None)


def test_moe_capacity_rounds_as_python_round():
    """The full configs' capacities at serving: grok prefill of 4 x 1024
    tokens gives 1280 slots an expert, deepseek's 160, and one token a row
    at decode (B = 4) one slot; 2.5 rounds to 2 (Python's round)."""
    grok, ds = tcfgs.get_config("grok_1_314b"), tcfgs.get_config("deepseek_v3_671b")
    assert [TL.moe_capacity(t, grok) for t in (4096, 4)] == [1280, 1]
    assert [TL.moe_capacity(t, ds) for t in (4096, 4)] == [160, 1]
    half = dataclasses.replace(grok, moe=dataclasses.replace(grok.moe, n_experts=4, top_k=1, capacity_factor=1.0))
    assert TL.moe_capacity(10, half) == 2


def test_moe_combine_is_deterministic_and_differentiable():
    """Two calls give the same bits, and every expert weight that a kept
    assignment reaches gets a gradient."""
    tc = cfg32(tcfgs, "deepseek_v3_671b")
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=0.5))
    jp, _ = jax_init(lambda s: JL.moe_init(s, "ffn", cfg32(jcfgs, "deepseek_v3_671b")), jax.random.PRNGKey(2))
    tp = T.tree_map(lambda t: t.requires_grad_(), params_from_jax(jp, device="cpu"))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(B, S, tc.d_model)).astype(np.float32))
    a, aux = TL.moe_apply(tp["ffn"], x, tc)
    assert torch.equal(a, TL.moe_apply(tp["ffn"], x, tc)[0])
    (a.sum() + aux).backward()
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert bool(tp["ffn"][name].grad.abs().sum() > 0), name


# ------------------------------------------------------------------------ MLA


def test_mla_matches_jax_in_train_prefill_and_decode():
    """mla_apply in its three modes: train, prefill (the latent cache it
    writes) and three decode steps on top of it, each within 2e-5."""
    jc, tc = cfg32(jcfgs, "deepseek_v3_671b"), cfg32(tcfgs, "deepseek_v3_671b")
    jp, _ = jax_init(lambda s: JL.mla_init(s, "mixer", jc), jax.random.PRNGKey(3))
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(2)
    xj, xt = both(rng.normal(size=(B, S + EXTRA, tc.d_model)))
    mla = jax.jit(JL.mla_apply, static_argnums=2, static_argnames="mode")
    want, _ = mla(jp["mixer"], xj, jc, mode="train")
    close(TL.mla_apply(tp["mixer"], xt, tc, mode="train")[0], want, 2e-5)

    jcache = JL.mla_make_cache(jc, B, S + EXTRA, jnp.float32)
    tcache = TL.mla_make_cache(tc, B, S + EXTRA, torch.float32, "cpu")
    want, jcache = mla(jp["mixer"], xj[:, :S], jc, jcache, mode="prefill")
    got, tcache = TL.mla_apply(tp["mixer"], xt[:, :S], tc, tcache, mode="prefill")
    close(got, want, 2e-5)
    for name in ("c_kv", "k_pe"):
        close(tcache[name], jcache[name], 2e-5)
    assert tcache["index"] == int(jcache["index"]) == S
    for i in range(S, S + EXTRA):
        want, jcache = mla(jp["mixer"], xj[:, i : i + 1], jc, jcache, mode="decode")
        got, tcache = TL.mla_apply(tp["mixer"], xt[:, i : i + 1], tc, tcache, mode="decode")
        close(got, want, 2e-5)
    assert tcache["index"] == S + EXTRA


# ----------------------------------------------------------------- the models


def test_decode_matches_full_forward(lm_pair):
    """Port of tests/test_serving.py::test_decode_matches_full_forward: prefill
    and decode reproduce the port's own teacher-forced logits."""
    arch, _, _, tm, tp = lm_pair
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, tm.cfg.vocab, (B, S + EXTRA)))
    full, _ = tm.train_logits(tp, tok)
    scale = float(full.abs().max())
    caches = tm.init_caches(B, S + EXTRA + 1, torch.float32, device="cpu")
    lg, caches = tm.prefill(tp, tok[:, :S], caches)
    errs = [float((lg[:, 0] - full[:, S - 1]).abs().max()) / scale]
    for i in range(EXTRA):
        lg, caches = tm.decode_step(tp, tok[:, S + i : S + i + 1], caches)
        errs.append(float((lg[:, 0] - full[:, S + i]).abs().max()) / scale)
    assert max(errs) < 5e-3, (arch, errs)


def test_logits_match_jax(lm_pair):
    """Train logits (and the MoE aux loss), prefill and each decode step's
    logits against the JAX model's, with the same greedy tokens."""
    arch, jm, jp, tm, tp = lm_pair
    tok = np.random.default_rng(1).integers(0, tm.cfg.vocab, (B, S + EXTRA))
    jfull, jaux = jax.jit(jm.train_logits)(jp, jnp.asarray(tok, jnp.int32))
    full, aux = tm.train_logits(tp, torch.from_numpy(tok))
    assert rel_err(full, jfull) < 5e-3
    close(aux, jaux, 1e-6)
    jcaches = jm.init_caches(B, S + EXTRA + 1, jnp.float32)
    caches = tm.init_caches(B, S + EXTRA + 1, torch.float32, device="cpu")
    jlg, jcaches = jax.jit(jm.prefill)(jp, jnp.asarray(tok[:, :S], jnp.int32), jcaches)
    lg, caches = tm.prefill(tp, torch.from_numpy(tok[:, :S]), caches)
    decode = jax.jit(jm.decode_step)
    for i in range(EXTRA + 1):
        assert rel_err(lg, jlg) < 5e-3, (arch, i)
        assert np.array_equal(lg[:, -1].argmax(-1).numpy(), np.asarray(jlg[:, -1].argmax(-1))), (arch, i)
        if i < EXTRA:
            step = tok[:, S + i : S + i + 1]
            jlg, jcaches = decode(jp, jnp.asarray(step, jnp.int32), jcaches)
            lg, caches = tm.decode_step(tp, torch.from_numpy(step), caches)


def test_mtp_logits_match_jax():
    """DeepSeek's MTP head (t+2 from [h_t; emb(t+1)]) on the JAX hidden
    states' counterparts."""
    jm, jp = jax_lm("deepseek_v3_671b")
    tm, tp = tcfgs.make_model(cfg32(tcfgs, "deepseek_v3_671b")), params_from_jax(jp, device="cpu")
    tok = np.random.default_rng(4).integers(0, tm.cfg.vocab, (B, S))
    jh, _ = jax.jit(jm.train_hidden)(jp, jnp.asarray(tok, jnp.int32))
    th, _ = tm.train_hidden(tp, torch.from_numpy(tok))
    close(th, jh, 1e-4)
    want = jax.jit(jm.mtp_logits)(jp, jnp.asarray(tok[:, 1:], jnp.int32), jh[:, :-1])
    assert rel_err(tm.mtp_logits(tp, torch.from_numpy(tok[:, 1:]), th[:, :-1]), want) < 5e-3


def test_windowed_ring_cache_long_decode():
    """Port of tests/test_serving.py::test_windowed_ring_cache_long_decode:
    reduced gemma3 decodes far past its 16-token window; the local layers'
    ring pages stay exact against the full forward."""
    tm, tp = torch_lm("gemma3_1b")
    total = 3 * tm.cfg.window + 5
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, tm.cfg.vocab, (1, total)))
    full, _ = tm.train_logits(tp, tok)
    caches = tm.init_caches(1, total + 1, torch.float32, device="cpu")
    assert {c["k"].shape[1] for c, spec in zip(caches.values(), tm.prefix) if spec.window} == {tm.cfg.window}
    lg, caches = tm.prefill(tp, tok[:, :8], caches)
    scale = float(full.abs().max())
    worst = float((lg[:, 0] - full[:, 7]).abs().max()) / scale
    for i in range(8, total):
        lg, caches = tm.decode_step(tp, tok[:, i : i + 1], caches)
        worst = max(worst, float((lg[:, 0] - full[:, i]).abs().max()) / scale)
    assert worst < 5e-3, worst


def test_tiered_serving_keeps_windowed_and_latent_caches():
    """make_tiered_caches: gemma3's global layers get the two-level cache and
    its local layers sliding rings; deepseek's MLA layers keep their
    latent caches; the tiered loop gives the dense loop's tokens."""
    from repro_torch.serving import TieredKVCache

    for arch, tiered in (("gemma3_1b", {5}), ("deepseek_v3_671b", set())):
        model, params = torch_lm(arch)
        cfg = model.cfg
        caches = tsteps.make_tiered_caches(model, cfg, 2, 40, 8, 4, torch.float32, "cpu")
        assert {i for i, c in enumerate(caches.values()) if isinstance(c, TieredKVCache)} == tiered
        prompts = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 20)))
        dense, *_ = tsteps.dense_serve_loop(model, cfg, params, prompts, 10, torch.float32)
        gen, *_ = tsteps.tiered_serve_loop(model, cfg, params, prompts, 10, window=8, page=4, dtype=torch.float32)
        assert torch.equal(gen, dense), arch


# ------------------------------------------------------------ the kernels' shapes


@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_every_config_shape_is_taken_by_both_launchers(which):
    """Every GQA layer of every config of the port, full and reduced, has a
    (G, D) both launchers' shape checks take (D = 12 zero-padded to 16), and
    the reduced command-r runs its kernels at D = 12."""
    from repro_torch.kernels import flash_attention, tiered_decode
    from repro_torch.models.lm import layer_specs

    seen = set()
    for arch in tcfgs.ARCH_IDS:
        cfg = getattr(tcfgs, which)(arch)
        if any(spec.mixer == "gqa" for spec in layer_specs(cfg)):
            h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
            assert flash_attention.check_shape(h, kv, d) >= d and tiered_decode.check_shape(h, kv, d) >= d, arch
            seen.add((h // kv, d))
    assert (4, 12) in seen if which == "get_reduced" else {(6, 128), (4, 256), (8, 128)} <= seen
    assert flash_attention.check_shape(8, 2, 12) == tiered_decode.check_shape(8, 2, 12) == 16
    assert flash_attention.check_shape(4, 1, 128) == tiered_decode.check_shape(4, 1, 128) == 128


# ----------------------------------------------------------------- training


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "grok_1_314b"])
def test_loss_trajectory_matches_jax(arch):
    """8 train steps from the JAX init state on the same batches: loss, ce,
    moe_aux and (deepseek) mtp_ce at every step within 1e-4 relative, and
    the final params within 1e-4 (AdamW moves a parameter by up to the
    learning rate, 1e-3, a step whatever its gradient's size, so a gradient
    near zero that the two packages round apart moves it apart by that
    much)."""
    assert (tsteps.MOE_AUX_WEIGHT, tsteps.MTP_WEIGHT) == (jsteps.MOE_AUX_WEIGHT, jsteps.MTP_WEIGHT)
    jc, tc = cfg32(jcfgs, arch), cfg32(tcfgs, arch)
    jm, jstate = jax_lm(arch)[0], jax_state(arch)
    tstate = port_state(T.tree_map(lambda x: torch.from_numpy(np.array(x)), jstate))
    jstep = jax.jit(jsteps.make_train_step(jm, jc, jadamw.AdamW(learning_rate=1e-3)))
    tstep = tsteps.make_train_step(tcfgs.make_model(tc), tc, tadamw.AdamW(learning_rate=1e-3))
    rng = np.random.default_rng(6)
    keys = ["loss", "ce", "moe_aux"] + (["mtp_ce"] if tc.mtp else [])
    for _ in range(8):
        toks = rng.integers(0, jc.vocab, (4, 17)).astype(np.int32)
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        jstate, jmet = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in keys:
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-4, err_msg=key)
    got = T.flatten_with_path(reference_state(tstate, tc)["params"])
    for (path, a), b in zip(got, jax.tree_util.tree_leaves(jstate["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=T.keystr(path))


def test_reference_layout_round_trip_deepseek():
    """Reduced deepseek's JAX tree (a dense prefix_0, scanned MoE periods and
    the mtp subtree) unrolls into the port's layers and stacks back exactly."""
    jc = cfg32(jcfgs, "deepseek_v3_671b")
    jp = jax_lm("deepseek_v3_671b")[1]
    assert {"prefix_0", "periods", "mtp"} <= set(jp)
    tp = params_from_jax(jp, device="cpu")
    assert sorted(k for k in tp if k.startswith("prefix_")) == [f"prefix_{i}" for i in range(jc.n_layers)]
    assert "router" in tp["prefix_1"]["ffn"] and "router" not in tp["prefix_0"]["ffn"]
    np.testing.assert_array_equal(tp["prefix_3"]["ffn"]["w_gate"].numpy(),
                                  np.asarray(jp["periods"]["slot_0"]["ffn"]["w_gate"])[2])
    back = to_reference_layout(tp, cfg32(tcfgs, "deepseek_v3_671b"))
    g, w = T.flatten_with_path(back), jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [T.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (_, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    again = from_reference_layout(back)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(again), T.leaves(tp)))


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_deepseek_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """A reduced-deepseek train state (MoE periods, mtp subtree) saved by one
    package's manager restores bit-identical in the other's, and both
    managers write the same bytes for it."""
    jstate = jax_state("deepseek_v3_671b")
    tstate = port_state(T.tree_map(lambda x: torch.from_numpy(np.array(x)), jstate))
    tc = cfg32(tcfgs, "deepseek_v3_671b")
    kw = dict(mem_capacity_bytes=64 * 2**20, block_bytes=2**20)
    if writer == "jax_package":
        with JStore(str(tmp_path / "s"), **kw) as st:
            JCheckpointManager(st, tag="t").save(2, jstate)
        with TStore(str(tmp_path / "s"), **kw) as st:
            step, got = CheckpointManager(st, tag="t").restore(
                reference_state(T.tree_map(torch.zeros_like, tstate), tc))
        assert step == 2
        assert all(torch.equal(a, b) for a, b in zip(T.leaves(port_state(got)), T.leaves(tstate)))
    else:
        with TStore(str(tmp_path / "s"), **kw) as st:
            CheckpointManager(st, tag="t").save(2, reference_state(tstate, tc))
        with JStore(str(tmp_path / "j"), **kw) as st:
            JCheckpointManager(st, tag="t").save(2, jstate)
        with TStore(str(tmp_path / "s"), **kw) as ts, JStore(str(tmp_path / "j"), **kw) as js:
            names = sorted(n for n in ts.list_files() if n.startswith("ckpt/t/"))
            assert names == sorted(n for n in js.list_files() if n.startswith("ckpt/t/"))
            assert all(ts.get(n) == js.get(n) for n in names)
        with JStore(str(tmp_path / "s"), **kw) as st:
            step, got = JCheckpointManager(st, tag="t").restore(jstate)
        assert step == 2
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_cli_takes_moe_and_mla_archs(tmp_path, monkeypatch, capsys):
    """launch/train.py on the CPU with reduced deepseek (MoE aux + MTP)."""
    from repro_torch.launch import train

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "deepseek-v3-671b", "--reduced", "--steps", "3",
                                      "--device", "cpu", "--store", str(tmp_path / "store"), "--ckpt-mode", "sync"])
    train.main()
    out = capsys.readouterr().out
    assert [l.split()[1] for l in out.splitlines() if l.startswith("step")] == ["0", "1", "2"]
    assert "done: 3 steps run (0 restarts)" in out


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("argv", [
    ["--arch", "grok-1-314b", "--layers", "2"],
    ["--arch", "deepseek-v3-671b"],
    ["--arch", "command-r-35b", "--kv-window", "16", "--kv-page", "8"],
    ["--arch", "gemma3-1b", "--kv-window", "16", "--kv-page", "8"],
], ids=["grok", "deepseek", "command_r", "gemma3"])
def test_serve_cli_on_cpu(argv, monkeypatch, capsys):
    """launch/serve.py serves each new arch, reduced, on the CPU; MoE archs
    print the assignments they dropped."""
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", *argv, "--reduced", "--batch", "2", "--prompt-len", "24",
                                      "--tokens", "6", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill 2x24" in out and "decode 6 steps" in out
    assert ("moe:" in out) == ("grok" in argv[1] or "deepseek" in argv[1])
    assert ("tiered KV" in out) == ("--kv-window" in argv)


def test_softcap_arch_refuses_kv_window():
    from repro_torch.launch.serve import tiered_serve

    with pytest.raises(SystemExit, match="softcap"):
        tiered_serve(tcfgs.get_reduced("grok_1_314b"), 1, 8, 2, window=4, page=2, device="cpu")


# sha1 over (key path, dtype, bytes) of every leaf of init_params(reduced
# arch, seed 3) on the CPU, as the port drew them before init cast leaf by
# leaf (fp32 tree drawn whole, then cast_matrices).
INIT_SHA1 = {"qwen3_8b": "0f9cbf47c3009eef4b841372bbfd68fc643d4bf5",
             "starcoder2_3b": "b7c900e34fd1a359290035b48b5b19e1be9bc065",
             "recurrentgemma_9b": "d6f25125c70609c3f83e8f60e3493a395d285485",
             "xlstm_125m": "63ff171fbce829e34459a2e14e77ae6aea0f011c"}


def test_init_params_casts_leaf_by_leaf_to_the_same_values():
    """init_params casts each matrix as it is drawn: the same values as
    drawing the fp32 tree and casting it afterwards (reduced deepseek and
    grok, bf16 compute: deepseek's untied head and the vectors stay fp32),
    and for the archs served before, the very bytes the port drew then."""
    import hashlib

    from repro_torch.launch.serve import init_params
    from repro_torch.nn.module import cast_matrices, init_with_axes
    from repro_torch.nn.recurrent import FP32_MATRICES

    for arch, want in INIT_SHA1.items():
        h = hashlib.sha1()
        for path, t in T.flatten_with_path(init_params(tcfgs.make_model(tcfgs.get_reduced(arch)), 3, "cpu")):
            h.update(T.keystr(path).encode())
            h.update(str(t.dtype).encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
        assert h.hexdigest() == want, arch

    for arch in ("deepseek_v3_671b", "grok_1_314b", "recurrentgemma_9b"):
        model = tcfgs.make_model(tcfgs.get_reduced(arch))
        got = init_params(model, seed=3, device="cpu")
        keep = ("head", *FP32_MATRICES) + (("embed",) if model.cfg.tie_embeddings else ())
        want = cast_matrices(init_with_axes(model.init, 3, device="cpu")[0], torch.bfloat16, keep)
        g, w = T.flatten_with_path(got), T.flatten_with_path(want)
        assert [T.keystr(p) for p, _ in g] == [T.keystr(p) for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b), (arch, T.keystr(path))
    assert got["prefix_0"]["mixer"]["w_a"].dtype == torch.float32  # recurrentgemma's fp32 gate matrix
