"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-large-v3)
and VLM patch path (``repro_torch.models.lm``, internvl2-1b) against the JAX
package on the CPU, at reduced sizes in fp32 with TF32 off.

Parameters come from the JAX init (``init_with_axes(PRNGKey(0))``) and reach
the port through ``params_from_jax``; frames, patches and tokens come from a
numpy seed.  Tolerances: 2e-5 for cross-attention (the kernels' fp32 bar),
the model bar of ``tests/test_serving.py`` (logits relative error < 5e-3, the
same greedy tokens) for the models, 1e-4 relative for an 8-step loss
trajectory.  ``attn_impl="flash"`` runs the JAX side's Pallas kernel in
interpret mode and the port's kernel op on its plain version.
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
from repro.core import TwoLevelStore as JStore
from repro.launch import steps as jsteps
from repro.nn import layers as JL
from repro.nn.module import init_with_axes as jax_init
from repro.optim import adamw as jadamw
from repro.runtime import CheckpointManager as JCheckpointManager
import repro_torch.configs as tcfgs
from repro_torch import tree as T
from repro_torch.core import TwoLevelStore as TStore
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import port_state, reference_state
from repro_torch.models.encdec import EncDec
from repro_torch.nn import layers as TL
from repro_torch.nn.module import from_reference_layout, params_from_jax, to_reference_layout
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import CheckpointManager

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCHS = ["whisper_large_v3", "internvl2_1b"]
B, S, EXTRA = 2, 24, 4


def cfg32(pkg, arch, **kw):
    return dataclasses.replace(pkg.get_reduced(arch), dtype="float32", **kw)


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def both(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


@functools.lru_cache(maxsize=None)
def jax_model(arch):
    """The JAX model of reduced ``arch`` in fp32 and its params from PRNGKey(0)."""
    jm = jcfgs.make_model(cfg32(jcfgs, arch))
    return jm, jax.jit(lambda key: jax_init(jm.init, key, dtype=jnp.float32)[0])(jax.random.PRNGKey(0))


def inputs(cfg, seed, seq=S + EXTRA):
    """(tokens, {"frames"} or {"patches"}) as numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.encdec is not None:
        extra = {"frames": rng.normal(size=(B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)}
    else:
        extra = {"patches": rng.normal(size=(B, cfg.vlm.n_patches, cfg.vlm.patch_dim)).astype(np.float32)}
    return rng.integers(0, cfg.vocab, (B, seq)), extra


# --------------------------------------------------------------- cross_kv


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_kv_attention_matches_jax(qk_norm):
    """attention_apply(cross_kv=...): reduced whisper's attention (biases;
    T = 16 encoder frames against S = 24 queries), and with q-norm."""
    jc = cfg32(jcfgs, "whisper_large_v3", qk_norm=qk_norm)
    tc = cfg32(tcfgs, "whisper_large_v3", qk_norm=qk_norm)
    jp, _ = jax_init(lambda s: JL.attention_init(s, "a", jc), jax.random.PRNGKey(1))
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(0)
    hd, t = tc.resolved_head_dim, tc.encdec.n_frames
    xj, xt = both(rng.normal(size=(B, S, tc.d_model)))
    kj, kt = both(rng.normal(size=(B, t, tc.n_kv_heads, hd)))
    vj, vt = both(rng.normal(size=(B, t, tc.n_kv_heads, hd)))
    want, _ = JL.attention_apply(jp["a"], xj, jc, mode="train", use_rope=False, cross_kv=(kj, vj))
    got, cache = TL.attention_apply(tp["a"], xt, tc, mode="train", use_rope=False, cross_kv=(kt, vt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert cache is None


# ----------------------------------------------------------------- models


def test_encode_matches_jax():
    """The bidirectional encoder over 16 frames (sinusoids, two layers,
    final LayerNorm)."""
    jm, jp = jax_model("whisper_large_v3")
    tm = tcfgs.make_model(cfg32(tcfgs, "whisper_large_v3"))
    assert isinstance(tm, EncDec)
    _, extra = inputs(tm.cfg, 0)
    want = jax.jit(jm.encode)(jp, jnp.asarray(extra["frames"]))
    got = tm.encode(params_from_jax(jp, device="cpu"), torch.from_numpy(extra["frames"]))
    assert rel_err(got, want) < 5e-3


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(arch, attn_impl):
    """Train logits (a VLM's at its text positions), prefill (whisper after
    encoding its frames, internvl2 after its patches) and 4 decode steps,
    each step's logits and greedy tokens against the JAX model's."""
    jm, jp = jax_model(arch)
    jm = jcfgs.make_model(cfg32(jcfgs, arch, attn_impl=attn_impl))
    tm = tcfgs.make_model(cfg32(tcfgs, arch, attn_impl=attn_impl))
    tp = params_from_jax(jp, device="cpu")
    tok, extra = inputs(tm.cfg, 1)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    tx = {k: torch.from_numpy(v) for k, v in extra.items()}
    n_patches = extra["patches"].shape[1] if "patches" in extra else 0
    if tm.cfg.encdec is not None:
        jfull, _ = jax.jit(jm.train_logits)(jp, jx["frames"], jnp.asarray(tok, jnp.int32))
        full, _ = tm.train_logits(tp, tx["frames"], torch.from_numpy(tok))
    else:
        jfull, _ = jax.jit(jm.train_logits)(jp, jnp.asarray(tok, jnp.int32), jx["patches"])
        full, _ = tm.train_logits(tp, torch.from_numpy(tok), tx["patches"])
    assert full.shape == (B, S + EXTRA, tm.cfg.vocab)
    assert rel_err(full, jfull) < 5e-3
    n = n_patches + S + EXTRA + 1
    jcaches, caches = jm.init_caches(B, n, jnp.float32), tm.init_caches(B, n, torch.float32, device="cpu")
    prompt = tok[:, :S]
    if tm.cfg.encdec is not None:
        jlg, jcaches = jax.jit(jm.prefill)(jp, jx["frames"], jnp.asarray(prompt, jnp.int32), jcaches)
        lg, caches = tm.prefill(tp, tx["frames"], torch.from_numpy(prompt), caches)
    else:
        jlg, jcaches = jax.jit(jm.prefill)(jp, jnp.asarray(prompt, jnp.int32), jcaches, patches=jx["patches"])
        lg, caches = tm.prefill(tp, torch.from_numpy(prompt), caches, patches=tx["patches"])
    decode = jax.jit(jm.decode_step)
    for i in range(EXTRA + 1):
        assert rel_err(lg, jlg) < 5e-3, (arch, i)
        assert np.array_equal(lg[:, -1].argmax(-1).numpy(), np.asarray(jlg[:, -1].argmax(-1))), (arch, i)
        if i < EXTRA:
            step = tok[:, S + i : S + i + 1]
            jlg, jcaches = decode(jp, jnp.asarray(step, jnp.int32), jcaches)
            lg, caches = tm.decode_step(tp, torch.from_numpy(step), caches)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Port of tests/test_serving.py::test_decode_matches_full_forward for
    both families: prefill and decode reproduce the port's own
    teacher-forced logits."""
    tm = tcfgs.make_model(cfg32(tcfgs, arch))
    tp = params_from_jax(jax_model(arch)[1], device="cpu")
    tok, extra = inputs(tm.cfg, 2)
    tok, (extra,) = torch.from_numpy(tok), [torch.from_numpy(v) for v in extra.values()]
    if tm.cfg.encdec is not None:
        full, _ = tm.train_logits(tp, extra, tok)
        caches = tm.init_caches(B, S + EXTRA + 1, torch.float32, device="cpu")
        lg, caches = tm.prefill(tp, extra, tok[:, :S], caches)
    else:
        full, _ = tm.train_logits(tp, tok, extra)
        caches = tm.init_caches(B, tm.cfg.vlm.n_patches + S + EXTRA + 1, torch.float32, device="cpu")
        lg, caches = tm.prefill(tp, tok[:, :S], caches, patches=extra)
    scale = float(full.abs().max())
    errs = [float((lg[:, 0] - full[:, S - 1]).abs().max()) / scale]
    for i in range(EXTRA - 1):
        lg, caches = tm.decode_step(tp, tok[:, S + i : S + i + 1], caches)
        errs.append(float((lg[:, 0] - full[:, S + i]).abs().max()) / scale)
    assert max(errs) < 5e-3, (arch, errs)


def test_decoder_positions_clamp_as_the_reference():
    """The learned positions' slice starts where the reference's
    dynamic_slice starts: clamped into the table at the last rows."""
    jm, jp = jax_model("whisper_large_v3")
    tm = tcfgs.make_model(cfg32(tcfgs, "whisper_large_v3"))
    tp = params_from_jax(jp, device="cpu")
    tok = np.random.default_rng(3).integers(0, tm.cfg.vocab, (B, 3))
    for start in (0, 50, tm.cfg.max_seq_len - 3, tm.cfg.max_seq_len + 7):
        want = jm._embed_dec(jp, jnp.asarray(tok, jnp.int32), start)
        np.testing.assert_array_equal(tm._embed_dec(tp, torch.from_numpy(tok), start).numpy(), np.asarray(want))


# ----------------------------------------------------------------- serving


def test_dense_serve_loop_takes_frames_and_patches():
    """steps.dense_serve_loop with the prefill's other inputs: the tokens of
    the JAX package's jitted prefill and serve steps for both archs; the
    tiered loop serves internvl2's text alone, as the reference's does."""
    for arch in ARCHS:
        jm, jp = jax_model(arch)
        tm = tcfgs.make_model(cfg32(tcfgs, arch))
        tp = params_from_jax(jp, device="cpu")
        tok, extra = inputs(tm.cfg, 4, seq=12)
        gen, *_ = tsteps.dense_serve_loop(tm, tm.cfg, tp, torch.from_numpy(tok), 5, torch.float32,
                                          extra={k: torch.from_numpy(v) for k, v in extra.items()})
        n = tm.cfg.vlm.n_patches + 18 if tm.cfg.vlm else 18
        jcaches = jm.init_caches(B, n, jnp.float32)
        t, jcaches = jax.jit(jsteps.make_prefill_step(jm, jm.cfg))(
            jp, {"inputs": jnp.asarray(tok, jnp.int32), **{k: jnp.asarray(v) for k, v in extra.items()}}, jcaches)
        want, t = [np.asarray(t)], t[:, None]
        step = jax.jit(jsteps.make_serve_step(jm, jm.cfg))
        for _ in range(5):
            t, jcaches = step(jp, t, jcaches)
            want.append(np.asarray(t[:, 0]))
        np.testing.assert_array_equal(gen.numpy(), np.stack(want, axis=1), err_msg=arch)
    jm = jcfgs.make_model(cfg32(jcfgs, "internvl2_1b", scan_layers=False))
    jp = jax.jit(lambda k: jax_init(jm.init, k)[0])(jax.random.PRNGKey(0))
    tm = tcfgs.make_model(cfg32(tcfgs, "internvl2_1b"))
    prompts = np.random.default_rng(5).integers(0, tm.cfg.vocab, (B, 12))
    want, *_ = jsteps.tiered_serve_loop(jm, jm.cfg, jp, jnp.asarray(prompts, jnp.int32), 5, window=4, page=2,
                                        dtype=jnp.float32)
    tp = params_from_jax(jp, device="cpu")
    got, *_ = tsteps.tiered_serve_loop(tm, tm.cfg, tp, torch.from_numpy(prompts), 5, window=4, page=2,
                                       dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("argv, says", [
    (["--arch", "whisper-large-v3"], "frames"),
    (["--arch", "internvl2-1b"], "patches"),
    (["--arch", "internvl2-1b", "--kv-window", "8", "--kv-page", "4"], None),
], ids=["whisper", "internvl2_dense", "internvl2_tiered"])
def test_serve_cli_on_cpu(argv, says, monkeypatch, capsys):
    """launch/serve.py: the dense loops of both archs need inputs the CLI has
    none of (the reference's CLI passes none either), and it exits naming
    them; internvl2 serves its text through the tiered cache."""
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", *argv, "--reduced", "--batch", "2", "--prompt-len", "16",
                                      "--tokens", "4", "--device", "cpu"])
    if says:
        with pytest.raises(SystemExit, match=says):
            serve.main()
    else:
        serve.main()
        out = capsys.readouterr().out
        assert "prefill 2x16" in out and "tiered KV" in out


def test_init_params_keeps_the_tied_embedding_fp32():
    """init_params (bf16 compute): whisper's tied decoder embedding and its
    vectors stay fp32, its learned positions and matrices (the attention
    biases (H, D) among them) go to bf16, the dtype the reference casts them
    to where it reads them;
    internvl2's vlm_proj goes to bf16, its tied embedding stays fp32."""
    from repro_torch.launch.serve import init_params

    p = init_params(tcfgs.make_model(tcfgs.get_reduced("whisper_large_v3")), 0, "cpu")
    dec = p["decoder"]
    assert dec["embed"]["table"].dtype == torch.float32
    assert dec["pos"]["table"].dtype == torch.bfloat16
    assert p["encoder"]["prefix_0"]["attn"]["wq"].dtype == dec["prefix_1"]["cross_attn"]["wo"].dtype == torch.bfloat16
    assert dec["prefix_0"]["ffn"]["b_up"].dtype == p["encoder"]["final_norm"]["scale"].dtype == torch.float32
    p = init_params(tcfgs.make_model(tcfgs.get_reduced("internvl2_1b")), 0, "cpu")
    assert p["vlm_proj"]["w"].dtype == torch.bfloat16 and p["embed"]["table"].dtype == torch.float32


# ---------------------------------------------------------------- training


def test_reference_layout_round_trip():
    """Whisper's JAX tree (encoder/periods and decoder/periods, one layer a
    period, no slot) unrolls into encoder/prefix_i and decoder/prefix_i and
    stacks back exactly; internvl2's tree carries vlm_proj."""
    jc = cfg32(jcfgs, "whisper_large_v3")
    jp = jax_model("whisper_large_v3")[1]
    tp = params_from_jax(jp, device="cpu")
    assert sorted(tp["encoder"]) == ["final_norm"] + [f"prefix_{i}" for i in range(jc.encdec.n_encoder_layers)]
    assert sorted(tp["decoder"]) == ["embed", "final_norm", "pos"] + [f"prefix_{i}" for i in range(jc.n_layers)]
    np.testing.assert_array_equal(tp["decoder"]["prefix_1"]["cross_attn"]["wk"].numpy(),
                                  np.asarray(jp["decoder"]["periods"]["cross_attn"]["wk"])[1])
    back = to_reference_layout(tp, cfg32(tcfgs, "whisper_large_v3", scan_layers=False))
    g, w = T.flatten_with_path(back), jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [T.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (_, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(from_reference_layout(back)), T.leaves(tp)))
    vp = jax_model("internvl2_1b")[1]
    tv = params_from_jax(vp, device="cpu")
    np.testing.assert_array_equal(tv["vlm_proj"]["w"].numpy(), np.asarray(vp["vlm_proj"]["w"]))
    again = to_reference_layout(tv, cfg32(tcfgs, "internvl2_1b"))
    assert [T.keystr(p) for p, _ in T.flatten_with_path(again)] == \
        [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(vp)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_trajectory_matches_jax(arch):
    """8 make_train_step steps from the JAX init state on the same batches
    (frames or patches drawn with the tokens), AdamW with run_training's
    schedule: loss and ce at every step within 1e-4 relative, the final
    params within 1e-4 (tests/test_torch_families.py's bar)."""
    jc, tc = cfg32(jcfgs, arch), cfg32(tcfgs, arch)
    jm, jp = jax_model(arch)
    jopt = jadamw.AdamW(learning_rate=jadamw.cosine_warmup(1e-3, 10, 20))
    topt = tadamw.AdamW(learning_rate=tadamw.cosine_warmup(1e-3, 10, 20))
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = port_state(T.tree_map(lambda x: torch.from_numpy(np.array(x)), jstate))
    jstep = jax.jit(jsteps.make_train_step(jm, jc, jopt))
    tstep = tsteps.make_train_step(tcfgs.make_model(tc), tc, topt)
    for i in range(8):
        toks, extra = inputs(tc, 10 + i, seq=17)
        batch = {"inputs": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32), **extra}
        jstate, jmet = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "ce"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-4, err_msg=f"{key} step {i}")
    got = T.flatten_with_path(reference_state(tstate, tc)["params"])
    want = jax.tree_util.tree_flatten_with_path(jstate["params"])[0]
    assert [T.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=T.keystr(path))


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_whisper_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """A reduced-whisper train state (both stacks, their moments) saved by
    one package's manager restores bit-identical in the other's."""
    jp = jax_model("whisper_large_v3")[1]
    jstate = {"params": jp, "opt": jadamw.AdamW(learning_rate=1e-3).init(jp), "step": jnp.asarray(3, jnp.int32)}
    jstate["opt"]["m"] = jax.tree_util.tree_map(lambda x: x * 0.5, jp)  # moments that differ from zero
    tstate = port_state(T.tree_map(lambda x: torch.from_numpy(np.array(x)), jstate))
    tc = cfg32(tcfgs, "whisper_large_v3")
    kw = dict(mem_capacity_bytes=64 * 2**20, block_bytes=2**20)
    if writer == "jax_package":
        with JStore(str(tmp_path / "s"), **kw) as st:
            JCheckpointManager(st, tag="w").save(3, jstate)
        with TStore(str(tmp_path / "s"), **kw) as st:
            step, got = CheckpointManager(st, tag="w").restore(
                reference_state(T.tree_map(torch.zeros_like, tstate), tc))
        assert step == 3
        got = port_state(got)
        g, w = T.flatten_with_path(got), T.flatten_with_path(tstate)
        assert [p for p, _ in g] == [p for p, _ in w]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(g, w))
    else:
        with TStore(str(tmp_path / "s"), **kw) as st:
            CheckpointManager(st, tag="w").save(3, reference_state(tstate, tc))
        with JStore(str(tmp_path / "s"), **kw) as st:
            step, got = JCheckpointManager(st, tag="w").restore(jax.tree_util.tree_map(jnp.zeros_like, jstate))
        assert step == 3
        g, w = jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_flatten_with_path(jstate)[0]
        assert [p for p, _ in g] == [p for p, _ in w]
        for (_, a), (_, b) in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
