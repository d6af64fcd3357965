"""Recurrent training in the port (reduced recurrentgemma-9b and xlstm-125m)
and rematerialisation, against the JAX package on the CPU.

Both packages start from the JAX init (PRNGKey(0), fp32, TF32 off).  Bars:
- losses: 1e-5 relative at every step of an 8-step run;
- step-1 gradients, leaf by leaf: within 5e-5 of the leaf's largest
  gradient, plus 1e-9 absolute (sLSTM's input-gate bias has gradients of
  1e-11, rounding noise on a loss of 6);
- final params after 8 steps: 3e-4 absolute.  The gradient functions agree
  (the step-1 test), but AdamW moves a parameter by up to its learning rate
  (1e-3) a step whatever its gradient's size, so a near-zero gradient the
  two packages round apart moves it apart by that much; the parted states
  then give parted gradients.  recurrentgemma's ``embed.table[359, 57]``
  ends 1.72e-4 apart (its token enters at step 2, from states parted at
  step 1 by ``wq`` elements whose gradients of ~5e-9 the packages round to
  opposite signs), xlstm's mLSTM gate biases ``b_if`` 8.7e-5.
"""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import TwoLevelStore as JStore
from repro.launch import steps as jsteps
from repro.launch.train import run_training as jax_run_training
from repro.nn.module import init_with_axes as jax_init
from repro.optim import adamw as jadamw
from repro.runtime import CheckpointManager as JCheckpointManager
import repro_torch.configs as tcfgs
from repro_torch import tree as T
from repro_torch.core import TwoLevelStore as TStore
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import reference_state, run_training
from repro_torch.models import lm as tlm
from repro_torch.nn.module import init_with_axes, params_from_jax
from repro_torch.runtime import CheckpointManager

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCHS = ["recurrentgemma_9b", "xlstm_125m"]
LOSS_RTOL = 1e-5
PARAM_ATOL = 3e-4


def cfg32(pkg, arch, **kw):
    return dataclasses.replace(pkg.get_reduced(arch), dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    jm = jcfgs.make_model(cfg32(jcfgs, arch))
    return jax.jit(lambda key: jax_init(jm.init, key, dtype=jnp.float32)[0])(jax.random.PRNGKey(0))


def batch(vocab, seed=6, shape=(4, 17)):
    toks = np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def grads_both(arch, remat="none"):
    """(port grads in the reference's layout, JAX grads, port loss, JAX loss)
    of one batch at the JAX init."""
    jc, tc = cfg32(jcfgs, arch, remat=remat), cfg32(tcfgs, arch, remat=remat)
    jp = jax_params(arch)
    b = batch(jc.vocab)
    jloss, jg = jax.value_and_grad(lambda p: jsteps.make_loss_fn(jcfgs.make_model(jc), jc)(p, b)[0])(jp)
    tp = T.tree_map(lambda p: p.requires_grad_(), params_from_jax(jp, device="cpu"))
    tloss, _ = tsteps.make_loss_fn(tcfgs.make_model(tc), tc)(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    tloss.backward()
    grads = T.tree_map(lambda p: p.grad, tp)
    tg = reference_state({"params": grads, "opt": {"m": grads, "v": grads}}, tc)["params"]
    return tg, jg, float(tloss.detach()), float(jloss)


def assert_grads_close(tg, jg):
    got, want = T.flatten_with_path(tg), jax.tree_util.tree_leaves(jg)
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        b = np.asarray(b)
        apart = np.abs(a.numpy() - b).max()
        assert apart <= 5e-5 * np.abs(b).max() + 1e-9, (T.keystr(path), apart, np.abs(b).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_step1_gradients_match_jax_leaf_by_leaf(arch):
    tg, jg, tloss, jloss = grads_both(arch)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert_grads_close(tg, jg)


def test_remat_full_matches_jax_with_the_same():
    """``remat="full"`` in both packages: the JAX package wraps each scanned
    period in ``jax.checkpoint``, the port each period of its unrolled stack
    in ``torch.utils.checkpoint``; loss and gradients agree at the
    step-1 bars."""
    tg, jg, tloss, jloss = grads_both("recurrentgemma_9b", remat="full")
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert_grads_close(tg, jg)


def port_grads(cfg, b, save_counter=None):
    """(loss, {leaf name: grad}, bytes autograd saved) of the port at its own
    init; ``save_counter`` adds the bytes a selective checkpoint keeps
    outside the saved-tensor hooks."""
    model = tcfgs.make_model(cfg)
    params = T.tree_map(lambda p: p.requires_grad_(), init_with_axes(model.init, 0, device="cpu")[0])
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tsteps.make_loss_fn(model, cfg)(params, b)
    loss.backward()
    extra = save_counter[0] if save_counter else 0
    return loss, {T.keystr(p): v.grad for p, v in T.flatten_with_path(params)}, saved[0] + extra


@pytest.mark.parametrize("arch,remat", [(a, r) for a in ARCHS for r in ("full", "dots")]
                         + [("whisper_large_v3", "full")])
def test_remat_gives_identical_gradients_and_saves_less(arch, remat, monkeypatch):
    """Rematerialised periods (the encoder-decoder: layers) give the loss and
    every gradient of ``remat="none"`` bit for bit (recompute is
    deterministic on the CPU), and autograd keeps fewer bytes: ``"full"``
    keeps only each period's input, ``"dots"`` also its matrix products'
    outputs (counted from the policy: the selective checkpoint holds them in
    a cache of its own)."""
    kept = [0]

    policy = tlm.save_matmuls

    def counting_policy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2], args[-1]
            kept[0] += a.shape[:-1].numel() * b.shape[-1] * a.element_size()
        return decision

    monkeypatch.setattr(tlm, "save_matmuls", counting_policy)
    base = cfg32(tcfgs, arch)
    b = {k: torch.from_numpy(v) for k, v in batch(base.vocab).items()}
    if base.encdec is not None:
        b["frames"] = torch.from_numpy(np.random.default_rng(7).normal(
            size=(4, base.encdec.n_frames, base.d_model)).astype(np.float32))
    loss0, g0, saved0 = port_grads(base, b)
    loss1, g1, saved1 = port_grads(dataclasses.replace(base, remat=remat), b, kept)
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert (kept[0] > 0) == (remat == "dots")
    assert saved1 < saved0, (saved1, saved0)


def test_remat_wraps_only_training_periods(monkeypatch):
    """The reference's partition: each period is wrapped, the unrolled
    suffix layer is not, and serving (no grad) is untouched."""
    cfg = dataclasses.replace(cfg32(tcfgs, "recurrentgemma_9b"), n_layers=7, remat="full")  # 2 periods + 1 suffix
    model = tcfgs.make_model(cfg)
    calls = []
    real = tlm.checkpoint
    monkeypatch.setattr(tlm, "checkpoint", lambda fn, *args, **kw: calls.append(args[3:]) or real(fn, *args, **kw))
    params = init_with_axes(model.init, 0, device="cpu")[0]
    toks = torch.from_numpy(batch(cfg.vocab)["inputs"])
    model.train_logits(params, toks)
    assert calls == [(0, 3), (3, 3)]
    with torch.no_grad():
        model.prefill(params, toks, model.init_caches(toks.shape[0], toks.shape[1] + 1, torch.float32, "cpu"))
    assert calls == [(0, 3), (3, 3)]


def jstore(root):
    return JStore(str(root), mem_capacity_bytes=64 * 2**20, block_bytes=2**20)


def tstore(root):
    return TStore(str(root), mem_capacity_bytes=64 * 2**20, block_bytes=2**20)


def uncommit(root, tag, step):
    """The store as a host lost while saving ``step`` leaves it: the step's
    COMMIT never landed, so a resume takes the checkpoint before it."""
    with tstore(root) as st:
        assert st.delete(f"ckpt/{tag}/step_{step:08d}/COMMIT")


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_matches_jax_and_checkpoints_cross(arch, tmp_path):
    """``run_training`` in both packages from the JAX init state (a step-0
    checkpoint written by the JAX package), 8 steps with sync checkpoints at
    4 and 8: the same losses a step and final params within PARAM_ATOL.
    Then the checkpoints cross mid-run: the port resumes the JAX run's store
    at step 4 (its step-8 commit lost) and runs steps 4-7 to the JAX run's
    losses and params; the JAX package restores the port's step-4 and
    step-8 checkpoints, which hold the port's states bit for bit (cursor
    and step included) and the JAX run's at PARAM_ATOL."""
    jc, tc = cfg32(jcfgs, arch), cfg32(tcfgs, arch)
    jp = jax_params(arch)
    state = {"params": jp, "opt": jadamw.AdamW(learning_rate=1e-3).init(jp), "step": jnp.zeros((), jnp.int32),
             "pipeline": {"epoch": np.int64(0), "step": np.int64(0)}}
    with jstore(tmp_path / "j") as st:
        JCheckpointManager(st, tag=jc.name).save(0, state)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    kw = dict(total_steps=8, ckpt_every=4, ckpt_mode="sync", seq_len=16, global_batch=4)
    with jstore(tmp_path / "j") as st:
        want = jax_run_training(jc, st, **kw)
    with tstore(tmp_path / "t") as st:
        got = run_training(tc, st, device="cpu", **kw)
    assert got.steps_run == want.steps_run == 8
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)

    shutil.copytree(tmp_path / "j", tmp_path / "j_to_t")
    uncommit(tmp_path / "j_to_t", jc.name, 8)
    with tstore(tmp_path / "j_to_t") as st:
        resumed = run_training(tc, st, device="cpu", **kw)
    assert resumed.steps_run == 4
    np.testing.assert_allclose(resumed.losses, want.losses[4:], rtol=LOSS_RTOL)
    leaves = jax.tree_util.tree_leaves(want.state["params"])
    for run in (got, resumed):
        for (path, a), b in zip(T.flatten_with_path(reference_state(run.state, tc)["params"]), leaves):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=PARAM_ATOL, err_msg=T.keystr(path))

    with jstore(tmp_path / "j") as st:
        _, jax4 = JCheckpointManager(st, tag=jc.name).restore(want.state, step=4)
    with jstore(tmp_path / "t") as st:
        mgr = JCheckpointManager(st, tag=jc.name)
        back = {step: mgr.restore(want.state, step=step)[1] for step in (4, 8)}
    with tstore(tmp_path / "t") as st:
        port4 = CheckpointManager(st, tag=tc.name).restore(reference_state(got.state, tc), step=4)[1]
    for step, port in ((4, port4), (8, reference_state(got.state, tc))):
        for (path, a), b in zip(T.flatten_with_path(port), jax.tree_util.tree_leaves(back[step])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"step {step} {T.keystr(path)}")
    assert int(back[4]["step"]) == 4 and back[4]["pipeline"] == jax4["pipeline"]
    for (path, a), b in zip(T.flatten_with_path(back[4]["params"]), jax.tree_util.tree_leaves(jax4["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=PARAM_ATOL, err_msg=T.keystr(path))
