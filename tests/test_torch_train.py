"""The port's training plane (``repro_torch.launch.train`` and what it runs:
loss, AdamW, train step, the data pipeline and checkpoint/restart through
the two-level store) against the JAX package on the CPU.

Parameters come from the JAX init (``params_from_jax``), inputs from a numpy
seed, configs in fp32 with TF32 off.  Tolerances: 2e-5 (rtol = atol) for
the loss, the optimizer and one train step; 1e-4 relative for an 8-step
loss trajectory; the recovery bars of ``tests/test_system.py`` (rtol 1e-5,
atol 1e-6) for restarts.
"""

import dataclasses
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import TwoLevelStore as JStore
from repro.launch import steps as jsteps
from repro.launch.train import run_training as jax_run_training
from repro.optim import adamw as jadamw
from repro.runtime import CheckpointManager as JCheckpointManager
import repro_torch.configs as tcfgs
from repro_torch import tree as T
from repro_torch.core import TwoLevelStore as TStore
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import port_state, reference_state, run_training
from repro_torch.nn.module import from_reference_layout, params_from_jax, to_reference_layout
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.failure import FailureInjector

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = dict(rtol=2e-5, atol=2e-5)


def close(got, want, tol=F32):
    np.testing.assert_allclose(np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), **tol)


def to_torch(tree):
    return T.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def reduced(pkg, **kw):
    return dataclasses.replace(pkg.get_reduced("starcoder2_3b"), dtype="float32", **kw)


def small(pkg, **kw):
    """tests/test_system.py's config (bf16 compute, as there, unless ``kw``
    says otherwise)."""
    return dataclasses.replace(pkg.get_reduced("starcoder2_3b"), n_layers=2, d_model=32, d_ff=64,
                               n_heads=4, n_kv_heads=2, vocab=256, **kw)


def jstore(root):
    return JStore(str(root), mem_capacity_bytes=64 * 2**20, block_bytes=2**20)


def tstore(root):
    return TStore(str(root), mem_capacity_bytes=64 * 2**20, block_bytes=2**20)


def assert_trees_close(got, want, tol):
    """Same leaf names, and every leaf within ``tol``."""
    g, w = T.flatten_with_path(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert [T.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a), np.asarray(b),
                                   err_msg=T.keystr(path), **tol)


# ---------------------------------------------------------------- loss, optim


def test_cross_entropy_matches_jax_with_ignored_labels():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = labels[2, 5] = jsteps.IGNORE_INDEX
    jt, jce = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tt, tce = tsteps.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    close(tt, jt)
    close(tce, jce)
    assert tsteps.Z_LOSS_WEIGHT == jsteps.Z_LOSS_WEIGHT and tsteps.IGNORE_INDEX == jsteps.IGNORE_INDEX
    all_ignored = np.full_like(labels, jsteps.IGNORE_INDEX)
    assert float(tsteps.cross_entropy(torch.from_numpy(logits), torch.from_numpy(all_ignored))[0]) == 0.0


@pytest.mark.parametrize("max_grad_norm", [1.0, 0.0])
def test_adamw_matches_jax_over_three_updates(max_grad_norm):
    """Updates, moments, count, grad norm and the warmup/cosine learning rate
    of 3 updates, with the clip active (norm ~ 10 > 1) and without it."""
    rng = np.random.default_rng(1)
    params = {"a": {"w": rng.normal(size=(6, 5))}, "b": rng.normal(size=(5,)), "c": rng.normal(size=(2, 3, 4))}
    params = jax.tree_util.tree_map(lambda x: x.astype(np.float32), params)
    kw = dict(learning_rate=jadamw.cosine_warmup(1e-2, 2, 5), max_grad_norm=max_grad_norm)
    jopt = jadamw.AdamW(**kw)
    topt = tadamw.AdamW(learning_rate=tadamw.cosine_warmup(1e-2, 2, 5), max_grad_norm=max_grad_norm)
    jp, jstate = params, jopt.init(params)
    tp = to_torch(params)
    tstate = topt.init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda x: (rng.normal(size=x.shape) * 3).astype(np.float32), params)
        ju, jstate, jm = jopt.update(grads, jstate, jp)
        tu, tstate, tm = topt.update(to_torch(grads), tstate, tp)
        assert_trees_close(tu, ju, F32)
        assert_trees_close(tstate, jstate, F32)
        close(tm["grad_norm"], jm["grad_norm"])
        close(tm["lr"], jm["lr"])
        jp, tp = jadamw.apply_updates(jp, ju), tadamw.apply_updates(tp, tu)
        assert_trees_close(tp, jp, F32)
    assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == 3
    for step in range(8):  # warmup, cosine, clamped past the end
        close(tadamw.cosine_warmup(3e-4, 3, 6)(torch.tensor(step, dtype=torch.int32)),
              jadamw.cosine_warmup(3e-4, 3, 6)(jnp.asarray(step, jnp.int32)))


# ------------------------------------------------------------------ the step


@pytest.fixture(scope="module")
def starcoder():
    """Reduced starcoder2 (fp32, scanned layers in JAX), its JAX train state,
    the same state in the port, and a batch."""
    jc, tc = reduced(jcfgs), reduced(tcfgs)
    jm = jcfgs.make_model(jc)
    jopt = jadamw.AdamW(learning_rate=1e-3)
    jstate, _ = jsteps.init_state(jm, jc, jopt, jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, jc.vocab, (4, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    return jc, jm, jopt, jstate, tc, port_state(to_torch(jstate)), batch


def test_reference_layout_round_trip(starcoder):
    """to_reference_layout re-stacks the port's unrolled layers into the JAX
    tree, from_reference_layout undoes it: scanned starcoder2 (all periods),
    unrolled (no periods) and a 5-layer recurrentgemma (a period of three
    layers and a suffix of two)."""
    from repro.nn.module import init_with_axes as jax_init

    _, _, _, jstate, tc, tstate, _ = starcoder
    exact = dict(rtol=0, atol=0)
    assert "periods" in jstate["params"] and "prefix_0" in tstate["params"]
    assert_trees_close(to_reference_layout(tstate["params"], tc), jstate["params"], exact)
    unrolled = to_reference_layout(tstate["params"], dataclasses.replace(tc, scan_layers=False))
    assert sorted(unrolled) == sorted(tstate["params"])
    back = from_reference_layout(to_reference_layout(tstate["params"], tc))
    assert_trees_close(back, T.tree_map(lambda t: t.numpy(), tstate["params"]), exact)
    rg = lambda pkg: dataclasses.replace(pkg.get_reduced("recurrentgemma_9b"), n_layers=5)
    shapes, _ = jax_init(jcfgs.make_model(rg(jcfgs)).init, jax.random.PRNGKey(1), abstract=True)
    rng = np.random.default_rng(2)
    jrg = jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    assert "periods" in jrg and "suffix_1" in jrg
    again = to_reference_layout(params_from_jax(jrg, device="cpu"), rg(tcfgs))
    assert_trees_close(again, jrg, exact)


def test_train_step_matches_jax(starcoder):
    """One step: loss, ce, grad norm, lr, and every updated parameter and
    moment within 2e-5."""
    jc, jm, jopt, jstate, tc, tstate, batch = starcoder
    jnew, jmet = jax.jit(jsteps.make_train_step(jm, jc, jopt))(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
    topt = tadamw.AdamW(learning_rate=1e-3)
    tnew, tmet = tsteps.make_train_step(tcfgs.make_model(tc), tc, topt)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "ce", "grad_norm", "lr"):
        close(tmet[key], jmet[key])
    assert int(tnew["step"]) == 1 and tnew["step"].dtype == torch.int32
    assert_trees_close(reference_state(tnew, tc), jnew, F32)


def test_every_parameter_gets_a_finite_nonzero_gradient(starcoder):
    *_, tc, tstate, batch = starcoder
    model = tcfgs.make_model(tc)
    params = T.tree_map(lambda p: p.detach().requires_grad_(), tstate["params"])
    loss, _ = tsteps.cross_entropy(model.train_logits(params, torch.from_numpy(batch["inputs"]))[0],
                                   torch.from_numpy(batch["labels"]))
    loss.backward()
    for path, p in T.flatten_with_path(params):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()) and bool(p.grad.abs().sum() > 0), path


def test_accum_matches_full_batch(starcoder):
    """Port of test_models.py::TestGradAccumulation: two microbatches give the
    full batch's loss and (fp32-accumulated) update."""
    *_, tc, tstate, batch = starcoder
    model, opt = tcfgs.make_model(tc), tadamw.AdamW(learning_rate=1e-3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    s1, m1 = tsteps.make_train_step(model, tc, opt, accum_steps=1)(tstate, tb)
    s2, m2 = tsteps.make_train_step(model, tc, opt, accum_steps=2)(tstate, tb)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=2e-4)
    diff = max(float((a - b).abs().max()) for a, b in zip(T.leaves(s1["params"]), T.leaves(s2["params"])))
    assert diff < 5e-5


@pytest.mark.parametrize("cfg_fn", [
    lambda: tcfgs.get_reduced("xlstm_125m"),
    lambda: tcfgs.get_reduced("recurrentgemma_9b"),
    lambda: dataclasses.replace(tcfgs.get_reduced("whisper_large_v3"), dtype="float32"),
], ids=["xlstm", "recurrentgemma", "encdec"])
def test_unported_training_branches_raise(cfg_fn):
    """The branches once refused now train: the recurrent archs and the
    encoder-decoder (with frames) give a finite loss and every leaf a
    non-zero gradient."""
    cfg = cfg_fn()
    from repro_torch.nn.module import init_with_axes

    model = tcfgs.make_model(cfg)
    params = T.tree_map(lambda p: p.requires_grad_(), init_with_axes(model.init, 0, device="cpu")[0])
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec is not None:
        batch["frames"] = torch.from_numpy(rng.normal(size=(2, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32))
    loss, metrics = tsteps.make_loss_fn(model, cfg)(params, batch)
    loss.backward()
    assert bool(torch.isfinite(loss)) and set(metrics) == {"ce"}
    for path, p in T.flatten_with_path(params):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()) and bool(p.grad.abs().sum() > 0), path


# ------------------------------------------------------- the kernel-op guard


def test_kernel_ops_refuse_tensors_that_require_grad():
    """The guard each op runs on CUDA inputs: it raises when autograd would
    track an input (also inside a list or tuple), and not under no_grad or
    for inputs that need no grad.  On the CPU the ops run their plain,
    differentiable versions."""
    x = torch.ones(2, requires_grad=True)
    y = torch.ones(2)
    for args in ((x,), (y, [y, x]), (y, (y, x, None))):
        with pytest.raises(RuntimeError, match="no backward"):
            ops.no_backward("op", *args)
    ops.no_backward("op", y, [y], None)
    with torch.no_grad():
        ops.no_backward("op", x)
    q = torch.randn(1, 2, 5, 8, requires_grad=True)
    out = ops.flash_attention(q, q[:, :1].detach(), q[:, :1].detach())
    out.sum().backward()
    assert q.grad is not None and bool(q.grad.abs().sum() > 0)


# -------------------------------------------------------------- the slice


def test_loss_trajectory_matches_jax(tmp_path):
    """run_training in both packages for 8 steps from the same start: the
    JAX init state, written as a step-0 checkpoint by the JAX package and
    restored by each (reduced starcoder2, fp32, sync checkpoints at 4 and
    8).  Then the JAX package restores the port's step-8 checkpoint: it holds
    the JAX run's final state."""
    jc, tc = reduced(jcfgs), reduced(tcfgs)
    jm = jcfgs.make_model(jc)
    jopt = jadamw.AdamW(learning_rate=1e-3)
    state, _ = jsteps.init_state(jm, jc, jopt, jax.random.PRNGKey(0))
    state["pipeline"] = {"epoch": np.int64(0), "step": np.int64(0)}
    with jstore(tmp_path / "j") as st:
        JCheckpointManager(st, tag=jc.name).save(0, state)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    kw = dict(total_steps=8, ckpt_every=4, ckpt_mode="sync", seq_len=32)
    with jstore(tmp_path / "j") as st:
        want = jax_run_training(jc, st, **kw)
    with tstore(tmp_path / "t") as st:
        got = run_training(tc, st, device="cpu", **kw)
    assert got.steps_run == want.steps_run == 8
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    tol = dict(rtol=1e-4, atol=1e-5)
    assert_trees_close(reference_state(got.state, tc)["params"], want.state["params"], tol)
    with jstore(tmp_path / "t") as st:  # the port's store, read by the JAX package
        step, restored = JCheckpointManager(st, tag=jc.name).restore(want.state)
    assert step == 8
    assert_trees_close(restored, want.state, tol)


def test_port_resumes_a_jax_run_mid_way(tmp_path):
    """A JAX run of 9 steps checkpoints (sync) at step 5; the port, on a copy
    of that store, restores step 5 — params, moments, count and pipeline
    cursor — and its steps 5-8 give the JAX run's losses and final params."""
    jc, tc = small(jcfgs, dtype="float32"), small(tcfgs, dtype="float32")
    with jstore(tmp_path / "j") as st:
        want = jax_run_training(jc, st, total_steps=9, ckpt_every=5, ckpt_mode="sync")
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    with tstore(tmp_path / "t") as st:
        got = run_training(tc, st, total_steps=9, ckpt_every=5, ckpt_mode="sync", device="cpu")
    assert got.steps_run == 4 and int(got.state["step"]) == 9
    np.testing.assert_allclose(got.losses, want.losses[5:], rtol=1e-4)
    assert_trees_close(reference_state(got.state, tc)["params"], want.state["params"], dict(rtol=1e-4, atol=1e-5))


# ------------------------------------- ports of tests/test_system.py:29-80


@pytest.fixture()
def big_store(tmp_path):
    with tstore(tmp_path / "pfs") as st:
        yield st


class TestEndToEnd:
    def test_train_completes_and_checkpoints(self, big_store):
        res = run_training(small(tcfgs), big_store, total_steps=8, ckpt_every=4, device="cpu")
        assert res.steps_run == 8
        assert res.restarts == 0
        assert np.isfinite(res.losses).all()
        names = big_store.list_files()
        assert any(n.startswith("ckpt/") for n in names)
        assert any(n.startswith("corpus/") for n in names)
        assert res.stalls["ckpt_save_critical_s"] > 0 and res.loader_stats

    def test_failure_recovery_reaches_target(self, big_store):
        inj = FailureInjector([6])
        res = run_training(small(tcfgs), big_store, total_steps=10, ckpt_every=5, injector=inj, device="cpu")
        assert res.restarts == 1
        assert len(inj.injected) == 1
        assert int(res.state["step"]) == 10
        assert res.stalls["ckpt_restore_total_s"] > 0

    def test_recovery_is_exact(self, tmp_path):
        """Failure + restore give the SAME losses and final params as an
        uninterrupted run (deterministic pipeline + committed cursor)."""
        cfg = small(tcfgs)
        with tstore(tmp_path / "a") as st_a:
            clean = run_training(cfg, st_a, total_steps=10, ckpt_every=5, ckpt_mode="sync", device="cpu")
        with tstore(tmp_path / "b") as st_b:
            failed = run_training(cfg, st_b, total_steps=10, ckpt_every=5, ckpt_mode="sync",
                                  injector=FailureInjector([7]), device="cpu")
        assert failed.restarts == 1
        np.testing.assert_allclose(failed.losses[-5:], clean.losses[-5:], rtol=1e-5, atol=1e-6)
        for a, b in zip(T.leaves(clean.state["params"]), T.leaves(failed.state["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)

    def test_cold_cluster_restart_resumes(self, tmp_path):
        """Process death: a NEW store (empty memory tier) resumes from the
        PFS tier — the paper's fault-tolerance argument for the TLS."""
        cfg = small(tcfgs)
        with tstore(tmp_path / "pfs") as st1:
            run_training(cfg, st1, total_steps=5, ckpt_every=5, ckpt_mode="sync", device="cpu")
        with tstore(tmp_path / "pfs") as st2:
            second = run_training(cfg, st2, total_steps=10, ckpt_every=5, ckpt_mode="sync", device="cpu")
            assert int(second.state["step"]) == 10
            assert second.steps_run == 5  # only the remaining steps
            assert st2.stats.mem_misses > 0

    def test_elastic_batch_change_via_restore(self, big_store):
        cfg = small(tcfgs)
        run_training(cfg, big_store, total_steps=5, ckpt_every=5, global_batch=8, ckpt_mode="sync", device="cpu")
        res = run_training(cfg, big_store, total_steps=8, ckpt_every=4, global_batch=4, device="cpu")
        assert int(res.state["step"]) == 8


def test_train_cli_on_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "starcoder2-3b", "--reduced", "--steps", "4",
                                      "--device", "cpu", "--store", str(tmp_path / "store"),
                                      "--ckpt-mode", "sync", "--fail-at", "3"])
    train.main()
    out = capsys.readouterr().out
    assert [l.split()[1] for l in out.splitlines() if l.startswith("step")] == ["0", "1", "2", "0", "1", "2", "3"]
    assert "done: 7 steps run (1 restarts)" in out and "restore" in out
    with TStore(str(tmp_path / "store")) as st:
        assert any(n.startswith("corpus/") for n in st.list_files())


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_corpus_written_by_one_package_loads_in_the_other(tmp_path, writer):
    """The copied pipeline writes the same shard bytes: a corpus generated
    through one package's store gives the other's loader the same batches,
    and the same cursor, as its own loader."""
    from repro.data import ShardedLoader as JLoader, SyntheticCorpus as JCorpus
    from repro_torch.data import ShardedLoader as TLoader, SyntheticCorpus as TCorpus

    pkgs = {"j": (jstore, JCorpus, JLoader), "t": (tstore, TCorpus, TLoader)}
    first = "j" if writer == "jax_package" else "t"
    with pkgs[first][0](tmp_path / "s") as st:
        pkgs[first][1](st, vocab_size=256, n_shards=8, tokens_per_shard=4096).generate()
    out = {}
    for pkg, (mk, corpus_cls, loader_cls) in pkgs.items():
        with mk(tmp_path / "s") as st:
            loader = loader_cls(corpus_cls(st, vocab_size=256, n_shards=8, tokens_per_shard=4096), 4, 32,
                                prefetch_depth=0)
            out[pkg] = ([next(loader) for _ in range(5)], dataclasses.astuple(loader.sync()))
            loader.close()
    for (ji, jl), (ti, tl) in zip(out["j"][0], out["t"][0]):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    assert out["t"][1] == out["j"][1]
