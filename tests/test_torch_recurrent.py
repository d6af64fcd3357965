"""The port's recurrent slice (repro_torch.nn.recurrent, the RG-LRU and
mLSTM ops, the recurrentgemma-9b and xlstm-125m LMs) against the JAX
package on the CPU, in fp32 with TF32 off.

Parameters come from the JAX init (perturbed, so that zero-initialised
biases and unit scales are exercised too) and reach the port through
``params_from_jax``; inputs come from a numpy seed.  On the CPU the port's
ops run their plain versions (``kernels/ref.py``); these are held against
the JAX oracles and against the Pallas kernels in interpret mode.
Tolerances: those of ``tests/test_kernels.py`` for the ops (fp32 2e-5,
mLSTM 2e-4, bf16 2e-2, the random-size property 1e-4), 1e-4 for blocks
whose matrix products over d_model are summed in another order by the two
backends, and the model bar of ``tests/test_serving.py`` (relative logits
error < 5e-3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis (pip install .[test])")
from hypothesis import given, settings, strategies as st

import repro.configs as jcfgs
from repro.kernels import mlstm_chunkwise as jax_mlstm
from repro.kernels import ref as jref
from repro.kernels import rglru_scan_op as jax_rglru
from repro.nn import recurrent as JR
from repro.nn.module import init_with_axes as jax_init
import repro_torch.configs as tcfgs
from repro_torch.kernels import ops
from repro_torch.nn import recurrent as TR
from repro_torch.nn.module import init_with_axes, params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCHS = ["recurrentgemma_9b", "xlstm_125m"]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MLSTM = dict(rtol=2e-4, atol=2e-4)
MATMUL = dict(rtol=1e-4, atol=1e-4)
B, S, EXTRA = 2, 24, 3


def cfgs(arch, **kw):
    """(JAX config, port config), fp32; the port runs its kernel ops."""
    jc = dataclasses.replace(jcfgs.get_reduced(arch), dtype="float32", **kw)
    tc = dataclasses.replace(tcfgs.get_reduced(arch), dtype="float32", attn_impl="flash", **kw)
    return jc, tc


def pair(x, dtype="float32"):
    """The same numbers as a JAX array and a torch tensor (bf16 rounds alike)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x.copy()).to(getattr(torch, dtype))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def init_both(init_fn, seed=0):
    """JAX init of one block, every leaf perturbed by N(0, 0.1), and the
    same tree in the port."""
    params, _ = jax_init(init_fn, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.normal(size=np.shape(x)), jnp.float32), params)
    return params, params_from_jax(params, device="cpu")


def jit_block(fn, cfg):
    """A JAX block apply, jitted: one compile instead of one per primitive."""
    return jax.jit(functools.partial(fn, cfg=cfg))


def states(jstate: dict | None):
    """(JAX state, port state) from one dict of numpy arrays."""
    if jstate is None:
        return None, None
    return ({k: jnp.asarray(v) for k, v in jstate.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()})


# ------------------------------------------------------------------- blocks


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_apply(with_state):
    jp, tp = init_both(lambda s: JR.conv1d_init(s, "conv", 4, 24))
    rng = np.random.default_rng(0)
    xj, xt = pair(rng.normal(size=(2, 9, 24)))
    sj, st_ = pair(rng.normal(size=(2, 3, 24))) if with_state else (None, None)
    jy, jstate = JR.conv1d_apply(jp["conv"], xj, sj)
    ty, tstate = TR.conv1d_apply(tp["conv"], xt, st_)
    close(ty, jy, TOL["float32"])
    close(tstate, jstate, TOL["float32"])


# (S, carry-in): train over S, prefill from a carried state, one decode step
BLOCK_CASES = {"train": (12, False), "carried": (12, True), "decode": (1, True)}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_rglru_block_apply(case):
    s, carried = BLOCK_CASES[case]
    jc, tc = cfgs("recurrentgemma_9b")
    w, width = jc.recurrent.lru_width, jc.recurrent.conv_width
    jp, tp = init_both(lambda sc: JR.rglru_init(sc, "blk", jc))
    rng = np.random.default_rng(1)
    xj, xt = pair(0.5 * rng.normal(size=(B, s, jc.d_model)))
    jstate, tstate = states({"h": rng.normal(size=(B, w)).astype(np.float32),
                             "conv": rng.normal(size=(B, width - 1, w)).astype(np.float32)} if carried else None)
    jy, jnew = jit_block(JR.rglru_block_apply, jc)(jp["blk"], xj, state=jstate)
    ty, tnew = TR.rglru_block_apply(tp["blk"], xt, tc, tstate)
    close(ty, jy, MATMUL)
    for key in ("h", "conv"):
        assert tnew[key].dtype == torch.float32
        close(tnew[key], jnew[key], MATMUL)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_mlstm_block_apply(case):
    """The block and the carry it returns ((C, n, m) and the conv history)
    against the state JAX's mlstm_block_apply returns."""
    s, carried = BLOCK_CASES[case]
    jc, tc = cfgs("xlstm_125m")
    dp = int(jc.d_model * jc.recurrent.mlstm_proj_factor)
    nh, dh = jc.n_heads, dp // jc.n_heads
    jp, tp = init_both(lambda sc: JR.mlstm_init(sc, "blk", jc))
    rng = np.random.default_rng(2)
    xj, xt = pair(0.5 * rng.normal(size=(B, s, jc.d_model)))
    jstate, tstate = states({
        "C": 0.3 * rng.normal(size=(B, nh, dh, dh)).astype(np.float32),
        "n": 0.3 * rng.normal(size=(B, nh, dh)).astype(np.float32),
        "m": rng.normal(size=(B, nh)).astype(np.float32),
        "conv": rng.normal(size=(B, 3, dp)).astype(np.float32),
    } if carried else None)
    jy, jnew = jit_block(JR.mlstm_block_apply, jc)(jp["blk"], xj, state=jstate)
    ty, tnew = TR.mlstm_block_apply(tp["blk"], xt, tc, tstate)
    close(ty, jy, MATMUL)
    for key in ("C", "n", "m", "conv"):
        close(tnew[key], jnew[key], MATMUL)


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_block_apply(carried):
    jc, tc = cfgs("xlstm_125m")
    d = jc.d_model
    jp, tp = init_both(lambda sc: JR.slstm_init(sc, "blk", jc))
    rng = np.random.default_rng(3)
    xj, xt = pair(0.5 * rng.normal(size=(B, 10, d)))
    jstate, tstate = states({
        "c": rng.normal(size=(B, d)).astype(np.float32), "n": np.abs(rng.normal(size=(B, d))).astype(np.float32),
        "m": rng.normal(size=(B, d)).astype(np.float32), "h": rng.normal(size=(B, d)).astype(np.float32),
    } if carried else None)
    jy, jnew = jit_block(JR.slstm_block_apply, jc)(jp["blk"], xj, state=jstate)
    ty, tnew = TR.slstm_block_apply(tp["blk"], xt, tc, tstate)
    close(ty, jy, MATMUL)
    for key in ("c", "n", "m", "h"):
        close(tnew[key], jnew[key], MATMUL)


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,w,bs,bw", [(256, 128, 64, 128), (512, 96, 128, 64), (100, 50, 64, 64)])
def test_rglru_scan_matches_jax(s, w, bs, bw, dtype):
    """Port of TestRGLRU.test_shapes_dtypes: the op against the JAX oracle
    and the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(42)
    aj, at = pair(rng.uniform(0.8, 0.999, size=(2, s, w)), dtype)
    xj, xt = pair(0.5 * rng.normal(size=(2, s, w)), dtype)
    got = ops.rglru_scan(at, xt)
    assert got.dtype == xt.dtype
    close(got, jref.rglru_ref(aj, xj), TOL[dtype])
    close(got, jax_rglru(aj, xj, block_s=bs, block_w=bw, interpret=True), TOL[dtype])


@given(s=st.integers(2, 300), w=st.integers(1, 100))
@settings(max_examples=12, deadline=None)
def test_rglru_scan_random_sizes(s, w):
    """Port of TestRGLRU.test_property_random_sizes."""
    rng = np.random.default_rng(s * 1000 + w)
    aj, at = pair(rng.uniform(0.5, 1.0, size=(1, s, w)))
    xj, xt = pair(rng.normal(size=(1, s, w)))
    close(ops.rglru_scan(at, xt), jax_rglru(aj, xj, block_s=64, block_w=64, interpret=True), dict(rtol=1e-4, atol=1e-4))


def mlstm_inputs(rng, b, h, s, d, dtype="float32", k_scale=None, i_scale=0.5, f_shift=2.0):
    """q, k, v, i_pre, f_log as (JAX, torch) pairs, as tests/test_kernels.py draws them."""
    k_scale = 1.0 / np.sqrt(d) if k_scale is None else k_scale
    q, k, v = rng.normal(size=(b, h, s, d)), rng.normal(size=(b, h, s, d)) * k_scale, rng.normal(size=(b, h, s, d))
    ip = rng.normal(size=(b, h, s)) * i_scale
    fl = np.log(1.0 / (1.0 + np.exp(-(rng.normal(size=(b, h, s)) + f_shift))))
    return [pair(x, dtype) for x in (q, k, v, ip, fl)]


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_mlstm_chunk_sizes(chunk):
    """Port of TestMLSTM.test_chunk_sizes: the op against the JAX oracle and
    the Pallas kernel at each of its chunk sizes."""
    ins = mlstm_inputs(np.random.default_rng(chunk), 2, 2, 256, 32)
    got, _ = ops.mlstm_chunkwise(*(t for _, t in ins))
    js = [j for j, _ in ins]
    close(got, jref.mlstm_ref(*js), MLSTM)
    close(got, jax_mlstm(*js, chunk=chunk, interpret=True), MLSTM)


def test_mlstm_bf16():
    """Port of TestMLSTM.test_bf16."""
    ins = mlstm_inputs(np.random.default_rng(7), 1, 2, 128, 32, "bfloat16", k_scale=1.0)
    got, _ = ops.mlstm_chunkwise(*(t for _, t in ins))
    assert got.dtype == torch.bfloat16
    js = [j for j, _ in ins]
    close(got, jref.mlstm_ref(*js), TOL["bfloat16"])
    close(got, jax_mlstm(*js, chunk=64, interpret=True), TOL["bfloat16"])


def test_mlstm_single_chunk_matches():
    """Port of TestMLSTM.test_single_chunk_matches (strong gates, no k scale)."""
    ins = mlstm_inputs(np.random.default_rng(8), 1, 1, 64, 16, k_scale=1.0, i_scale=1.0, f_shift=0.0)
    got, _ = ops.mlstm_chunkwise(*(t for _, t in ins))
    js = [j for j, _ in ins]
    close(got, jref.mlstm_ref(*js), MLSTM)
    close(got, jax_mlstm(*js, chunk=64, interpret=True), MLSTM)


def test_mlstm_carry_continues_the_sequence():
    """Two calls chained through the carry give the one-call h, and the
    carry-out equals the (C, n, m) that the JAX model's cell reaches by
    lax.scan over the whole sequence."""
    b, h, s1, s2, d = 2, 2, 40, 25, 16
    ins = mlstm_inputs(np.random.default_rng(9), b, h, s1 + s2, d)
    ts = [t for _, t in ins]
    h1, carry = ops.mlstm_chunkwise(*(t[:, :, :s1] for t in ts))
    h2, carry = ops.mlstm_chunkwise(*(t[:, :, s1:] for t in ts), carry)
    js = [j for j, _ in ins]
    close(torch.cat([h1, h2], dim=2), jref.mlstm_ref(*js), MLSTM)
    init = (jnp.zeros((b, h, d, d)), jnp.zeros((b, h, d)), jnp.full((b, h), -jnp.inf))
    seq = tuple(jnp.moveaxis(x, 2, 0) for x in js)
    want, _ = jax.lax.scan(JR._mlstm_cell, init, seq)
    for got_t, want_t in zip(carry, want):
        close(got_t, want_t, MLSTM)


@pytest.mark.parametrize("d", [32, 64, 128, 256, 384])
def test_mlstm_tile_plan(d):
    """The kernel's value-tile plan: each built TV divides D and fits a
    block's shared memory, the list equals the (D, TV) pairs the CUDA source
    instantiates, every plan for B*H = 1..256 is a built TV, and xlstm-125m's
    prefill (D = 384) takes one wave of 128 blocks on 132 SMs at B*H = 16
    and the narrow tile at batch 1 (B*H = 4: 48 blocks)."""
    import re
    from pathlib import Path

    from repro_torch.kernels import mlstm as tm

    assert d in tm.HEAD_DIMS
    built = tm.TILE_VS[d]
    assert all(d % tv == 0 and tm.smem_bytes(d, tv) <= tm.SMEM_LIMIT for tv in built)
    src = (Path(tm.__file__).resolve().parents[1] / "csrc" / "mlstm.cu").read_text()
    cases = {(int(a), int(b)) for a, b in re.findall(r"MLSTM_CASE\((\d+), (\d+)\)", src)}
    assert {tv for dd, tv in cases if dd == d} == set(built)
    for bh in range(1, 257):
        tv = tm.plan_tile_v(d, bh, 132)
        assert tv in built and d % tv == 0 and tm.smem_bytes(d, tv) <= 232_448
    if d == 384:
        assert built == (32, 48)
        tv = tm.plan_tile_v(384, 16, 132)
        assert tv == 48 and d // tv * 16 == 128 <= 132
        assert tm.plan_tile_v(384, 4, 132) == 32
    else:
        assert built == (32,)


# ---------------------------------------------------------------- the models


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(arch, JAX model, JAX params, port model, port params).  The reduced
    JAX configs scan their layers; the bridge unrolls the tree."""
    jc, tc = cfgs(request.param)
    jm = jcfgs.make_model(jc)
    jp, _ = jax_init(jm.init, jax.random.PRNGKey(0), dtype=jnp.float32)
    return request.param, jm, jp, tcfgs.make_model(tc), params_from_jax(jp, device="cpu")


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def test_train_logits_match_jax(models):
    arch, jm, jp, tm, tp = models
    assert jm.n_periods > 0 and "periods" in jp
    tok = np.random.default_rng(0).integers(0, tm.cfg.vocab, (B, S))
    want, _ = jax.jit(jm.train_logits)(jp, jnp.asarray(tok, jnp.int32))
    got, _ = tm.train_logits(tp, torch.from_numpy(tok))
    assert rel_err(got, want) < 5e-3, arch


def test_prefill_decode_match_jax_and_full_forward(models):
    """Port of test_serving.py::test_decode_matches_full_forward for the
    recurrent archs, plus step-by-step agreement with the JAX prefill and
    decode logits and the same greedy tokens."""
    arch, jm, jp, tm, tp = models
    tok = np.random.default_rng(0).integers(0, tm.cfg.vocab, (B, S + EXTRA))
    full, _ = tm.train_logits(tp, torch.from_numpy(tok))
    scale = float(full.abs().max())
    jcaches = jm.init_caches(B, S + EXTRA + 1, jnp.float32)
    caches = tm.init_caches(B, S + EXTRA + 1, torch.float32, device="cpu")
    jlg, jcaches = jax.jit(jm.prefill)(jp, jnp.asarray(tok[:, :S], jnp.int32), jcaches)
    jdecode = jax.jit(jm.decode_step)
    lg, caches = tm.prefill(tp, torch.from_numpy(tok[:, :S]), caches)
    errs = [float((lg[:, 0] - full[:, S - 1]).abs().max()) / scale]
    jax_errs = [rel_err(lg, jlg)]
    same_tokens = [bool((lg.argmax(-1).numpy() == np.asarray(jlg).argmax(-1)).all())]
    for i in range(EXTRA):
        step = tok[:, S + i : S + i + 1]
        jlg, jcaches = jdecode(jp, jnp.asarray(step, jnp.int32), jcaches)
        lg, caches = tm.decode_step(tp, torch.from_numpy(step), caches)
        errs.append(float((lg[:, 0] - full[:, S + i]).abs().max()) / scale)
        jax_errs.append(rel_err(lg, jlg))
        same_tokens.append(bool((lg.argmax(-1).numpy() == np.asarray(jlg).argmax(-1)).all()))
    assert max(errs) < 5e-3, (arch, errs)
    assert max(jax_errs) < 5e-3, (arch, jax_errs)
    assert all(same_tokens), arch


def test_recurrent_state_is_o1(models):
    """Port of test_serving.py::test_recurrent_state_is_o1, for both archs:
    the decode state does not grow with max_seq (recurrentgemma's local
    attention keeps a window-sized page)."""
    arch, _, _, tm, _ = models
    size = lambda caches: sum(t.numel() for c in caches.values() for t in c.values() if torch.is_tensor(t))
    assert size(tm.init_caches(1, 64, torch.float32, "cpu")) == size(tm.init_caches(1, 4096, torch.float32, "cpu")), arch


def test_init_tree_matches_jax_unrolled_tree(models):
    """The port's own init fills the keys, shapes and axes of the JAX init
    of the same unrolled model, with the same schemes (``lam`` is uniform
    on (-1, 1))."""
    arch = models[0]
    jc = dataclasses.replace(jcfgs.get_reduced(arch), scan_layers=False)
    jp, jaxes = jax_init(jcfgs.make_model(jc).init, jax.random.PRNGKey(0), abstract=True)
    tp, taxes = init_with_axes(tcfgs.make_model(tcfgs.get_reduced(arch)).init, 0, device="cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda x: tuple(x.shape), t)
    assert shapes(tp) == shapes(jp)
    assert taxes == jaxes
    if arch == "recurrentgemma_9b":
        lam = torch.cat([tp[f"prefix_{i}"]["mixer"]["lam"] for i in (0, 1)])
        assert float(lam.abs().max()) < 1.0 and float(lam.min()) < -0.5 and float(lam.max()) > 0.5


def test_serve_loop_on_cpu(models):
    """The serve driver runs both archs when the caller asks for the CPU, and
    the kernel ops (plain versions on the CPU) give the tokens of the plain
    path."""
    from repro_torch.launch.serve import serve_loop

    arch, _, _, tm, _ = models
    cfg = tcfgs.get_reduced(arch)
    gen, _, _ = serve_loop(dataclasses.replace(cfg, attn_impl="flash"), 2, 20, 4, device="cpu")
    plain, _, _ = serve_loop(dataclasses.replace(cfg, attn_impl="xla"), 2, 20, 4, device="cpu")
    assert tuple(gen.shape) == (2, 5) and torch.equal(gen, plain), arch
