"""The port's LM (repro_torch.models.lm) against the JAX LM on qwen3-8b
reduced, fp32, TF32 off, with the JAX parameters carried over by
``params_from_jax``.  The bar is that of ``tests/test_serving.py``:
logits relative error (max abs error / max |logit|) < 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.nn.module import init_with_axes as jax_init
import repro_torch.configs as tcfgs
from repro_torch.nn.module import cast_matrices, init_with_axes, params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, S, EXTRA = 2, 24, 3


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, port params) — the JAX tree is the
    scanned one (reduced qwen3 scans its layers), unrolled by the bridge."""
    jc = dataclasses.replace(jcfgs.get_reduced("qwen3_8b"), dtype="float32")
    tc = dataclasses.replace(tcfgs.get_reduced("qwen3_8b"), dtype="float32")
    jm = jcfgs.make_model(jc)
    jp, _ = jax_init(jm.init, jax.random.PRNGKey(0), dtype=jnp.float32)
    tm = tcfgs.make_model(tc)
    return jm, jp, tm, params_from_jax(jp, device="cpu")


def test_params_from_jax_unrolls_scanned_periods(models):
    jm, jp, tm, tp = models
    assert jm.n_periods == jm.cfg.n_layers and "periods" in jp
    for i in range(jm.n_periods):
        for path in (("mixer", "wq"), ("ffn", "w_down"), ("pre_norm", "scale")):
            want = np.asarray(jp["periods"]["slot_0"][path[0]][path[1]])[i]
            np.testing.assert_array_equal(tp[f"prefix_{i}"][path[0]][path[1]].numpy(), want)
    assert sorted(k for k in tp if k.startswith("prefix_")) == [f"prefix_{i}" for i in range(jm.n_periods)]


def test_init_tree_matches_jax_unrolled_tree():
    """The port's own init fills the keys, shapes and axes of the JAX init
    of the same (unrolled) model, with the same schemes."""
    jc = dataclasses.replace(jcfgs.get_reduced("qwen3_8b"), scan_layers=False)
    jp, jaxes = jax_init(jcfgs.make_model(jc).init, jax.random.PRNGKey(0), abstract=True)
    tp, taxes = init_with_axes(tcfgs.make_model(tcfgs.get_reduced("qwen3_8b")).init, 0, device="cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda x: tuple(x.shape), t)
    assert shapes(tp) == shapes(jp)
    assert taxes == jaxes
    assert torch.all(tp["prefix_0"]["pre_norm"]["scale"] == 1)
    w = tp["prefix_0"]["ffn"]["w_up"]
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05  # fan_in scheme


def test_cast_matrices_keeps_vectors_and_head_fp32(models):
    tp = cast_matrices(models[3], torch.bfloat16)
    assert tp["prefix_0"]["mixer"]["wq"].dtype == torch.bfloat16
    assert tp["embed"]["table"].dtype == torch.bfloat16
    assert tp["prefix_0"]["mixer"]["q_norm"].dtype == torch.float32
    assert tp["head"]["w"].dtype == torch.float32


def test_train_logits_match_jax(models):
    jm, jp, tm, tp = models
    tok = np.random.default_rng(0).integers(0, tm.cfg.vocab, (B, S))
    want, _ = jm.train_logits(jp, jnp.asarray(tok, jnp.int32))
    got, _ = tm.train_logits(tp, torch.from_numpy(tok))
    assert rel_err(got, want) < 5e-3


def test_prefill_decode_match_jax_and_full_forward(models):
    """Port of test_serving.py::test_decode_matches_full_forward for qwen3,
    plus step-by-step agreement with the JAX prefill/decode logits."""
    jm, jp, tm, tp = models
    tok = np.random.default_rng(0).integers(0, tm.cfg.vocab, (B, S + EXTRA))
    full, _ = tm.train_logits(tp, torch.from_numpy(tok))
    scale = float(full.abs().max())
    jcaches = jm.init_caches(B, S + EXTRA + 1, jnp.float32)
    caches = tm.init_caches(B, S + EXTRA + 1, torch.float32, device="cpu")
    jlg, jcaches = jm.prefill(jp, jnp.asarray(tok[:, :S], jnp.int32), jcaches)
    lg, caches = tm.prefill(tp, torch.from_numpy(tok[:, :S]), caches)
    errs = [float((lg[:, 0] - full[:, S - 1]).abs().max()) / scale]
    jax_errs = [rel_err(lg, jlg)]
    for i in range(EXTRA):
        step = tok[:, S + i : S + i + 1]
        jlg, jcaches = jm.decode_step(jp, jnp.asarray(step, jnp.int32), jcaches)
        lg, caches = tm.decode_step(tp, torch.from_numpy(step), caches)
        errs.append(float((lg[:, 0] - full[:, S + i]).abs().max()) / scale)
        jax_errs.append(rel_err(lg, jlg))
    assert max(errs) < 5e-3, errs
    assert max(jax_errs) < 5e-3, jax_errs


def test_unported_families_refused():
    """The VLM and encoder-decoder families are ported (and MoE, MLA and MTP,
    tests/test_torch_families.py): make_model builds an EncDec for an
    encoder-decoder config and an LM with ``vlm_proj`` for a VLM one; only
    an arch outside the registry is refused."""
    from repro_torch.configs.base import EncDecConfig, VLMConfig
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.lm import LM

    base = tcfgs.get_reduced("qwen3_8b")
    vlm = tcfgs.make_model(dataclasses.replace(base, vlm=VLMConfig(n_patches=4, patch_dim=8)))
    assert type(vlm) is LM
    params, axes = init_with_axes(vlm.init, 0, device="cpu")
    assert tuple(params["vlm_proj"]["w"].shape) == (8, base.d_model) and axes["vlm_proj"]["w"] == ("embed", None)
    assert isinstance(tcfgs.make_model(dataclasses.replace(base, encdec=EncDecConfig())), EncDec)
    with pytest.raises(KeyError):
        tcfgs.make_model(tcfgs.get_reduced("no_such_arch"))
