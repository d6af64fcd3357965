"""Top-k gradient compression with error feedback in the port
(``repro_torch.optim.topk_compress_with_ef``): the properties of
``tests/test_compression.py``, ported, and parity with the JAX package's
transform on the same grads and EF state.

Parity is exact: the k-th largest magnitude is a value of the input, so
both packages draw the same mask, send the same values and keep the same
residuals, ties at the threshold included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import topk_compress_with_ef as jax_topk
from repro_torch import optim as toptim
from repro_torch import tree as T
from repro_torch.optim import topk_compress_with_ef


def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)),
        "b": torch.from_numpy(rng.normal(size=(128,)).astype(np.float32)),
    }


def test_mask_size_matches_ratio():
    grads = _tree()
    for ratio in (0.01, 0.1, 0.5):
        sparse, _, stats = topk_compress_with_ef(grads, None, ratio=ratio)
        for leaf in T.leaves(sparse):
            k = max(1, int(leaf.numel() * ratio))
            nz = int(torch.count_nonzero(leaf))
            # Ties at the threshold may admit a few extra elements, but the
            # mask must cover at least k and stay O(k).
            assert k <= nz <= max(2 * k, k + 8)
        assert stats["elements_sent"] <= stats["elements_total"]


def test_sent_plus_residual_recomposes_accumulator():
    grads = _tree(1)
    ef = T.tree_map(lambda g: torch.full(g.shape, 0.25), grads)
    sparse, new_ef, _ = topk_compress_with_ef(grads, ef, ratio=0.05)
    for g, e, s, r in zip(T.leaves(grads), T.leaves(ef), T.leaves(sparse), T.leaves(new_ef)):
        np.testing.assert_allclose((g + e).numpy(), (s + r).numpy(), atol=1e-6)


def test_residual_disjoint_from_sent():
    grads = _tree(2)
    sparse, new_ef, _ = topk_compress_with_ef(grads, None, ratio=0.1)
    for s, r in zip(T.leaves(sparse), T.leaves(new_ef)):
        # An element is either sent (residual zero) or held back (sent zero).
        assert not bool(((s != 0) & (r != 0)).any())


def test_long_run_unbiasedness():
    """Sum of sent updates converges to the sum of raw grads (EF catches up)."""
    rng = np.random.default_rng(3)
    ef = None
    total_raw = np.zeros((32, 16), np.float64)
    total_sent = np.zeros((32, 16), np.float64)
    for _ in range(200):
        g = {"w": torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))}
        sparse, ef, _ = topk_compress_with_ef(g, ef, ratio=0.05)
        total_raw += g["w"].double().numpy()
        total_sent += sparse["w"].double().numpy()
    residual = ef["w"].double().numpy()
    # Everything not yet sent lives in the residual, exactly.
    np.testing.assert_allclose(total_sent + residual, total_raw, rtol=1e-4, atol=1e-3)
    # The residual stays bounded — EF drains, it does not accumulate drift.
    assert np.abs(residual).max() < 10 * np.abs(total_raw).max() / 200 + 5.0


def test_pure_and_dtype_preserving():
    """The port of ``test_jit_compatible``: the transform is a pure function
    of its inputs (a second call gives the same trees, the inputs are not
    written), keeps each grad's dtype and gives fp32 residuals, also for
    bf16 grads and under ``torch.no_grad``."""
    grads = _tree(4)
    grads["h"] = torch.from_numpy(np.random.default_rng(9).normal(size=(16, 8)).astype(np.float32)).bfloat16()
    ef0 = T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32), grads)
    inputs = T.leaves(grads) + T.leaves(ef0)
    before = [t.clone() for t in inputs]
    s1, e1, _ = topk_compress_with_ef(grads, ef0, ratio=0.1)
    with torch.no_grad():
        s2, e2, _ = topk_compress_with_ef(grads, ef0, ratio=0.1)
    for a, b in zip(T.leaves(s1) + T.leaves(e1), T.leaves(s2) + T.leaves(e2)):
        assert torch.equal(a, b)
    for a, b in zip(inputs, before):
        assert torch.equal(a, b)
    assert s1["h"].dtype == torch.bfloat16 and all(e.dtype == torch.float32 for e in T.leaves(e1))


def test_stats_ratio_tracks_request():
    grads = _tree(5)
    _, _, stats = topk_compress_with_ef(grads, None, ratio=0.02)
    assert stats["ratio"] == pytest.approx(0.02, rel=0.5)
    assert stats["elements_total"] == sum(g.numel() for g in T.leaves(grads))


def test_exports_match_the_reference():
    import repro.optim as joptim

    assert toptim.__all__ == joptim.__all__


@pytest.mark.parametrize("ratio", [0.01, 0.1])
def test_matches_jax_over_three_rounds_with_ties_and_a_zero_leaf(ratio):
    """Three rounds with EF in both packages on the same grads: sent values,
    residuals and stats equal bit for bit.  ``ties`` holds 40 elements of
    the same magnitude at the threshold (more sent than k), ``zero`` is all
    zeros (nothing sent: the mask also asks ``|acc| > 0``)."""
    rng = np.random.default_rng(11)
    jef = tef = None
    for round_ in range(3):
        ties = rng.normal(size=(20, 10)).astype(np.float32) * 0.01
        ties.flat[rng.permutation(ties.size)[:40]] = np.where(rng.random(40) < 0.5, -3.0, 3.0)
        grads = {"a": {"w": rng.normal(size=(48, 24)).astype(np.float32)}, "ties": ties,
                 "zero": np.zeros((7, 5), np.float32), "b": rng.normal(size=(33,)).astype(np.float32)}
        jsent, jef, jstats = jax_topk(jax.tree_util.tree_map(jnp.asarray, grads), jef, ratio=ratio)
        tsent, tef, tstats = topk_compress_with_ef(T.tree_map(torch.from_numpy, grads), tef, ratio=ratio)
        assert tstats == jstats
        for tree_t, tree_j in ((tsent, jsent), (tef, jef)):
            got, want = T.flatten_with_path(tree_t), jax.tree_util.tree_flatten_with_path(tree_j)[0]
            assert [T.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
            for (path, a), (_, b) in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"round {round_} {T.keystr(path)}")
        if round_ == 0:  # no residual yet: the 40 ties are the largest, all sent though k is less
            assert int(torch.count_nonzero(tsent["ties"])) == 40 > max(1, int(ties.size * ratio))
        assert int(torch.count_nonzero(tsent["zero"])) == 0
