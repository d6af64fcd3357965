"""The port's attention kernels (repro_torch.kernels) against the JAX package.

On the CPU the port's ops run their plain PyTorch versions; these are held
against the JAX oracles (``repro.kernels.ref``) and against the JAX Pallas
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them.
Inputs come from a numpy seed and go to both frameworks.  Tolerances are
those of ``tests/test_kernels.py``: fp32 rtol = atol = 2e-5, bf16 2e-2.
The CUDA kernels themselves are tested on a GPU by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import ref as jref
from repro.kernels import tiered_decode_attention as jax_tiered
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import TENSOR_CORE_HEAD_DIMS, flash_path
from repro_torch.kernels.tiered_decode import (GROUPS, HEAD_DIMS, HEAD_TILES, blocks_per_sm, head_tile, plan_splits,
                                               split_merge_plain, split_ranges, valid_key_rows)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def pair(rng, shape, dtype="float32", scale=1.0):
    """The same numbers as a JAX array and a torch tensor (bf16 rounds alike)."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def assert_close(got_t, want_j, dtype):
    np.testing.assert_allclose(got_t.float().numpy(), np.asarray(want_j, np.float32), **TOL[dtype])


# name: (b, h, kv, s, t, d, causal, window, softcap, dtype)
FLASH_CASES = {
    "causal_f32": (1, 4, 4, 64, 64, 32, True, 0, 0.0, "float32"),
    "causal_gqa_bf16": (2, 8, 2, 64, 64, 32, True, 0, 0.0, "bfloat16"),
    "mqa_d64": (1, 4, 1, 48, 48, 64, True, 0, 0.0, "float32"),
    "window_16": (1, 4, 2, 96, 96, 32, True, 16, 0.0, "float32"),
    "window_300": (1, 4, 2, 96, 96, 32, True, 300, 0.0, "float32"),
    "softcap_30": (1, 2, 2, 64, 64, 32, True, 0, 30.0, "float32"),
    "ragged_50": (1, 2, 2, 50, 50, 32, True, 0, 0.0, "float32"),
    "noncausal": (1, 2, 2, 64, 64, 32, False, 0, 0.0, "float32"),
    "t_gt_s": (1, 4, 2, 24, 64, 32, True, 0, 0.0, "float32"),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_attention_plain_matches_jax_ref(case):
    b, h, kv, s, t, d, causal, window, cap, dtype = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    scale = 3.0 if cap else 1.0
    (qj, qt), (kj, kt), (vj, vt) = (pair(rng, sh, dtype, sc) for sh, sc in (
        ((b, h, s, d), scale), ((b, kv, t, d), scale), ((b, kv, t, d), 1.0)))
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window, logit_softcap=cap)
    want = jref.attention_ref(qj, kj, vj, causal=causal, window=window, logit_softcap=cap)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("case", ["causal_f32", "causal_gqa_bf16", "window_16", "softcap_30", "ragged_50", "noncausal"])
def test_attention_plain_matches_jax_flash_kernel(case):
    """Against the Pallas flash kernel in interpret mode (block 32)."""
    b, h, kv, s, t, d, causal, window, cap, dtype = FLASH_CASES[case]
    rng = np.random.default_rng(1)
    scale = 3.0 if cap else 1.0
    (qj, qt), (kj, kt), (vj, vt) = (pair(rng, sh, dtype, sc) for sh, sc in (
        ((b, h, s, d), scale), ((b, kv, t, d), scale), ((b, kv, t, d), 1.0)))
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window, logit_softcap=cap)
    want = jax_flash(qj, kj, vj, causal=causal, window=window, logit_softcap=cap,
                     block_q=32, block_k=32, interpret=True)
    assert_close(got, want, dtype)


def test_attention_fully_masked_rows_give_mean_of_v():
    """Causal with T < S leaves the first S - T rows without a key.  They
    give what the JAX oracle and the Pallas kernel give, the mean of v over
    all T keys (a softmax of T equal -1e30 scores), on every row of the
    input that once exposed a difference: q (1,2,40,32), k/v (1,2,24,32),
    fp32, seed 2."""
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = (pair(rng, sh) for sh in ((1, 2, 40, 32), (1, 2, 24, 32), (1, 2, 24, 32)))
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert_close(got, jref.attention_ref(qj, kj, vj, causal=True), "float32")
    assert_close(got, jax_flash(qj, kj, vj, causal=True, block_q=32, block_k=32, interpret=True), "float32")
    assert_close(got[:, :, :16], np.broadcast_to(np.asarray(vj).mean(axis=2, keepdims=True), (1, 2, 16, 32)),
                 "float32")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_path_is_a_function_of_dtype_and_head_dim(dtype, d):
    """bf16 at D = 64, 128, 256 takes the tensor-core kernel; fp32 (held to
    2e-5, which TF32 products cannot hold) and the small head dims take the
    CUDA-core kernel."""
    want = "tensor_core" if dtype == torch.bfloat16 and d in (64, 128, 256) else "cuda_core"
    assert flash_path(dtype, d) == want
    assert TENSOR_CORE_HEAD_DIMS == (64, 128, 256)


# (hot_len, cold_len, newest): hot 16 slots, cold capacity 64
TIERED_CASES = {
    "both_tiers": (16, 40, 15),
    "hot_len=0": (0, 40, 7),
    "cold_len=0": (12, 0, 11),
    "ring_wrap": (16, 32, 5),
    "ring_partial_wrap": (9, 48, 3),
    "cold_full_capacity": (16, 64, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(TIERED_CASES))
def test_tiered_plain_matches_jax(case, dtype):
    """Plain tiered decode vs the JAX ring oracle and the Pallas kernel
    (interpret mode), ring rotation and tier edges included."""
    hot_len, cold_len, newest = TIERED_CASES[case]
    rng = np.random.default_rng(3)
    (qj, qt), (hkj, hkt), (hvj, hvt), (ckj, ckt), (cvj, cvt) = (
        pair(rng, sh, dtype) for sh in ((2, 8, 1, 32), (2, 2, 16, 32), (2, 2, 16, 32), (2, 2, 64, 32), (2, 2, 64, 32)))
    got = ops.tiered_decode_attention(qt, hkt, hvt, ckt, cvt, hot_len, cold_len, newest)
    want_ref = jref.tiered_ring_attention_ref(qj, hkj, hvj, ckj, cvj, hot_len, cold_len, newest)
    want_kernel = jax_tiered(qj, hkj, hvj, ckj, cvj, hot_len=hot_len, cold_len=cold_len,
                             ring_newest=newest, block_k=32, interpret=True)
    assert_close(got, want_ref, dtype)
    assert_close(got, want_kernel, dtype)


@pytest.mark.parametrize("hot_len,cold_len", [(1, 0), (64, 0), (0, 1), (0, 384), (37, 200), (64, 384)])
def test_tier_split_equivalence(hot_len, cold_len):
    """Port of TestTieredDecode: the two tiers == one concatenated history
    (chronological hot buffer: ring_newest defaults to hot_len - 1)."""
    rng = np.random.default_rng(hot_len * 1000 + cold_len)
    (qj, qt), (hkj, hkt), (hvj, hvt), (ckj, ckt), (cvj, cvt) = (
        pair(rng, sh) for sh in ((1, 4, 1, 64), (1, 2, 64, 64), (1, 2, 64, 64), (1, 2, 384, 64), (1, 2, 384, 64)))
    got = ops.tiered_decode_attention(qt, hkt, hvt, ckt, cvt, hot_len=hot_len, cold_len=cold_len)
    kcat = jnp.concatenate([ckj[:, :, :cold_len], hkj[:, :, :hot_len]], axis=2)
    vcat = jnp.concatenate([cvj[:, :, :cold_len], hvj[:, :, :hot_len]], axis=2)
    want = jref.decode_attention_ref(qj, kcat, vcat, hot_len + cold_len)
    assert_close(got, want, "float32")
    # and the port's own decode oracle agrees with the JAX one
    assert_close(tref.decode_attention_ref(qt, torch.from_numpy(np.array(kcat)),
                                           torch.from_numpy(np.array(vcat)), hot_len + cold_len), want, "float32")


def test_tiered_empty_gives_zero():
    """No valid key in either tier: 0, like the Pallas kernel's l == 0 guard."""
    rng = np.random.default_rng(4)
    (qj, qt), (hkj, hkt), (hvj, hvt), (ckj, ckt), (cvj, cvt) = (
        pair(rng, sh) for sh in ((1, 4, 1, 32), (1, 2, 8, 32), (1, 2, 8, 32), (1, 2, 32, 32), (1, 2, 32, 32)))
    got = ops.tiered_decode_attention(qt, hkt, hvt, ckt, cvt, 0, 0, 0)
    want = jax_tiered(qj, hkj, hvj, ckj, cvj, hot_len=0, cold_len=0, ring_newest=0, block_k=32, interpret=True)
    assert_close(got, want, "float32")
    assert not got.any()


def test_cpu_ops_run_plain_versions_and_count_no_launch():
    """On CPU tensors the ops are their plain versions, and no kernel launch
    is counted."""
    rng = np.random.default_rng(5)
    ts = [pair(rng, sh)[1] for sh in ((1, 4, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32))]
    before = ops.launches()
    torch.testing.assert_close(ops.flash_attention(*ts, window=4), tref.attention_ref(*ts, window=4), rtol=0, atol=0)
    hot = [pair(rng, (1, 2, 8, 32))[1] for _ in range(2)]
    cold = [pair(rng, (1, 2, 16, 32))[1] for _ in range(2)]
    q = pair(rng, (1, 4, 1, 32))[1]
    torch.testing.assert_close(ops.tiered_decode_attention(q, *hot, *cold, 5, 8, 2),
                               tref.tiered_ring_attention_ref(q, *hot, *cold, 5, 8, 2), rtol=0, atol=0)
    assert ops.launches() == before


def test_kernel_launchers_reject_cpu_tensors():
    """A launcher never runs a CPU tensor: it raises before building anything."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.tiered_decode import tiered_decode_attention_fwd

    x = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        tiered_decode_attention_fwd(x[:, :, :1], x, x, x, x, 1, 1, 0)


@pytest.mark.parametrize("n_keys,rows,want", [
    (1088, 32, 8),    # qwen3-8b serving, batch 4: 32 rows x 8 = 256 <= 2 x 132 blocks of 136 keys
    (8192, 32, 8),    # the long-history case: 8 splits of 1024 keys
    (1088, 4, 17),    # few rows: capped at 64 keys a split
    (100, 32, 1),     # too few keys for two splits of 64
    (63, 1, 1),
    (0, 32, 1),       # no key: one split, which sees none
    (5000, 300, 1),   # more rows than one wave holds: one block a row
])
def test_tiered_split_planner(n_keys, rows, want):
    n_split = plan_splits(n_keys, rows, sms=132)
    assert n_split == want
    assert n_split >= 1 and (n_split == 1 or n_keys // n_split >= 64)
    assert rows * n_split <= 2 * 132 or n_split == 1  # one wave
    # G = 8 holds one block an SM: half the splits where the SMs bound them
    assert plan_splits(n_keys, rows, sms=132, per_sm=blocks_per_sm(8)) == max(1, min(132 // rows, n_keys // 64))
    assert blocks_per_sm(4) == 2 and blocks_per_sm(1) == 2
    ranges = split_ranges(n_keys, n_split)
    covered = [k for k0, k1 in ranges for k in range(k0, k1)]
    assert covered == list(range(n_keys))  # every key exactly once, in order


@pytest.mark.parametrize("n_keys,n_split", [(0, 1), (0, 4), (5, 8), (80, 7), (1088, 9)])
def test_tiered_split_ranges_cover_keys_once(n_keys, n_split):
    ranges = split_ranges(n_keys, n_split)
    assert len(ranges) == n_split
    assert [k for k0, k1 in ranges for k in range(k0, k1)] == list(range(n_keys))
    assert max(k1 - k0 for k0, k1 in ranges) - min(k1 - k0 for k0, k1 in ranges) <= 1


def test_tiered_valid_key_rows_are_the_valid_slots_oldest_first():
    """Cold positions first, then the ring's valid arc from its oldest slot."""
    assert valid_key_rows(4, 3, 1, 8, 10).tolist() == [0, 1, 2, 10 + 6, 10 + 7, 10 + 0, 10 + 1]
    assert valid_key_rows(0, 2, 5, 8, 10).tolist() == [0, 1]
    assert valid_key_rows(8, 0, 7, 8, 10).tolist() == [10 + j for j in range(8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split", [1, 3, 8, 100])
@pytest.mark.parametrize("case", sorted(TIERED_CASES))
def test_tiered_split_merge_matches_jax(case, n_split, dtype):
    """The kernel's split-then-merge arithmetic (plain PyTorch) against the
    port's oracle, the JAX ring oracle and the Pallas kernel in interpret
    mode; 100 splits leave most splits without a key."""
    hot_len, cold_len, newest = TIERED_CASES[case]
    rng = np.random.default_rng(6)
    (qj, qt), (hkj, hkt), (hvj, hvt), (ckj, ckt), (cvj, cvt) = (
        pair(rng, sh, dtype) for sh in ((2, 8, 1, 32), (2, 2, 16, 32), (2, 2, 16, 32), (2, 2, 64, 32), (2, 2, 64, 32)))
    got = split_merge_plain(qt, hkt, hvt, ckt, cvt, hot_len, cold_len, newest, n_split)
    assert_close(got, jref.tiered_ring_attention_ref(qj, hkj, hvj, ckj, cvj, hot_len, cold_len, newest), dtype)
    assert_close(got, jax_tiered(qj, hkj, hvj, ckj, cvj, hot_len=hot_len, cold_len=cold_len,
                                 ring_newest=newest, block_k=32, interpret=True), dtype)
    want = tref.tiered_ring_attention_ref(qt, hkt, hvt, ckt, cvt, hot_len, cold_len, newest)
    assert_close(got, want.float().numpy(), dtype)


@pytest.mark.parametrize("hot_len,cold_len,newest,n_split", [
    (0, 40, 7, 4),     # hot_len = 0: every split is cold
    (16, 10, 3, 4),    # cold_len shorter than one split: a split straddles the tiers
    (3, 2, 1, 8),      # three splits see no key
    (0, 0, 0, 4),      # no key at all: 0
])
def test_tiered_split_merge_edge_splits(hot_len, cold_len, newest, n_split):
    rng = np.random.default_rng(7)
    (qj, qt), (hkj, hkt), (hvj, hvt), (ckj, ckt), (cvj, cvt) = (
        pair(rng, sh) for sh in ((1, 4, 1, 32), (1, 2, 16, 32), (1, 2, 16, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    got = split_merge_plain(qt, hkt, hvt, ckt, cvt, hot_len, cold_len, newest, n_split)
    # The Pallas kernel (the JAX ring oracle softmaxes -1e30 scores when no key is valid)
    assert_close(got, jax_tiered(qj, hkj, hvj, ckj, cvj, hot_len=hot_len, cold_len=cold_len,
                                 ring_newest=newest, block_k=32, interpret=True), "float32")
    assert torch.isfinite(got).all()
    if hot_len + cold_len == 0:
        assert not got.any()


def test_tiered_kernel_takes_every_gqa_layer_of_every_config():
    """Every GQA layer (full or windowed) of every config of the JAX package
    has a group and head dim the kernel is built for."""
    import repro.configs as jcfgs
    from repro.models.lm import layer_specs

    seen = set()
    for arch in jcfgs.ARCH_IDS:
        cfg = jcfgs.get_config(arch)
        if any(spec.mixer == "gqa" for spec in layer_specs(cfg)):
            g, d = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
            assert cfg.n_heads % cfg.n_kv_heads == 0 and g in GROUPS and d in HEAD_DIMS, (arch, g, d)
            seen.add((g, d))
    assert {(6, 128), (7, 64), (12, 128), (16, 256), (4, 256)} <= seen


@pytest.mark.parametrize("group", GROUPS)
def test_tiered_head_tiles_and_one_wave(group):
    """The head tiles of each group: a built width, as few tiles as the widest
    build allows, at most one padded head up to G = 8; and the planner's
    splits over B x KV x tiles rows stay in one wave of the resident blocks."""
    gt, tiles = head_tile(group)
    assert gt in HEAD_TILES and tiles == -(-group // gt) == -(-group // HEAD_TILES[-1])
    assert tiles * gt - group <= (1 if group <= 8 else 3)
    assert blocks_per_sm(group) == (2 if gt <= 4 else 1)
    for b, kv, n_keys in ((4, 8, 1088), (4, 1, 8192), (1, 2, 300)):
        rows = b * kv * tiles
        n_split = plan_splits(n_keys, rows, sms=132, per_sm=blocks_per_sm(group))
        assert n_split == 1 or (rows * n_split <= blocks_per_sm(group) * 132 and n_keys // n_split >= 64)


def test_tiered_launcher_refuses_unbuilt_shapes():
    """A group above 16, a group that does not divide, or a head dim not
    built raises before any device is touched: there is no fallback."""
    from repro_torch.kernels.tiered_decode import tiered_decode_attention_fwd

    for h, kv, d in [(17, 1, 64), (34, 2, 64), (6, 4, 64), (4, 1, 48), (4, 1, 512)]:
        z = lambda *s: torch.zeros(s)
        with pytest.raises(ValueError, match="built for"):
            tiered_decode_attention_fwd(z(1, h, 1, d), z(1, kv, 8, d), z(1, kv, 8, d), z(1, kv, 8, d), z(1, kv, 8, d),
                                        4, 4, 3)


@pytest.mark.parametrize("h,kv,d", [(5, 1, 16), (12, 2, 64), (14, 2, 32), (16, 1, 256)])
def test_tiered_split_merge_matches_jax_at_other_groups(h, kv, d):
    """The split-then-merge arithmetic and the op's plain version at groups
    and head dims beyond qwen3's, against the JAX oracle and the Pallas
    kernel in interpret mode (fp32)."""
    hot_len, cold_len, newest = 12, 40, 3
    rng = np.random.default_rng(8)
    (qj, qt), (hkj, hkt), (hvj, hvt), (ckj, ckt), (cvj, cvt) = (
        pair(rng, sh) for sh in ((1, h, 1, d), (1, kv, 16, d), (1, kv, 16, d), (1, kv, 64, d), (1, kv, 64, d)))
    want = jref.tiered_ring_attention_ref(qj, hkj, hvj, ckj, cvj, hot_len, cold_len, newest)
    assert_close(split_merge_plain(qt, hkt, hvt, ckt, cvt, hot_len, cold_len, newest, 3), want, "float32")
    assert_close(ops.tiered_decode_attention(qt, hkt, hvt, ckt, cvt, hot_len, cold_len, newest), want, "float32")
    assert_close(ops.tiered_decode_attention(qt, hkt, hvt, ckt, cvt, hot_len, cold_len, newest),
                 jax_tiered(qj, hkj, hvj, ckj, cvj, hot_len=hot_len, cold_len=cold_len, ring_newest=newest,
                            block_k=32, interpret=True), "float32")
