"""Layer-by-layer parity of the port (repro_torch.nn, configs) with the JAX
package on the CPU, in fp32 with TF32 off.

Parameters come from the JAX init and reach the port through
``params_from_jax``; inputs come from a numpy seed.  Tolerance: fp32
rtol = atol = 2e-5 for elementwise layers and attention (the kernels'
fp32 bar), 1e-4 where a matrix product over d_model is summed in another
order by the two backends.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.nn import layers as JL
from repro.nn.module import init_with_axes as jax_init
import repro_torch.configs as tcfgs
from repro_torch.nn import layers as TL
from repro_torch.nn.module import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = dict(rtol=2e-5, atol=2e-5)
MATMUL = dict(rtol=1e-4, atol=1e-4)


def cfg32(**kw):
    return dataclasses.replace(tcfgs.get_reduced("qwen3_8b"), dtype="float32", **kw)


def jcfg32(**kw):
    return dataclasses.replace(jcfgs.get_reduced("qwen3_8b"), dtype="float32", **kw)


def both(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def close(got, want, tol=F32):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def init_both(init_fn_jax, seed=0):
    params, _ = jax_init(init_fn_jax, jax.random.PRNGKey(seed))
    return params, params_from_jax(params, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3_8b", "recurrentgemma_9b", "xlstm_125m", "starcoder2_3b", "command_r_35b",
                                  "gemma3_1b", "grok_1_314b", "deepseek_v3_671b", "whisper_large_v3",
                                  "internvl2_1b"])
@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_config_copy_matches_jax(which, arch):
    want = dataclasses.asdict(getattr(jcfgs, which)(arch))
    got = dataclasses.asdict(getattr(tcfgs, which)(arch.replace("_", "-")))
    assert got == want
    assert [f.name for f in dataclasses.fields(tcfgs.ArchConfig)] == [f.name for f in dataclasses.fields(jcfgs.ArchConfig)]
    assert tcfgs.SHAPES == {k: tcfgs.ShapeCell(**dataclasses.asdict(v)) for k, v in jcfgs.SHAPES.items()}


def test_unported_arch_raises():
    """An arch outside the registry raises; the registry is the JAX
    package's, whisper-large-v3 and internvl2-1b included."""
    with pytest.raises(KeyError):
        tcfgs.get_config("no_such_arch")
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS
    assert tcfgs.get_config("whisper_large_v3").encdec.n_encoder_layers == 32
    assert tcfgs.get_config("internvl2_1b").vlm.n_patches == 256


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(norm):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.normal(size=(2, 5, 96)) * 3 + 1)
    jp = {"scale": jnp.asarray(rng.normal(size=96), jnp.float32), "bias": jnp.asarray(rng.normal(size=96), jnp.float32)}
    tp = params_from_jax(jp, device="cpu")
    if norm == "rmsnorm":
        close(TL.rmsnorm_apply(tp, xt, 1e-6), JL.rmsnorm_apply(jp, xj, 1e-6))
    else:
        close(TL.layernorm_apply(tp, xt, 1e-6), JL.layernorm_apply(jp, xj, 1e-6))
    close(TL._head_rms(xt, tp["scale"], 1e-6), JL._head_rms(xj, jp["scale"], 1e-6))


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 5000, size=(3, 7) if batched else (7,))
    cj, sj = JL.rope_tables(jnp.asarray(pos), 16, 1e6)
    ct, st = TL.rope_tables(torch.from_numpy(pos), 16, 1e6)
    close(ct, cj, dict(rtol=0, atol=5e-6))  # angles up to 5000 rad: a few float32 ulps of sin/cos
    close(st, sj, dict(rtol=0, atol=5e-6))
    xj, xt = both(rng.normal(size=(3, 7, 4, 16)))
    close(TL.apply_rope(xt, torch.from_numpy(np.array(cj)), torch.from_numpy(np.array(sj))),
          JL.apply_rope(xj, cj, sj))


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp(mlp_type):
    jc = jcfg32(mlp_type=mlp_type, use_bias=mlp_type == "gelu")
    jp, tp = init_both(lambda s: JL.mlp_init(s, "ffn", jc))
    rng = np.random.default_rng(2)
    xj, xt = both(rng.normal(size=(2, 5, jc.d_model)))
    close(TL.mlp_apply(tp["ffn"], xt, cfg32(mlp_type=mlp_type)), JL.mlp_apply(jp["ffn"], xj, jc), MATMUL)


def test_embedding_linear_logits():
    jc = jcfg32()
    def init(s):
        JL.embedding_init(s, "embed", jc.vocab, jc.d_model)
        JL.linear_init(s, "proj", jc.d_model, 32, ("embed", None), use_bias=True)
        s.child("head").param("w", (jc.d_model, jc.vocab), ("embed", "vocab"), init="fan_in")
    jp, tp = init_both(init)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, jc.vocab, size=(2, 6))
    close(TL.embedding_apply(tp["embed"], torch.from_numpy(tok), cfg32()), JL.embedding_apply(jp["embed"], jnp.asarray(tok), jc))
    xj, xt = both(rng.normal(size=(2, 6, jc.d_model)))
    close(TL.linear_apply(tp["proj"], xt), JL.linear_apply(jp["proj"], xj), MATMUL)
    close(TL.logits_apply(tp["embed"], tp["head"], xt, cfg32()), JL.logits_apply(jp["embed"], jp["head"], xj, jc), MATMUL)
    close(TL.logits_apply(tp["embed"], None, xt, cfg32()), JL.logits_apply(jp["embed"], None, xj, jc), MATMUL)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_train_and_prefill(window, attn_impl):
    """train and prefill outputs, and the dict cache prefill fills — incl.
    the s > page roll of a windowed ring page."""
    jc, tc = jcfg32(attn_impl=attn_impl), cfg32(attn_impl=attn_impl)
    jp, tp = init_both(lambda s: JL.attention_init(s, "a", jc))
    rng = np.random.default_rng(4)
    s = 20
    xj, xt = both(rng.normal(size=(2, s, jc.d_model)))
    yj, _ = JL.attention_apply(jp["a"], xj, jc, window=window, mode="train")
    yt, _ = TL.attention_apply(tp["a"], xt, tc, window=window, mode="train")
    close(yt, yj, MATMUL)
    page = window or 32
    cj = JL.make_cache(jc, 2, page, jnp.float32)
    ct = TL.make_cache(tc, 2, page, torch.float32, device="cpu")
    yj, cj = JL.attention_apply(jp["a"], xj, jc, window=window, cache=cj, mode="prefill")
    yt, ct = TL.attention_apply(tp["a"], xt, tc, window=window, cache=ct, mode="prefill")
    close(yt, yj, MATMUL)
    close(ct["k"], cj["k"], MATMUL)
    close(ct["v"], cj["v"], MATMUL)
    assert ct["index"] == int(cj["index"]) == s


@pytest.mark.parametrize("window", [0, 8])
def test_attention_decode_dict_cache(window):
    """Decode against the dict cache past the ring page (slot = pos % page)."""
    jc, tc = jcfg32(), cfg32()
    jp, tp = init_both(lambda s: JL.attention_init(s, "a", jc))
    rng = np.random.default_rng(5)
    page = window or 24
    cj = JL.make_cache(jc, 2, page, jnp.float32)
    ct = TL.make_cache(tc, 2, page, torch.float32, device="cpu")
    xj, xt = both(rng.normal(size=(2, 6, jc.d_model)))
    _, cj = JL.attention_apply(jp["a"], xj, jc, window=window, cache=cj, mode="prefill")
    _, ct = TL.attention_apply(tp["a"], xt, tc, window=window, cache=ct, mode="prefill")
    for _ in range(4):  # 6 + 4 tokens wrap the 8-slot ring
        xj, xt = both(rng.normal(size=(2, 1, jc.d_model)))
        yj, cj = JL.attention_apply(jp["a"], xj, jc, window=window, cache=cj, mode="decode")
        yt, ct = TL.attention_apply(tp["a"], xt, tc, window=window, cache=ct, mode="decode")
        close(yt, yj, MATMUL)
    close(ct["k"], cj["k"], MATMUL)
    assert ct["index"] == int(cj["index"])


def test_attention_tiered_prefill_and_decode():
    """The tiered branches of attention_apply against JAX's, both caches
    TieredKVCache (hot ring 6, page 3), across the ring wrap."""
    from repro.serving import TieredKVCache as JCache
    from repro_torch.serving import TieredKVCache as TCache

    jc, tc = jcfg32(attn_impl="flash"), cfg32(attn_impl="flash")
    jp, tp = init_both(lambda s: JL.attention_init(s, "a", jc))
    rng = np.random.default_rng(6)
    kv, hd = jc.n_kv_heads, jc.resolved_head_dim
    cj = JCache(2, kv, hd, window=6, max_len=32, dtype=jnp.float32, page=3)
    ct = TCache(2, kv, hd, window=6, max_len=32, dtype=torch.float32, page=3, device="cpu")
    xj, xt = both(rng.normal(size=(2, 10, jc.d_model)))
    yj, _ = JL.attention_apply(jp["a"], xj, jc, cache=cj, mode="prefill")
    yt, _ = TL.attention_apply(tp["a"], xt, tc, cache=ct, mode="prefill")
    close(yt, yj, MATMUL)
    for _ in range(4):
        xj, xt = both(rng.normal(size=(2, 1, jc.d_model)))
        yj, _ = JL.attention_apply(jp["a"], xj, jc, cache=cj, mode="decode")
        yt, _ = TL.attention_apply(tp["a"], xt, tc, cache=ct, mode="decode")
        close(yt, yj, MATMUL)
    assert (ct.length, ct.hot_len, ct.cold_len) == (cj.length, cj.hot_len, cj.cold_len)
    close(ct.hot_k, cj.hot_k, MATMUL)
    close(ct.host_views()[0], cj.host_views()[0], MATMUL)


def test_tiered_rejects_window_and_softcap():
    from repro_torch.serving import TieredKVCache

    from repro_torch.nn.module import init_with_axes

    tc = cfg32()
    tp, _ = init_with_axes(lambda s: TL.attention_init(s, "a", tc), 0, device="cpu")
    cache = TieredKVCache(1, tc.n_kv_heads, tc.resolved_head_dim, window=4, max_len=8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="tiered"):
        TL.attention_apply(tp["a"], torch.zeros(1, 1, tc.d_model), tc, window=4, cache=cache, mode="decode")
