"""Decoder-only LM of the port — ``repro/models/lm.py`` for the dense GQA
family (qwen3-8b, starcoder2-3b, command-r-35b, gemma3-1b's 5:1 local and
global layers), MoE (grok-1-314b), MLA + MoE with DeepSeek's multi-token
prediction head (deepseek-v3-671b) and the recurrent ones: the RG-LRU hybrid
with local attention (recurrentgemma-9b) and xLSTM (xlstm-125m), and the
VLM (internvl2-1b): precomputed patch embeddings, projected by ``vlm_proj``
and prepended to the text at train and prefill; decode is text-only.  The
encoder-decoder (whisper) is ``models.encdec.EncDec``.  Only the port has
Command A+ (``cohere2_moe``): window layers with RoPE beside NoPE global
ones, Cohere's parallel block, and an expert share in every layer
(``configs.port.PortArchConfig``).

The stack is always unrolled (``prefix_0 .. prefix_{L-1}``): PyTorch runs
eagerly and has no ``lax.scan``, and the two-level cache is host state that
could not ride a scan carry anyway.  ``nn.module.params_from_jax`` unrolls a
scanned JAX tree into the same keys, and ``nn.module.to_reference_layout``
stacks them back (``stack_plan``) for a checkpoint either package restores.
In training, ``cfg.remat`` rematerialises the layers the reference's
``jax.checkpoint`` wraps: each period of ``stack_plan`` (``rematerialise``).

Three entry points (pure functions of params and caches; only the first is
differentiable):

    train_logits(params, tokens, patches=None)     -> (logits, aux)
    train_hidden(params, tokens, patches=None)     -> (hidden, aux)   [+ mtp_logits]
    prefill(params, tokens, caches, patches=None)  -> (logits, new_caches)
    decode_step(params, token, caches)  -> (logits, new_caches)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.port import setting
from repro_torch.nn import layers as L
from repro_torch.nn import recurrent as R
from repro_torch.nn.module import Scope, constrain

Params = Any


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # 'gqa' | 'mla' | 'rglru' | 'mlstm' | 'slstm'
    window: int = 0  # sliding window for gqa (0 = full)
    ffn: str = "mlp"  # 'mlp' | 'moe' | 'none'
    rope: bool = True  # gqa: RoPE on q and k (False: Command A's global NoPE)


def layer_specs(cfg: ArchConfig) -> list[LayerSpec]:
    """Expand a config into its per-layer specs."""
    specs: list[LayerSpec] = []
    for i in range(cfg.n_layers):
        if cfg.recurrent is not None and cfg.recurrent.kind == "rglru":
            every = cfg.recurrent.attn_every
            if i % every == every - 1:
                specs.append(LayerSpec("gqa", window=cfg.window or 2048))
            else:
                specs.append(LayerSpec("rglru"))
        elif cfg.recurrent is not None and cfg.recurrent.kind == "xlstm":
            every = cfg.recurrent.slstm_every
            kind = "slstm" if i % every == every - 1 else "mlstm"
            specs.append(LayerSpec(kind, ffn="none"))
        elif cfg.attn_type == "mla":
            ffn = "moe" if (cfg.moe and i >= cfg.moe.first_k_dense) else "mlp"
            specs.append(LayerSpec("mla", ffn=ffn))
        else:
            window = cfg.window
            if cfg.global_every > 0 and i % cfg.global_every == cfg.global_every - 1:
                window = 0  # periodic global layer (gemma3 5:1)
            ffn = "moe" if cfg.moe is not None else "mlp"
            rope = window > 0 or setting(cfg, "rope_on_global")
            specs.append(LayerSpec("gqa", window=window, ffn=ffn, rope=rope))
    return specs


def _period_len(cfg: ArchConfig) -> int:
    if cfg.recurrent is not None:
        return cfg.recurrent.attn_every if cfg.recurrent.kind == "rglru" else cfg.recurrent.slstm_every
    if cfg.global_every > 0:
        return cfg.global_every
    return 1


def stack_plan(cfg: ArchConfig) -> tuple[list[LayerSpec], list[LayerSpec], int, list[LayerSpec]]:
    """(prefix, period, n_periods, suffix): the JAX package's partition of the
    layer list, which lays out its parameter tree (scanned periods when
    ``cfg.scan_layers``).  The port's own stack is always unrolled
    (``LM.prefix``); ``nn.module.to_reference_layout`` re-stacks it by this plan."""
    specs = layer_specs(cfg)
    n_prefix = cfg.moe.first_k_dense if (cfg.moe and cfg.attn_type == "mla") else 0
    plen = _period_len(cfg)
    body = len(specs) - n_prefix
    n_periods = body // plen
    n_suffix = body - n_periods * plen
    prefix = specs[:n_prefix]
    period = specs[n_prefix : n_prefix + plen] if n_periods else []
    suffix = specs[len(specs) - n_suffix :] if n_suffix else []
    if not cfg.scan_layers:
        return specs, [], 0, []
    return prefix, period, n_periods, suffix


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of ``remat="dots"`` (the reference's
    ``checkpoint_dots``): keep the matrix products' outputs, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def rematerialise(fn, remat: str):
    """``fn`` as the reference's ``jax.checkpoint`` wraps it: ``"full"`` keeps
    only its inputs and recomputes the rest in the backward
    (``nothing_saveable``), ``"dots"`` keeps the matrix products' outputs too;
    ``"none"`` gives ``fn`` back."""
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, save_matmuls)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


_MIXER_INIT = {"gqa": L.attention_init, "mla": L.mla_init, "rglru": R.rglru_init, "mlstm": R.mlstm_init,
               "slstm": R.slstm_init}
_RECURRENT_APPLY = {"rglru": R.rglru_block_apply, "mlstm": R.mlstm_block_apply, "slstm": R.slstm_block_apply}


def init_layer(scope: Scope, spec: LayerSpec, cfg: ArchConfig) -> None:
    L.norm_init(scope, "pre_norm", cfg.d_model, cfg)
    _MIXER_INIT[spec.mixer](scope, "mixer", cfg)
    if cfg.post_norms:
        L.norm_init(scope, "post_mixer_norm", cfg.d_model, cfg)
    if spec.ffn != "none":
        if not setting(cfg, "parallel_block"):
            L.norm_init(scope, "pre_ffn_norm", cfg.d_model, cfg)
        (L.moe_init if spec.ffn == "moe" else L.mlp_init)(scope, "ffn", cfg)
        if cfg.post_norms:
            L.norm_init(scope, "post_ffn_norm", cfg.d_model, cfg)


def make_layer_cache(spec: LayerSpec, cfg: ArchConfig, batch: int, max_seq: int, dtype, device="cuda") -> dict:
    if spec.mixer == "gqa":
        # Sliding-window layers only ever need `window` keys; cap the page.
        size = min(max_seq, spec.window) if spec.window > 0 else max_seq
        return L.make_cache(cfg, batch, size, dtype, device)
    if spec.mixer == "mla":
        return L.mla_make_cache(cfg, batch, max_seq, dtype, device)
    if spec.mixer == "rglru":
        return R.rglru_make_state(cfg, batch, dtype, device)
    if spec.mixer == "mlstm":
        return R.mlstm_make_state(cfg, batch, device)
    if spec.mixer == "slstm":
        return R.slstm_make_state(cfg, batch, device)
    raise ValueError(spec.mixer)


def to_stream(y: torch.Tensor, cfg: ArchConfig, mode: str = "train") -> torch.Tensor:
    """``y`` placed as the residual stream: ``("batch", "seq", "act_embed")``,
    or under ``cfg.seq_parallel`` in training ``("batch", "residual_seq",
    None)`` (Megatron-SP: the stream stays sharded over 'model' on the
    sequence dim between blocks).  On a block's output, a partial sum over
    'model' on a mesh, this is where it is reduced, once and in the
    activation dtype (a reduce-scatter under sequence parallelism), as the
    reference's partitioner reduces it; left partial, DTensor would reduce
    it in fp32 inside every norm that reads the stream, and again in the
    backward."""
    if cfg.seq_parallel and mode == "train":
        return constrain(y, "batch", "residual_seq", None)
    return constrain(y, "batch", "seq", "act_embed")


def apply_layer(p: Params, x: torch.Tensor, spec: LayerSpec, cfg: ArchConfig,
                cache: Any = None, mode: str = "train") -> tuple[torch.Tensor, Any, torch.Tensor]:
    """Residual layer body. Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.seq_parallel and mode == "train":
        x = to_stream(x, cfg, mode)
    h = L.norm_apply(p["pre_norm"], x, cfg)
    if spec.mixer == "gqa":
        mix, new_cache = L.attention_apply(p["mixer"], h, cfg, window=spec.window, cache=cache, mode=mode,
                                           use_rope=spec.rope)
    elif spec.mixer == "mla":
        mix, new_cache = L.mla_apply(p["mixer"], h, cfg, cache=cache, mode=mode)
    else:
        mix, new_cache = _RECURRENT_APPLY[spec.mixer](p["mixer"], h, cfg, state=cache)
    mix = to_stream(mix, cfg, mode)
    if cfg.post_norms:
        mix = L.norm_apply(p["post_mixer_norm"], mix, cfg)
    x = x + mix
    if spec.ffn != "none":
        # Cohere's parallel block feeds the FFN the attention's normed input.
        h2 = h if setting(cfg, "parallel_block") else L.norm_apply(p["pre_ffn_norm"], x, cfg)
        if spec.ffn == "moe":
            f, aux = L.moe_apply(p["ffn"], h2, cfg)
        else:
            f = L.mlp_apply(p["ffn"], h2, cfg)
        f = to_stream(f, cfg, mode)
        if cfg.post_norms:
            f = L.norm_apply(p["post_ffn_norm"], f, cfg)
        x = x + f
    return x, new_cache, aux


class LM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        # Unrolled: every layer is prefix_i (see the module docstring).
        self.prefix, self.period, self.n_periods, self.suffix = layer_specs(cfg), [], 0, []

    def init(self, scope: Scope) -> None:
        cfg = self.cfg
        L.embedding_init(scope, "embed", cfg.vocab, cfg.d_model)
        if not cfg.tie_embeddings:
            scope.child("head").param("w", (cfg.d_model, cfg.vocab), ("embed", "vocab"), init="fan_in")
        if cfg.vlm is not None:
            L.linear_init(scope, "vlm_proj", cfg.vlm.patch_dim, cfg.d_model, ("embed", None))
        for i, spec in enumerate(self.prefix):
            init_layer(scope.child(f"prefix_{i}"), spec, cfg)
        L.norm_init(scope, "final_norm", cfg.d_model, cfg)
        if cfg.mtp:
            m = scope.child("mtp")
            L.norm_init(m, "in_norm", cfg.d_model, cfg)
            L.linear_init(m, "proj", 2 * cfg.d_model, cfg.d_model, (None, "embed"))
            init_layer(m.child("layer"), LayerSpec(cfg.attn_type, ffn="mlp"), cfg)

    def init_caches(self, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> dict:
        return {
            f"prefix_{i}": make_layer_cache(spec, self.cfg, batch, max_seq, dtype, device)
            for i, spec in enumerate(self.prefix)
        }

    def _run_stack(self, params: Params, x: torch.Tensor, caches: dict | None, mode: str):
        """Every layer in turn. Returns (x, new_caches, the layers' aux losses summed).

        In training with ``cfg.remat`` set, each period of the reference's
        ``stack_plan`` runs as one rematerialised body (its layers and their
        aux losses); its unrolled prefix and suffix layers do not."""
        cfg = self.cfg
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        if mode == "train" and cfg.remat != "none":
            prefix, period, n_periods, _ = stack_plan(cfg)
            first, plen = len(prefix), len(period)
            body = rematerialise(self._run_layers, cfg.remat)
            i = 0
            while i < len(self.prefix):
                periodic = first <= i < first + n_periods * plen
                n = plen if periodic else 1
                x, aux_total = (body if periodic else self._run_layers)(params, x, aux_total, i, n)
                i += n
            return x, None, aux_total
        new_caches: dict[str, Any] = {}
        for i, spec in enumerate(self.prefix):
            key = f"prefix_{i}"
            x, nc, aux = apply_layer(params[key], x, spec, cfg, caches.get(key) if caches else None, mode)
            aux_total = aux_total + aux
            if caches is not None:
                new_caches[key] = nc
        return x, (new_caches if caches is not None else None), aux_total

    def _run_layers(self, params: Params, x: torch.Tensor, aux_total: torch.Tensor, start: int,
                    n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Training layers ``start .. start+n-1``: (x, aux_total) after them."""
        for i in range(start, start + n):
            x, _, aux = apply_layer(params[f"prefix_{i}"], x, self.prefix[i], self.cfg, None, "train")
            aux_total = aux_total + aux
        return x, aux_total

    def _embed(self, params: Params, tokens: torch.Tensor, patches: torch.Tensor | None) -> torch.Tensor:
        x = L.embedding_apply(params["embed"], tokens, self.cfg)
        if self.cfg.vlm is not None and patches is not None:
            # Patches arrive at train/prefill; decode steps are text-only.
            pe = L.linear_apply(params["vlm_proj"], patches.to(x.dtype))
            x = torch.cat([pe, x], dim=1)
        return constrain(x, "batch", "seq", "act_embed")

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = L.norm_apply(params["final_norm"], x, self.cfg)
        return L.logits_apply(params["embed"], params.get("head"), x, self.cfg)

    def train_logits(self, params: Params, tokens: torch.Tensor,
                     patches: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence causal logits (a VLM's at its text positions only).
        Returns (logits fp32, aux_loss).

        Differentiable (the training forward, ``launch.steps.make_loss_fn``):
        autograd tracks it when the params require grad."""
        x, aux = self.train_hidden(params, tokens, patches)
        logits = self._logits(params, x)
        if self.cfg.vlm is not None:
            logits = logits[:, self.cfg.vlm.n_patches :, :]  # text positions only
        return logits, aux

    def train_hidden(self, params: Params, tokens: torch.Tensor,
                     patches: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Hidden states before the final norm (for the MTP head) + aux."""
        x = self._embed(params, tokens, patches)
        x, _, aux = self._run_stack(params, x, None, "train")
        return x, aux

    def mtp_logits(self, params: Params, tokens: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        """DeepSeek MTP head: predict t+2 from [h_t ; emb(t+1)] (depth 1); the
        caller shifts ``tokens`` and ``hidden``."""
        cfg = self.cfg
        m = params["mtp"]
        emb_next = L.embedding_apply(params["embed"], tokens, cfg)
        h = L.norm_apply(m["in_norm"], hidden, cfg)
        z = L.linear_apply(m["proj"], torch.cat([h, emb_next], dim=-1))
        z, _, _ = apply_layer(m["layer"], z, LayerSpec(cfg.attn_type, ffn="mlp"), cfg, None, "train")
        return self._logits(params, z)

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor, caches: dict,
                patches: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """Process the prompt (after a VLM's patches); fill caches; return
        last-position logits."""
        x = self._embed(params, tokens, patches)
        x, new_caches, _ = self._run_stack(params, x, caches, "prefill")
        return self._logits(params, x[:, -1:, :]), new_caches

    @torch.no_grad()
    def decode_step(self, params: Params, token: torch.Tensor, caches: dict) -> tuple[torch.Tensor, dict]:
        """One autoregressive step against pre-allocated caches."""
        x = L.embedding_apply(params["embed"], token, self.cfg)
        x, new_caches, _ = self._run_stack(params, x, caches, "decode")
        return self._logits(params, x), new_caches
