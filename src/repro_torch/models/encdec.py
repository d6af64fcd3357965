"""Encoder-decoder transformer of the port (whisper-large-v3's backbone) —
``repro/models/encdec.py``, unrolled as the port's ``LM`` is.

The audio conv frontend is a stub, as in the reference: callers pass
precomputed frame embeddings (B, n_frames, d_model), the mel-spectrogram
conv stack's output.  Whisper's details are kept: LayerNorm, GELU MLP,
biases, learned decoder positions, sinusoidal encoder positions, MHA
(n_kv == n_heads), tied decoder embedding/head, no RoPE.

Layout: ``encoder/prefix_i`` and ``decoder/prefix_i``, one subtree a layer
(the reference stacks each side's layers under ``periods``;
``nn.module.params_from_jax`` unrolls them and ``to_reference_layout``
stacks them back).  Decode uses a dict self-KV cache a decoder layer plus
that layer's cross (k, v), computed once from the encoder output at prefill:
``{"self": {prefix_i: cache}, "cross": {prefix_i: {"k", "v"}}}``.

    train_logits(params, frames, tokens)     -> (logits, aux = 0)
    prefill(params, frames, tokens, caches)  -> (logits, new_caches)
    decode_step(params, token, caches)       -> (logits, new_caches)
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import rematerialise, to_stream
from repro_torch.nn import layers as L
from repro_torch.nn.module import Scope

Params = Any


def _sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding (fp32)."""
    log_timescale = torch.tensor(math.log(10_000.0), dtype=torch.float32) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32)).to(device)
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def _kv(p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (k, v) of attention params ``p`` over ``x``, biases added."""
    dt = x.dtype
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


class EncDec:
    def __init__(self, cfg: ArchConfig):
        if cfg.encdec is None:
            raise ValueError("EncDec requires cfg.encdec")
        self.cfg = cfg

    # ------------------------------------------------------------------ init

    def _enc_layer_init(self, s: Scope) -> None:
        cfg = self.cfg
        L.norm_init(s, "pre_norm", cfg.d_model, cfg)
        L.attention_init(s, "attn", cfg)
        L.norm_init(s, "pre_ffn_norm", cfg.d_model, cfg)
        L.mlp_init(s, "ffn", cfg)

    def _dec_layer_init(self, s: Scope) -> None:
        cfg = self.cfg
        L.norm_init(s, "pre_self_norm", cfg.d_model, cfg)
        L.attention_init(s, "self_attn", cfg)
        L.norm_init(s, "pre_cross_norm", cfg.d_model, cfg)
        L.attention_init(s, "cross_attn", cfg)
        L.norm_init(s, "pre_ffn_norm", cfg.d_model, cfg)
        L.mlp_init(s, "ffn", cfg)

    def init(self, scope: Scope) -> None:
        cfg = self.cfg
        enc = scope.child("encoder")
        for i in range(cfg.encdec.n_encoder_layers):
            self._enc_layer_init(enc.child(f"prefix_{i}"))
        L.norm_init(enc, "final_norm", cfg.d_model, cfg)

        dec = scope.child("decoder")
        L.embedding_init(dec, "embed", cfg.vocab, cfg.d_model)
        dec.child("pos").param("table", (cfg.max_seq_len, cfg.d_model), ("seq", "embed"), init="normal", scale=0.01)
        for i in range(cfg.n_layers):
            self._dec_layer_init(dec.child(f"prefix_{i}"))
        L.norm_init(dec, "final_norm", cfg.d_model, cfg)

    # --------------------------------------------------------------- encoder

    def encode(self, params: Params, frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """frames: (B, n_frames, d_model) precomputed conv-frontend output;
        ``remat`` rematerialises each layer (training)."""
        cfg = self.cfg
        dt = L.cdtype(cfg)
        x = frames.to(dt) + _sinusoids(frames.shape[1], cfg.d_model, frames.device).to(dt)[None]
        enc = params["encoder"]
        layer = rematerialise(self._enc_layer, "full") if remat else self._enc_layer
        for i in range(cfg.encdec.n_encoder_layers):
            x = layer(enc[f"prefix_{i}"], x)
        return L.norm_apply(enc["final_norm"], x, cfg)

    def _enc_layer(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        # Bidirectional: cross-attention of the sequence onto itself.
        cfg = self.cfg
        h = L.norm_apply(p["pre_norm"], x, cfg)
        a, _ = L.attention_apply(p["attn"], h, cfg, mode="train", use_rope=False, cross_kv=_kv(p["attn"], h))
        x = x + to_stream(a, cfg)
        return x + to_stream(L.mlp_apply(p["ffn"], L.norm_apply(p["pre_ffn_norm"], x, cfg), cfg), cfg)

    # ------------------------------------------------------------- cross kv

    def cross_kv(self, params: Params, enc_out: torch.Tensor) -> dict:
        """Each decoder layer's (k, v) of the encoder memory."""
        dec = params["decoder"]
        out = {}
        for i in range(self.cfg.n_layers):
            k, v = _kv(dec[f"prefix_{i}"]["cross_attn"], enc_out)
            out[f"prefix_{i}"] = {"k": k, "v": v}
        return out

    # --------------------------------------------------------------- decoder

    def _decode_stack(self, params: Params, x: torch.Tensor, caches: dict | None, cross: dict, mode: str):
        """The decoder layers; in training with ``cfg.remat`` set, each one
        rematerialised (the reference wraps its decoder body in
        ``jax.checkpoint`` for any ``remat`` but ``"none"``)."""
        cfg = self.cfg
        dec = params["decoder"]
        remat = mode == "train" and cfg.remat != "none"
        layer = rematerialise(self._dec_layer, "full") if remat else self._dec_layer
        new_caches = {}
        for i in range(cfg.n_layers):
            key = f"prefix_{i}"
            x, new_caches[key] = layer(dec[key], x, caches[key] if caches is not None else None, cross[key], mode)
        x = L.norm_apply(dec["final_norm"], x, cfg)
        return x, (new_caches if caches is not None else None)

    def _dec_layer(self, p: Params, x: torch.Tensor, cache: dict | None, cross: dict, mode: str):
        cfg = self.cfg
        h = L.norm_apply(p["pre_self_norm"], x, cfg)
        sa, new_cache = L.attention_apply(p["self_attn"], h, cfg, cache=cache, mode=mode, use_rope=False)
        x = x + to_stream(sa, cfg, mode)
        h2 = L.norm_apply(p["pre_cross_norm"], x, cfg)
        ca, _ = L.attention_apply(p["cross_attn"], h2, cfg, mode="train", use_rope=False,
                                  cross_kv=(cross["k"], cross["v"]))
        x = x + to_stream(ca, cfg, mode)
        f = L.mlp_apply(p["ffn"], L.norm_apply(p["pre_ffn_norm"], x, cfg), cfg)
        return x + to_stream(f, cfg, mode), new_cache

    def _embed_dec(self, params: Params, tokens: torch.Tensor, start: int) -> torch.Tensor:
        x = L.embedding_apply(params["decoder"]["embed"], tokens, self.cfg)
        table = params["decoder"]["pos"]["table"]
        n = tokens.shape[1]
        # The reference's dynamic_slice clamps its start into the table.
        start = min(max(int(start), 0), table.shape[0] - n)
        return x + table[start : start + n].to(x.dtype)[None]

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return L.logits_apply(params["decoder"]["embed"], None, x, self.cfg)

    # ----------------------------------------------------------- public api

    def train_logits(self, params: Params, frames: torch.Tensor,
                     tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Decoder logits (fp32) over ``tokens`` given ``frames``, and a zero
        aux loss. Differentiable, as ``LM.train_logits``; ``cfg.remat``
        rematerialises each encoder and decoder layer."""
        cross = self.cross_kv(params, self.encode(params, frames, remat=self.cfg.remat != "none"))
        x, _ = self._decode_stack(params, self._embed_dec(params, tokens, 0), None, cross, "train")
        return self._logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def init_caches(self, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> dict:
        return {
            "self": {f"prefix_{i}": L.make_cache(self.cfg, batch, max_seq, dtype, device)
                     for i in range(self.cfg.n_layers)},
            "cross": None,
        }

    @torch.no_grad()
    def prefill(self, params: Params, frames: torch.Tensor, tokens: torch.Tensor,
                caches: dict) -> tuple[torch.Tensor, dict]:
        """Encode ``frames``, fill the self caches with ``tokens``; return the
        last position's logits and the caches with the cross (k, v)."""
        cross = self.cross_kv(params, self.encode(params, frames))
        x, new_self = self._decode_stack(params, self._embed_dec(params, tokens, 0), caches["self"], cross, "prefill")
        return self._logits(params, x[:, -1:, :]), {"self": new_self, "cross": cross}

    @torch.no_grad()
    def decode_step(self, params: Params, token: torch.Tensor, caches: dict) -> tuple[torch.Tensor, dict]:
        """One token against the caches; every layer's index is the position."""
        index = caches["self"]["prefix_0"]["index"]
        x = self._embed_dec(params, token, index)
        x, new_self = self._decode_stack(params, x, caches["self"], caches["cross"], "decode")
        return self._logits(params, x), {"self": new_self, "cross": caches["cross"]}
