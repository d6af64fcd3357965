"""Plain reference of Command A+ (``cohere2_moe``) as the benchmark serves
it: float32 PyTorch with TF32 off, no kernels, no cache, no batching.  It
imports nothing of the program: it reads the configuration file's ``model``
block and the weights the benchmark drew, and shares ``dense_lm``'s norm,
RoPE, products and float8 control.

The equations, per layer i (Cohere's parallel block off one pre-norm):

    h = LN(x);  x = x + Attn_i(h) + MoE(h)
    Attn_i: q, k, v = h Wq, h Wk, h Wv; GQA softmax(q k^T / sqrt(D)) v Wo,
            causal; window layers (three of every ``global_every``) see the
            keys (p - window, p] and rope q and k (split halves, theta from
            the file); the global layers see every earlier key, no RoPE
    MoE:    s = sigmoid(h Wr) over all ``n_experts``; the top k of s, gates
            g = s / sum of the k; of those, the experts this device holds,
            [experts_lo, experts_lo + experts_held):
            sum g_e (silu(h Wg_e) * (h Wu_e)) Wd_e; plus the mean over the
            ``n_shared`` shared experts of (silu(h Wg_j) * (h Wu_j)) Wd_j
    logits = LN_final(x) E^T         # the tied embedding, logit_scale 1

The expert share is the program's: the experts other devices hold add
nothing here either.  Departures from the published model, which the
program shares: RoPE over split halves rather than interleaved pairs (a
fixed permutation of each head's q and k columns), a LayerNorm bias, and
the shared experts' "average" read as the mean of their outputs added to
the routed sum.

``precision="fp8"`` is the control: every product inside the layers takes
its operands rounded to float8 e4m3 with one scale a tensor.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.dense_lm import _mm, exact_matmuls, layernorm, logits, rope


EXPERT = ("w_gate", "w_up", "w_down")


def _w(p: dict, name: str) -> torch.Tensor:
    return p[name].float()


def layer_window(m: dict, i: int) -> int:
    """Layer i's window: 0 on every ``global_every``-th layer, else the
    file's ``window``."""
    g = m["global_every"]
    return 0 if g and i % g == g - 1 else m["window"]


def attention(h: torch.Tensor, p: dict, m: dict, window: int, precision: str, block: int) -> torch.Tensor:
    """Causal GQA over h (S, d), windowed where ``window`` > 0 (with RoPE),
    global otherwise (no RoPE); queries in blocks of ``block`` rows, each
    against the keys it can see."""
    s, d = h.shape
    heads, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    g = heads // kv
    proj = lambda name, n: _mm(h, _w(p, "w" + name).reshape(d, n * hd), precision).reshape(s, n, hd)
    q, k, v = proj("q", heads), proj("k", kv), proj("v", kv)
    if window:
        pos = torch.arange(s, device=h.device)
        q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    kt, vt = k.permute(1, 2, 0), v.transpose(0, 1)  # (KV, D, S), (KV, S, D)
    outs = []
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        k0 = max(0, lo - window + 1) if window else 0
        qb = q[lo:hi].reshape(hi - lo, kv, g, hd).permute(1, 2, 0, 3)  # (KV, G, b, D)
        scores = _mm(qb, kt[:, None, :, k0:hi], precision) / math.sqrt(hd)  # (KV, G, b, T)
        qpos = torch.arange(lo, hi, device=h.device)[:, None]
        kpos = torch.arange(k0, hi, device=h.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        probs = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
        out = _mm(probs, vt[:, None, k0:hi], precision)  # (KV, G, b, D)
        outs.append(out.permute(2, 0, 1, 3).reshape(hi - lo, heads * hd))
    return _mm(torch.cat(outs), _w(p, "wo").reshape(heads * hd, d), precision)


def _expert(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, precision: str) -> torch.Tensor:
    return _mm(F.silu(_mm(x, wg, precision)) * _mm(x, wu, precision), wd, precision)


def moe(h: torch.Tensor, p: dict, m: dict, precision: str, block: int) -> torch.Tensor:
    """The held experts' part of the routed sum and the shared experts'
    mean, for h (S, d), ``block`` tokens at a time."""
    lo, held, k, f = m["experts_lo"], m["experts_held"], m["moe_top_k"], m["moe_expert_ff"]
    n_shared = m["moe_shared"]
    out = []
    for t0 in range(0, h.shape[0], block):
        x = h[t0 : t0 + block]
        scores = torch.sigmoid(_mm(x, _w(p, "router"), precision))
        top, chosen = torch.topk(scores, k, dim=-1)
        gates = top / (top.sum(-1, keepdim=True) + 1e-9)
        y = torch.zeros_like(x)
        for e in range(held):
            picked = chosen == lo + e  # (b, k): a token picks an expert at most once
            tokens = picked.any(-1).nonzero()[:, 0]
            if tokens.numel():
                gate = (gates * picked).sum(-1)[tokens, None]
                y.index_add_(0, tokens, gate * _expert(x[tokens], *(p[w][e].float() for w in EXPERT), precision))
        sp = p["shared"]
        cols = [slice(j * f, (j + 1) * f) for j in range(n_shared)]
        shared = [_expert(x, sp["w_gate"][:, c].float(), sp["w_up"][:, c].float(), sp["w_down"][c].float(), precision)
                  for c in cols]
        out.append(y + torch.stack(shared).mean(0))
    return torch.cat(out)


def layer(x: torch.Tensor, p: dict, m: dict, i: int, precision: str, block: int) -> torch.Tensor:
    h = layernorm(x, p["pre_norm"], m["norm_eps"])
    return x + attention(h, p["mixer"], m, layer_window(m, i), precision, block) + moe(h, p["ffn"], m, precision,
                                                                                      8 * block)


def hidden(params: dict, tokens: torch.Tensor, m: dict, precision: str = "fp32", block: int = 256) -> torch.Tensor:
    """Final-normed hidden states (S, d) of one sequence, layer by layer."""
    x = params["embed"]["table"].float()[tokens]
    for i in range(m["n_layers"]):
        x = layer(x, params[f"prefix_{i}"], m, i, precision, block)
    return layernorm(x, params["final_norm"], m["norm_eps"])


@torch.no_grad()
def served_gaps(params: dict, m: dict, prompt: torch.Tensor, served: list[int],
                precisions: tuple[str, ...] = ("fp32",), program=None) -> dict[str, list[float]]:
    """Run the reference once over ``prompt`` followed by the served
    tokens, and at each served position return how far below the float32
    reference's best logit lies the logit of the token chosen: ``"served"``
    the token the program served, and for each other precision the token
    that precision's own logits put first (the control, read at the same
    prompts and tokens, without decoding).

    ``program``, the program's leading logits at the served positions
    (values and token ids, (n, k) each), adds ``"served_logit"``: at each
    position the largest distance between a leading logit of the program
    and the float32 reference's logit of the same token; each other
    precision gets ``"<precision>_logit"`` from its own k leading logits."""
    exact_matmuls()
    seq = torch.cat([prompt.to(torch.long), torch.as_tensor(served[:-1], dtype=torch.long, device=prompt.device)])
    first = len(prompt) - 1  # the position whose logits chose served[0]
    gold = torch.as_tensor(served, dtype=torch.long, device=prompt.device)
    out: dict[str, list[float]] = {}
    ref = None
    for prec in ("fp32",) + tuple(q for q in precisions if q != "fp32"):
        lg = logits(params, hidden(params, seq, m, prec)[first:])
        if prec == "fp32":
            ref = lg
            out["served"] = (ref.max(-1).values - ref.gather(-1, gold[:, None])[:, 0]).tolist()
            if program is not None:
                values, ids = (torch.as_tensor(t, device=ref.device) for t in program)
                out["served_logit"] = _logit_gaps(ref, values.float(), ids.long())
        else:
            pick = lg.argmax(-1)
            out[prec] = (ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]).tolist()
            if program is not None:
                values, ids = lg.topk(program[1].shape[-1], dim=-1)
                out[prec + "_logit"] = _logit_gaps(ref, values, ids)
        del lg
    return out


def _logit_gaps(ref: torch.Tensor, values: torch.Tensor, ids: torch.Tensor) -> list[float]:
    """At each position, the largest |value - ref[id]| over the k leading
    (value, id) pairs of a precision's logits."""
    return (values - ref.gather(-1, ids)).abs().amax(-1).tolist()
