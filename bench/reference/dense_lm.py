"""Plain reference of the dense decoder LMs the benchmark runs (command-r-35b,
starcoder2-3b): float32 PyTorch with TF32 off, no kernels, no cache, no
batching.  It imports nothing of the program: it reads the configuration
file's ``model`` block and the weights the benchmark drew.

The equations, per layer (pre-norm, sequential residual):

    h = LN(x);  q, k, v = h Wq (+ bq), h Wk (+ bk), h Wv (+ bv)
    q, k = rope(q), rope(k)          # split halves, theta from the file
    x = x + softmax(q k^T / sqrt(D) + causal) v Wo
    h = LN(x);  x = x + MLP(h)       # SwiGLU, or tanh-GELU with biases
    logits = LN_final(x) E^T         # the tied embedding, in float32

Departures from the published models are the program's, and the reference
follows them so that the two compute the same function: Cohere's parallel
attention/FFN block is sequential here, its logit scale (0.0625) is not
applied, and its LayerNorm carries a bias.

``precision="fp8"`` is the control: every product inside the layers takes
its operands rounded to float8 e4m3 with one scale a tensor, the step below
the bfloat16 that the configuration states.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def exact_matmuls() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _RoundFP8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale; the gradient passes
    through unchanged (the usual straight-through rule)."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _op(x: torch.Tensor, precision: str) -> torch.Tensor:
    return _RoundFP8.apply(x) if precision == "fp8" else x


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return _op(a, precision) @ _op(b, precision)


def layernorm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"].float() + p["bias"].float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, D): rotate the first half against the second."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _w(p: dict, name: str) -> torch.Tensor:
    return p[name].float()


def attention(h: torch.Tensor, p: dict, m: dict, precision: str, block: int) -> torch.Tensor:
    """Causal GQA over h (S, d), queries in blocks of ``block`` rows."""
    s, d = h.shape
    heads, kv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // heads

    def proj(name: str, n: int) -> torch.Tensor:
        y = _mm(h, _w(p, "w" + name).reshape(d, n * hd), precision).reshape(s, n, hd)
        return y + _w(p, "b" + name) if "b" + name in p else y

    pos = torch.arange(s, device=h.device)
    q = rope(proj("q", heads), pos, m["rope_theta"])
    k = rope(proj("k", kv), pos, m["rope_theta"]).repeat_interleave(heads // kv, dim=1)
    v = proj("v", kv).repeat_interleave(heads // kv, dim=1)
    kt, vt = k.permute(1, 2, 0), v.transpose(0, 1)  # (H, D, S), (H, S, D)
    outs = []
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        qb = q[lo:hi].transpose(0, 1)  # (H, b, D)
        scores = _mm(qb, kt[:, :, :hi], precision) / math.sqrt(hd)
        mask = torch.arange(hi, device=h.device)[None, :] <= torch.arange(lo, hi, device=h.device)[:, None]
        probs = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
        outs.append(_mm(probs, vt[:, :hi], precision).transpose(0, 1))
    out = torch.cat(outs).reshape(s, heads * hd)
    return _mm(out, _w(p, "wo").reshape(heads * hd, d), precision)


def mlp(h: torch.Tensor, p: dict, m: dict, precision: str) -> torch.Tensor:
    if m["mlp_type"] == "swiglu":
        a = F.silu(_mm(h, _w(p, "w_gate"), precision)) * _mm(h, _w(p, "w_up"), precision)
    else:
        a = _mm(h, _w(p, "w_up"), precision)
        if "b_up" in p:
            a = a + _w(p, "b_up")
        a = F.gelu(a, approximate="tanh")
    y = _mm(a, _w(p, "w_down"), precision)
    return y + _w(p, "b_down") if "b_down" in p else y


def layer(x: torch.Tensor, p: dict, m: dict, precision: str, block: int) -> torch.Tensor:
    x = x + attention(layernorm(x, p["pre_norm"], m["norm_eps"]), p["mixer"], m, precision, block)
    return x + mlp(layernorm(x, p["pre_ffn_norm"], m["norm_eps"]), p["ffn"], m, precision)


def hidden(params: dict, tokens: torch.Tensor, m: dict, precision: str = "fp32", block: int = 512,
           remat: bool = False) -> torch.Tensor:
    """Final-normed hidden states (S, d) of one sequence, layer by layer."""
    x = params["embed"]["table"].float()[tokens]
    for i in range(m["n_layers"]):
        p = params[f"prefix_{i}"]
        if remat:
            x = checkpoint(layer, x, p, m, precision, block, use_reentrant=False)
        else:
            x = layer(x, p, m, precision, block)
    return layernorm(x, params["final_norm"], m["norm_eps"])


def logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["embed"]["table"].float().T


# ------------------------------------------------------------------ serving


@torch.no_grad()
def served_gaps(params: dict, m: dict, prompt: torch.Tensor, served: list[int],
                precisions: tuple[str, ...] = ("fp32",)) -> dict[str, list[float]]:
    """Run the reference once over ``prompt`` followed by the served
    tokens, and at each served position return how far below the float32
    reference's best logit lies the logit of the token chosen:
    ``"served"`` the token the program served, and for each other
    precision the token that precision's own logits put first (a control
    read at the same prompts and tokens, without decoding)."""
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
            best = ref.max(-1).values
            out["served"] = (best - ref.gather(-1, gold[:, None])[:, 0]).tolist()
        else:
            pick = lg.argmax(-1)
            out[prec] = (ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]).tolist()
        del lg
    return out


# ----------------------------------------------------------------- training


def sequence_loss(params: dict, inputs: torch.Tensor, labels: torch.Tensor, m: dict, precision: str,
                  z_loss: float, n: int) -> torch.Tensor:
    """One sequence's share of the batch loss: its cross-entropy summed
    plus the z-loss, over the batch's ``n`` positions (remat'd layer by
    layer)."""
    lg = logits(params, hidden(params, inputs.long(), m, precision, remat=True))
    logz = torch.logsumexp(lg, -1)
    gold = lg.gather(-1, labels.long()[:, None])[:, 0]
    return ((logz - gold).sum() + z_loss * (logz**2).sum()) / n


def adamw_step(params: dict, grads: dict, m: dict, v: dict, count: int, h: dict) -> None:
    """One AdamW step in place, as the configuration's optimizer states it:
    global-norm clipping, bias-corrected moments, decay added to the step."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    scale = torch.clamp(h["max_grad_norm"] / (norm + 1e-9), max=1.0)
    b1c, b2c = 1 - h["b1"] ** count, 1 - h["b2"] ** count
    for k, p in params.items():
        g = grads[k] * scale
        m[k].mul_(h["b1"]).add_((1 - h["b1"]) * g)
        v[k].mul_(h["b2"]).add_((1 - h["b2"]) * g * g)
        step = (m[k] / b1c) / (torch.sqrt(v[k] / b2c) + h["eps"]) + h["weight_decay"] * p
        p.sub_(h["lr"] * step)


def flat(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(leaves: dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, v in leaves.items():
        node = out
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def train(params0: dict[str, torch.Tensor], batches: list[tuple[torch.Tensor, torch.Tensor]], m: dict,
          h: dict, initial: Callable[[str], torch.Tensor], precision: str = "fp32", z_loss: float = 1e-4) -> dict:
    """Follow the program's first steps from the same float32 weights
    (``params0``, a flat dict by path, consumed: updated in place) on the
    same batches.  Returns each step's loss, every leaf's clipped first
    gradient norm and raw first gradient norm, and each leaf's change
    after the last step (``initial(path)`` gives a leaf's starting
    weights back)."""
    exact_matmuls()
    params = {k: p.float().requires_grad_(True) for k, p in params0.items()}
    mom = {k: torch.zeros_like(p) for k, p in params.items()}
    vel = {k: torch.zeros_like(p) for k, p in params.items()}
    out: dict = {"loss": []}
    for i, (inputs, labels) in enumerate(batches, start=1):
        loss = 0.0
        tree = nest(params)
        for b in range(inputs.shape[0]):  # the batch's gradient, a sequence at a time
            part = sequence_loss(tree, inputs[b], labels[b], m, precision, z_loss, inputs.numel())
            part.backward()
            loss += float(part.detach())
        grads = {k: p.grad for k, p in params.items()}
        out["loss"].append(loss)
        with torch.no_grad():
            if i == 1:
                norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
                clip = min(1.0, h["max_grad_norm"] / (norm + 1e-9))
                out["grad_raw"] = {k: float(g.norm()) for k, g in grads.items()}
                out["grad"] = {k: float(g.norm()) * clip for k, g in grads.items()}
            adamw_step(params, grads, mom, vel, i, h)
        for p in params.values():
            p.grad = None
        del grads
    with torch.no_grad():
        out["change"] = {k: float((p - initial(k).float()).norm()) for k, p in params.items()}
    return out
