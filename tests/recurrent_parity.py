#!/usr/bin/env python3
"""Where the port's recurrent training parts from the JAX package's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/recurrent_parity.py [--arch recurrentgemma_9b]

1. ``--arch`` reduced, fp32, from the JAX init (PRNGKey(0)), 8 AdamW steps
   (lr 1e-3) on batches of 4 x 16 tokens from ``np.random.default_rng(6)``
   in both packages: each leaf's step-1 gradient gap against the leaf's
   largest gradient, the losses, the final parameter gap of each leaf, and
   for the largest gap the element's gradient at every step in both
   packages and the port's gradient at the JAX package's own state.
2. One xlstm-125m sLSTM block at full width (d_model 768, 4 heads of 192,
   the JAX init), batch 1, inputs and output weights from
   ``np.random.default_rng(1)``: the largest gradient at the first input
   position after S = 32, 64, 128, 256 steps, in both packages.

Needs both packages (JAX and PyTorch on the CPU); it prints, and asserts
nothing (``tests/test_torch_recurrent_train.py`` holds the bars).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.nn import recurrent as JR  # noqa: E402
from repro.nn.module import init_with_axes as jax_init  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.train import port_state, reference_state  # noqa: E402
from repro_torch.nn import recurrent as TR  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


def port_grads(model, cfg, params, batch):
    """The port's gradients at ``params`` (its own layout), in the reference's layout."""
    tp = T.tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    tsteps.make_loss_fn(model, cfg)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})[0].backward()
    g = T.tree_map(lambda p: p.grad, tp)
    return reference_state({"params": g, "opt": {"m": g, "v": g}}, cfg)["params"]


def trajectory(arch: str) -> None:
    jc = dataclasses.replace(jcfgs.get_reduced(arch), dtype="float32")
    tc = dataclasses.replace(tcfgs.get_reduced(arch), dtype="float32")
    jm, tm = jcfgs.make_model(jc), tcfgs.make_model(tc)
    jp = jax.jit(lambda key: jax_init(jm.init, key, dtype=jnp.float32)[0])(jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jadamw.AdamW(learning_rate=1e-3).init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = port_state(T.tree_map(lambda x: torch.from_numpy(np.array(x)), jstate))
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(8):
        toks = rng.integers(0, jc.vocab, (4, 17)).astype(np.int32)
        batches.append({"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    jgrad = jax.jit(jax.grad(lambda p, b: jsteps.make_loss_fn(jm, jc)(p, b)[0]))

    print(f"== {arch} (reduced, fp32): step-1 gradient gap / the leaf's largest gradient")
    tg = port_grads(tm, tc, tstate["params"], batches[0])
    jg = jgrad(jp, jax.tree_util.tree_map(jnp.asarray, batches[0]))
    for (path, a), b in zip(T.flatten_with_path(tg), jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        gap, top = float(np.abs(a.numpy() - b).max()), float(np.abs(b).max())
        print(f"  {T.keystr(path):58s} {gap:.3e} / {top:.3e} = {gap / max(top, 1e-30):.3e}")

    jstep = jax.jit(jsteps.make_train_step(jm, jc, jadamw.AdamW(learning_rate=1e-3)))
    tstep = tsteps.make_train_step(tm, tc, tadamw.AdamW(learning_rate=1e-3))
    states = []
    for b in batches:
        states.append((jstate, tstate))
        jstate, jmet = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b))
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        print(f"  loss port {float(tmet['loss']):.9g} jax {float(jmet['loss']):.9g} "
              f"relative {abs(float(tmet['loss']) / float(jmet['loss']) - 1):.3e}")
        if len(states) == 1:  # after one step: the largest parameter gap and its step-1 gradients
            leaves = zip(T.flatten_with_path(reference_state(tstate, tc)["params"]), T.leaves(tg),
                         jax.tree_util.tree_leaves(jstate["params"]), jax.tree_util.tree_leaves(jg))
            best = (0.0, "", 0.0, 0.0)
            for (path, a), gt, b_, gj_ in leaves:
                d = np.abs(a.numpy() - np.asarray(b_))
                i = np.unravel_index(d.argmax(), d.shape)
                if d[i] > best[0]:
                    best = (float(d[i]), f"{T.keystr(path)}{[int(x) for x in i]}", float(gt.numpy()[i]),
                            float(np.asarray(gj_)[i]))
            gap, name, g_t, g_j = best
            print(f"  after step 1 the largest parameter gap is {gap:.3e} at {name}; its step-1 gradient: "
                  f"port {g_t:+.4e} jax {g_j:+.4e}")
    print("  final parameter gap per leaf:")
    worst = (0.0, None, None)
    for (path, a), b in zip(T.flatten_with_path(reference_state(tstate, tc)["params"]),
                            jax.tree_util.tree_leaves(jstate["params"])):
        d = np.abs(a.numpy() - np.asarray(b))
        idx = np.unravel_index(d.argmax(), d.shape)
        print(f"  {T.keystr(path):58s} {d.max():.3e} at {tuple(int(i) for i in idx)}")
        if d.max() > worst[0]:
            worst = (float(d.max()), path, idx)
    gap, path, idx = worst
    print(f"  largest: {T.keystr(path)}{list(int(i) for i in idx)} {gap:.3e}; its gradient a step "
          "(port at its state, JAX at its state, port at JAX's state):")

    def pick(tree_):
        for key in path:
            tree_ = tree_[key]
        return np.asarray(tree_)[idx]

    for i, ((js, ts), b) in enumerate(zip(states, batches)):
        jb = jax.tree_util.tree_map(jnp.asarray, b)
        g_j = pick(T.tree_map(np.asarray, jgrad(js["params"], jb)))
        g_t = pick(T.tree_map(lambda t: t.numpy(), port_grads(tm, tc, ts["params"], b)))
        at_j = port_state({"params": js["params"], "opt": {"m": js["params"], "v": js["params"]}})["params"]
        g_tj = pick(T.tree_map(lambda t: t.numpy(), port_grads(
            tm, tc, T.tree_map(lambda x: torch.from_numpy(np.array(x)), at_j), b)))
        print(f"    step {i + 1}: {g_t:+.4e} {g_j:+.4e} {g_tj:+.4e}")


def slstm_growth() -> None:
    print("== xlstm-125m sLSTM block at full width: max |dL/dx| at the first position")
    jc = dataclasses.replace(jcfgs.get_config("xlstm_125m"), dtype="float32")
    tc = dataclasses.replace(tcfgs.get_config("xlstm_125m"), dtype="float32")
    jp = jax_init(lambda s: JR.slstm_init(s, "mixer", jc), jax.random.PRNGKey(0), dtype=jnp.float32)[0]["mixer"]
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jp.items()}
    for s in (32, 64, 128, 256):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(1, s, jc.d_model)).astype(np.float32)
        w = rng.normal(size=(1, s, jc.d_model)).astype(np.float32)
        gj = np.asarray(jax.grad(lambda x_: jnp.sum(JR.slstm_block_apply(jp, x_, jc)[0] * w))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_()
        (TR.slstm_block_apply(tp, xt, tc)[0] * torch.from_numpy(w)).sum().backward()
        print(f"  S = {s:3d}: jax {np.abs(gj[0, 0]).max():.3e} port {xt.grad[0, 0].abs().max().item():.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="recurrentgemma_9b", choices=["recurrentgemma_9b", "xlstm_125m"])
    args = ap.parse_args()
    trajectory(args.arch)
    slstm_growth()
    return 0


if __name__ == "__main__":
    sys.exit(main())
