"""Training steps of the program, fed by its own data path.

The program under test is ``repro_torch.launch.steps.make_train_step`` with
``repro_torch.optim.adamw.AdamW`` and the configuration's ``remat``; its
batches come from ``repro_torch.data.pipeline.ShardedLoader`` over a
``SyntheticCorpus`` in a ``repro_torch.core.store.TwoLevelStore`` whose
memory tier holds the corpus and whose file tier (a few MB) lies under
``TMPDIR``.  No checkpoint is saved.

Set-up builds one train state from the seed and drives it through its
first ``check_steps`` steps by the window's own call and feed; the numbers
the reference checks are read from that same state as it goes: each
step's loss, every leaf's first gradient (from the moments after step 1)
and every leaf's change after the last checked step.  The window then
continues the same state.
"""

from __future__ import annotations

import math
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from bench import yardstick
from bench.harness import Record, Weights, log, model_config
from bench.reference import dense_lm
from bench.trace import Tracer


def corpus_windows(seed: int, vocab: int, n_shards: int, tokens_per_shard: int, span: int) -> np.ndarray:
    """The corpus made from the seed, as the mix defines it (shard ``i``
    uniform over the vocabulary from ``seed + i``), cut into the windows
    of ``span`` tokens that rows may be."""
    toks = np.concatenate([np.random.default_rng(seed + i).integers(0, vocab, size=tokens_per_shard, dtype=np.int32)
                           for i in range(n_shards)])
    n = len(toks) // span
    return toks[: n * span].reshape(n, span)


def rows_off_corpus(batches: list[tuple[np.ndarray, np.ndarray]], windows: np.ndarray) -> int:
    """Rows served that are not a window of the corpus, or that repeat one."""
    index = {w.tobytes(): i for i, w in enumerate(windows)}
    seen, bad = set(), 0
    for inputs, labels in batches:
        for x, y in zip(inputs, labels):
            row = np.concatenate([x, y[-1:]]).astype(np.int32)
            i = index.get(row.tobytes())
            if i is None or i in seen or not np.array_equal(row[1:], y):
                bad += 1
            seen.add(i)
    return bad


def leaf_gap(prog: dict[str, float], ref: dict[str, float], keep=None) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    keys = [k for k in ref if keep is None or keep(k)]
    med = statistics.median(ref[k] for k in keys)
    worst = max(keys, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], med))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med), worst


def run(ctx) -> Record:
    from repro_torch.configs import make_model
    from repro_torch.core.store import TwoLevelStore
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW

    mix, seed, device = ctx.traffic, ctx.seed, torch.device(ctx.device)
    cfg = model_config(ctx.config)
    m = ctx.config["model"]
    model = make_model(cfg)
    opt_h = dict(mix["adamw"])
    optimizer = AdamW(learning_rate=opt_h["lr"], b1=opt_h["b1"], b2=opt_h["b2"], eps=opt_h["eps"],
                      weight_decay=opt_h["weight_decay"], max_grad_norm=opt_h["max_grad_norm"])
    train_step = make_train_step(model, cfg, optimizer)
    log(ctx.t_start, "program imported")
    weights = Weights(model, cfg, seed, device, served=False)
    params = weights.tree()
    state = {"params": params, "opt": optimizer.init(params), "step": torch.zeros((), dtype=torch.int32, device=device)}
    del params
    log(ctx.t_start, "weights drawn")

    B, S = mix["batch"], mix["seq"]
    root = tempfile.mkdtemp(prefix="bench_store_")
    store = TwoLevelStore(root + "/pfs", mem_capacity_bytes=mix["store_mem_mb"] << 20, block_bytes=1 << 20)
    corpus_seed = seed % (1 << 31)
    corpus = SyntheticCorpus(store, vocab_size=cfg.vocab, n_shards=mix["shards"],
                             tokens_per_shard=mix["tokens_per_shard"], seed=corpus_seed)
    corpus.generate()
    loader = ShardedLoader(corpus, B, S, prefetch_depth=2)

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t

    box = {"state": state}
    del state

    def one_step() -> tuple[float, float, tuple[np.ndarray, np.ndarray]]:
        t0 = time.perf_counter()
        with record_function("bench.next_batch"):
            inputs, labels = next(loader)
        t_data = time.perf_counter() - t0
        with record_function("bench.train_step"):
            box["state"], metrics = train_step(box["state"], {"inputs": to_device(inputs), "labels": to_device(labels)})
            loss = float(metrics["loss"])
        return loss, t_data, (inputs, labels)

    try:
        # Set-up: the checked steps, read from the state as it goes.
        losses, batches = [], []
        grad_norms = change = None
        for i in range(1, mix["check_steps"] + 1):
            loss, _, batch = one_step()
            losses.append(loss)
            batches.append(batch)
            if i == 1:
                grad_norms = {k: float(v.norm()) / (1 - opt_h["b1"]) for k, v in dense_lm.flat(box["state"]["opt"]["m"]).items()}
        with torch.no_grad():
            now = dense_lm.flat(box["state"]["params"])
            change = {}
            for chunk in weights.chunks:
                for path, p0 in weights.chunk(chunk).items():
                    k = "/".join(path)
                    change[k] = float((now[k] - p0).norm())
            del now
        log(ctx.t_start, f"checked steps done, losses {losses}")
        for _ in range(mix["warm_steps"]):
            one_step()

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_open = time.perf_counter()
        setup_s = t_open - ctx.t_start
        steps, failed, waits = 0, 0, []
        tracer, traced_steps = None, 0
        now_t = t_open
        while now_t - t_open < ctx.seconds:
            if ctx.trace and tracer is None and steps == mix["trace_after_steps"]:
                tracer = Tracer().__enter__()
            loss, t_data, _ = one_step()
            now_t = time.perf_counter()
            steps += 1
            failed += not math.isfinite(loss)
            waits.append(t_data)
            if tracer is not None and tracer.summary is None and traced_steps < mix["trace_steps"]:
                traced_steps += 1
                if traced_steps == mix["trace_steps"]:
                    tracer.__exit__(None, None, None)
        if tracer is not None and tracer.summary is None:
            tracer.__exit__(None, None, None)
        window_s = now_t - t_open
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        loader.close()
        store.close()
        shutil.rmtree(root, ignore_errors=True)
    del box
    if device.type == "cuda":
        torch.cuda.empty_cache()

    log(ctx.t_start, f"window closed: {window_s:.2f} s, {steps} steps, peak {memory_peak} B")
    tokens = steps * B * S
    e2e = {"train_tok_s": tokens / window_s}
    counters = {"steps": steps, "data_wait_s": sum(waits),
                "model_flops": steps * yardstick.train_flops(m, B, S)}
    traced = {"steps": traced_steps}

    # Correctness: the reference follows the checked steps from the same weights.
    p0 = {"/".join(path): leaf for c in weights.chunks for path, leaf in weights.chunk(c).items()}
    drawn: dict = {}

    def initial(k: str) -> torch.Tensor:  # a leaf's starting weights, its chunk drawn again once
        chunk = k.split("/")[0]
        if chunk not in drawn:
            drawn.clear()
            drawn[chunk] = weights.chunk(chunk)
        return drawn[chunk][tuple(k.split("/"))]

    paths = list(p0)
    on_device = [(to_device(x), to_device(y)) for x, y in batches]
    ref = dense_lm.train(p0, on_device, m, opt_h, initial=initial)
    del p0
    log(ctx.t_start, "reference done")
    med_raw = statistics.median(ref["grad_raw"].values())
    moved = lambda k: ref["grad_raw"][k] >= 1e-3 * med_raw

    def gaps(loss: list[float], grad: dict[str, float], change: dict[str, float]) -> dict[str, float]:
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(loss, ref["loss"])),
                "grad_gap": leaf_gap(grad, ref["grad"])[0],
                "change_gap": leaf_gap(change, ref["change"], moved)[0]}

    windows = corpus_windows(corpus_seed, cfg.vocab, mix["shards"], mix["tokens_per_shard"], S + 1)
    checks = [(k, v, ctx.limits[k]["limit"]) for k, v in gaps(losses, grad_norms, change).items()]
    checks.append(("rows_off_corpus", float(rows_off_corpus(batches, windows)), 0.0))

    # Where asked for, the reference in the program's place from the same
    # starting weights: in float8 (the control), or with half of each batch
    # left out and the mean taken over the rest.
    readings = {}
    for name in ctx.readings:
        feed = {"control": (on_device, "fp8"),
                "half_batch": ([(x[: len(x) // 2], y[: len(y) // 2]) for x, y in on_device], "fp32")}[name]
        other = dense_lm.train({k: initial(k).clone() for k in paths}, feed[0], m, opt_h, initial, feed[1])
        readings[name] = gaps(other["loss"], other["grad"], other["change"])
    return Record(setup_s=setup_s, window_s=window_s, e2e=e2e, attempted=steps, failed=failed,
                  memory_peak_bytes=memory_peak, checks=checks, counters=counters, traced=traced,
                  trace=tracer.summary if tracer is not None else None, cfg=m, readings=readings)
