"""Resilient training driver of the port: the paper's storage system under a
real loop, on the card unless ``--device cpu`` is given — the port of
``repro/launch/train.py`` (every decoder LM, the recurrent ones included; one
device).

Wiring: the token pipeline reads its shards through the ``TwoLevelStore``
(hot shards in the memory tier, all shards durable on the PFS tier) and its
batches go to the device from pinned host memory; the checkpoint manager
writes two-level checkpoints (sync = write mode (c), or async); a heartbeat
watches liveness; a failure injector simulates host loss; on failure the
driver restores the last committed checkpoint AND the exact pipeline
cursor, then continues — the recovery path is the paper's read mode (f):
memory tier first, PFS fallback.  ``--distributed`` joins the store's root
as one host shard of a ``DistributedStore`` (leases, peer reads, background
reclamation) and runs the training I/O through that shard's local store.

The checkpoints hold the state as the JAX package lays it out
(``nn.module.to_reference_layout``), so either package resumes the other's
run.  The attention trains through its plain path (``attn_impl="xla"``, as
the reference does), and so do the recurrent blocks (their plain scans):
the kernels are forward only.  ``cfg.remat`` rematerialises each period
of layers in the backward, as the reference's ``jax.checkpoint`` does.

CLI:  python -m repro_torch.launch.train --arch starcoder2-3b --steps 20 --reduced
      python -m repro_torch.launch.train --arch starcoder2-3b --reduced --steps 4 --device cpu
      python -m repro_torch.launch.train --arch xlstm-125m --reduced --steps 4 --device cpu \
          --store /tmp/s --distributed --host-id 0
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced, make_model
from repro_torch.core.dstore import DistributedStore
from repro_torch.core.store import TwoLevelStore
from repro_torch.data.pipeline import PipelineState, ShardedLoader, SyntheticCorpus
from repro_torch.launch.steps import init_state, make_train_step
from repro_torch.nn.module import from_reference_layout, to_reference_layout
from repro_torch.optim.adamw import AdamW, cosine_warmup
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.failure import FailureInjector, Heartbeat, SimulatedFailure
from repro_torch.runtime.straggler import StepTimeMonitor

DEFAULT_STORE = Path(__file__).resolve().parents[3] / "build" / "train_store"


@dataclasses.dataclass
class TrainResult:
    state: dict
    losses: list
    restarts: int
    steps_run: int
    #: per-phase stall breakdown (seconds): where the step wall time went
    stalls: dict = dataclasses.field(default_factory=dict)
    #: accumulated two-level data-path stats across all loaders of the run
    loader_stats: dict = dataclasses.field(default_factory=dict)


def reference_state(state: dict, cfg) -> dict:
    """The train state with params and moments in the JAX package's layout
    (the stacked periods are copies), as checkpoints hold it."""
    ref = lambda tree: to_reference_layout(tree, cfg)
    opt = state["opt"]
    return dict(state, params=ref(state["params"]), opt=dict(opt, m=ref(opt["m"]), v=ref(opt["v"])))


def port_state(ref: dict) -> dict:
    """The inverse of ``reference_state``: the port's unrolled layers."""
    opt = ref["opt"]
    return dict(ref, params=from_reference_layout(ref["params"]),
                opt=dict(opt, m=from_reference_layout(opt["m"]), v=from_reference_layout(opt["v"])))


def run_training(
    cfg,
    store: TwoLevelStore,
    total_steps: int,
    global_batch: int = 8,
    seq_len: int = 64,
    ckpt_every: int = 5,
    ckpt_mode: str = "async",
    peak_lr: float = 1e-3,
    injector: FailureInjector | None = None,
    max_restarts: int = 8,
    heartbeat_timeout: float = 300.0,
    on_step: Callable[[int, dict], None] | None = None,
    accum_steps: int = 1,
    device="cuda",
    seed: int = 0,
) -> TrainResult:
    """Train with checkpoint/restart through the two-level store, on
    ``device``; a fresh run's params are drawn from ``seed``."""
    device = torch.device(device)
    model = make_model(cfg)
    optimizer = AdamW(learning_rate=cosine_warmup(peak_lr, 10, max(total_steps, 20)))
    train_step = make_train_step(model, cfg, optimizer, accum_steps=accum_steps)

    corpus = SyntheticCorpus(
        store, vocab_size=cfg.vocab, n_shards=8,
        tokens_per_shard=max(global_batch * (seq_len + 1) * 4, 1 << 14),
    )
    corpus.generate()
    ckpt = CheckpointManager(store, tag=cfg.name, mode=ckpt_mode, keep_last=2)
    injector = injector or FailureInjector()
    # One monitor per step phase: total step time, time stalled on the data
    # plane (next(loader)), and time stalled on the checkpoint critical path
    # (cursor sync + save).  In async mode the save stall is the
    # device-to-host snapshot only — serialization and store puts run off
    # the step path.
    monitor = StepTimeMonitor(n_hosts=1)
    data_monitor = StepTimeMonitor(n_hosts=1)
    ckpt_monitor = StepTimeMonitor(n_hosts=1)
    data_stall_s = ckpt_stall_s = restore_s = 0.0
    agg_loader: dict[str, float] = {}

    def fold_loader_stats(loader: ShardedLoader) -> None:
        for k, v in dataclasses.asdict(loader.stats).items():
            agg_loader[k] = agg_loader.get(k, 0) + v

    def fresh_state():
        state, _ = init_state(model, cfg, optimizer, seed, device)
        state["pipeline"] = {"epoch": np.int64(0), "step": np.int64(0)}
        return state

    def resume():
        """A fresh state, overwritten by the last committed checkpoint if any."""
        nonlocal restore_s
        state = fresh_state()
        if ckpt.latest_step() is None:
            return state
        t0 = time.perf_counter()
        _, ref = ckpt.restore(reference_state(state, cfg))
        state = port_state(ref)
        restore_s += time.perf_counter() - t0
        return state

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        return t

    state = resume()
    losses: list = []
    restarts = 0
    steps_run = 0

    try:
        with Heartbeat(timeout_s=heartbeat_timeout) as hb:
            while True:
                pstate = PipelineState(
                    int(state["pipeline"]["epoch"]), int(state["pipeline"]["step"])
                )
                loader = ShardedLoader(
                    corpus, global_batch, seq_len, prefetch_depth=2, state=pstate
                )
                try:
                    while int(state["step"]) < total_steps:
                        step_no = int(state["step"])
                        injector.maybe_fail(step_no)
                        t0 = time.perf_counter()
                        inputs, labels = next(loader)
                        t_data = time.perf_counter() - t0
                        batch = {"inputs": to_device(inputs), "labels": to_device(labels)}
                        state, metrics = train_step(state, batch)
                        hb.beat()
                        loss = float(metrics["loss"])
                        losses.append(loss)
                        steps_run += 1
                        if on_step:
                            on_step(step_no, metrics)
                        t_ckpt = 0.0
                        if int(state["step"]) % ckpt_every == 0:
                            tc = time.perf_counter()
                            cursor = loader.sync()
                            state["pipeline"] = {
                                "epoch": np.int64(cursor.epoch),
                                "step": np.int64(cursor.step),
                            }
                            ckpt.save(int(state["step"]), reference_state(state, cfg))
                            t_ckpt = time.perf_counter() - tc
                        monitor.record({0: time.perf_counter() - t0})
                        data_monitor.record({0: t_data})
                        ckpt_monitor.record({0: t_ckpt})
                        data_stall_s += t_data
                        ckpt_stall_s += t_ckpt
                    break  # completed
                except SimulatedFailure:
                    restarts += 1
                    if restarts > max_restarts:
                        raise
                    # Recovery: last committed two-level checkpoint (memory-
                    # tier hit when the tier survived; PFS read mode (f)
                    # otherwise).
                    state = resume()
                finally:
                    loader.close()
                    fold_loader_stats(loader)

        ckpt.wait_until_durable()
    finally:
        ckpt.close()  # stop the background save lane (joins pending saves)
    stalls = {
        "step_ewma_s": monitor.synchronous_step_time(),
        "data_stall_ewma_s": data_monitor.synchronous_step_time(),
        "ckpt_stall_ewma_s": ckpt_monitor.synchronous_step_time(),
        "data_stall_total_s": data_stall_s,
        "ckpt_stall_total_s": ckpt_stall_s,
        "ckpt_save_critical_s": sum(ckpt.save_critical_s),
        "ckpt_restore_total_s": restore_s,
    }
    return TrainResult(
        state=state,
        losses=losses,
        restarts=restarts,
        steps_run=steps_run,
        stalls=stalls,
        loader_stats=agg_loader,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--store", default=str(DEFAULT_STORE),
                    help="root of the two-level store (a rerun on the same root resumes its checkpoint)")
    ap.add_argument("--ckpt-mode", default="async", choices=["sync", "async", "memory_only"])
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--distributed", action="store_true",
                    help="join --store as a DistributedStore host shard (leases, peer "
                         "reads, background reclamation)")
    ap.add_argument("--host-id", type=int, default=1,
                    help="host id for --distributed (unique per process)")
    ap.add_argument("--lease-ttl", type=float, default=5.0,
                    help="heartbeat/lease ttl seconds for --distributed")
    ap.add_argument("--chaos", nargs="*", default=[], metavar="SITE:KIND[,k=v...]",
                    help="arm chaos faults, e.g. peer.request:delay,prob=0.2,delay_s=0.05 or "
                         "pfs.write_unit:delay,prob=0.2,delay_s=0.01 (see repro_torch.runtime.failure.ChaosInjector)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0, help="seed of a fresh run's params")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    chaos = None
    if args.chaos:
        from repro_torch.runtime.failure import ChaosInjector

        chaos = ChaosInjector.from_specs(args.chaos, seed=args.chaos_seed)
    store_kw = dict(mem_capacity_bytes=256 * 2**20, block_bytes=4 * 2**20)
    dstore = None
    if args.distributed:
        dstore = DistributedStore(args.host_id, args.store, lease_ttl_s=args.lease_ttl, chaos=chaos, **store_kw)
        store = dstore.store  # training I/O runs this shard's local data path
    else:
        store = TwoLevelStore(args.store, chaos=chaos, **store_kw)
    try:
        res = run_training(
            cfg,
            store,
            total_steps=args.steps,
            global_batch=args.batch,
            seq_len=args.seq,
            ckpt_mode=args.ckpt_mode,
            injector=FailureInjector(args.fail_at),
            on_step=lambda s, m: print(f"step {s:4d} loss {float(m['loss']):.4f}"),
            device=args.device,
            seed=args.seed,
        )
    finally:
        (dstore or store).close()
    print(
        f"done: {res.steps_run} steps run ({res.restarts} restarts), "
        f"final loss {res.losses[-1]:.4f}" if res.losses else
        f"done: nothing to run (the store's checkpoint is at step {args.steps} or later)"
    )
    print(
        f"stalls: data {res.stalls['data_stall_total_s']:.2f}s, "
        f"ckpt {res.stalls['ckpt_stall_total_s']:.2f}s "
        f"(save critical path {res.stalls['ckpt_save_critical_s']:.2f}s), "
        f"restore {res.stalls['ckpt_restore_total_s']:.2f}s"
    )
    if dstore is not None:
        st = dstore.stats
        print(
            f"dstore[h{dstore.host_id}]: {st.lease_claims} leases "
            f"({st.takeovers} takeovers, {st.reclaimed_files} reclaimed in "
            f"{st.reclaim_ticks} ticks), {st.peer_retries} peer retries, "
            f"{st.peer_reconnects} reconnects, {st.cold_fallback_reads} cold fallbacks"
        )
    if chaos is not None:
        print(f"chaos: {chaos.fired_count()} faults fired ({len(chaos.history)} events)")


if __name__ == "__main__":
    main()
