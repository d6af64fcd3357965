"""The port's two-level checkpoint manager (``repro_torch.runtime``) on the
CPU: the ports of ``tests/test_checkpoint.py``, its elastic restores onto
meshes of ``gloo`` ranks included (``tests/torch_ranks.py``), and the JAX
package's manager on the same state — the same leaf names in the same
order, the same manifest and chunk bytes, and checkpoints that restore in
the other package, sharded too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import TwoLevelStore as JStore
from repro.launch.steps import init_state as jax_init_state
from repro.optim.adamw import AdamW as JAdamW
from repro.runtime import CheckpointManager as JCheckpointManager
import repro_torch.configs as tcfgs
from repro_torch import tree as T
from repro_torch.core import TwoLevelStore as TStore
from repro_torch.launch.train import port_state, reference_state
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.runtime import CheckpointManager
from torch_ranks import run_ranks


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(size=(16, 8)).astype(np.float32), "b": np.zeros(8, np.float32)},
        "opt": {"m": np.zeros((16, 8), np.float32), "count": np.int32(3)},
        "step": np.int64(7),
    }


def assert_tree_equal(got, want):
    g, w = T.flatten_with_path(got), T.flatten_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def mk_store(pkg_store, root):
    return pkg_store(str(root), mem_capacity_bytes=8 * 2**20, block_bytes=1 * 2**20, n_pfs_servers=2,
                     stripe_bytes=256 * 1024)


@pytest.fixture()
def store(tmp_path):
    with mk_store(TStore, tmp_path / "pfs") as st:
        yield st


class TestSaveRestore:
    def test_roundtrip_exact(self, store):
        cm = CheckpointManager(store, tag="t")
        state = tree()
        cm.save(10, state)
        step, got = cm.restore(state)
        assert step == 10
        assert_tree_equal(got, state)

    def test_latest_wins(self, store):
        cm = CheckpointManager(store, tag="t")
        s1, s2 = tree(1), tree(2)
        cm.save(1, s1)
        cm.save(2, s2)
        step, got = cm.restore(s1)
        assert step == 2
        np.testing.assert_array_equal(got["params"]["w"], s2["params"]["w"])

    def test_restore_specific_step(self, store):
        cm = CheckpointManager(store, tag="t", keep_last=5)
        s1, s2 = tree(1), tree(2)
        cm.save(1, s1)
        cm.save(2, s2)
        step, got = cm.restore(s1, step=1)
        assert step == 1
        np.testing.assert_array_equal(got["params"]["w"], s1["params"]["w"])

    def test_empty_raises(self, store):
        cm = CheckpointManager(store, tag="none")
        with pytest.raises(FileNotFoundError):
            cm.restore(tree())

    def test_shape_mismatch_raises(self, store):
        cm = CheckpointManager(store, tag="t")
        cm.save(1, tree())
        bad = tree()
        bad["params"]["w"] = np.zeros((4, 4), np.float32)
        with pytest.raises(ValueError, match="shape mismatch"):
            cm.restore(bad)

    def test_structure_mismatch_raises(self, store):
        cm = CheckpointManager(store, tag="t")
        cm.save(1, tree())
        bad = tree()
        bad["params"]["extra"] = np.zeros(3, np.float32)
        with pytest.raises(KeyError):
            cm.restore(bad)

    def test_tensors_serializable_and_restored_on_the_template_device(self, store):
        """Port of test_jax_arrays_serializable: tensor leaves (one needing
        grad, one of int64) go in; a tensor template gets tensors back on
        its device, an array template gets arrays."""
        cm = CheckpointManager(store, tag="t")
        state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4).requires_grad_(),
                 "i": torch.arange(5), "n": np.int64(4)}
        cm.save(1, state)
        _, got = cm.restore(state)
        assert isinstance(got["w"], torch.Tensor) and got["w"].device == state["w"].device
        assert not got["w"].requires_grad and got["i"].dtype == torch.int64
        assert isinstance(got["n"], np.ndarray)
        assert_tree_equal(got, state | {"w": state["w"].detach()})


class TestDurabilityAndGC:
    def test_async_mode_durable_after_barrier(self, store):
        cm = CheckpointManager(store, tag="t", mode="async")
        cm.save(5, tree())
        cm.wait_until_durable()
        store.mem.clear()  # restore must come from the PFS tier
        step, _ = cm.restore(tree())
        assert step == 5

    def test_memory_only_mode_is_volatile(self, store):
        cm = CheckpointManager(store, tag="t", mode="memory_only")
        cm.save(5, tree())
        assert cm.steps() == [5]
        store.mem.clear()
        with pytest.raises(Exception):
            cm.restore(tree())

    def test_keep_last_gc(self, store):
        cm = CheckpointManager(store, tag="t", keep_last=2)
        for s in (1, 2, 3, 4):
            cm.save(s, tree())
        assert cm.steps() == [3, 4]

    def test_uncommitted_save_invisible(self, store):
        cm = CheckpointManager(store, tag="t")
        state = tree()
        cm.save(1, state)
        prefix = cm._prefix(2)  # a crash mid-save: data without COMMIT
        store.put(f"{prefix}/leaves", b"partial")
        store.put(f"{prefix}/manifest", b"{}")
        assert cm.steps() == [1]
        step, _ = cm.restore(state)
        assert step == 1


class TestChunkedLayout:
    def test_chunks_and_manifest_files_exist(self, store):
        cm = CheckpointManager(store, tag="t", chunk_bytes=256)  # force many chunks
        cm.save(3, tree())
        names = [n for n in store.list_files() if n.startswith("ckpt/t/step_00000003/")]
        chunk_names = [n for n in names if "/chunk_" in n]
        assert len(chunk_names) >= 2
        assert any(n.endswith("/manifest") for n in names)
        assert any(n.endswith("/COMMIT") for n in names)
        man = json.loads(store.get("ckpt/t/step_00000003/manifest").decode())
        assert len(man["chunks"]) == len(chunk_names)
        for meta in man["leaves"].values():
            assert meta["offset"] + meta["size"] <= man["chunks"][meta["chunk"]]

    def test_gc_removes_chunk_files(self, store):
        cm = CheckpointManager(store, tag="t", keep_last=1, chunk_bytes=256)
        cm.save(1, tree())
        cm.save(2, tree())
        assert [n for n in store.list_files() if n.startswith("ckpt/t/step_00000001/")] == []

    def test_steps_ignores_debris(self, store):
        cm = CheckpointManager(store, tag="t")
        cm.save(4, tree())
        store.put("ckpt/t/step_garbage/COMMIT", b"x")
        store.put("ckpt/t/step_12xy/leaves", b"x")
        store.put("ckpt/t/notes/README", b"x")
        assert cm.steps() == [4]
        assert cm.latest_step() == 4

    def test_restore_uses_ranged_reads_for_partial_chunks(self, store):
        cm = CheckpointManager(store, tag="t", chunk_bytes=1 << 30)  # one big chunk
        state = tree()
        cm.save(1, state)
        store.mem.clear()  # force PFS reads so byte accounting is visible
        sub = {"opt": {"count": np.int32(0)}}
        before = store.pfs.stats.bytes_read
        _, got = cm.restore(sub)
        assert int(got["opt"]["count"]) == int(state["opt"]["count"])
        total = sum(np.asarray(v).nbytes for v in T.leaves(state))
        assert store.pfs.stats.bytes_read - before < total

    def test_async_save_overlaps_and_commits_in_order(self, store):
        cm = CheckpointManager(store, tag="t", mode="async", keep_last=10)
        for s in (1, 2, 3):
            cm.save(s, tree(s))
        cm.wait_until_durable()
        assert cm.steps() == [1, 2, 3]
        step, got = cm.restore(tree())
        assert step == 3
        np.testing.assert_array_equal(got["params"]["w"], tree(3)["params"]["w"])


def test_restore_legacy_monolithic_format(store):
    """Port of the test of the same name: the pre-chunked layout (one
    `leaves` blob + a flat manifest) still restores."""
    state = tree()
    manifest, parts, offset = {}, [], 0
    for path, leaf in T.flatten_with_path(state):
        arr = np.asarray(leaf)
        raw = np.ascontiguousarray(arr).tobytes()
        manifest[T.keystr(path)] = {"shape": list(arr.shape), "dtype": str(arr.dtype), "offset": offset,
                                   "size": len(raw)}
        parts.append(raw)
        offset += len(raw)
    prefix = "ckpt/t/step_00000009"
    store.put(f"{prefix}/leaves", b"".join(parts))
    store.put(f"{prefix}/manifest", json.dumps(manifest).encode())
    store.put(f"{prefix}/COMMIT", str(offset).encode())
    step, got = CheckpointManager(store, tag="t").restore(state)
    assert step == 9
    assert_tree_equal(got, state)


def test_attach_arbiter_throttles_async_staging(store):
    """Async snapshots register as pool ``ckpt_staging``; over its budget the
    next save drains the lane first, and the pool reports what is held."""
    from repro_torch.core.arbiter import MemoryArbiter

    arb = MemoryArbiter(total_bytes=1 << 20)
    cm = CheckpointManager(store, tag="t", mode="async", keep_last=10)
    pool = cm.attach_arbiter(arb)
    assert arb.pools()["ckpt_staging"] is pool and pool.cls == "write_burst"
    pool.budget = 1  # every snapshot is over it
    for s in (1, 2, 3):
        cm.save(s, tree(s))
        pool.value_fn()
        assert pool.used == cm._inflight_bytes <= sum(np.asarray(v).nbytes for v in T.leaves(tree()))
    cm.wait_until_durable()
    assert cm.steps() == [1, 2, 3] and cm._inflight_bytes == 0
    cm.close()


# ------------------------------------------------------ across the packages


def test_leaf_names_and_order_are_jax_keystr():
    nested = {"b": {"z": 1, "a": {"y": 2, "c": 3}}, "a": 4, "params": {"periods": {"slot_0": {"w": 5}}}}
    want = [(jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_flatten_with_path(nested)[0]]
    assert [(T.keystr(p), v) for p, v in T.flatten_with_path(nested)] == want


@pytest.fixture(scope="module")
def train_state():
    """A JAX train state of reduced starcoder2 (scanned layers) with a
    pipeline cursor, and the same state in the port's unrolled layout."""
    cfg = jcfgs.get_reduced("starcoder2_3b")
    opt = JAdamW(learning_rate=1e-3)
    jstate, _ = jax_init_state(jcfgs.make_model(cfg), cfg, opt, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jstate["opt"]["m"] = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                                                jstate["opt"]["m"])
    jstate["opt"]["count"] = jnp.asarray(3, jnp.int32)
    jstate["step"] = jnp.asarray(3, jnp.int32)
    jstate["pipeline"] = {"epoch": np.int64(1), "step": np.int64(12)}
    tstate = port_state(T.tree_map(lambda x: torch.from_numpy(np.array(x)), jstate))
    return jstate, tstate, tcfgs.get_reduced("starcoder2_3b")


@pytest.mark.parametrize("mode,chunk_bytes", [("sync", 16 * 2**20), ("async", 40_000)])
def test_same_state_same_bytes_in_both_packages(tmp_path, train_state, mode, chunk_bytes):
    """The JAX state through the JAX manager and the port's state through the
    port's (in the reference layout): byte-identical manifests, chunks and
    COMMIT markers — with one chunk, and with many."""
    jstate, tstate, tcfg = train_state
    prefix = "ckpt/t/step_00000003/"
    with mk_store(JStore, tmp_path / "j") as js, mk_store(TStore, tmp_path / "t") as ts:
        jcm = JCheckpointManager(js, tag="t", mode=mode, chunk_bytes=chunk_bytes)
        tcm = CheckpointManager(ts, tag="t", mode=mode, chunk_bytes=chunk_bytes)
        jcm.save(3, jstate)
        tcm.save(3, reference_state(tstate, tcfg))
        jcm.close()
        tcm.close()
        names = sorted(n for n in js.list_files() if n.startswith(prefix))
        assert names == sorted(n for n in ts.list_files() if n.startswith(prefix))
        n_chunks = sum("/chunk_" in n for n in names)
        assert (n_chunks == 1) if chunk_bytes > 2**20 else (n_chunks > 2)
        for n in names:
            assert js.get(n) == ts.get(n), n
        manifest = json.loads(ts.get(prefix + "manifest"))
        assert list(manifest["leaves"]) == [jax.tree_util.keystr(p) for p, _ in
                                            jax.tree_util.tree_flatten_with_path(jstate)[0]]
        assert {m["dtype"] for m in manifest["leaves"].values()} == {"float32", "int32", "int64"}


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_checkpoint_restores_in_the_other_package(tmp_path, train_state, writer):
    """A state saved by one package's manager restores bit-identical through
    the other's, from the PFS tier of a reopened store (read mode f)."""
    jstate, tstate, tcfg = train_state
    ref = reference_state(tstate, tcfg)
    if writer == "jax_package":
        with mk_store(JStore, tmp_path / "s") as st:
            JCheckpointManager(st, tag="t").save(3, jstate)
        with mk_store(TStore, tmp_path / "s") as st:
            blank = {k: T.tree_map(torch.zeros_like, v) for k, v in tstate.items() if k != "pipeline"}
            step, got = CheckpointManager(st, tag="t").restore(
                reference_state(dict(blank, pipeline=tstate["pipeline"]), tcfg))
            assert st.stats.mem_misses > 0
        assert step == 3
        assert_tree_equal(port_state(got), tstate)
    else:
        with mk_store(TStore, tmp_path / "s") as st:
            CheckpointManager(st, tag="t").save(3, ref)
        with mk_store(JStore, tmp_path / "s") as st:
            step, got = JCheckpointManager(st, tag="t").restore(jstate)
        assert step == 3
        assert_tree_equal(got, jax.tree_util.tree_map(np.asarray, jstate))


@pytest.fixture()
def one_rank(tmp_path):
    """A one-rank ``gloo`` process group in this process and a 1 x 1
    ``(data, model)`` mesh over it, torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import _mk

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        yield _mk((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


class TestElasticRestore:
    def test_restore_sharded_places_on_device(self, store, one_rank):
        from torch.distributed.tensor import DTensor

        from repro_torch.nn.module import NamedSharding

        cm = CheckpointManager(store, tag="t")
        state = tree()
        cm.save(1, state)
        shardings = T.tree_map(lambda leaf: NamedSharding(one_rank, ("model",) if np.ndim(leaf) else ()), state)
        step, placed = cm.restore_sharded(state, shardings)
        assert step == 1
        leaf = placed["params"]["w"]
        assert isinstance(leaf, DTensor) and leaf.device_mesh is one_rank
        np.testing.assert_array_equal(leaf.full_tensor().numpy(), state["params"]["w"])
        assert_tree_equal(T.tree_map(lambda x: x.full_tensor(), placed), state)


ELASTIC_RANKS = """
import shutil
import numpy as np
from repro_torch import tree as T
from repro_torch.configs import get_reduced, make_model
from repro_torch.core import TwoLevelStore
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import _mk
from repro_torch.nn.module import NamedSharding
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import CheckpointManager

KW = dict(mem_capacity_bytes=8 * 2**20, block_bytes=2**20, n_pfs_servers=2, stripe_bytes=256 * 1024)


def opened(name):
    # Each rank reads its own copy of the PFS root, as ranks on other hosts
    # read a shared file system.
    root = TMP / f"{name}_of{WORLD}_rank{RANK}"
    shutil.copytree(TMP / name, root)
    return TwoLevelStore(str(root), **KW)


mesh = _mk((1, WORLD), ("data", "model"), "cpu")
cfg = get_reduced("qwen3_8b")
template, axes = S.init_state(make_model(cfg), cfg, AdamW(), device="meta")
sh = S.state_shardings(template, axes, mesh)
want = torch.load(TMP / "state.pt")
with opened("one") as st:
    step, got = CheckpointManager(st, tag="t").restore_sharded(template, sh)
out = {"step": step,
       "equal": all(torch.equal(a.full_tensor(), b) for a, b in zip(T.leaves(got), T.leaves(want))),
       "w_gate": got["params"]["prefix_0"]["ffn"]["w_gate"].to_local().numpy().tobytes().hex(),
       "sharded_leaves": sum(any(p.is_shard() for p in x.placements) for x in T.leaves(got)),
       # Each local tensor owns just its block: no rank copied a whole leaf.
       "block_only": all(x.to_local().untyped_storage().nbytes() == x.to_local().numel() * x.element_size()
                         for x in T.leaves(got))}
if WORLD == 4:  # save back from the 4-rank DTensor state: rank 0 writes, all wait
    with TwoLevelStore(str(TMP / "from4"), **KW) as st:
        CheckpointManager(st, tag="t").save(step, got)
# A checkpoint the JAX package wrote, in its layout: dim 0 over `model` where it divides.
jwant = torch.load(TMP / "jax_state.pt")
jsh = T.tree_map(lambda x: NamedSharding(mesh, ("model",) if x.ndim and x.shape[0] % WORLD == 0 else ()), jwant)
with opened("jax") as st:
    jstep, jgot = CheckpointManager(st, tag="t").restore_sharded(jwant, jsh)
out["jax_step"] = jstep
out["jax_equal"] = all(torch.equal(a.full_tensor(), b) and a.dtype == b.dtype
                       for a, b in zip(T.leaves(jgot), T.leaves(jwant)))
out["jax_sharded_leaves"] = sum(any(p.is_shard() for p in x.placements) for x in T.leaves(jgot))
emit(out)
"""


def test_elastic_restore_across_mesh_sizes(tmp_path, train_state):
    """Save on 1 process; ``restore_sharded`` onto 2- and 4-rank meshes:
    every leaf equal, ``ffn/w_gate`` in n distinct local shards, each
    rank's local tensors holding only their own blocks.  The
    4-rank DTensor state saved again (rank 0 writes) is the same bytes as
    the 1-process save and restores on 1 process equal.  A checkpoint the
    JAX package wrote restores sharded on both meshes."""
    from repro_torch.launch.steps import init_state

    cfg = tcfgs.get_reduced("qwen3_8b")
    state, _ = init_state(tcfgs.make_model(cfg), cfg, TAdamW(), seed=0, device="cpu")
    state["opt"]["m"] = T.tree_map(lambda x: torch.randn_like(x), state["opt"]["m"])
    torch.save(state, tmp_path / "state.pt")
    with mk_store(TStore, tmp_path / "one") as st:
        CheckpointManager(st, tag="t").save(5, state)
    jstate, tstate, tcfg = train_state
    with mk_store(JStore, tmp_path / "jax") as st:
        JCheckpointManager(st, tag="t").save(3, jstate)
    jref = reference_state(tstate, tcfg)
    torch.save(T.tree_map(lambda x: torch.as_tensor(np.asarray(x)), jref), tmp_path / "jax_state.pt")

    for world in (2, 4):
        outs = run_ranks(tmp_path, world, ELASTIC_RANKS)
        assert all(o["step"] == 5 and o["equal"] and o["jax_step"] == 3 and o["jax_equal"] for o in outs), outs
        assert len({o["w_gate"] for o in outs}) == world
        assert outs[0]["sharded_leaves"] > 0 and outs[0]["jax_sharded_leaves"] > 0
        assert all(o["block_only"] for o in outs), outs

    prefix = "ckpt/t/step_00000005/"
    with mk_store(TStore, tmp_path / "one") as one, mk_store(TStore, tmp_path / "from4") as four:
        names = sorted(n for n in one.list_files() if n.startswith(prefix))
        assert names == sorted(n for n in four.list_files() if n.startswith(prefix))
        for n in names:
            assert one.get(n) == four.get(n), n
        step, back = CheckpointManager(four, tag="t").restore(T.tree_map(torch.zeros_like, state))
    assert step == 5
    assert_tree_equal(back, state)


def test_bfloat16_leaves_round_trip_and_cross_packages(tmp_path):
    """bf16 leaves, which numpy lacks, are stored as their bit patterns
    under the dtype name ``bfloat16``: they restore to the same bits in the
    port and as ml_dtypes' bfloat16 in the JAX package, and back."""
    t = torch.randn(6, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    state = {"w": t, "b": torch.ones(4)}
    with mk_store(TStore, tmp_path / "s") as st:
        CheckpointManager(st, tag="t").save(1, state)
        _, got = CheckpointManager(st, tag="t").restore(T.tree_map(torch.zeros_like, state))
        manifest = json.loads(st.get("ckpt/t/step_00000001/manifest"))
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    assert manifest["leaves"]["['w']"]["dtype"] == "bfloat16"
    with mk_store(JStore, tmp_path / "s") as st:
        _, jgot = JCheckpointManager(st, tag="t").restore({"w": jnp.zeros((6, 4), jnp.bfloat16),
                                                          "b": np.zeros(4, np.float32)})
        assert str(jgot["w"].dtype) == "bfloat16"
        np.testing.assert_array_equal(jgot["w"].view(np.int16), t.view(torch.int16).numpy())
        JCheckpointManager(st, tag="t").save(2, {"w": jgot["w"], "b": jgot["b"]})
    with mk_store(TStore, tmp_path / "s") as st:
        step, back = CheckpointManager(st, tag="t").restore(T.tree_map(torch.zeros_like, state))
    assert step == 2 and torch.equal(back["w"], t)
