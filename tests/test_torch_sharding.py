"""The port's multi-device layer against the JAX package on the CPU:
logical-axis resolution and its rule tables, the spec trees of the full-size
configs on both production meshes, the cache and batch shardings, a train
step on 8 ``gloo`` ranks, the MoE's group-local dispatch, and the dry-run's
accounting.

Multi-rank cases run as subprocesses (``tests/torch_ranks.py``); the JAX
reference on an 8-device mesh runs in a subprocess of its own with 8 forced
host devices, as ``tests/test_sharding.py`` runs it.  Tolerances: equality
for specs, bytes and FLOP counts (the dry-run's against ``hlo_analysis``
within 2%), 1e-5 relative to a leaf's largest magnitude for values.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import repro.configs as jcfgs
import repro.nn.module as jmod
import repro_torch.configs as tcfgs
import repro_torch.nn.module as tmod
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import analyze
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import tree as T
from repro_torch.launch import dryrun, steps as tsteps
from repro_torch.launch.mesh import dp_size
from repro_torch.nn.module import MeshShape, mesh_shape
from repro_torch.optim.adamw import AdamW as TAdamW
from torch_ranks import ROOT, run_ranks

torch.backends.cuda.matmul.allow_tf32 = False


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# Rule tables and resolution
# ---------------------------------------------------------------------------

RESOLVE_CASES = {
    "divisible_dims_shard": (dict(data=4, model=16), ("embed", "ff"), (1024, 4096), (None, "model")),
    "indivisible_dims_replicate": (dict(data=4, model=16), ("embed", "heads", "head_dim"), (896, 14, 64),
                                   (None, None, None)),
    "vocab_shards_when_divisible": (dict(data=2, model=16), ("vocab", "embed"), (129_280, 7168), ("model", None)),
    "vocab_replicates_when_not": (dict(data=2, model=16), ("vocab", "embed"), (51_866, 1280), (None, None)),
    "mesh_axis_used_once": (dict(model=8), ("vocab", "ff"), (1024, 4096), ("model", None)),
    "missing_mesh_axis_replicates": (dict(data=4), ("embed", "ff"), (64, 4096), (None, None)),
    "batch_axes_tuple": (dict(pod=2, data=16, model=16), ("batch", "seq"), (256, 4096), (("pod", "data"), None)),
}


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_shard_if_divisible(case, package):
    """The reference's ``TestShardIfDivisible`` cases, through both packages'
    ``resolve_axes``: the same entries (the reference's as a PartitionSpec)."""
    shape, logical, dims, want = RESOLVE_CASES[case]
    resolve = jmod.resolve_axes if package == "jax" else tmod.resolve_axes
    got = resolve(logical, dims, MeshShape(**shape))
    assert tuple(got) == want
    if package == "torch":
        assert got == want and type(got) is tuple


def test_rule_tables_equal_the_reference():
    assert tmod.DEFAULT_RULES == jmod.DEFAULT_RULES
    assert tmod.FSDP_RULES == jmod.FSDP_RULES
    assert tmod.RULE_SETS == jmod.RULE_SETS


def test_placements_and_shard_shapes():
    mesh = MeshShape(pod=2, data=16, model=16)
    sh = tmod.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert sh.placements() == (Shard(0), Shard(0), Shard(2))
    assert tmod.NamedSharding(mesh, (None, "data")).placements() == (Replicate(), Shard(1), Replicate())
    assert sh.shard_shape((256, 7, 32)) == (8, 7, 2)
    assert tmod.NamedSharding(mesh, ()).shard_shape((3, 5)) == (3, 5)
    assert mesh_shape(MeshShape(data=4, model=2)) == {"data": 4, "model": 2} and dp_size(mesh) == 32


def test_constrain_off_mesh_and_on_plain_tensors():
    x = torch.ones(2, 3)
    assert tmod.constrain(x, "batch", "act_ff") is x  # off-mesh
    assert tmod.current_dp_groups() == 1
    with tmod.axis_rules(MeshShape(pod=2, data=4, model=2)):
        assert tmod.current_dp_groups() == 8
        assert tmod.constrain(x, "batch", "act_ff") is x  # a plain tensor stays as it is
        with pytest.raises(ValueError, match="rank-2"):
            tmod.constrain(x, "batch")
    assert tmod.current_dp_groups() == 1


# ---------------------------------------------------------------------------
# Spec trees at full size
# ---------------------------------------------------------------------------

FULL_ARCHS = ["qwen3_8b", "deepseek_v3_671b", "grok_1_314b", "internvl2_1b", "whisper_large_v3"]
MESHES = {"16x16": dict(data=16, model=16), "2x16x16": dict(pod=2, data=16, model=16)}
_INITS: dict = {}


def abstract_inits(arch):
    """(port meta params, port axes, reference shapes, reference axes)."""
    if arch not in _INITS:
        tcfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
        tstate, taxes = tsteps.init_state(tcfgs.make_model(tcfg), tcfg, TAdamW(), device="meta")
        jstate, jaxes = jsteps.init_state(jcfgs.make_model(jcfg), jcfg, JAdamW(), jax.random.PRNGKey(0),
                                          abstract=True)
        _INITS[arch] = (tstate["params"], taxes, jstate["params"], jaxes)
    return _INITS[arch]


def port_layout(ref_specs, ref_shapes):
    def conv(tree, shapes):
        out = {}
        for k, v in tree.items():
            if k == "periods":
                n = jax.tree_util.tree_leaves(shapes[k])[0].shape[0]
                out[k] = jax.tree_util.tree_map(lambda s: _stacked(s, n), v, is_leaf=lambda x: isinstance(x, P))
            elif isinstance(v, dict):
                out[k] = conv(v, shapes[k])
            else:
                out[k] = v
        return out

    return tmod.from_reference_layout(conv(ref_specs, ref_shapes), lambda s: tuple(s))


def _stacked(spec, n):
    assert tuple(spec)[0] is None, spec  # "layers" never shards
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = P(*tuple(spec)[1:])
    return arr


def ref_device_bytes(specs, shapes, mesh: dict) -> int:
    """Per-device bytes of a reference tree from its PartitionSpecs."""
    out = 0
    for spec, sds in zip(jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P)),
                         jax.tree_util.tree_leaves(shapes)):
        dims = list(sds.shape)
        for i, entry in enumerate(tuple(spec)):
            for axis in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                dims[i] //= mesh[axis]
        out += int(np.prod(dims)) * np.dtype(sds.dtype).itemsize
    return out


@pytest.mark.parametrize("rules", ["default", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_param_spec_trees_match_reference_at_full_size(arch, mesh, rules):
    """The port's meta init resolved on a production mesh equals
    ``jax.eval_shape`` of the reference's init resolved there, leaf by leaf
    in the port's layout, and so do the per-device param bytes."""
    tparams, taxes, jshapes, jaxes = abstract_inits(arch)
    shape = MESHES[mesh]
    got = tmod.logical_to_pspec(taxes, tparams, MeshShape(**shape), tmod.RULE_SETS[rules])
    jspecs = jmod.logical_to_pspec(jaxes, jshapes, MeshShape(**shape), jmod.RULE_SETS[rules])
    want = port_layout(jspecs, jshapes)
    assert T.flatten_with_path(got) == T.flatten_with_path(want)
    assert any(s != (None,) * len(s) for s in T.leaves(got))  # something shards
    assert all(p.device.type == "meta" for p in T.leaves(tparams))
    sh = T.tree_map(lambda s: tmod.NamedSharding(MeshShape(**shape), s), got)
    assert dryrun.device_bytes(tparams, sh) == ref_device_bytes(jspecs, jshapes, shape)


DECODE_ARCHS = ["qwen3_8b", "deepseek_v3_671b", "recurrentgemma_9b", "xlstm_125m", "whisper_large_v3"]


def ref_cache_specs_in_port_layout(jcache_sh, jcfg):
    """The reference's cache shardings (stacked under ``periods``, ``self``
    or ``cross`` along a leading layers dim, or per layer) as spec tuples in
    the port's per-layer layout."""
    from repro.models.lm import stack_plan

    specs = jax.tree_util.tree_map(lambda s: s.spec, jcache_sh)
    if jcfg.encdec is not None:
        side = lambda tree: {f"prefix_{i}": {k: tuple(v)[1:] for k, v in tree.items()} for i in range(jcfg.n_layers)}
        return {"self": side(specs["self"]), "cross": side(specs["cross"])}
    n_periods = stack_plan(jcfg)[2]
    tree = {k: jax.tree_util.tree_map(lambda s: _stacked(s, n_periods), v, is_leaf=lambda x: isinstance(x, P))
            if k == "periods" else v for k, v in specs.items()}
    return tmod.from_reference_layout(tree, lambda s: tuple(s))


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_cache_and_batch_shardings_match_reference(arch, seq_shard):
    """One decode cell (decode_32k) of a dense, an MLA, two recurrent and the
    encoder-decoder config on the single-pod mesh: the port's per-layer
    cache shardings equal the reference's stacked ones leaf by leaf, without
    the stacked offset; the token and train batch shard the same way."""
    tcfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    cell, jcell = tcfgs.SHAPES["decode_32k"], jcfgs.SHAPES["decode_32k"]
    amesh = AbstractMesh((16, 16), ("data", "model"))
    mesh = MeshShape(data=16, model=16)
    tcache = tsteps.cache_specs(tcfgs.make_model(tcfg), tcfg, cell)
    got = T.tree_map(lambda s: s.spec, tsteps.cache_shardings(tcache, tcfg, mesh, seq_shard))
    jcache = jsteps.cache_specs(jcfgs.make_model(jcfg), jcfg, jcell)
    want = ref_cache_specs_in_port_layout(jsteps.cache_shardings(jcache, jcfg, amesh, seq_shard), jcfg)
    assert T.flatten_with_path(got) == T.flatten_with_path(want)
    tok = tsteps.batch_shardings(tsteps.token_specs(tcfg, cell), mesh).spec
    assert tok == tuple(jsteps.batch_shardings(jsteps.token_specs(jcfg, jcell), amesh).spec)
    tb = tsteps.batch_shardings(tsteps.batch_specs(tcfg, tcfgs.SHAPES["train_4k"]), mesh)
    jb = jsteps.batch_shardings(jsteps.batch_specs(jcfg, jcfgs.SHAPES["train_4k"]), amesh)
    assert {k: v.spec for k, v in tb.items()} == {k: tuple(v.spec) for k, v in jb.items()}


# ---------------------------------------------------------------------------
# 8 ranks: the train step and the MoE's group-local dispatch
# ---------------------------------------------------------------------------

JAX_MESH_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_reduced, make_model
    from repro.launch.mesh import _mk
    from repro.nn.module import axis_rules, init_with_axes

    tmp = sys.argv[1]
    out = {}
    base = dataclasses.replace(get_reduced("grok_1_314b"), dtype="float32")
    model = make_model(base)
    params, _ = init_with_axes(model.init, jax.random.PRNGKey(0), dtype=jnp.float32)
    np.savez(os.path.join(tmp, "grok_params.npz"),
             **{jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(params)})
    tok = jnp.asarray(np.random.default_rng(0).integers(0, base.vocab, (4, 32)), jnp.int32)
    mesh = _mk((4, 2), ("data", "model"))
    for name, cf in (("nodrop", base.moe.n_experts / base.moe.top_k), ("drop", 1.0)):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
        m = make_model(cfg)
        with mesh, axis_rules(mesh):
            logits, _ = jax.jit(lambda p, t: m.train_logits(p, t))(params, tok)
        np.save(os.path.join(tmp, f"grok_{name}.npy"), np.asarray(logits))
    # hlo_analysis' per-device dot FLOPs of reduced qwen3's train and
    # decode steps and of six other reduced archs' train steps,
    # SPMD-partitioned for a (2, 4) mesh.
    from repro.configs import ShapeCell
    from repro.launch import steps as S
    from repro.launch.hlo_analysis import analyze
    from repro.optim.adamw import AdamW
    qcfg = get_reduced("qwen3_8b")
    qmodel, opt, mesh24 = make_model(qcfg), AdamW(), _mk((2, 4), ("data", "model"))
    with mesh24, axis_rules(mesh24):
        state, axes = S.init_state(qmodel, qcfg, opt, jax.random.PRNGKey(0), abstract=True)
        st = S.state_shardings(state, axes, mesh24)
        b = S.batch_specs(qcfg, ShapeCell("train_4k", 64, 8, "train"))
        train = jax.jit(S.make_train_step(qmodel, qcfg, opt), in_shardings=(st, S.batch_shardings(b, mesh24)),
                        out_shardings=(st, None)).lower(state, b).compile()
        dcell = ShapeCell("decode_32k", 64, 8, "decode")
        t, c = S.token_specs(qcfg, dcell), S.cache_specs(qmodel, qcfg, dcell)
        decode = jax.jit(S.make_serve_step(qmodel, qcfg), in_shardings=(
            st["params"], S.batch_shardings(t, mesh24), S.cache_shardings(c, qcfg, mesh24))).lower(
            state["params"], t, c).compile()
    out["dot_flops"] = {name: analyze(x.as_text()).corrected_dot_flops for name, x in (("train", train), ("decode", decode))}
    # ... and the collective bytes of that train step, by type.
    out["collectives_2x4"] = analyze(train.as_text()).corrected_coll_bytes
    # hlo_analysis' per-device collective bytes of reduced qwen3's train
    # step on a data-only (8, 1) mesh.
    mesh81 = _mk((8, 1), ("data", "model"))
    with mesh81, axis_rules(mesh81):
        st = S.state_shardings(state, axes, mesh81)
        x = jax.jit(S.make_train_step(qmodel, qcfg, opt), in_shardings=(st, S.batch_shardings(b, mesh81)),
                    out_shardings=(st, None)).lower(state, b).compile()
    out["collectives_8x1"] = analyze(x.as_text()).corrected_coll_bytes
    for arch in ("grok_1_314b", "starcoder2_3b", "gemma3_1b", "deepseek_v3_671b", "xlstm_125m", "recurrentgemma_9b"):
        acfg = get_reduced(arch)
        amodel = make_model(acfg)
        with mesh24, axis_rules(mesh24):
            state, axes = S.init_state(amodel, acfg, opt, jax.random.PRNGKey(0), abstract=True)
            st = S.state_shardings(state, axes, mesh24)
            b = S.batch_specs(acfg, ShapeCell("train_4k", 64, 8, "train"))
            x = jax.jit(S.make_train_step(amodel, acfg, opt), in_shardings=(st, S.batch_shardings(b, mesh24)),
                        out_shardings=(st, None)).lower(state, b).compile()
        out["dot_flops"][arch] = analyze(x.as_text()).corrected_dot_flops
    # ... and reduced xlstm's on a (1, 8) mesh, over which its 4 heads do
    # not divide, with its temporaries.
    xcfg = get_reduced("xlstm_125m")
    xmodel, mesh18 = make_model(xcfg), _mk((1, 8), ("data", "model"))
    with mesh18, axis_rules(mesh18):
        state, axes = S.init_state(xmodel, xcfg, opt, jax.random.PRNGKey(0), abstract=True)
        st = S.state_shardings(state, axes, mesh18)
        b = S.batch_specs(xcfg, ShapeCell("train_4k", 64, 8, "train"))
        x = jax.jit(S.make_train_step(xmodel, xcfg, opt), in_shardings=(st, S.batch_shardings(b, mesh18)),
                    out_shardings=(st, None)).lower(state, b).compile()
    out["dot_flops_1x8"] = {"xlstm_125m": analyze(x.as_text()).corrected_dot_flops}
    out["temp_1x8"] = {"xlstm_125m": x.memory_analysis().temp_size_in_bytes}
    # Which rows of a (pod, data)-sharded dim each device holds, by its
    # position in a (2, 2, 2) mesh.
    mesh3 = _mk((2, 2, 2), ("pod", "data", "model"))
    imap = NamedSharding(mesh3, P(("pod", "data"), None)).devices_indices_map((8, 3))
    out["rows"] = [imap[d][0].start for d in mesh3.devices.flat]
    print(json.dumps(out))
    """
)


class Background:
    """A subprocess started when the module's first test asks for it and
    read when a test needs its result, so it overlaps the tests between."""

    def __init__(self, argv, timeout):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("XLA_FLAGS", None)
        self.proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.timeout = timeout

    def result(self) -> tuple[int, str, str]:
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode, out, err


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The reference on 8 forced host devices (reduced grok's params and
    its (4, 2)-mesh logits with and without drops, and the rows each device
    of a (2, 2, 2) mesh holds of a ("pod", "data")-sharded dim), and the
    dry-run CLI over every reduced cell."""
    jtmp, dtmp = tmp_path_factory.mktemp("jax_mesh"), tmp_path_factory.mktemp("dryrun")
    cli = lambda archs: Background([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ",".join(archs),
                                    "--mesh", "single", "--reduced", "--out", str(dtmp)], 600)
    # Two processes: xlstm's fitted train cell takes about as long as every other cell.
    slow = ["xlstm_125m"]
    jobs = {
        "jax_mesh": (jtmp, Background([sys.executable, "-c", JAX_MESH_SCRIPT, str(jtmp)], 300)),
        "dryrun": (dtmp, cli(slow)),
        "dryrun_rest": (dtmp, cli([a for a in tcfgs.ARCH_IDS if a not in slow])),
    }
    yield jobs
    for _, job in jobs.values():
        if job.proc.poll() is None:
            job.proc.kill()
            job.proc.wait()


@pytest.fixture(scope="module")
def jax_mesh_run(background):
    tmp, job = background["jax_mesh"]
    rc, out, err = job.result()
    assert rc == 0, err[-3000:]
    return tmp, json.loads(out.strip().splitlines()[-1])


MOE_RANKS = """
import dataclasses
import numpy as np
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced, make_model
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import _mk
from repro_torch.nn import layers as L
from repro_torch.nn.module import NamedSharding, axis_rules, from_reference_layout, init_with_axes

base = dataclasses.replace(get_reduced("grok_1_314b"), dtype="float32")
_, axes = init_with_axes(make_model(base).init, 0, device="meta")
flat = np.load(TMP / "grok_params.npz")
nested = {}
for key, val in flat.items():
    node = nested
    parts = [p.strip("[]'") for p in key.split("][")]
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = torch.from_numpy(val)
params = from_reference_layout(nested)
tok = torch.from_numpy(np.random.default_rng(0).integers(0, base.vocab, (4, 32))).int()
mesh = _mk((4, 2), ("data", "model"), "cpu")
sharded = S.shard_state(params, S.state_shardings({"params": params}, axes, mesh)["params"])
dtok = distribute_tensor(tok, mesh, [Shard(0), Replicate()], src_data_rank=None)
out = {}
for name, cf in (("nodrop", base.moe.n_experts / base.moe.top_k), ("drop", 1.0)):
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
    model = make_model(cfg)
    L.reset_moe_counts()
    one, _ = model.train_logits(params, tok)
    out[name + "_dropped_g1"] = L.moe_counts()["dropped"]
    L.reset_moe_counts()
    with axis_rules(mesh), implicit_replication():
        got, _ = model.train_logits(sharded, dtok)
    out[name + "_dropped_g4"] = L.moe_counts()["dropped"]
    got = got.full_tensor()
    ref = torch.from_numpy(np.load(TMP / f"grok_{name}.npy"))
    scale = float(ref.abs().max())
    out[name + "_vs_jax"] = float((got - ref).abs().max()) / scale
    out[name + "_vs_one_group"] = float((got - one).abs().max()) / scale
# The rows this rank holds of a ("pod", "data")-sharded dim of a (2, 2, 2) mesh.
mesh3 = _mk((2, 2, 2), ("pod", "data", "model"), "cpu")
rows = distribute_tensor(torch.arange(8 * 3).reshape(8, 3), mesh3,
                         NamedSharding(mesh3, (("pod", "data"), None)).placements(), src_data_rank=None)
out["row"] = int(rows.to_local()[0, 0]) // 3
emit(out)
"""


def test_moe_group_local_dispatch_on_8_ranks(tmp_path, jax_mesh_run):
    """Reduced grok in fp32 on a (4, 2) mesh of 8 ranks (4 dispatch groups,
    DTensor params and tokens), from the JAX init.  Without drops
    (cf = E/k) it equals one group; with drops (cf = 1) it equals the
    reference's run on its 8-device (4, 2) mesh, and drops another count of
    assignments than one group does.  A ("pod", "data") dim puts rank r's
    rows where JAX puts device r's."""
    jtmp, jout = jax_mesh_run
    for name in ("grok_params.npz", "grok_nodrop.npy", "grok_drop.npy"):
        (tmp_path / name).symlink_to(jtmp / name)
    outs = run_ranks(tmp_path, 8, MOE_RANKS)
    o = outs[0]
    assert o["nodrop_vs_one_group"] < 1e-5 and o["nodrop_vs_jax"] < 1e-5, o
    assert o["drop_vs_jax"] < 1e-5, o
    assert o["drop_vs_one_group"] > 1e-3, o  # the groups route differently
    assert o["nodrop_dropped_g4"] == o["nodrop_dropped_g1"] == 0
    assert o["drop_dropped_g4"] != o["drop_dropped_g1"], o
    assert [r["row"] for r in outs] == jout["rows"]


TRAIN_RANKS = """
import numpy as np
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_reduced, make_model
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import _mk
from repro_torch.nn import layers as L
from repro_torch.nn.module import init_with_axes
from repro_torch.optim.adamw import AdamW
import dataclasses
from repro_torch import tree as T

meshes = {}
link = L.LINK_BYTES
placed = lambda x: [f"S{p.dim}" if p.is_shard() else "R" for p in x.placements]
local_hex = lambda x: x.to_local().detach().numpy().tobytes().hex()[:64]
out = {}
for case, arch in TRAIN_CASES.items():
    shape = TRAIN_MESHES.get(case, (2, 4))
    mesh = meshes.setdefault(shape, _mk(shape, ("data", "model"), "cpu"))
    # "_moved": the kv heads' projection split over the sequence and moved
    # (an infinitely fast link makes it the cheaper layout).
    L.LINK_BYTES = float("inf") if case.endswith("_moved") else link
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    model = make_model(cfg)
    opt = AdamW(learning_rate=1e-3)
    state = torch.load(TMP / f"state_{case}.pt")
    batch = torch.load(TMP / f"batch_{case}.pt")
    _, axes = init_with_axes(model.init, 0, device="meta")
    sh = S.state_shardings(state, axes, mesh)
    step = S.make_sharded_train_step(model, cfg, opt, sh)
    dstate = S.shard_state(state, sh)
    dbatch = S.shard_state(batch, S.batch_shardings(batch, mesh))
    logits, _ = S.on_mesh(model.train_logits, mesh)(dstate["params"], dbatch["inputs"])
    new, metrics = step(dstate, dbatch)
    w = new["params"]["prefix_0"]
    for key in SPLIT_LEAVES[arch][0].split("/"):
        w = w[key]
    table = new["params"]["embed"]["table"]
    full = T.tree_map(lambda x: x.full_tensor(), new)
    if RANK == 0:
        torch.save(full, TMP / f"sharded_state_{case}.pt")
    out[case] = {"loss": float(metrics["loss"]), "w_local": local_hex(w), "w_placements": placed(w),
                 "table_local": local_hex(table), "table_placements": placed(table),
                 "logits_local": local_hex(logits), "logits_placements": placed(logits),
                 "same_placements": all(str(a.placements) == str(b.placements)
                                        for a, b in zip(T.leaves(new), T.leaves(dstate)))}
emit(out)
"""

# case -> reduced arch: qwen3 (untied head), gemma3 (tied head, scaled
# embeddings; one kv head, projected by each of the 4 devices that read it),
# gemma3 with that projection split over the sequence and moved to them,
# qwen3 on a batch with ignored labels, and xlstm (tied head) on a (1, 8)
# mesh, over which its 4 heads do not divide: each device steps half a
# head's cells (the mLSTM's value rows, the sLSTM's output columns).
TRAIN_CASES = {"qwen3": "qwen3_8b", "gemma3": "gemma3_1b", "gemma3_moved": "gemma3_1b", "qwen3_ignore": "qwen3_8b",
               "xlstm_1x8": "xlstm_125m"}
# A case's mesh, (2, 4) unless named here.
TRAIN_MESHES = {"xlstm_1x8": (1, 8)}
# An arch's weight split over 'model' (its path in the first layer), and
# that split's placements on the case's mesh.
SPLIT_LEAVES = {"qwen3_8b": ("ffn/w_gate", ["R", "S1"]), "gemma3_1b": ("ffn/w_gate", ["R", "S1"]),
                "xlstm_125m": ("mixer/wq", ["R", "S0"])}
# The params' bar after one AdamW step, (rtol, atol).  gemma3's is the bar
# tests/test_torch_recurrent_train.py holds AdamW-amplified params to
# (PARAM_ATOL): its one-process port and JAX already differ by up to 7.5e-5
# after one step, elements whose gradient is near zero, off any mesh.
# xlstm's is the same bar: its one-process port and JAX differ by up to
# 6.0e-5 after one step (the mLSTM gate biases ``b_if``, a ``wk``), off any
# mesh; the sharded step by up to 8.2e-5 from JAX.
PARAM_BARS = {"qwen3": (2e-5, 2e-5), "gemma3": (0.0, 3e-4), "gemma3_moved": (0.0, 3e-4), "qwen3_ignore": (2e-5, 2e-5),
              "xlstm_1x8": (0.0, 3e-4)}
# The moments' absolute floor of a case, beside the 1e-5 relative bar: the
# AdamW moments (b1 0.9, b2 0.95) of a gradient of 1e-9, the absolute bar
# tests/test_torch_recurrent_train.py holds the sLSTM's gradients to.  Its
# input-gate bias ``b_i`` has gradients of 3e-12, rounding noise (h = o·c/n
# does not move when every input-gate pre-activation shifts alike): the
# one-process port and JAX part its moments by 1.7 times their largest,
# off any mesh.
MOMENT_FLOORS = {"xlstm_1x8": {"m": 1e-10, "v": 5e-20}}


def test_train_step_on_8_ranks_matches_one_process_and_jax(tmp_path):
    """The counterpart of ``tests/test_sharding.py::test_multidevice_train_step_runs``:
    reduced qwen3 in fp32 from the JAX init, a (2, 4) mesh of 8 ranks, the
    reference's batch; reduced gemma3 (a tied head: the logits are the
    vocab-split table's transpose) the same way, once with its kv head
    projected on each device and once split over the sequence and moved
    (``layers._project_kv``); qwen3 on that batch
    with every third label ``IGNORE_INDEX``; and reduced xlstm on a (1, 8)
    mesh, over which its 4 heads do not divide (each device steps half a
    head's cells, ``recurrent._head_share``).  The sharded step's loss and
    AdamW moments (after one step, the clipped gradient and its square)
    equal the port's one-process step and the JAX step within 1e-5
    relative (xlstm's or ``MOMENT_FLOORS``); its params within the bar
    ``tests/test_torch_train.py`` holds one step to (rtol = atol = 2e-5),
    since AdamW turns rounding in near-zero gradients into parameter gaps
    of 3e-5 of a leaf's largest value between the one-process port and JAX
    too (gemma3's and xlstm's within ``PARAM_BARS``' wider one, for the
    same reason).  The new state keeps
    its shardings, and a weight split over ``model`` (``SPLIT_LEAVES``) has
    a distinct local shard on each device along it.  The vocab stays split:
    the embedding table's new value and the logits are ``Shard`` on the
    vocab dim over ``model``, a distinct local block a device along it (the
    vocab-parallel lookup and loss)."""
    from repro_torch.launch.train import port_state

    to_t = lambda tree: T.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)
    want, made = {}, {}
    for case, arch in TRAIN_CASES.items():
        if arch not in made:  # one JAX init and compiled step an arch
            jcfg = dataclasses.replace(jcfgs.get_reduced(arch), dtype="float32")
            tcfg = dataclasses.replace(tcfgs.get_reduced(arch), dtype="float32")
            jmodel, jopt = jcfgs.make_model(jcfg), JAdamW(learning_rate=1e-3)
            jstate, _ = jsteps.init_state(jmodel, jcfg, jopt, jax.random.PRNGKey(0))
            made[arch] = (jcfg, jstate, jax.jit(jsteps.make_train_step(jmodel, jcfg, jopt)),
                          port_state(to_t(jax.tree_util.tree_map(np.asarray, jstate))),
                          tsteps.make_train_step(tcfgs.make_model(tcfg), tcfg, TAdamW(learning_rate=1e-3)))
        jcfg, jstate, jstep, state, tstep = made[arch]
        toks = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 33)).astype(np.int32)
        labels = toks[:, 1:].copy()
        if case.endswith("_ignore"):
            labels[:, ::3] = jsteps.IGNORE_INDEX
        jbatch = {"inputs": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
        jnew, jm = jstep(jstate, jbatch)
        batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
        torch.save(state, tmp_path / f"state_{case}.pt")
        torch.save(batch, tmp_path / f"batch_{case}.pt")
        one, m1 = tstep(state, batch)
        want[case] = (one, float(m1["loss"]), port_state(to_t(jax.tree_util.tree_map(np.asarray, jnew))),
                      float(jm["loss"]))

    outs = run_ranks(tmp_path, 8, f"TRAIN_CASES = {TRAIN_CASES!r}\nTRAIN_MESHES = {TRAIN_MESHES!r}\n"
                                  f"SPLIT_LEAVES = {SPLIT_LEAVES!r}\n" + TRAIN_RANKS)
    for case, (one, loss, jone, jloss) in want.items():
        got = [o[case] for o in outs]
        sharded = torch.load(tmp_path / f"sharded_state_{case}.pt")
        assert abs(got[0]["loss"] - loss) <= 1e-5 * abs(loss), case
        assert abs(got[0]["loss"] - jloss) <= 1e-5 * abs(jloss), case
        for (path, g), (_, w), (_, jw) in zip(T.flatten_with_path(sharded), T.flatten_with_path(one),
                                              T.flatten_with_path(jone)):
            if path[0] == "opt" and path[1] in ("m", "v"):
                floor = MOMENT_FLOORS.get(case, {}).get(path[1], 0.0)
                close = lambda r: rel(g.numpy(), r.numpy()) < 1e-5 or float((g - r).abs().max()) <= floor
                assert close(w) and close(jw), (case, path)
            rtol, atol = PARAM_BARS[case]
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=f"{case} {path}")
            np.testing.assert_allclose(g.numpy(), jw.numpy(), rtol=rtol, atol=atol, err_msg=f"{case} {path}")
        model = TRAIN_MESHES.get(case, (2, 4))[1]
        batch_split = "S0" if TRAIN_MESHES.get(case, (2, 4))[0] > 1 else "R"
        assert all(o["same_placements"] for o in got), case
        assert got[0]["w_placements"] == SPLIT_LEAVES[TRAIN_CASES[case]][1], (case, got[0])
        assert len({o["w_local"] for o in got}) == model, case
        assert got[0]["table_placements"] == ["R", "S0"], got[0]
        assert got[0]["logits_placements"] == [batch_split, "S2"], got[0]
        assert len({o["table_local"] for o in got}) == model and len({o["logits_local"] for o in got}) == 8, case


XLSTM_PREFILL_RANKS = """
import dataclasses
import numpy as np
from repro_torch import tree as T
from repro_torch.configs import get_reduced, make_model
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import _mk
from repro_torch.nn.module import init_with_axes

cfg = dataclasses.replace(get_reduced("xlstm_125m"), dtype="float32", attn_impl="xla")
model = make_model(cfg)
params, axes = init_with_axes(model.init, 0, device="cpu")
tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 25))).int()
fresh = lambda: model.init_caches(2, 32, torch.float32, "cpu")
with torch.no_grad():
    want, caches = model.prefill(params, tok[:, :24], fresh())
    want_next, caches = model.decode_step(params, tok[:, 24:], caches)
mesh = _mk((1, 8), ("data", "model"), "cpu")
dparams = S.shard_state(params, S.state_shardings({"params": params}, axes, mesh)["params"])
dtok = S.shard_state({"t": tok}, S.batch_shardings({"t": tok}, mesh))["t"]
with torch.no_grad():
    got, dcaches = S.on_mesh(model.prefill, mesh)(dparams, dtok[:, :24],
                                                  S.shard_state(fresh(), S.cache_shardings(fresh(), cfg, mesh)))
    got_next, dcaches = S.on_mesh(model.decode_step, mesh)(dparams, dtok[:, 24:], dcaches)
gap = lambda a, b: float((a.full_tensor() - b).abs().max() / b.abs().max())
out = {"prefill": gap(got, want), "decode": gap(got_next, want_next)}
for (path, a), (_, b) in zip(T.flatten_with_path(dcaches), T.flatten_with_path(caches)):
    if isinstance(b, torch.Tensor):
        out["/".join(path)] = gap(a, b) if tuple(a.shape) == tuple(b.shape) else "shape"
emit(out)
"""


def test_xlstm_prefill_on_8_ranks_returns_whole_states(tmp_path):
    """Reduced xlstm in fp32 prefilling 24 tokens on a (1, 8) mesh, over
    which its 4 heads do not divide (each device steps half a head's cells,
    ``recurrent._head_share``), then decoding one: the logits of both and
    every layer's state after them (the mLSTM's C, n, m gathered whole from
    the devices' value rows, the sLSTM's split by columns) equal one
    process's within 1e-5 of each leaf's largest."""
    out = run_ranks(tmp_path, 8, XLSTM_PREFILL_RANKS)[0]
    assert out.keys() > {"prefill", "decode", "prefix_0/C", "prefix_3/h"}, out
    assert all(v != "shape" and v < 1e-5 for v in out.values()), out


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------


def test_dryrun_accounting_matches_reference(jax_mesh_run):
    """Reduced qwen3's train step on a (2, 4) mesh: per-device bytes equal
    those of the reference's specs; the per-device dot FLOPs (``dot_flops``)
    equal ``hlo_analysis``' count of the reference step SPMD-partitioned for
    its 8-device (2, 4) mesh, and the whole step's (``global_dot_flops``)
    its count compiled for one CPU device, both within 2%.  The per-device
    FLOPs of the decode step, and of reduced grok's and starcoder2's train
    steps, equal the reference's on that mesh too."""
    _, jout = jax_mesh_run
    jcfg, tcfg = jcfgs.get_reduced("qwen3_8b"), tcfgs.get_reduced("qwen3_8b")
    jcell = jcfgs.ShapeCell("train_4k", 64, 8, "train")
    tcell = tcfgs.ShapeCell("train_4k", 64, 8, "train")
    shape = dict(data=2, model=4)
    got = dryrun.account(tcfg, tcell, MeshShape(**shape))

    jmodel, jopt = jcfgs.make_model(jcfg), JAdamW()
    jstate, jaxes = jsteps.init_state(jmodel, jcfg, jopt, jax.random.PRNGKey(0), abstract=True)
    fake = MeshShape(**shape)
    pspecs = jmod.logical_to_pspec(jaxes, jstate["params"], fake)
    bspec = jsteps.batch_specs(jcfg, jcell)
    lead = jsteps._shard_if(jcell.global_batch, ("data",), fake)
    want = {
        "params": ref_device_bytes(pspecs, jstate["params"], shape),
        "opt": 2 * ref_device_bytes(pspecs, jstate["opt"]["m"], shape) + 4 + 4,  # m, v, count; step
        "batch": ref_device_bytes({k: P(lead, None) for k in bspec}, bspec, shape),
    }
    want["argument_size_in_bytes"] = sum(want.values())
    assert {k: v for k, v in got["memory"].items() if k != "temp_size_in_bytes"} == want
    assert got["memory"]["temp_size_in_bytes"] > 0

    per_device = jout["dot_flops"]["train"]
    assert abs(got["dot_flops"] / per_device - 1) < 0.02, (got["dot_flops"], per_device)
    compiled = jax.jit(jsteps.make_train_step(jmodel, jcfg, jopt)).lower(jstate, bspec).compile()
    whole = analyze(compiled.as_text()).corrected_dot_flops
    assert abs(got["global_dot_flops"] / whole - 1) < 0.02, (got["global_dot_flops"], whole)

    decode = dryrun.account(tcfg, tcfgs.ShapeCell("decode_32k", 64, 8, "decode"), MeshShape(**shape))
    assert abs(decode["dot_flops"] / jout["dot_flops"]["decode"] - 1) < 0.02, (decode, jout["dot_flops"])
    for arch in ("grok_1_314b", "starcoder2_3b"):  # MoE, and GQA whose KV the model axis does not divide
        other = dryrun.account(tcfgs.get_reduced(arch), tcell, MeshShape(**shape))
        assert abs(other["dot_flops"] / jout["dot_flops"][arch] - 1) < 0.02, (arch, other, jout["dot_flops"])


# Per-device dot FLOPs a port's step differs from the reference's by, for
# products located and counted (ROADMAP.md §C), reduced train cells of 8 x 64
# by mesh: on (2, 4) a device holds 4 sequences, 256 tokens, and 1 of the 4
# heads; on (1, 8) all 8 sequences, 512 tokens, and half a head.
LOCATED_FLOPS = {
    # +13,369,344 / 8: autograd's outer products in the backward of the
    # mLSTM step's ``bhde,bhe->bhd`` are bmm's with a contraction of 1,
    # which XLA lowers to broadcast multiplies that hlo_analysis does not
    # count; -3/2 of 2·256·85·64: the reference runs the sLSTM's w_ff_down
    # products whole on every device (its ff dim, 85, does not divide over
    # model), the port splits the forward and one of the two backward ones.
    ("xlstm_125m", (2, 4)): 13_369_344 // 8 - 3 * (2 * 256 * 85 * 64) // 2,
    # The same outer products of a device's half head, 8 sequences x 16
    # value rows x 32 keys, 64 steps, 3 mLSTM layers: +2·8·16·32·64·3, and
    # of the denominator n·q (two a step): +2·(2·8·32)·64·3; -2·8·8·16·4:
    # the port takes no gradient of the sLSTM's first step into its
    # initial h, a constant, where the reference's scan differentiates its
    # carry-in (8 sequences x 8 of a device's columns x 16 of its head, 4
    # gates).  Both run w_ff_down whole on every device.
    ("xlstm_125m", (1, 8)): 2 * 8 * 16 * 32 * 64 * 3 + 2 * (2 * 8 * 32) * 64 * 3 - 2 * 8 * 8 * 16 * 4,
}


@pytest.mark.parametrize("arch, mesh", [
    *(pytest.param(arch, (2, 4), id=arch) for arch in ("gemma3_1b", "deepseek_v3_671b", "xlstm_125m",
                                                       "recurrentgemma_9b")),
    pytest.param("xlstm_125m", (1, 8), id="xlstm_125m-1x8"),
])
def test_dryrun_device_flops_match_reference(arch, mesh, jax_mesh_run):
    """One device's dot FLOPs of a reduced train step of 8 x 64 (the step on
    DTensors over a fake process group, at that length) equal
    ``hlo_analysis``' count of the reference step SPMD-partitioned for its
    8-device mesh within 2%, after the products located in
    ``LOCATED_FLOPS``: on (2, 4), gemma3 (one kv head, each device
    projecting it), deepseek (MLA's low-rank products and the MTP head),
    xlstm and recurrentgemma (their scans); and xlstm on (1, 8), where its
    4 heads do not divide over the model axis and each device steps its
    share of every head's cells, as the reference's partitioner splits
    them, holding at most 1.5 times the reference's temporaries."""
    _, jout = jax_mesh_run
    cfg = tcfgs.get_reduced(arch)
    model, opt = tcfgs.make_model(cfg), TAdamW()
    state, axes = tsteps.init_state(model, cfg, opt, device="meta")
    with dryrun.fake_mesh(MeshShape(data=mesh[0], model=mesh[1])) as dmesh:
        run = dryrun.sharded_run(model, cfg, tcfgs.ShapeCell("train_4k", 64, 8, "train"), state, axes, opt, dmesh,
                                 tmod.DEFAULT_RULES)
    tag = "" if mesh == (2, 4) else "_1x8"
    ref, located = jout["dot_flops" + tag][arch], LOCATED_FLOPS.get((arch, mesh), 0)
    assert abs(run["dot_flops"] / (ref + located) - 1) < 0.02, (arch, mesh, run["dot_flops"], ref, located)
    if tag:
        want = jout["temp" + tag][arch]
        assert 0 < run["temp_size_in_bytes"] <= 1.5 * want, (run["temp_size_in_bytes"], want)


def test_dryrun_mesh_step_sends_the_references_collectives(jax_mesh_run):
    """Reduced qwen3's train step of 8 x 64 on a (2, 4) mesh sends only
    all-reduces, as the reference's SPMD-partitioned step does, and at most
    1.1 times the reference's bytes: each block's output is reduced once,
    in the activation dtype, before the residual add (the reference's 28
    all-reduces, their shapes and the port's counterparts: ROADMAP.md §C)."""
    _, jout = jax_mesh_run
    ref = jout["collectives_2x4"]
    got = dryrun.account(tcfgs.get_reduced("qwen3_8b"), tcfgs.ShapeCell("train_4k", 64, 8, "train"),
                         MeshShape(data=2, model=4))["collectives"]
    assert set(ref) == {"all-reduce"}, ref
    assert got["total_bytes"] == got["bytes_by_type"]["all-reduce"] > 0, got
    assert got["total_bytes"] <= 1.1 * ref["all-reduce"], (got, ref)


def test_dryrun_full_size_step_keeps_each_device_share():
    """qwen3-8b's ``train_4k`` cell on the 16x16 mesh at full size: one
    device's dot FLOPs are at most 1.02 times the whole step's over the
    256 devices (each product split, the kv projections too: 8 kv heads
    over 16 devices); it sends at most 160 GB a step, 120 GB of it
    all-reduce, and holds at most 45.9 GB of temporaries."""
    r = dryrun.run_cell("qwen3_8b", "train_4k", multi_pod=False)
    assert r["dot_flops"] <= 1.02 * r["global_dot_flops"] / r["n_devices"], r
    coll = r["collectives"]
    assert coll["total_bytes"] <= 160e9 and coll["bytes_by_type"]["all-reduce"] <= 120e9, coll
    assert 0 < r["memory"]["temp_size_in_bytes"] <= 45.9e9, r["memory"]


def test_dryrun_seq_fit_is_exact():
    """The recurrent cells' FLOPs come from a quadratic fit in the sequence
    length: a quadratic count comes back exactly, another is refused; a
    record's counts fit through the first window that fits them all, each
    collective's bytes on its own (their largest is the largest fitted)."""
    assert dryrun.fit_in_seq(lambda s: 3 * s * s + 5 * s + 7, 32_768) == 3 * 32_768**2 + 5 * 32_768 + 7
    with pytest.raises(ValueError, match="not quadratic"):
        dryrun.fit_in_seq(lambda s: s**3, 4096)

    def run(s):  # a temporary that settles into a line only past s = 16
        ops = [("all-reduce", 4096), ("all-gather", 64 * s)]
        return {"dot_flops": 10 * s * s, "temp_size_in_bytes": max(1000, 50 * s) + s,
                "collectives": {"bytes_by_type": {"all-reduce": 4096, "all-gather": 64 * s},
                                "largest_bytes": {}}, "ops": ops}

    record, points = dryrun.fit_record_in_seq(run, 4096)
    assert points == (48, 64, 80, 96, 112)
    assert record["dot_flops"] == 10 * 4096**2 and record["temp_size_in_bytes"] == 51 * 4096
    assert record["collectives"]["largest_bytes"]["all-gather"] == 64 * 4096
    assert record["collectives"]["largest_bytes"]["all-reduce"] == 4096


def test_collective_counter_closed_forms():
    """``DeviceCounter`` on hand-built redistributions over a fake (2, 4)
    mesh: Shard -> Replicate is one all-gather of the gathered tensor's
    bytes, Partial -> Replicate one all-reduce of the whole tensor,
    Partial -> Shard one reduce-scatter of the shard, and Shard(0) ->
    Shard(1) one all-to-all of the block received."""
    from torch.distributed.tensor import DTensor, Partial

    def dt(local_shape, placements, shape, dtype=torch.float32):
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(torch.empty(local_shape, dtype=dtype, device="meta"), mesh, placements,
                                  run_check=False, shape=shape, stride=stride)

    cases = [
        (((4, 8), [Replicate(), Shard(0)], (16, 8)), [Replicate(), Replicate()], "all-gather", 16 * 8 * 4),
        (((16, 8), [Partial(), Replicate()], (16, 8), torch.bfloat16), [Replicate(), Replicate()], "all-reduce",
         16 * 8 * 2),
        (((16, 8), [Replicate(), Partial()], (16, 8)), [Replicate(), Shard(0)], "reduce-scatter", 4 * 8 * 4),
        (((4, 8), [Replicate(), Shard(0)], (16, 8)), [Replicate(), Shard(1)], "all-to-all", 16 * 2 * 4),
    ]
    with dryrun.fake_mesh(MeshShape(data=2, model=4)) as mesh:
        for args, target, kind, nbytes in cases:
            x = dt(*args)
            with dryrun._alltoall_as_on_the_card(), dryrun.DeviceCounter((x,)) as counter:
                x.redistribute(mesh, target)
            coll = counter.collectives()
            assert coll["counts"] == {**dict.fromkeys(dryrun.COLLECTIVES, 0), kind: 1}, (kind, coll)
            assert coll["bytes_by_type"][kind] == coll["total_bytes"] == nbytes, (kind, coll)


def test_temp_bytes_closed_form():
    """Allocate A and B, free A, allocate C (and a view of it): the peak of
    live storages is max(A + B, B + C); the arguments' storages and views
    of them count nothing."""
    arg = torch.empty(1000, device="meta")
    with dryrun.DeviceCounter((arg,)) as counter:
        a = torch.empty(100, device="meta")  # 400 B
        b = torch.empty(50, dtype=torch.float64, device="meta")  # 400 B
        del a
        c = torch.empty(300, device="meta")  # 1200 B
        c.view(10, 30).add_(1)
        arg.view(10, 100).mul_(2)
        assert counter.live_bytes == 400 + 1200
        del b, c
    assert counter.temp_bytes == max(400 + 400, 400 + 1200) and counter.live_bytes == 0


def test_dryrun_all_reduces_the_gradient_once_on_a_data_mesh(jax_mesh_run):
    """Reduced qwen3's train step on a data-only (8, 1) mesh: its
    all-reduce bytes are the fp32 gradient's (the params' bytes; one
    reduce a gradient) within 1%, and equal ``hlo_analysis``' count of the
    reference step on its 8-device (8, 1) mesh within 1%; nothing else is
    sent."""
    _, jout = jax_mesh_run
    got = dryrun.account(tcfgs.get_reduced("qwen3_8b"), tcfgs.ShapeCell("train_4k", 64, 8, "train"),
                         MeshShape(data=8, model=1))
    coll = got["collectives"]
    grad_bytes = got["memory"]["params"]
    assert abs(coll["bytes_by_type"]["all-reduce"] / grad_bytes - 1) < 0.01, (coll, grad_bytes)
    assert abs(coll["bytes_by_type"]["all-reduce"] / jout["collectives_8x1"]["all-reduce"] - 1) < 0.01, jout
    assert coll["total_bytes"] == coll["bytes_by_type"]["all-reduce"], coll


def test_vocab_forms_off_mesh_and_on_one_by_one_are_todays(tmp_path):
    """Where the vocab is not split, the lookup and the loss are today's
    code: off a mesh, ``embedding_apply`` and ``cross_entropy`` equal the
    replicated forms (``F.embedding`` on the whole table, ``logsumexp`` and
    a gather of the gold logit) bit for bit, for qwen3 (untied) and gemma3
    (tied, scaled), with ``IGNORE_INDEX`` labels.  On a 1 x 1 mesh (a
    one-rank ``gloo`` group in this process) the lookup, the logits and the
    loss of DTensor params equal the plain ones bit for bit, and so does a
    whole train step of each (gemma3's ``k_norm`` gradients too: the qk
    norms' output gradients are made contiguous, ROADMAP.md §C)."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch import tree
    from repro_torch.launch.mesh import _mk
    from repro_torch.nn import layers as L

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 17)))
    labels = toks[:, 1:].clone()
    labels[:, ::4] = tsteps.IGNORE_INDEX
    batch = {"inputs": toks[:, :-1], "labels": labels}
    runs = {}
    for arch in ("qwen3_8b", "gemma3_1b"):
        cfg = dataclasses.replace(tcfgs.get_reduced(arch), n_layers=2)
        model, opt = tcfgs.make_model(cfg), TAdamW(learning_rate=1e-3)
        state, axes = tsteps.init_state(model, cfg, opt, seed=0, device="cpu")
        table = state["params"]["embed"]["table"]
        want = F.embedding(batch["inputs"], table).to(getattr(torch, cfg.dtype))
        if cfg.embed_scale:
            want = want * torch.tensor(cfg.d_model**0.5, dtype=want.dtype)
        assert torch.equal(L.embedding_apply(state["params"]["embed"], batch["inputs"], cfg), want)
        logits, _ = model.train_logits(state["params"], batch["inputs"])
        mask = (labels != tsteps.IGNORE_INDEX).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.where(labels == tsteps.IGNORE_INDEX, 0, labels)[..., None])[..., 0]
        n = torch.clamp(mask.sum(), min=1.0)
        ce = ((logz - gold) * mask).sum() / n
        total = ce + tsteps.Z_LOSS_WEIGHT * ((logz * mask) ** 2).sum() / n
        got_total, got_ce = tsteps.cross_entropy(logits, labels)
        assert torch.equal(got_total, total) and torch.equal(got_ce, ce), arch
        runs[arch] = (model, cfg, opt, state, axes)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        mesh = _mk((1, 1), ("data", "model"), "cpu")
        for arch, (model, cfg, opt, state, axes) in runs.items():
            sh = tsteps.state_shardings(state, axes, mesh)
            dstate = tsteps.shard_state(tree.tree_map(torch.clone, state), sh)
            dbatch = tsteps.shard_state(batch, tsteps.batch_shardings(batch, mesh))
            emb = tsteps.on_mesh(L.embedding_apply, mesh)(dstate["params"]["embed"], dbatch["inputs"], cfg)
            assert torch.equal(emb.full_tensor(), L.embedding_apply(state["params"]["embed"], batch["inputs"], cfg))
            logits, _ = tsteps.on_mesh(model.train_logits, mesh)(dstate["params"], dbatch["inputs"])
            plain_logits, _ = model.train_logits(state["params"], batch["inputs"])
            assert torch.equal(logits.full_tensor(), plain_logits), arch
            got = tsteps.on_mesh(tsteps.cross_entropy, mesh)(logits, dbatch["labels"])
            assert all(torch.equal(a.full_tensor(), b) for a, b in zip(got, tsteps.cross_entropy(plain_logits, labels)))
            new, m = tsteps.make_sharded_train_step(model, cfg, opt, sh)(dstate, dbatch)
            plain, pm = tsteps.make_train_step(model, cfg, opt)(state, batch)
            assert torch.equal(m["loss"], pm["loss"]), arch
            for (path, a), (_, b) in zip(tree.flatten_with_path(new), tree.flatten_with_path(plain)):
                assert torch.equal(a.full_tensor(), b), (arch, path)
    finally:
        dist.destroy_process_group()


def test_dryrun_cli_all_reduced(background):
    """``--mesh single --reduced`` over every arch (two runs of the CLI, in
    parallel) exits 0 with a record per cell,
    each with its whole step's dot FLOPs and one device's share of them,
    its collectives (bytes and counts by type, and their total) and its
    temporary bytes; the recurrent archs' train and prefill cells from fits
    in the sequence length that ``fit_in_seq`` accepted."""
    tmp = background["dryrun"][0]
    for name in ("dryrun", "dryrun_rest"):
        rc, out, err = background[name][1].result()
        assert rc == 0, out[-3000:] + err[-3000:]
    n_cells = sum(len(tcfgs.applicable_shapes(tcfgs.get_config(a))) for a in tcfgs.ARCH_IDS)
    records = [json.loads(p.read_text()) for p in tmp.glob("*.json")]
    assert len(records) == n_cells
    assert all(r["global_dot_flops"] > 0 and r["memory"]["argument_size_in_bytes"] > 0 for r in records)
    for r in records:  # per device, every cell
        recurrent = tcfgs.get_config(r["arch"]).recurrent is not None and r["kind"] != "decode"
        assert 0 < r["dot_flops"] <= r["global_dot_flops"], r
        assert r["dot_flops_from"].startswith("seq fit") if recurrent else r["dot_flops_from"] == "run", r
        coll = r["collectives"]
        assert r["memory"]["temp_size_in_bytes"] > 0, r
        assert set(coll["bytes_by_type"]) == set(coll["counts"]) == set(dryrun.COLLECTIVES), r
        assert coll["total_bytes"] == sum(coll["bytes_by_type"].values()) > 0, r
