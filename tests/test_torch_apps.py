"""The port's data-analytics apps (``repro_torch.apps``: the shuffle engine,
TeraSort, group-by) and I/O model (``repro_torch.core.simulator``) against
the JAX package's, on the CPU at a few MB.

Both packages share byte layouts, so each step may run in either: TeraGen
by one package and TeraSort by the other give output shards equal byte for
byte to a run in one package, and both packages' TeraValidate pass them;
a group-by's aggregates read the same in both packages; the analytic
TeraSort and storage-mountain models give the same numbers (exact
equality: the same arithmetic in the same order).
"""

import dataclasses
from importlib import import_module

import numpy as np
import pytest

import repro.apps.groupby as jgroupby
import repro.core as jcore
import repro.core.simulator as jsim
import repro_torch.apps.groupby as tgroupby
import repro_torch.core as tcore
import repro_torch.core.simulator as tsim

# The modules (each package's ``apps`` exports a function of the same name).
jterasort, tterasort = import_module("repro.apps.terasort"), import_module("repro_torch.apps.terasort")

MB = 2**20
RECORDS = 40_000  # 4 MB of TeraSort records
PACKAGES = {"jax_package": (jcore, jterasort, jgroupby), "port": (tcore, tterasort, tgroupby)}


def store(core, root):
    return core.TwoLevelStore(str(root / "pfs"), mem_capacity_bytes=2 * MB, block_bytes=256 * 1024,
                              stripe_bytes=64 * 1024, n_pfs_servers=2)


def outputs(core, root, name, n: int) -> list[bytes]:
    with store(core, root) as st:
        return [st.get(name(r)) for r in range(n)]


def sort_run(root, gen: str, sort: str) -> list[bytes]:
    """TeraGen by package ``gen``, TeraSort by package ``sort`` (each on the
    store closed by the step before), TeraValidate by both; the output
    shards' bytes."""
    gcore, gts, _ = PACKAGES[gen]
    score, sts, _ = PACKAGES[sort]
    with store(gcore, root) as st:
        gts.teragen(st, RECORDS, n_shards=4, write_mode=gcore.WriteMode.WRITE_THROUGH, seed=7)
    with store(score, root) as st:
        t = sts.terasort(st, n_shards=4, n_reducers=4, read_mode=score.ReadMode.TIERED,
                         write_mode=score.WriteMode.WRITE_THROUGH, memory_budget_bytes=1 * MB)
    assert t.records == RECORDS and t.spill_files > 0  # the out-of-core path ran
    for core, ts, _ in PACKAGES.values():
        with store(core, root) as st:
            assert ts.teravalidate(st, 4)
    return outputs(jcore, root, jterasort._out_name, 4)


def test_terasort_crosses_packages_byte_for_byte(tmp_path):
    """TeraGen by either package sorted by the other: the output shards
    equal those of a run in the JAX package alone, byte for byte, in both
    directions, and hold every generated record in key order."""
    want = sort_run(tmp_path / "ref", "jax_package", "jax_package")
    for gen, sort in (("jax_package", "port"), ("port", "jax_package")):
        assert sort_run(tmp_path / f"{gen}_{sort}", gen, sort) == want, (gen, sort)
    got = np.frombuffer(b"".join(want), dtype=np.uint8).reshape(-1, jterasort.RECORD)
    gen = np.concatenate([np.random.default_rng(7 + i).integers(0, 256, size=(RECORDS // 4, jterasort.RECORD),
                                                                dtype=np.uint8) for i in range(4)])
    keys = jterasort._record_keys(gen)
    assert (jterasort._record_keys(got) == np.sort(keys)).all()


@pytest.mark.parametrize("gen", ["jax_package", "port"])
def test_groupby_aggregates_read_equal_across_packages(tmp_path, gen):
    """Group-by records generated by one package and summed by the other:
    both packages read the same aggregates, equal to those of a run in the
    JAX package alone and to numpy's sums over the generated records."""
    def run(root, gen_pkg, agg_pkg):
        gcore, _, ggb = PACKAGES[gen_pkg]
        acore, _, agb = PACKAGES[agg_pkg]
        with store(gcore, root) as st:
            ggb.groupgen(st, 20_000, n_groups=300, n_shards=4, write_mode=gcore.WriteMode.WRITE_THROUGH, seed=3)
        with store(acore, root) as st:
            res = agb.groupby_sum(st, n_shards=4, n_reducers=4, write_mode=acore.WriteMode.WRITE_THROUGH,
                                  memory_budget_bytes=256 * 1024)
        reads = []
        for core, _, gb in PACKAGES.values():
            with store(core, root) as st:
                reads.append(gb.read_aggregates(st, 4))
        assert reads[0] == reads[1] and len(reads[0]) == res.groups
        return reads[0]

    other = "port" if gen == "jax_package" else "jax_package"
    got = run(tmp_path / "cross", gen, other)
    assert got == run(tmp_path / "ref", "jax_package", "jax_package")
    with store(jcore, tmp_path / "cross") as st:
        recs = np.frombuffer(b"".join(st.get(jgroupby._shard_name(i)) for i in range(4)),
                             dtype=np.uint8).reshape(-1, jgroupby.RECORD)
    keys = recs[:, :8].astype(np.uint64) @ jgroupby._BE64
    vals = jgroupby._values_of(recs)
    want: dict[int, tuple[int, int]] = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        s, c = want.get(k, (0, 0))
        want[k] = (s + v, c + 1)
    assert got == want


@pytest.mark.parametrize("cluster", ["palmetto_cluster", "paper_average_cluster"])
def test_simulator_models_equal_the_reference(cluster):
    """``terasort_report``, ``reduce_scaling`` and the storage mountain of
    both packages on the paper's cluster specs: the same numbers."""
    jspec, tspec = getattr(jcore, cluster)(), getattr(tcore, cluster)()
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    jrep, trep = jsim.terasort_report(jspec), tsim.terasort_report(tspec)
    assert {k: dataclasses.asdict(v) for k, v in jrep.items()} == {k: dataclasses.asdict(v) for k, v in trep.items()}
    assert jsim.reduce_scaling(jspec, [2, 4, 12]) == tsim.reduce_scaling(tspec, [2, 4, 12])
    jm = jsim.storage_mountain(jspec)
    assert jm == tsim.storage_mountain(tspec)
    assert jsim.mountain_summary(jm) == tsim.mountain_summary(tsim.storage_mountain(tspec))
