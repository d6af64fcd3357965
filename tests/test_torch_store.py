"""The port's copy of the two-level store (``repro_torch.core``) against the
JAX package's ``repro.core``.

Each copied module is the original with only ``repro.core`` read as
``repro_torch.core``, so both packages write the same bytes (stripes,
blocks, manifests, CRCs, leases, the peer protocol); the package exports
the reference's names; and files written through one package's store read
back through the other's.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore

ROOT = Path(__file__).resolve().parents[1]
MODULES = ("cluster", "iomodel", "layout", "tiers", "codec", "scrub", "sched", "arbiter", "store", "resilience",
           "dstore", "simulator")


@pytest.mark.parametrize("module", MODULES)
def test_store_module_copy_matches_reference(module):
    ref = (ROOT / "src" / "repro" / "core" / f"{module}.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "core" / f"{module}.py").read_text()
    assert port == ref.replace("repro.core", "repro_torch.core")


@pytest.mark.parametrize("path", ["runtime/failure.py", "runtime/straggler.py", "data/pipeline.py",
                                  "data/__init__.py", "configs/starcoder2_3b.py"])
def test_training_module_copy_matches_reference(path):
    """The training plane's copied modules: each equals its original with the
    package read as ``repro_torch`` (the corpus a store holds is then the same
    bytes whichever package wrote it)."""
    ref = (ROOT / "src" / "repro" / path).read_text()
    port = (ROOT / "src" / "repro_torch" / path).read_text()
    assert port == ref.replace("repro.", "repro_torch.")


@pytest.mark.parametrize("path", ["apps/__init__.py", "apps/shuffle.py", "apps/terasort.py", "apps/groupby.py"])
def test_apps_module_copy_matches_reference(path):
    """The data-analytics apps (the shuffle engine, TeraSort, group-by): each
    equals its original with the package read as ``repro_torch``, so both
    packages write and read the same records, spills and outputs."""
    ref = (ROOT / "src" / "repro" / path).read_text()
    port = (ROOT / "src" / "repro_torch" / path).read_text()
    assert port == ref.replace("repro.", "repro_torch.")


def test_store_copies_import_only_each_other():
    """The copies form a closed set: every module of the package that one of
    them imports is itself a copy."""
    imported = set()
    for module in MODULES:
        tree = ast.parse((ROOT / "src" / "repro_torch" / "core" / f"{module}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("repro_torch.core"):
                names = [node.module.split(".")[2]] if node.module.count(".") == 2 else [a.name for a in node.names]
                imported.update(names)
    assert imported and imported <= set(MODULES)


def test_port_exports_the_reference_names_but_the_distributed_store():
    """The port's ``repro_torch.core`` exports exactly the reference's names
    (the distributed store's among them, since it was copied), each from the
    copy of the module the reference's comes from."""
    assert set(tcore.__all__) == set(jcore.__all__)
    assert {"DistributedStore", "LeaseTable", "PeerUnreachable"} <= set(tcore.__all__)
    for name in tcore.__all__:
        assert getattr(tcore, name).__module__.replace("repro_torch.", "repro.") == getattr(jcore, name).__module__


def _store(pkg, root):
    return pkg.TwoLevelStore(str(root), mem_capacity_bytes=2 * 2**20, block_bytes=256 * 1024,
                             stripe_bytes=64 * 1024, n_pfs_servers=2)


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_files_written_by_one_package_read_back_in_the_other(tmp_path, writer):
    """A store at one root, closed, then opened by the other package's store:
    every file reads back bit-identical (small, one block, several blocks;
    write-through and async write-back)."""
    w_pkg, r_pkg = (jcore, tcore) if writer == "jax_package" else (tcore, jcore)
    rng = np.random.default_rng(3)
    files = {f"kv/f{n}": rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (10, 256 * 1024, 700_001)}
    with _store(w_pkg, tmp_path) as store:
        for i, (name, blob) in enumerate(files.items()):
            store.put(name, blob, mode=w_pkg.WriteMode.ASYNC_WRITEBACK if i % 2 else w_pkg.WriteMode.WRITE_THROUGH)
    with _store(r_pkg, tmp_path) as store:
        for name, blob in files.items():
            assert store.exists(name)
            assert store.get(name) == blob
