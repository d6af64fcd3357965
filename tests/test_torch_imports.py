"""The PyTorch port stands alone: neither ``chip_smoke.py``, ``mlstm_card.py``
nor any module under ``src/repro_torch/`` imports ``jax`` or anything of the
JAX package ``repro`` (checked on the source, so lazy imports inside
functions count)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "mlstm_card.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_checker_sees_lazy_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    import jax.numpy as jnp\n    from repro.core import store\n"
                   "    importlib.import_module('repro.nn')\n")
    assert imported_roots(src) == {"jax", "repro"}
    assert len(FILES) > 10
