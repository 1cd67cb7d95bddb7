"""The port imports nothing of JAX nor of the JAX package: every module
under ``src/repro_torch/`` and ``chip_smoke.py`` is parsed (not imported)
and its import statements checked."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "src" / "repro_torch").rglob("*.py")) \
    + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    """Top-level package of every import in ``tree`` (absolute imports;
    a relative import stays inside its own package)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_port_has_modules_to_check():
    assert len(FILES) > 20 and "src/repro_torch/kernels/ops.py" in FILES


@pytest.mark.parametrize("path", FILES)
def test_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = sorted(set(_imported(tree)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"
