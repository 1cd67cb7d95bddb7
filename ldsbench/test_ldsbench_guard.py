"""The run's checks of what it loads and where it may run: top-level module
names compared whole; the reference importing nothing of the program or
of JAX; no result without a card or without the program."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ldsbench import guard

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.serving.engine", "torch", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.models.model"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "reproducible", "repro_torchx"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, bad):
    assert guard.forbidden_modules(names) == bad


def imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("sub", ["reference", "families"])
def test_reference_and_weights_import_nothing_of_the_program(sub):
    for path in sorted((HERE / sub).glob("*.py")):
        roots = imported_roots(path)
        assert not roots & {"repro_torch", "repro", "jax", "jaxlib",
                            "flax", "benchmarks"}, path


def test_nothing_in_the_harness_imports_jax_or_the_old_benchmarks():
    for path in sorted(HERE.rglob("*.py")):
        roots = imported_roots(path)
        assert not roots & {"repro", "jax", "jaxlib", "flax",
                            "benchmarks"}, path


def run_cli(cwd: Path, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "ldsbench/run.py", "--workload", "granite-8b.chat",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_no_result_without_a_card():
    res = run_cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    if res.returncode == 0:
        pytest.skip("a CUDA card is visible")
    assert res.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "ldsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    res = run_cli(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_benchmark_file_names_only_its_own_paths():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["paths"] == ["ldsbench"]
    for conf in spec["configs"]:
        assert conf["file"].startswith("ldsbench/")
        assert (ROOT / conf["file"]).exists()
    for cell in spec["workloads"]:
        assert (HERE / "traffic" / f"{cell['traffic']}.json").exists()
        assert (HERE / "limits" / f"{cell['name']}.json").exists()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
