"""Nothing the benchmark runs imports the JAX stack or the JAX package, or
reads the repository's older benchmarks, smoke script or tests."""

import ast
from pathlib import Path

import pytest

from portbench import core

SOURCES = sorted(p for p in core.HERE.rglob("*.py") if "tests" not in p.relative_to(core.HERE).parts)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _literals(path: Path):
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(core.HERE)))
def test_no_forbidden_import(path):
    for name in _imports(path):
        assert name.split(".")[0] not in core.FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(core.HERE)))
def test_reads_no_older_benchmark(path):
    for s in _literals(path):
        assert not any(x in s for x in ("chip_smoke", "benches", "bench.py", "tests/")), f"{path}: {s!r}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((core.HERE / "reference").glob("*.py")):
        for name in _imports(path):
            assert not name.startswith("pyisingmontecarlo"), f"{path} imports {name}"


def test_top_level_names_compared_whole():
    assert core.forbidden_modules(["pyisingmontecarlo_tpu_torch", "pyisingmontecarlo_tpu_torch.ops", "jaxtyping"]) == []
    assert core.forbidden_modules(["jax.numpy", "pyisingmontecarlo_tpu.ops", "flax"]) == [
        "flax", "jax", "pyisingmontecarlo_tpu"]


def test_found_by_name_only():
    """Every driver and metric the benchmark names is a file of its own under portbench/."""
    for m in core.benchmark()["per_layer"]:
        assert (core.HERE / "metrics" / f"{m['name']}.py").is_file()
