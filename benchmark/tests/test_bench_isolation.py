"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference and the counts import nothing of the program: each import's
top-level name compared whole (``vsta_tpu_torch`` begins with
``vsta_tpu``)."""

import ast
import json
import sys
from pathlib import Path

import pytest

from benchmark.harness.main import FORBIDDEN, loaded_forbidden

BENCH = Path(__file__).resolve().parents[1]
PROGRAM = "vsta_tpu_torch"


def top_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(top_names(path)).intersection(FORBIDDEN)


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_reference_and_counts_stand_apart_from_the_program(sub):
    for path in (BENCH / sub).rglob("*.py"):
        assert PROGRAM not in set(top_names(path)), path


def imported_modules(path: Path):
    """Every module an import of ``path`` names, relative ones resolved
    against the package of ``path`` under ``benchmark``."""
    tree = ast.parse(path.read_text())
    package = ["benchmark", *path.relative_to(BENCH).parts[:-1]]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


REFERENCES = sorted({json.loads(p.read_text())["reference"] for p in (BENCH / "configs").glob("*.json")})
GENERAL = sorted(p for sub in ("harness", "counts", "drivers") for p in (BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", GENERAL, ids=lambda p: str(p.relative_to(BENCH)))
def test_harness_names_no_reference_module(path):
    """What serves every configuration imports no configuration's reference
    module, nor names one: ``cell.find`` resolves it from the
    configuration's file."""
    named = {f"benchmark.reference.{r}" for r in REFERENCES}
    assert not named.intersection(imported_modules(path)), path
    assert not any(f"reference/{r}.py" in path.read_text() for r in REFERENCES), path


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "vsta_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert "vsta_tpu" not in loaded_forbidden() and "jax" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "vsta_tpu.ops", sys)
    assert "vsta_tpu" in loaded_forbidden()
