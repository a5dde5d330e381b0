"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of a checkout. Tests marked ``card`` need a CUDA device and skip
without one; each decides inside the test, never at import."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def configuration(name: str):
    """(the reference module that configuration ``name``'s file names, as
    the harness resolves it; the file's config)."""
    from benchmark.harness.cell import reference

    cfile = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    return reference(name, cfile), cfile["config"]


def tiny(cfg: dict) -> dict:
    """A configuration cut to a size the CPU runs in seconds (widths kept)."""
    cfg["DATA"]["IMG_SIZE"] = [3, 64, 112]
    cfg["MODEL"]["BEV_SIZE"] = [32, 24, 72]
    return cfg
