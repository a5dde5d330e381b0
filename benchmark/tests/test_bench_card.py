"""On the card: one short run of every cell through the command the
driver runs, each correct. Skips without a CUDA device."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from .conftest import need_card

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    need_card()
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2**31 + 77),
                        "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
