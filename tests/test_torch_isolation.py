"""vsta_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points do not quietly run on the CPU when a CUDA
device is asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "vsta_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vsta_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({n for n in _imported_names(tree) if n.split(".")[0] in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every port module imports in a process where importing jax or
    vsta_tpu fails."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'flax', 'optax', 'vsta_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {_port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_cuda_entry_point_raises_without_a_card(monkeypatch):
    from vsta_tpu_torch import config
    from vsta_tpu_torch.serving import build_serving_fn
    from vsta_tpu_torch.training.state import create_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.from_dict({"MODEL": {"BACKBONE": "efficientnet_b0", "WARP_IMPL": "pallas"}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serving_fn(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serving_fn(cfg, {}, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_state(cfg, {}, steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_state(cfg, device="cuda", steps_per_epoch=1)


def test_loop_and_prefetcher_raise_without_a_card(monkeypatch, tmp_path):
    """RUNTIME.DEVICE other than cpu names the CUDA device: the loop and a
    CUDA Prefetcher raise where there is none; cpu stays on the CPU."""
    from vsta_tpu_torch import config
    from vsta_tpu_torch.data.pipeline import DevicePut, Prefetcher
    from vsta_tpu_torch.training.loop import run_training
    from vsta_tpu_torch.utils.platform import runtime_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.from_dict({"RUNTIME": {"DEVICE": "tpu"}, "DATA": {"DATA_ROOT": str(tmp_path / "none")}})
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_training(cfg, work_dir=str(tmp_path), device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prefetcher([], [], 1, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePut("cuda:0")
    for name in ("tpu", "gpu", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime_device(name)
    assert runtime_device("cpu") == runtime_device("CPU") == torch.device("cpu")
    assert not list(tmp_path.iterdir())  # nothing was written before the raise


@pytest.mark.parametrize("cli", ["train", "evaluate", "inference"])
def test_clis_raise_without_a_card(cli, tmp_path):
    """``python -m vsta_tpu_torch.<cli>`` with RUNTIME.DEVICE tpu exits
    non-zero here, where no CUDA device exists."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f'RUNTIME: {{DEVICE: "tpu"}}\nDATA: {{DATA_ROOT: "{tmp_path / "none"}"}}\n')
    res = subprocess.run(
        [sys.executable, "-m", f"vsta_tpu_torch.{cli}", "--config", str(cfg)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0 and "no CUDA device" in res.stderr, res.stderr[-2000:]
