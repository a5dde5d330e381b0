"""The plain reference holds to the port at tiny shapes on the CPU (the
port's plain kernel versions run there): the serving forward of both
configurations, and the first training calls, all in float32."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.harness.inputs import FrameSets, make_weights
from benchmark.harness.judge import training_numbers
from benchmark.reference.model import Reference
from benchmark.reference.train import kinds_of, steps

from .conftest import tiny

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name, amp=False):
    cfg = tiny(json.loads((CONFIGS / f"{name}.json").read_text())["config"])
    cfg["RUNTIME"]["USE_AMP"] = amp
    return cfg


@pytest.mark.parametrize("name", ["wildtrack", "wildtrack_deform"])
def test_serving_forward_matches_the_port(name):
    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.serving import build_serving_fn

    cfg = config(name)
    w = make_weights(cfg, 2**31 + 3, "cpu")
    b = FrameSets(cfg, 3, 11, "cpu").batch([0, 1, 2])
    out = build_serving_fn(from_dict(cfg), w, device="cpu")(b["images"], b["K"], b["Rt"])
    ref = Reference(cfg, w)(*(torch.as_tensor(b[k]) for k in ("images", "K", "Rt")))
    assert float((out["heatmap"] - ref["heatmap"]).abs().max()) < 1e-5


def test_training_calls_match_the_port():
    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.training.state import create_state, make_train_step

    cfg = config("wildtrack")
    w = make_weights(cfg, 5, "cpu")
    ds = FrameSets(cfg, 6, 5, "cpu")
    pc = from_dict(cfg)
    state = create_state(pc, state_dict=w, device="cpu", steps_per_epoch=180)
    step = make_train_step(pc)
    start = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    batches = [ds.batch([2 * i, 2 * i + 1]) for i in range(3)]
    losses, grad = [], None
    for i, b in enumerate(batches):
        losses.append(float(step(state, b)["total_loss"]))
        if i == 0:
            grad = {k: v.clone() for k, v in state.opt_state.acc.items()}
    update = {k: p.detach() - start[k] for k, p in state.model.named_parameters()}
    ref = steps(cfg, w, kinds_of(cfg), [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches], 180)
    got = training_numbers({"losses": losses, "grad": grad, "update": update}, ref)
    assert got["loss_gap"] < 1e-3 and got["grad_gap"] < 1e-2 and got["update_gap"] < 1e-2, got
    assert got["leaves_kept"] > 50
