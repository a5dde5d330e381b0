"""The plain references hold to the port at tiny shapes on the CPU (the
port's plain kernel versions run there): the serving forward of every
configuration, each against the reference its file names, and the first
training calls, all in float32."""

import pytest
import torch

from benchmark.harness.inputs import FrameSets, calibrate, make_weights
from benchmark.harness.judge import training_numbers
from benchmark.reference.train import kinds_of, steps

from .conftest import configuration, tiny


def config(name, amp=False):
    ref, cfg = configuration(name)
    cfg = tiny(cfg)
    cfg["RUNTIME"]["USE_AMP"] = amp
    return ref, cfg


@pytest.mark.parametrize("name", ["wildtrack", "wildtrack_deform", "wildtrack_v1_resnet50"])
def test_serving_forward_matches_the_port(name):
    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.serving import build_serving_fn

    reference, cfg = config(name)
    w = make_weights(reference, cfg, 2**31 + 3, "cpu")
    b = FrameSets(cfg, 3, 11, "cpu").batch([0, 1, 2])
    out = build_serving_fn(from_dict(cfg), w, device="cpu")(b["images"], b["K"], b["Rt"])
    ref = reference.Reference(cfg, w)(*(torch.as_tensor(b[k]) for k in ("images", "K", "Rt")))
    assert float((out["heatmap"] - ref["heatmap"]).abs().max()) < 1e-5


def test_training_calls_match_the_port():
    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.training.state import create_state, make_train_step

    reference, cfg = config("wildtrack")
    w = make_weights(reference, cfg, 5, "cpu")
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
    ref = steps(reference, cfg, w, kinds_of(reference, cfg), [{k: torch.as_tensor(v) for k, v in b.items()}
                                                              for b in batches], 180)
    got = training_numbers({"losses": losses, "grad": grad, "update": update}, ref)
    assert got["loss_gap"] < 1e-3 and got["grad_gap"] < 1e-2 and got["update_gap"] < 1e-2, got
    assert got["leaves_kept"] > 50


@pytest.mark.parametrize("variant,level", [("resnet18", 3), ("resnet34", 1), ("resnet50", 2), ("resnet101", 0)])
def test_resnet_variants_match_the_port(variant, level):
    """Every ResNet the reference builds lists the port's state dict, names
    and shapes, and its serving forward holds to the port's at another
    pyramid level than the configuration's."""
    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.models.bevnet import BEVNet
    from vsta_tpu_torch.serving import build_serving_fn

    reference, cfg = config("wildtrack_v1_resnet50")
    cfg["MODEL"].update({"BACKBONE": variant, "OUT_INDEX": level})
    specs = reference.param_specs(dict(cfg["MODEL"], VIEWS=cfg["DATA"]["VIEWS"]))
    port = BEVNet.from_config(from_dict(cfg)).state_dict()
    assert {n: tuple(s) for n, s, _ in specs} == {n: tuple(t.shape) for n, t in port.items()}
    w = make_weights(reference, cfg, 2**31 + 7, "cpu")
    b = FrameSets(cfg, 2, 13, "cpu").batch([0, 1])
    out = build_serving_fn(from_dict(cfg), w, device="cpu")(b["images"], b["K"], b["Rt"])
    ref = reference.Reference(cfg, w)(*(torch.as_tensor(b[k]) for k in ("images", "K", "Rt")))
    assert float((out["heatmap"] - ref["heatmap"]).abs().max()) < 1e-5


def test_resnet_batch_stats_normalise_in_eval_mode():
    """Calibration on the ResNet reference: once every BatchNorm's running
    statistics are the frame set's batch statistics, the eval-mode trunk on
    that frame set reads as the train-mode one, and its 24 norms up to C3
    (the stem's, stage 0's 10 and stage 1's 13) are all that it records."""
    reference, cfg = config("wildtrack_v1_resnet50")
    w = make_weights(reference, cfg, 2**31 + 5, "cpu")
    frame_set = FrameSets(cfg, 2, 7, "cpu")[0]
    calibrate(reference, cfg, w, frame_set, "cpu")
    ref = reference.Reference(cfg, w)
    images = torch.as_tensor(frame_set["images"])
    assert len(ref.batch_stats(images)) == 24
    x = reference.normalise(images)
    train, evaluated = ref.trunk(True)(x), ref.trunk(False)(x)
    assert float((train - evaluated).abs().max()) < 1e-3 * float(train.abs().max())


def test_resnet_reference_refuses_group_norm():
    reference, cfg = config("wildtrack_v1_resnet50")
    cfg["MODEL"]["NORM"] = "group"
    with pytest.raises(ValueError, match="NORM"):
        reference.param_specs(dict(cfg["MODEL"], VIEWS=7))
    with pytest.raises(ValueError, match="NORM"):
        reference.Reference(cfg, {})
