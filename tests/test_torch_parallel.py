"""vsta_tpu_torch.parallel: the ('data', 'view') mesh on torch.distributed,
the twin of tests/test_multichip.py, on the CPU with gloo.

One world of 4 ranks is spawned for the module (this file run as a
script, one process a rank, ``torch.set_num_threads(1)`` in each): every
case runs in it, and each rank writes its numpy results for the parent to
read. The parent computes the references from the same weights (random
numpy values on JAX's variable tree, moved through convert.py): the
port's single-device run, on one thread as the ranks (oneDNN splits a
convolution's sums by the thread count: at default threads the bf16
cases' one device lay 3.1e-5 and 4.4e-5 from itself on one thread), and
JAX's ``make_mesh(1, 1)`` first loss.

Model: the JAX test's tiny config (``simple`` backbone, FEAT_DIM 8, BEV
16x32) at batch 4 and 4 views of 32x48, so that both axes split; ms_max
is ResNet-18 with OUT_INDEX (1, 2) and ``max``, as JAX's. Two train
steps a case.
Boxes differ from frame to frame, so the loss's normalisers differ from
shard to shard.

The bf16 cases on a 1x2 mesh (ranks 0 and 1), one step each: ms_max and
concat under WARP_IMPL pallas with USE_AMP, each against the port's
single-device step, held within a limit taken from JAX's own 1x2 mesh
against its 1x1 (test_bf16_view_mesh_holds_to_jax_mesh,
test_bf16_pallas_view_mesh_holds_to_jax_mesh). On the same mesh, the
f32 concat step's encoder calls and its gradients before the mesh's sum
(test_view_ranks_encode_every_view).

Last, every rank drives the entry points on a 2x2 mesh over a synthetic
tree (10 frames, 2 views): ``run_training`` (2 steps and an eval), then
``python -m vsta_tpu_torch.evaluate --split all`` and ``.inference
--track`` on rank 0's checkpoint. The parent runs the same on one device.

Tolerances: the losses at rtol 2e-4, as JAX's multi-device tests hold
theirs: every call's against the port's single-device run, the first
call's against JAX's. (After the first update the port's and JAX's runs
part where Adam's first step, about lr times the sign of the gradient,
meets an element whose gradient differs between the two: from JAX's own
initial weights, attn's second loss lay 4.3e-4 from JAX's.) The first
call's gradients per parameter within 1e-3 of its norm (floored at 1e-2
of the largest norm), and the global norm within 1e-4 of one device's: a
sharded step sums in another order (the view sum crosses ranks, the
BatchNorm and loss sums are split), and a ReLU or max-pool input within
rounding of its kink moves single elements by far more than rounding
(the known divergence of tests/test_torch_resnet_train.py: the element
by element tolerance of tests/test_torch_train.py fails on one element
of 1,152 at 32x48), where the trap (gradients n_view times or 1/n_data
of one device's) would move every parameter by 0.5 or more. The
parameters and statistics of every rank bit for bit against rank 0's; a
world of one bit for bit against the single-device step; the int8
head's eval 1e-5 absolute, as JAX's test.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.data.synthetic import generate_synthetic_wildtrack, make_ring_camera
from vsta_tpu_torch.parallel import ACTIVE, get_active_mesh, init_distributed, make_mesh, shard_batch
from vsta_tpu_torch.parallel.collectives import gather
from vsta_tpu_torch.parallel.mesh import Mesh
from vsta_tpu_torch.training.loop import run_training
from vsta_tpu_torch.training.state import create_state, make_eval_step, make_train_step

if __name__ != "__main__":  # the rank processes compile nothing of JAX
    from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


WORLD = 4
B, V, H, W = 4, 4, 32, 48
SPE = 10  # steps per epoch of the optimizer's schedule
BF16_MESH = (1, 2)  # the bf16 cases' mesh: the views split over two ranks
# the bf16 cases' limits on the gradient distance to one device's, from
# JAX's own 1x2 mesh against its 1x1 at these weights (4.7e-9 for ms_max):
# ms_max, whose program splits no sum over 'view', at 10 times JAX's
# reading; pallas, whose warp sums its views over 'view' in both
# packages, at twice it; each floored at 1e-7
BF16_MESH_FACTOR = {"ms_max-bf16": 10.0, "pallas-bf16": 2.0}
BF16_MESH_FLOOR = 1e-7

# config name -> MODEL fields over the tiny config, image size, steps[,
# RUNTIME fields]
CONFIGS = {
    "concat": ({}, (H, W), 2),
    "pallas": ({"WARP_IMPL": "pallas"}, (H, W), 2),
    "attn": ({"FUSION": "attn", "WARP_IMPL": "gather"}, (H, W), 2),
    "deform_attn": ({"FUSION": "deform_attn", "ATTN_HEADS": 2, "ATTN_POINTS": 2, "ATTN_STRIDE": 2}, (H, W), 2),
    "ms_max": ({"BACKBONE": "resnet18", "FUSION": "max", "OUT_INDEX": [1, 2], "WARP_IMPL": "gather"}, (H, W), 2),
    "ms_max-bf16": ({"BACKBONE": "resnet18", "FUSION": "max", "OUT_INDEX": [1, 2], "WARP_IMPL": "gather"}, (H, W), 1,
                    {"USE_AMP": True}),
    "pallas-bf16": ({"WARP_IMPL": "pallas"}, (H, W), 1, {"USE_AMP": True}),
}
# on the CPU JAX runs WARP_IMPL pallas as the XLA warp, the function of
# fused: one JAX run (and its weights) serves both
JAX_TWIN = {"pallas": "concat", "ms_max-bf16": "ms_max", "pallas-bf16": "concat"}
# case -> (config, mesh): each twin of tests/test_multichip.py
CASES = {
    "data-parallel-4x1": ("concat", (4, 1)),
    "data-view-2x2": ("concat", (2, 2)),
    "pallas-4x1": ("pallas", (4, 1)),
    "pallas-2x2": ("pallas", (2, 2)),
    "attn-4x1": ("attn", (4, 1)),
    "deform_attn-4x1": ("deform_attn", (4, 1)),
    "deform_attn-2x2": ("deform_attn", (2, 2)),
    "ms_max-2x2": ("ms_max", (2, 2)),
}


def raw_config(name):
    model, (h, w) = CONFIGS[name][:2]
    runtime = CONFIGS[name][3] if len(CONFIGS[name]) > 3 else {}
    return {
        "DATA": {"BATCH_SIZE": B, "IMG_SIZE": [3, h, w], "VIEWS": V},
        "MODEL": {
            "BACKBONE": "simple", "FEAT_DIM": 8, "OUT_INDEX": 2, "BEV_SIZE": [32, 16, 32],
            "BEV_BOUNDS": [-8.0, 8.0, -4.0, 4.0], "BEV_PROJ_CH": 12, "WARP_IMPL": "fused", "FUSION": "concat",
            **model,
        },
        "TRAIN": {"EPOCHS": 2, "LR": 1e-3, "ACCUM_STEPS": 1},
        "LOSS": {"MAX_OBJECTS": 8},
        "RUNTIME": {"USE_AMP": False, "DEVICE": "cpu", **runtime},
    }


def host_batch(name, seed=0):
    """Frames, ring cameras and 1-4 boxes a frame, as numpy."""
    h, w = CONFIGS[name][1]
    rng = np.random.default_rng(seed)
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=(h, w)) for v in range(V)))
    boxes = np.zeros((B, 8, 4), np.float32)
    boxes[..., 0] = rng.uniform(-7.0, 7.0, (B, 8))
    boxes[..., 1] = rng.uniform(-3.5, 3.5, (B, 8))
    boxes[..., 2:] = 0.6
    return {
        "images": rng.standard_normal((B, V, h, w, 3)).astype(np.float32),
        "K": np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32).copy(),
        "Rt": np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32).copy(),
        "boxes_world": boxes,
        "num_boxes": np.array([1, 4, 2, 3], np.int32),
        "frame_idx": np.arange(B, dtype=np.int32),
        "batch_mask": np.ones(B, bool),
    }


def run_port(name, state_dict, mesh=None):
    """The config's steps through the port: losses, the first call's
    gradients and the final state dict, as numpy."""
    cfg = tcfg.from_dict(raw_config(name))
    state = create_state(cfg, state_dict, device="cpu", steps_per_epoch=SPE, mesh=mesh)
    hb = host_batch(name)
    batch = hb if mesh is None else shard_batch(hb, mesh, "cpu")
    grads, update = {}, state.tx.update

    def spy(opt_state, model, g):
        if not grads:
            grads.update({k: v.detach().numpy().copy() for k, v in g.items()})
        return update(opt_state, model, g)

    state.tx.update = spy
    step = make_train_step(cfg)
    losses = [float(step(state, batch)["total_loss"]) for _ in range(CONFIGS[name][2])]
    return {
        "losses": np.array(losses),
        "grads": grads,
        "state": {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()},
    }


def encoder_probe(name, state_dict, mesh):
    """One train step of ``name`` on ``mesh``: the [B, V] of the images of
    each of the encoder's calls, and this rank's gradients as the step
    hands them to the mesh's sum (``all_reduce_gradients``), as numpy."""
    from vsta_tpu_torch.training import state as tstate

    cfg = tcfg.from_dict(raw_config(name))
    state = create_state(cfg, state_dict, device="cpu", steps_per_epoch=SPE, mesh=mesh)
    seen, before = [], {}
    state.model.encoder.register_forward_pre_hook(lambda mod, args: seen.append(tuple(args[0].shape[:2])))
    reduce = tstate.all_reduce_gradients

    def spy(grads, m):
        before.update({k: v.detach().numpy().copy() for k, v in grads.items()})
        return reduce(grads, m)

    tstate.all_reduce_gradients = spy
    try:
        make_train_step(cfg)(state, shard_batch(host_batch(name), mesh, "cpu"))
    finally:
        tstate.all_reduce_gradients = reduce
    return {"seen": seen, "before": before}


# the entry points on a synthetic tree: run_training, .evaluate, .inference
LOOP_FRAMES = 10
LOOP_MESH = (2, 2)
# no heatmap score of the single-device run's trained model, over the 10
# frames, lies within 1e-3 of it: the mesh's rounding cannot cross it
LOOP_CONF = 0.35


def loop_raw(tree, out, mesh):
    """The tiny loop config of tests/test_torch_loop.py over ``tree``,
    writing under ``out``, on a ``mesh`` of (MESH_DATA, MESH_VIEW)."""
    return {
        "DATA": {"BATCH_SIZE": 2, "IMG_SIZE": [3, 54, 96], "VIEWS": 2, "DATA_ROOT": str(tree)},
        "MODEL": {"BACKBONE": "simple", "FEAT_DIM": 8, "OUT_INDEX": 1, "BEV_SIZE": [32, 12, 24],
                  "BEV_BOUNDS": [-12.0, 12.0, -6.0, 6.0], "BEV_PROJ_CH": 8},
        "TRAIN": {"EPOCHS": 1, "LR": 0.001},
        "LOSS": {"MAX_OBJECTS": 8},
        "RUNTIME": {"DEVICE": "cpu", "NUM_WORKERS": 1, "SAVE_DIR": str(out / "ckpt"), "OUTPUT_DIR": str(out / "pred"),
                    "USE_AMP": False, "DEBUG_MAX_STEPS": 2, "MESH_DATA": mesh[0], "MESH_VIEW": mesh[1]},
        "EVAL": {"CONF_THRESH": LOOP_CONF, "NMS_DIST_M": 0.5, "INTERVAL": 1, "MAX_DETS": 16},
    }


def _losses(save_dir):
    recs = [json.loads(s) for s in (save_dir / "scalars.jsonl").read_text().splitlines()]
    return [r["value"] for r in recs if r["tag"] == "train/loss_iter"]


def entry_points(tree, out, mesh, checkpoint=None):
    """``run_training`` (unless ``checkpoint`` is given), then ``python -m
    vsta_tpu_torch.evaluate --split all`` and ``.inference --track`` on
    ``checkpoint`` (else on rank 0's ``last``), in this process. Returns
    the loop's metrics, each CLI's standard output and the files written
    under ``out``."""
    import contextlib
    import io

    import yaml

    from vsta_tpu_torch import evaluate, inference
    from vsta_tpu_torch.training.loop import run_training

    out.mkdir(parents=True, exist_ok=True)
    raw = loop_raw(tree, out, mesh)
    rec = {}
    if checkpoint is None:
        rec["train"] = run_training(tcfg.from_dict(raw), work_dir=str(out))
        if torch.distributed.is_initialized():
            torch.distributed.barrier()  # rank 0 has written its checkpoints
        checkpoint = out.parent / "entry0" / "ckpt" / "last"
    cfg_path = out.parent / f"{out.name}.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    argv = sys.argv
    for name, module, extra in (("evaluate", evaluate, ["--split", "all"]), ("inference", inference, ["--track"])):
        sys.argv = [name, "--config", str(cfg_path), "--checkpoint", str(checkpoint), *extra]
        try:
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                module.main()
        finally:
            sys.argv = argv
        rec[name] = buf.getvalue()
    rec["files"] = sorted(f.relative_to(out).as_posix() for f in out.rglob("*") if f.is_file())
    rec["predictions"] = {f.name: f.read_text() for f in sorted((out / "pred").glob("frame_*.json"))}
    return rec


# -- the ranks -------------------------------------------------------------


def _rank_main(outdir: Path) -> None:
    torch.set_num_threads(1)
    init_distributed("cpu")
    rank = torch.distributed.get_rank()
    rec = {"rank": rank}
    weights = pickle.loads((outdir / "weights.pkl").read_bytes())

    # mesh shapes, coordinates and the clamps, as tests/test_multichip.py
    shapes = {}
    for label, args, kw in (
        ("4x1", (4, 1), {}), ("2x2", (2, 2), {}), ("0x1", (0, 1), {}), ("0x2", (0, 2), {}), ("1x1", (1, 1), {}),
        ("clamp-batch2", (0, 1), {"batch_size": 2}), ("clamp-batch3", (0, 1), {"batch_size": 3}),
        ("clamp-views3", (2, 2), {"batch_size": 4, "views": 3}),
        ("clamp-batch2-views4", (4, 1), {"batch_size": 2, "views": 4}),
        ("divisible", (2, 2), {"batch_size": 8, "views": 4}),
    ):
        m = make_mesh(*args, **kw)
        shapes[label] = (m.shape, m.member, m.data_index, m.view_index)
    rec["shapes"] = shapes
    try:
        make_mesh(4, 2)
    except ValueError as e:
        rec["too_large"] = str(e)

    # the opt-in registry
    from vsta_tpu_torch.models import BEVNet

    cfg = tcfg.from_dict(raw_config("concat"))
    reg = [get_active_mesh() is None]
    m = make_mesh(2, 2)
    reg.append(get_active_mesh() is None)
    reg += [BEVNet.from_config(cfg).mesh is None, BEVNet.from_config(cfg, mesh=m).mesh is m]
    r = make_mesh(2, 2, register=True)
    reg += [get_active_mesh() is r, BEVNet.from_config(cfg, mesh=ACTIVE).mesh is r, BEVNet.from_config(cfg).mesh is None]
    rec["registry"] = reg

    # the exact gather: -0.0, infinities and NaN payloads come back bit for bit
    m = make_mesh(4, 1)
    special = torch.tensor([-0.0, 0.0, float("inf"), -float("inf"), float("nan"), 1e-45, -3.5, rank + 0.25])
    special = torch.cat([special, special.view(torch.int32).add(rank).view(torch.float32)[4:5]])
    rec["gathered"] = {
        str(dt): gather(special.to(dt), m, "data", 0).view(torch.uint8 if dt == torch.bfloat16 else torch.int32).numpy()
        for dt in (torch.float32, torch.bfloat16)
    }
    rec["special"] = special.view(torch.int32).numpy()

    # the train cases
    rec["cases"] = {}
    for case, (name, (nd, nv)) in CASES.items():
        mesh = make_mesh(nd, nv, batch_size=B, views=V)
        rec["cases"][case] = run_port(name, weights[name], mesh)
    # the bf16 cases and the encoder's probe on ranks 0 and 1; ranks 2
    # and 3 lie outside the mesh
    mesh = make_mesh(*BF16_MESH, batch_size=B, views=V)
    if mesh.member:
        rec["bf16"] = {name: run_port(name, weights[name], mesh) for name in BF16_MESH_FACTOR}
        rec["probe"] = encoder_probe("concat", weights["concat"], mesh)

    # the int8 head's eval on 4x1 against 1x1
    from vsta_tpu_torch.export import calibrate_quant_head

    hb = host_batch("concat")
    cfg = tcfg.from_dict(raw_config("concat"))
    qh = calibrate_quant_head(cfg, weights["concat"], [(hb["images"], hb["K"], hb["Rt"])], device="cpu")
    eval_step = make_eval_step(cfg, quant_head=qh)
    heat = {}
    for label, mesh in (("1x1", None), ("4x1", make_mesh(4, 1))):
        state = create_state(cfg, weights["concat"], device="cpu", steps_per_epoch=SPE, mesh=mesh)
        heat[label] = eval_step(state, hb if mesh is None else shard_batch(hb, mesh, "cpu"))["heatmap"].numpy()
    rec["int8"] = heat

    # the entry points on the 2x2 mesh, last: the CLIs send a rank's
    # standard output other than 0's to /dev/null while they run. Without
    # TensorBoard, whose import loads TensorFlow for seconds a rank:
    # ScalarLogger then writes scalars.jsonl alone
    sys.modules["torch.utils.tensorboard"] = None
    rec["entry"] = entry_points(outdir / "tree", outdir / f"entry{rank}", LOOP_MESH)

    (outdir / f"rank{rank}.pkl").write_bytes(pickle.dumps(rec))
    torch.distributed.destroy_process_group()


# -- the parent ------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _random_variables(tree, rng):
    """Numpy values for a Flax variable tree of shapes: kernels
    normal over the fan-in, biases and BatchNorm means small, norm scales
    and variances in [0.5, 1.5]."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _random_variables(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "mean" or len(v.shape) == 1:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
    return out


def _jax_train_loss(name, mesh_shape):
    """JAX's model of the config on ``make_mesh(*mesh_shape)`` and the
    train-mode forward and loss of its ``make_train_step``, as
    ``loss(variables, batch)``."""
    from vsta_tpu import config as jcfg
    from vsta_tpu.models import BEVNet as JBEVNet
    from vsta_tpu.ops.losses import detection_loss
    from vsta_tpu.ops.splat import build_targets
    from vsta_tpu.parallel.mesh import make_mesh as jmake_mesh

    cfg = jcfg.from_dict(raw_config(name))
    mesh = jmake_mesh(*mesh_shape)
    model = JBEVNet.from_config(cfg, mesh=mesh)
    l, m = cfg.loss, cfg.model

    def loss(variables, batch):
        targets = build_targets(
            batch["boxes_world"], batch["num_boxes"], bounds=m.bev_bounds, bev_hw=m.bev_size,
            min_overlap=l.gaussian_iou, min_radius=l.gaussian_min_radius,
        )
        out, _ = model.apply(variables, batch["images"], batch["K"], batch["Rt"], train=True, mutable=["batch_stats"])
        return detection_loss(
            out, targets, hm_alpha=l.hm_alpha, hm_beta=l.hm_beta, hm_weight=l.hm_weight,
            offset_weight=l.offset_weight, size_weight=l.size_weight,
        )["total_loss"]

    return model, mesh, loss


def _jax_run(name):
    """JAX's make_mesh(1, 1) run of the config from random weights: the
    weights as a port state dict, a function that returns the loss of its
    first train step (compiled without the backward), and the weights as
    JAX's numpy variables."""
    import jax
    import jax.numpy as jnp

    from vsta_tpu.parallel.mesh import shard_batch as jshard_batch
    from vsta_tpu_torch.convert import state_dict_from_flax

    model, mesh, loss = _jax_train_loss(name, (1, 1))
    hb = host_batch(name)
    shapes = jax.eval_shape(lambda *a: model.init(*a, train=False), jax.random.PRNGKey(0), hb["images"], hb["K"], hb["Rt"])
    variables = _random_variables(shapes, np.random.default_rng(0))
    jvars = jax.tree.map(jnp.asarray, variables)
    return state_dict_from_flax(variables), lambda: float(jax.jit(loss)(jvars, jshard_batch(hb, mesh))), variables


def _jax_first_gradients(name, variables, mesh_shape):
    """The gradients of JAX's first train step of ``name`` on
    ``make_mesh(*mesh_shape)`` (devices of the conftest's eight virtual
    CPU devices), weights replicated and the batch sharded as
    tests/test_multichip.py's ``_run_steps`` does: ``make_train_step``'s
    loss under ``jax.grad`` of the parameters, as port tensors by name."""
    import jax
    import jax.numpy as jnp

    from vsta_tpu.parallel.mesh import replicate_sharding
    from vsta_tpu.parallel.mesh import shard_batch as jshard_batch
    from vsta_tpu_torch.convert import params_from_flax

    _, mesh, loss = _jax_train_loss(name, mesh_shape)
    v = jax.device_put(jax.tree.map(jnp.asarray, variables), replicate_sharding(mesh))
    grad = jax.jit(jax.grad(lambda params, stats, batch: loss({"params": params, "batch_stats": stats}, batch)))
    g = grad(v["params"], v.get("batch_stats", {}), jshard_batch(host_batch(name), mesh))
    return {k: t.numpy() for k, t in params_from_flax(jax.tree.map(lambda a: np.asarray(a, np.float32), g)).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 4 ranks; meanwhile run JAX's and the port's single-device
    references. Returns (ranks' records, JAX losses, port references)."""
    outdir = tmp_path_factory.mktemp("world")
    jax_runs = {name: _jax_run(name) for name in CONFIGS if name not in JAX_TWIN}
    weights = {name: jax_runs[JAX_TWIN.get(name, name)][0] for name in CONFIGS}
    bf16_vars = {name: jax_runs[JAX_TWIN[name]][2] for name in BF16_MESH_FACTOR}
    (outdir / "weights.pkl").write_bytes(pickle.dumps(weights))
    generate_synthetic_wildtrack(outdir / "tree", n_frames=LOOP_FRAMES, n_views=2, n_people=3, img_hw=(108, 192))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD))
    env["PYTHONPATH"] = os.pathsep.join([str(Path(__file__).resolve().parent.parent), env.get("PYTHONPATH", "")])
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(outdir)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    try:
        first = {name: run() for name, (_, run, _) in jax_runs.items()}
        jax_bf16 = {
            name: {shape: _jax_first_gradients(name, bf16_vars[name], shape) for shape in ((1, 1), BF16_MESH)}
            for name in BF16_MESH_FACTOR
        }
        want_jax = {name: first[JAX_TWIN.get(name, name)] for name in CONFIGS}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as the ranks: oneDNN splits a convolution's sums by the thread count
        try:
            single = {name: run_port(name, weights[name]) for name in CONFIGS}
        finally:
            torch.set_num_threads(threads)
        with pytest.MonkeyPatch.context() as mp:  # as in the ranks: no TensorBoard
            mp.setitem(sys.modules, "torch.utils.tensorboard", None)
            single["loop"] = run_training(tcfg.from_dict(loop_raw(outdir / "tree", outdir / "single", (1, 1))),
                                          work_dir=str(outdir / "single"))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [f"rank {r} failed:\n{log[-3000:]}" for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    ranks = [pickle.loads((outdir / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    # the CLIs on one device, on the checkpoint the mesh's loop wrote
    single["entry"] = entry_points(outdir / "tree", outdir / "single-cli", (1, 1), outdir / "entry0" / "ckpt" / "last")
    single["loop_losses"] = _losses(outdir / "single" / "ckpt")
    return ranks, want_jax, single, logs, outdir, jax_bf16


def test_mesh_shapes_and_coordinates(world):
    ranks = world[0]
    for rec in ranks:
        r, s = rec["rank"], rec["shapes"]
        assert s["4x1"] == ({"data": 4, "view": 1}, True, r, 0)
        assert s["2x2"] == ({"data": 2, "view": 2}, True, r // 2, r % 2)
        assert s["0x1"][0] == {"data": 4, "view": 1} and s["0x2"][0] == {"data": 2, "view": 2}
        assert s["1x1"] == ({"data": 1, "view": 1}, r == 0, 0 if r == 0 else -1, 0 if r == 0 else -1)


def test_make_mesh_clamps_to_batch_and_views(world):
    """The clamps of JAX's make_mesh on a world of 4; ranks past the mesh
    say so and take no part."""
    ranks, logs = world[0], world[3]
    for rec in ranks:
        r, s = rec["rank"], rec["shapes"]
        assert s["clamp-batch2"][:2] == ({"data": 2, "view": 1}, r < 2)
        assert s["clamp-batch3"][:2] == ({"data": 3, "view": 1}, r < 3)
        assert s["clamp-views3"][0] == {"data": 2, "view": 1}
        assert s["clamp-batch2-views4"][0] == {"data": 2, "view": 1}
        assert s["divisible"][0] == {"data": 2, "view": 2}
    assert "clamping the view axis to 1" in logs[0] and "clamping the data axis to 2" in logs[0]
    assert "rank 3 is outside the 2x1 mesh; it takes no part" in logs[3]


def test_mesh_larger_than_the_world_raises(world):
    assert all("needs 8 ranks; the world has 4" in rec["too_large"] for rec in world[0])
    with pytest.raises(ValueError, match="needs 2 ranks; the world has 1"):
        make_mesh(2, 1)


def test_mesh_registration_opt_in(world):
    """make_mesh leaves the registry alone unless register=True; ACTIVE
    reads it; None is one device even with a mesh registered."""
    for rec in world[0]:
        assert rec["registry"] == [True] * 7
    assert get_active_mesh() is None


def test_gather_is_exact_for_every_value(world):
    for rec in world[0]:
        want = np.stack([r["special"] for r in world[0]])
        assert np.array_equal(rec["gathered"]["torch.float32"], want.reshape(-1))
        bf = np.stack([
            torch.from_numpy(r["special"]).view(torch.float32).to(torch.bfloat16).view(torch.uint8).numpy()
            for r in world[0]
        ])
        assert np.array_equal(rec["gathered"]["torch.bfloat16"], bf.reshape(-1))


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_single_device(world, case):
    """The twin of each of JAX's multi-device cases: every rank's losses
    against the port's single-device run, and the first against JAX's
    make_mesh(1, 1) run."""
    ranks, want_jax, single = world[:3]
    name = CASES[case][0]
    for rec in ranks:
        got = rec["cases"][case]["losses"]
        np.testing.assert_allclose(got, single[name]["losses"], rtol=2e-4)
        np.testing.assert_allclose(got[0], want_jax[name], rtol=2e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_single_device(world, case):
    """After the all-reduce each rank holds the single-device gradients of
    the global batch: not n_view times them, not 1/n_data of them."""
    ranks, _, single = world[:3]
    want = single[CASES[case][0]]["grads"]
    norms = {k: float(np.linalg.norm(w)) for k, w in want.items()}
    floor = 1e-2 * max(norms.values())
    total = np.sqrt(sum(n * n for n in norms.values()))
    for rec in ranks:
        got = rec["cases"][case]["grads"]
        assert set(got) == set(want)
        for k, w in want.items():
            assert np.linalg.norm(got[k] - w) <= 1e-3 * max(norms[k], floor), k
        assert abs(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in got.values())) / total - 1) <= 1e-4


def grad_distance(got, want):
    """The worst per-parameter distance: ||got - want|| / max(||want||,
    1e-2 of the largest ||want||), as chip_smoke.py's ``grad_distance``."""
    norms = {k: float(np.linalg.norm(w.astype(np.float64))) for k, w in want.items()}
    floor = 1e-2 * max(norms.values())
    return max(float(np.linalg.norm(got[k].astype(np.float64) - w)) / max(norms[k], floor) for k, w in want.items())


def _bf16_view_mesh(world, name):
    """The first call's gradients of the bf16 case ``name`` on the 1x2
    mesh against the port's one device, and JAX's 1x2 mesh against its
    1x1, read the same way (the worst per-parameter distance); the limit
    BF16_MESH_FACTOR times JAX's reading, floored at BF16_MESH_FLOOR. The
    first loss at rtol 2e-4, as the f32 cases, and the first call's
    BatchNorm statistics (where the model has any) bit-equal to one
    device's."""
    ranks, single, jax_bf16 = world[0], world[2], world[5]
    want = single[name]
    d_jax = grad_distance(jax_bf16[name][BF16_MESH], jax_bf16[name][(1, 1)])
    limit = max(BF16_MESH_FACTOR[name] * d_jax, BF16_MESH_FLOOR)
    stats = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
    assert [r["rank"] for r in ranks if "bf16" in r] == [0, 1]
    for rec in ranks[:2]:
        got = rec["bf16"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
        d_port = grad_distance(got["grads"], want["grads"])
        assert d_port <= limit, (d_port, d_jax, limit)
        for k in stats:  # after the first call: its batch statistics, summed over 'data'
            assert got["state"][k].tobytes() == want["state"][k].tobytes(), k
    return stats


def test_bf16_view_mesh_holds_to_jax_mesh(world):
    """ms_max (ResNet-18, OUT_INDEX (1, 2), FUSION max) in bf16 on a 1x2
    mesh, one step from the same weights in both packages.

    Readings on the CPU from these weights (tiny shapes, batch 4, 4 views):
    JAX's 1x2 mesh lies 4.7e-9 from its 1x1. Its compiled program gathers
    the images (and the sample coordinates) over 'view' and runs the
    encoder and the fusion whole on both devices, so no sum is split. The
    port's mesh partitions so too (every view rank encodes B x V images,
    BatchNorm sums over 'data'), and its gradients are one device's bit for
    bit. The limit is ten times JAX's reading, floored at 1e-7."""
    assert _bf16_view_mesh(world, "ms_max-bf16")


def test_bf16_pallas_view_mesh_holds_to_jax_mesh(world):
    """The concat fusion under WARP_IMPL pallas in bf16 on a 1x2 mesh: the
    one sum both packages split over 'view', the warp's sum over the
    views, each rank warping its two. The port's mesh against its one
    device within twice JAX's 1x2 mesh against its 1x1, floored at 1e-7.
    Read from these weights: the port 3.68e-2, JAX 3.45e-2 (its CPU
    program splits the warp's view contraction in f32 and rounds the sum
    to bf16; the port rounds each rank's half, as JAX's shard_map does on
    the TPU)."""
    _bf16_view_mesh(world, "pallas-bf16")


def test_view_ranks_encode_every_view(world):
    """On the 1x2 mesh (f32 concat, WARP_IMPL fused) each rank's encoder
    runs once on all B x V images, and the gradients each rank hands to
    the mesh's sum are whole, not the rank's part of a sum over 'view':
    bit-equal across the two view ranks, and every parameter's within
    1e-3 of its norm of one device's, as test_gradients_match_single_device
    holds the f32 cases (read 6.5e-5, in the encoder's: the warp's f32 view
    sum split in two moves them by rounding; a half-sum would read 0.5)."""
    ranks, single = world[0], world[2]
    want = single["concat"]["grads"]
    a, b = (rec["probe"] for rec in ranks[:2])
    assert a["seen"] == b["seen"] == [(B, V)]
    assert any(k.startswith("encoder.") for k in want)
    for k, w in want.items():
        assert a["before"][k].tobytes() == b["before"][k].tobytes(), k
    assert grad_distance(a["before"], want) <= 1e-3


@pytest.mark.parametrize("case", list(CASES))
def test_parameters_bit_equal_across_ranks(world, case):
    """Parameters, BatchNorm statistics included, after the steps."""
    ranks = world[0]
    ref = ranks[0]["cases"][case]["state"]
    for rec in ranks[1:]:
        for k, a in rec["cases"][case]["state"].items():
            assert a.tobytes() == ref[k].tobytes(), (case, rec["rank"], k)


def test_quant_head_eval_matches_single_device(world):
    for rec in world[0]:
        np.testing.assert_allclose(rec["int8"]["4x1"], rec["int8"]["1x1"], atol=1e-5)
        assert rec["int8"]["4x1"].shape == (B, 16, 32, 1)


def test_entry_points_write_on_rank_0_only(world):
    """run_training, .evaluate and .inference on the 2x2 mesh: rank 0
    writes the checkpoints, scalars.jsonl, metrics.jsonl and a JSON a
    frame, and prints; the other ranks write and print nothing."""
    ranks = world[0]
    files = ranks[0]["entry"]["files"]
    for name in ("ckpt/last", "ckpt/best", "ckpt/scalars.jsonl", "ckpt/metrics.jsonl"):
        assert any(f == name or f.startswith(name + "/") for f in files), name
    assert len(ranks[0]["entry"]["predictions"]) == LOOP_FRAMES
    assert "[mesh] data 2 x view 2" in world[3][0]
    for rec in ranks[1:]:
        assert rec["entry"]["files"] == [], rec["rank"]
        assert rec["entry"]["evaluate"] == rec["entry"]["inference"] == "", rec["rank"]


def test_run_training_on_mesh_matches_single_device(world):
    """Every rank's loop scores the same frames as one device's loop from
    the same weights: the eval's detections and ground truth are gathered
    over 'data'. The losses at rtol 2e-4."""
    ranks, _, single = world[:3]
    want = single["loop"]
    for rec in ranks:
        got = rec["entry"]["train"]
        assert got.keys() == want.keys()
        for k in want:
            if k in ("mle", "modp", "frame_mle", "train_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)
            else:
                assert got[k] == want[k], (rec["rank"], k)
    assert want["n_frames"] == 2.0 and want["tp"] > 0
    got_losses = _losses(world[4] / "entry0" / "ckpt")
    assert len(got_losses) == 2
    np.testing.assert_allclose(got_losses, single["loop_losses"], rtol=2e-4)


def test_evaluate_on_mesh_matches_single_device(world):
    """.evaluate --split all on the mesh's checkpoint: rank 0's metrics
    are one device's, on all 10 frames."""
    ranks, _, single = world[:3]
    text = ranks[0]["entry"]["evaluate"]
    got = json.loads(text[text.index("{"):])
    text = single["entry"]["evaluate"]
    want = json.loads(text[text.index("{"):])
    assert got.keys() == want.keys() and got["n_frames"] == float(LOOP_FRAMES) and got["tp"] > 0
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=2e-4), k


def test_inference_on_mesh_matches_single_device(world):
    """.inference --track on the mesh's checkpoint: rank 0 writes every
    frame's detections and tracks as one device does."""
    ranks, _, single = world[:3]
    got, want = ranks[0]["entry"]["predictions"], single["entry"]["predictions"]
    assert got.keys() == want.keys() and len(got) == LOOP_FRAMES
    assert "Saved predictions JSON for 10 frames" in ranks[0]["entry"]["inference"]
    for name in want:
        a, b = json.loads(got[name]), json.loads(want[name])
        assert a["frame_idx"] == b["frame_idx"]
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-4, err_msg=name)
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4, err_msg=name)
        assert [t["id"] for t in a["tracks"]] == [t["id"] for t in b["tracks"]], name


def test_world_of_one_is_the_single_device_step():
    """No process group: make_mesh is 1x1, makes no collective, and the
    train and eval steps are bit-equal to the single-device ones."""
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "view": 1} and mesh.member and mesh.group is None
    cfg = tcfg.from_dict(raw_config("concat"))
    from vsta_tpu_torch.convert import init_state_dict

    sd = init_state_dict(cfg, 0)
    a, b = run_port("concat", sd), run_port("concat", sd, mesh)
    assert a["losses"].tobytes() == b["losses"].tobytes()
    for k in a["state"]:
        assert a["state"][k].tobytes() == b["state"][k].tobytes(), k
    hb = host_batch("concat")
    outs = [
        make_eval_step(cfg)(create_state(cfg, sd, device="cpu", steps_per_epoch=1, mesh=m), hb)
        for m in (None, mesh)
    ]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_slice_batch_and_no_fallback():
    """A rank's slice of a host batch, by the JAX layout; a CUDA entry
    point without a card raises; without RANK there is no process group."""
    hb = host_batch("concat")
    part = Mesh(2, 2, rank=3).slice_batch(hb)
    assert np.array_equal(part["images"], hb["images"][2:4, 2:4])
    assert np.array_equal(part["K"], hb["K"][2:4, 2:4]) and np.array_equal(part["Rt"], hb["Rt"][2:4, 2:4])
    for k in ("boxes_world", "num_boxes", "frame_idx", "batch_mask"):
        assert np.array_equal(part[k], hb[k][2:4])
    assert init_distributed("cpu") == torch.device("cpu") and not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed("cuda")


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]))
