"""The port's serving export (vsta_tpu_torch/export.py) on the CPU: the
artifact's round trip against the live model, its manifest, the frozen
batch size, the int8 round trip, and the artifact served by the port
against the JAX package's ``load_serving`` on the same (converted)
weights and inputs. The tiny config is tests/test_export.py's.

On the CPU an artifact runs eagerly; the CUDA graph it replays on the
card is held bit-equal to eager serving by ``chip_smoke.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu import config as jcfg
from vsta_tpu import export as jexport
from vsta_tpu.data.synthetic import make_ring_camera
from vsta_tpu.models import BEVNet as JBEVNet
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch import export as texport
from vsta_tpu_torch.convert import init_state_dict, quant_head_from_jax, state_dict_from_flax

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


def tiny_raw(device_normalize=False):
    return {
        "DATA": {"BATCH_SIZE": 2, "IMG_SIZE": [3, 48, 64], "VIEWS": 3, "DATA_ROOT": "",
                 "DEVICE_NORMALIZE": device_normalize},
        "MODEL": {"BACKBONE": "simple", "FEAT_DIM": 8, "OUT_INDEX": 2, "BEV_SIZE": [32, 16, 32],
                  "BEV_BOUNDS": [-8.0, 8.0, -4.0, 4.0], "BEV_PROJ_CH": 12, "WARP_IMPL": "fused",
                  "FUSION": "concat"},
        "TRAIN": {"EPOCHS": 1, "LR": 1e-3, "ACCUM_STEPS": 1},
        "LOSS": {"MAX_OBJECTS": 8},
        "RUNTIME": {"USE_AMP": False, "DEVICE": "cpu"},
        "EVAL": {"CONF_THRESH": 0.05, "MAX_DETS": 16},
    }


def inputs(B=2, V=3, hw=(48, 64), uint8=False, seed=0):
    rng = np.random.default_rng(seed)
    H, W = hw
    if uint8:
        images = rng.integers(0, 256, (B, V, H, W, 3)).astype(np.uint8)
    else:
        images = rng.standard_normal((B, V, H, W, 3)).astype(np.float32)
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=(H, W)) for v in range(V)))
    K = np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32)
    Rt = np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32)
    return images, K, Rt


def _export(tmp_path, cfg, sd, name="m.pt", **kw):
    path = tmp_path / name
    texport.save_exported(texport.export_serving(cfg, sd, platforms=["cpu"], **kw), path)
    return path


def test_export_round_trip_matches_live_model(tmp_path):
    """The artifact loaded on the CPU against build_serving_fn on the same
    weights: equal outputs (the same eager code)."""
    cfg = tcfg.from_dict(tiny_raw())
    sd = init_state_dict(cfg, seed=1)
    args = inputs()
    live = texport.build_serving_fn(cfg, sd, device="cpu")(*args)
    serve = texport.load_serving(_export(tmp_path, cfg, sd, batch_size=2), device="cpu")
    assert serve.graph is None and serve.batch_size == 2
    out = serve(*args)
    assert set(out) == {"boxes", "scores", "valid", "heatmap"}
    for k in out:
        assert torch.equal(out[k], live[k]), k


def test_export_manifest_and_uint8_spec(tmp_path):
    """uint8 frames under DEVICE_NORMALIZE in JAX's aval form; the manifest's
    keys and embedded config; the weights file loads with
    weights_only=True; the decode contract holds."""
    from vsta_tpu_torch.serve import _batch_from_manifest

    cfg = tcfg.from_dict(tiny_raw(device_normalize=True))
    path = _export(tmp_path, cfg, init_state_dict(cfg), name="m.hlo", batch_size=2)
    manifest = json.loads((tmp_path / "m.hlo.json").read_text())
    assert set(manifest) == {"fn_name", "platforms", "in_avals", "out_avals", "torch_version", "config"}
    assert manifest["platforms"] == ["cpu"] and manifest["fn_name"] == "serve"
    assert manifest["in_avals"] == ["uint8[2,3,48,64,3]", "float32[2,3,3,3]", "float32[2,3,4,4]"]
    assert manifest["out_avals"] == ["float32[2,16,4]", "float32[2,16,32,1]", "float32[2,16]", "bool[2,16]"]
    assert manifest["config"]["MODEL"]["BACKBONE"] == "simple"
    assert tcfg.from_dict(manifest["config"]) == cfg
    assert manifest["torch_version"] == torch.__version__
    assert _batch_from_manifest(manifest, 7) == 2
    blob = torch.load(path, weights_only=True)
    assert blob["batch_size"] == 2 and blob["quant_head"] is None and blob["quant_encoder"] is None

    out = texport.load_serving(path, device="cpu")(*inputs(uint8=True))
    assert out["boxes"].shape == (2, cfg.eval.max_dets, 4)
    assert out["valid"].dtype == torch.bool


def test_export_batch_size_is_frozen(tmp_path):
    """A batch-1 artifact serves batch 1 and refuses batch 2, and float
    frames where it takes uint8 ones."""
    cfg = tcfg.from_dict(tiny_raw())
    serve = texport.load_serving(_export(tmp_path, cfg, init_state_dict(cfg), batch_size=1), device="cpu")
    images, K, Rt = inputs()
    assert serve(images[:1], K[:1], Rt[:1])["boxes"].shape[0] == 1
    with pytest.raises(ValueError, match="frozen at 1"):
        serve(images, K, Rt)
    cfg8 = tcfg.from_dict(tiny_raw(device_normalize=True))
    serve8 = texport.load_serving(_export(tmp_path, cfg8, init_state_dict(cfg8), name="u8.pt"), device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        serve8(images[:1], K[:1], Rt[:1])


def test_export_platforms_and_devices(tmp_path):
    """'tpu' names the JAX package's exporter; no fallback hides the
    device: a CUDA load without a card raises, and an artifact exported for
    the card does not load on the CPU."""
    cfg = tcfg.from_dict(tiny_raw())
    sd = init_state_dict(cfg)
    with pytest.raises(ValueError, match="export.py"):
        texport.export_serving(cfg, sd, platforms=["tpu"])
    with pytest.raises(ValueError, match="unknown platform"):
        texport.export_serving(cfg, sd, platforms=["rocm"])
    cpu_art = _export(tmp_path, cfg, sd)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texport.load_serving(cpu_art)
    gpu_art = tmp_path / "gpu.pt"
    texport.save_exported(texport.export_serving(cfg, sd), gpu_art)
    with pytest.raises(ValueError, match="exported for"):
        texport.load_serving(gpu_art, device="cpu")


def test_export_quantized_head_round_trip(tmp_path):
    """--quantize-head: calibrated, exported, reloaded; equal to the live
    int8 serving function and within the JAX test's 0.05 of the float
    heatmap."""
    cfg = tcfg.from_dict(tiny_raw())
    sd = init_state_dict(cfg, seed=2)
    args = inputs()
    qh = texport.calibrate_quant_head(cfg, sd, [args], device="cpu")
    live_q = texport.build_serving_fn(cfg, sd, quant_head=qh, device="cpu")(*args)
    live = texport.build_serving_fn(cfg, sd, device="cpu")(*args)
    out = texport.load_serving(_export(tmp_path, cfg, sd, batch_size=2, quant_head=qh), device="cpu")(*args)
    for k in out:
        assert torch.equal(out[k], live_q[k]), k
    err = float((out["heatmap"] - live["heatmap"]).abs().max())
    assert err < 0.05, err


@pytest.mark.parametrize("int8_head", [False, True])
def test_artifact_matches_jax_load_serving(tmp_path, int8_head):
    """The same weights (converted) and, with int8_head, JAX's int8 tree
    (converted) through both packages' artifacts. Float: heatmaps, scores
    and boxes within 1e-4 (convolution sums in another order) and the same
    detections kept; the heatmap head's kernel is scaled up and its bias
    zeroed so that the peaks stand apart and a share of them clears
    CONF_THRESH 0.5. Int8, on the weights as initialised: heatmaps within
    5e-3, and the detections kept a frame within 2 (two peaks that close
    may trade places in the greedy NMS): the f32 model ahead
    of the head lies 1e-5 from JAX's, so a stem input that close to a
    rounding boundary quantizes one step apart, and the head's three int8
    stems carry each such step on (2.1e-3 at most here)."""
    raw = tiny_raw()
    raw["EVAL"].update(CONF_THRESH=0.05 if int8_head else 0.5, MAX_DETS=64)
    jc, cfg = jcfg.from_dict(raw), tcfg.from_dict(raw)
    args = inputs(seed=3)
    model = JBEVNet.from_config(jc)
    v = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), *map(jnp.asarray, args), train=False))
    if not int8_head:
        hm = v["params"]["detector"]["heatmap_head"]
        hm["kernel"], hm["bias"] = hm["kernel"] * 20.0, np.zeros_like(hm["bias"])
    qj = jexport.calibrate_quant_head(jc, v, [args]) if int8_head else None
    jpath = tmp_path / "j.hlo"
    jexport.save_exported(jexport.export_serving(jc, v, batch_size=2, quant_head=qj), jpath, cfg=jc)
    want = {k: np.asarray(a) for k, a in jexport.load_serving(jpath)(*args).items()}

    qt = None
    if int8_head:
        qt = quant_head_from_jax(jax.tree_util.tree_map(lambda a: a if isinstance(a, str) else np.asarray(a), qj))
    got = texport.load_serving(_export(tmp_path, cfg, state_dict_from_flax(v), batch_size=2, quant_head=qt),
                               device="cpu")(*args)
    tol = dict(atol=5e-3 if int8_head else 1e-4, rtol=0)
    np.testing.assert_allclose(got["heatmap"].numpy(), want["heatmap"], **tol)
    if int8_head:  # two peaks that close may trade places in the greedy NMS
        assert np.abs(got["valid"].numpy().sum(1) - want["valid"].sum(1)).max() <= 2
        return
    assert want["valid"].any() and not want["valid"].all()
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], **tol)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], **tol)
