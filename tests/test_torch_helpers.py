"""The JAX package's last public helpers in the port, and its two tool
twins: geom_consistency_error, pixel_to_world and bev_sample_coords against
vsta_tpu.geometry on ring cameras; native.image_size against Pillow;
ModelConfig's bev_h / bev_w / res_x / res_y against vsta_tpu.config on
every shipped config; ``python -m vsta_tpu_torch.check_dataset`` as
tests/test_scripts.py runs the JAX one; ``python -m
vsta_tpu_torch.overfit_check`` for one epoch on the CPU.

Tolerances: geometry in float32 at 1e-5 relative (the homography and its
inverse are products of 3x3 matrices; JAX's run at HIGHEST precision),
2e-4 for pixels back-projected near the horizon, which land kilometres
out, where 1/w amplifies the rounding (8.8e-5 at most here);
the round-trip errors of good cameras at 1e-4 m absolute: both are float32
rounding noise of up to 1.4e-5 m (cameras 20 m out), a hundredth of the
1e-2 m at which check_dataset flags a camera; the config's numbers
exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vsta_tpu import config as jcfg
from vsta_tpu import geometry as jgeo
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch import geometry as tgeo
from vsta_tpu_torch import native
from vsta_tpu_torch.data.synthetic import generate_synthetic_wildtrack

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


ROOT = Path(__file__).resolve().parent.parent
PTS = np.stack(np.meshgrid(np.linspace(-5, 5, 4), np.linspace(-3, 3, 4)), -1).reshape(-1, 2).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_geom_consistency_error_matches_jax(cameras):
    """Well-formed calibrations round-trip to rounding, on both sides."""
    Ks, Rts = cameras
    want = np.asarray(jgeo.geom_consistency_error(jnp.asarray(Ks), jnp.asarray(Rts), jnp.asarray(PTS)))
    got = tgeo.geom_consistency_error(_t(Ks), _t(Rts), _t(PTS)).numpy()
    assert got.shape == want.shape == (7,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got.max() < 1e-2


def test_geom_consistency_error_flags_a_garbage_calibration(cameras):
    """A rank-deficient K: the pseudo-inverse takes over and the round
    trip no longer closes, in both packages alike."""
    Ks, Rts = cameras
    bad_K = Ks.copy()
    bad_K[0, 0, :] = 0.0
    pts = np.array([[2.0, 1.0], [-3.0, 0.5]], np.float32)
    want = float(jgeo.geom_consistency_error(jnp.asarray(bad_K[0]), jnp.asarray(Rts[0]), jnp.asarray(pts)))
    got = float(tgeo.geom_consistency_error(_t(bad_K[0]), _t(Rts[0]), _t(pts)))
    assert got > 1e-2 and want > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_pixel_to_world_matches_jax(cameras):
    """A grid of pixels over each camera's image, above the horizon too
    (those come back behind the camera, valid as JAX says)."""
    Ks, Rts = cameras
    uv = np.stack(np.meshgrid(np.linspace(0, 480, 6), np.linspace(0, 270, 5)), -1).reshape(-1, 2).astype(np.float32)
    uv = np.broadcast_to(uv, (7,) + uv.shape).copy()
    want_xy, want_ok = jgeo.pixel_to_world(jnp.asarray(uv), jnp.asarray(Ks), jnp.asarray(Rts))
    got_xy, got_ok = tgeo.pixel_to_world(_t(uv), _t(Ks), _t(Rts))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    np.testing.assert_allclose(got_xy.numpy()[ok], np.asarray(want_xy)[ok], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("per_frame", [False, True])
def test_bev_sample_coords_matches_jax(cameras, per_frame):
    Ks, Rts = cameras
    if per_frame:  # [B, V, ...]
        Ks, Rts = np.stack([Ks, Ks * 1.01]), np.stack([Rts, Rts])
    bounds, bev = (-12.0, 12.0, -4.0, 4.0), (16, 48)
    want = jgeo.bev_sample_coords(jnp.asarray(Ks), jnp.asarray(Rts), (270, 480), (34, 60), jgeo.ground_grid(*bev, bounds))
    got = tgeo.bev_sample_coords(_t(Ks), _t(Rts), (270, 480), (34, 60), tgeo.ground_grid(*bev, bounds))
    assert got.shape == want.shape == Ks.shape[:-2] + bev + (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    with_depth = tgeo.bev_sample_coords_with_depth(_t(Ks), _t(Rts), (270, 480), (34, 60), tgeo.ground_grid(*bev, bounds))
    assert torch.equal(got, with_depth[0])


def test_image_size_matches_pillow(tmp_path, monkeypatch):
    """(H, W) of the PNG and JPEG frames the generator writes; None for a
    file that is not there, and None with the codec switched off."""
    root = generate_synthetic_wildtrack(tmp_path / "wt", n_frames=1, n_views=1, n_people=1, img_hw=(54, 96))
    frame = sorted((root / "Image_subsets" / "C1").iterdir())[0]
    for path in (frame, tmp_path / "f.jpg"):
        if path.suffix == ".jpg":
            Image.new("RGB", (33, 21), (10, 20, 30)).save(path)
        with Image.open(path) as im:
            want = (im.height, im.width)
        got = native.image_size(str(path))
        if native.available():
            assert got == want, path
        else:
            assert got is None
    assert native.image_size(str(tmp_path / "missing.png")) is None
    monkeypatch.setenv(native.OFF_SWITCH, "1")
    assert native.image_size(str(frame)) is None


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")), ids=lambda p: p.name)
def test_model_config_grid_properties_match_jax(path):
    want, got = jcfg.load_config(str(path)).model, tcfg.load_config(str(path)).model
    assert (got.bev_h, got.bev_w) == (want.bev_h, want.bev_w) == tuple(got.bev_size)
    assert (got.res_x, got.res_y) == (want.res_x, want.res_y)


def _run(args, tmp_path, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run(
        [sys.executable, "-m", *args], cwd=str(tmp_path), capture_output=True, text=True, timeout=timeout, env=env
    )


def test_check_dataset_cli(tmp_path):
    """As tests/test_scripts.py::test_check_dataset_cli runs the JAX one."""
    root = generate_synthetic_wildtrack(tmp_path / "wt", n_frames=2, n_views=3, n_people=4, img_hw=(108, 192))
    r = _run(["vsta_tpu_torch.check_dataset", "--data_root", str(root), "--views", "3"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "frames: 2" in r.stdout and "OK" in r.stdout
    assert r.stdout.count("round-trip error") == 3
    assert "SUSPICIOUS" not in r.stdout
    r = _run(["vsta_tpu_torch.check_dataset"], tmp_path)
    assert r.returncode != 0 and "pass --config or --data_root" in r.stderr


def test_overfit_check_runs_and_prints_its_f1(tmp_path, capsys, monkeypatch):
    """One epoch of 2 frames and 2 views on the CPU: it trains and prints
    its F1 line and its verdict (no eval before epoch 2: best F1 -1, FAIL).
    TensorBoard is kept out (its import takes 13 s here): the loop's
    logger then writes scalars.jsonl alone."""
    from vsta_tpu_torch import overfit_check

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    rc = overfit_check.main(
        ["--device", "cpu", "--epochs", "1", "--frames", "2", "--views", "2", "--work_dir", str(tmp_path / "w")]
    )
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[overfit] 1 epochs in")]
    assert len(lines) == 1, out[-2000:]
    assert lines[0].endswith("best F1 -1.000")
    assert rc == 1 and "[overfit] FAIL (< 0.8)" in out
