"""MVDet's upsample folded into its per-view warp (ops/warp.folded_taps and
the grouped sampler's 9-tap path), on the CPU.

The folded taps, summed by the plain 9-tap sampler over the map before the
resize, against the two steps they replace: ``F.interpolate`` (bilinear,
``align_corners`` False, float32) then the bilinear sample of the resized
map (``sample_bilinear_many``, zeros outside), and against the JAX
package's ``jax.image.resize(..., "linear")`` then its own
``sample_bilinear_many``, at integer and non-integer ratios, with
coordinates on and past every edge and non-finite ones. Tolerance: 2e-6
of the largest value, float32 sums in another order (the two resizes
agree to 8e-7 on upsampling). BEVNet's MVDet path then runs no resize and
no pad: one 9-tap sample of the encoder's own maps.

The 4-tap sampler must not move: its plain version and wrapper are held
bit for bit to the arithmetic they had before 9 taps were added (a copy
below), and its partition rules to the old ones, on the shapes of
tests/test_torch_grouped.py.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vsta_tpu.ops import warp as jwarp
from vsta_tpu_torch.ops import grouped_cuda as gc
from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps, folded_taps, tap_weights

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)

ROOT = Path(__file__).resolve().parent.parent
G, N, C = 3, 400, 5
TOL = 2e-6

# (map before the resize, resized map): MVDet's 3x on both axes, other
# integer ratios, non-integer ones, an axis kept as it is, a 1-pixel axis
SHAPES = [
    ((6, 9), (18, 27)),
    ((5, 7), (10, 28)),
    ((5, 7), (13, 22)),
    ((4, 6), (7, 11)),
    ((6, 9), (6, 20)),
    ((3, 5), (3, 5)),
    ((1, 4), (5, 9)),
]
IDS = [f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in SHAPES]


def _coords(seed, hw, n=N):
    """(x, y) on the resized map over it and two pixels past each edge,
    every edge and half pixel hit exactly, some non-finite."""
    H, W = hw
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-2.0, W + 1.0, (G, n)), rng.uniform(-2.0, H + 1.0, (G, n))], -1).astype(np.float32)
    edges_x = np.array([-1.5, -1.0, -0.5, 0.0, 0.5, W - 1.0, W - 0.5, W, W + 0.5], np.float32)
    edges_y = np.array([-1.5, -1.0, -0.5, 0.0, 0.5, H - 1.0, H - 0.5, H, H + 0.5], np.float32)
    ex, ey = np.meshgrid(edges_x, edges_y)
    edges = np.stack([ex.ravel(), ey.ravel()], -1)[:n]
    c[0, : len(edges)] = edges
    c[1, ::37, 0] = np.nan
    c[2, ::41, 1] = np.inf
    c[2, 7::43, 0] = -np.inf
    return torch.from_numpy(c)


def _maps(seed, hw):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((G,) + hw + (C,)).astype(np.float32))


def _folded(feats, coords, size):
    Gm, hf, wf, Cm = feats.shape
    idx, wts = folded_taps(coords, (hf, wf), size)
    return gc.sample_tiles_grouped_ref(feats.reshape(Gm, hf * wf, Cm), idx, wts)


@pytest.mark.parametrize("hw,size", SHAPES, ids=IDS)
def test_folded_taps_are_resize_then_sample(hw, size):
    """The 9-tap sum over the map before the resize equals F.interpolate
    (float32) then the plain bilinear sample of the resized map."""
    feats, coords = _maps(1, hw), _coords(2, size)
    got = _folded(feats, coords, size)
    up = F.interpolate(feats.permute(0, 3, 1, 2), size=size, mode="bilinear", align_corners=False)
    want = gc.sample_bilinear_many(up.permute(0, 2, 3, 1).contiguous(), coords, grouped=gc.PLAIN)
    assert got.shape == want.shape == (G, N, C)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL * float(want.abs().max()))


@pytest.mark.parametrize("hw,size", SHAPES, ids=IDS)
def test_folded_taps_match_jax_resize_then_sample(hw, size):
    """The same against the JAX package: jax.image.resize(..., "linear")
    then vsta_tpu.ops.warp.sample_bilinear_many."""
    feats, coords = _maps(3, hw), _coords(4, size)
    got = _folded(feats, coords, size)
    up = jax.image.resize(jnp.asarray(feats.numpy()), (G,) + size + (C,), "linear")
    want = np.asarray(jwarp.sample_bilinear_many(up, jnp.asarray(coords.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("hw,size", SHAPES, ids=IDS)
def test_folded_taps_shape_and_liveness(hw, size):
    """T = 9 wherever no axis shrinks, at most 9 live taps a sample (at
    most 4 where each ratio is an odd whole number, as MVDet's 3: a
    resized pixel of every run of that many sits on a source pixel, so the
    warp's two pixels share two source pixels), every row inside the unpadded map, the
    weights of a sample summing to its bilinear weight inside the resized
    map (the resize's weights sum to 1), non-finite coordinates weigh 0."""
    coords = _coords(5, size)
    idx, wts = folded_taps(coords, hw, size)
    assert idx.shape == wts.shape == (G, N, 9) and idx.dtype == torch.int32 and wts.dtype == torch.float32
    assert int(idx.min()) >= 0 and int(idx.max()) < hw[0] * hw[1]
    live = (wts != 0).sum(-1)
    assert int(live.max()) <= 9
    if all(n % h == 0 and n // h % 2 == 1 for n, h in zip(size, hw)):
        assert int(live.max()) <= 4
    x, y = coords[..., 0], coords[..., 1]
    want = torch.zeros_like(x)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x.floor() + dx, y.floor() + dy
            inside = (xi >= 0) & (xi < size[1]) & (yi >= 0) & (yi < size[0])
            want += torch.where(inside, (1 - (xi - x).abs()) * (1 - (yi - y).abs()), 0.0)
    finite = torch.isfinite(coords).all(-1)
    np.testing.assert_allclose(wts.sum(-1)[finite].numpy(), want[finite].numpy(), rtol=0, atol=1e-6)
    assert not bool(wts[~finite].any())


def test_folded_taps_refuse_a_shrinking_axis():
    with pytest.raises(ValueError, match="shrinks"):
        folded_taps(torch.zeros(1, 3, 2), (8, 8), (4, 16))
    with pytest.raises(ValueError, match="shrinks"):
        folded_taps(torch.zeros(1, 3, 2), (8, 8), (16, 7))


def test_folded_taps_keep_leading_shape():
    """Shared coordinates [V, Hb, Wb, 2] and per-frame ones [B, V, Hb, Wb, 2]
    give the same taps where the frames repeat one calibration."""
    c = _coords(6, (18, 27), n=24).reshape(G, 4, 6, 2)
    idx, wts = folded_taps(c, (6, 9), (18, 27))
    idx_b, wts_b = folded_taps(c[None].expand(2, *c.shape), (6, 9), (18, 27))
    assert idx.shape == (G, 4, 6, 9) and idx_b.shape == (2, G, 4, 6, 9)
    assert torch.equal(idx_b[1], idx) and torch.equal(wts_b[0], wts)


def _sample_ref_before(maps, idx, wts):
    """The 4-tap plain version as it was before 9 taps: every weight
    rounded to the maps' dtype, fused multiply-adds over t = 0..3."""
    Gm, Pm, K = maps.shape
    w = tap_weights(wts, maps.dtype)
    base = torch.arange(Gm, dtype=torch.int64)[:, None] * Pm
    flat = maps.reshape(Gm * Pm, K)
    out = torch.zeros(idx.shape[:2] + (K,), dtype=torch.float32)
    for t in range(4):
        rows = flat.index_select(0, (base + idx[..., t].long()).reshape(-1))
        out.addcmul_(w[..., t, None], rows.reshape(out.shape).to(torch.float32))
    return out.to(maps.dtype)


HF, WF = 6, 9  # tests/test_torch_grouped.py's map, padded to 7 x 10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1, 8, 13, 82, 128])
def test_four_tap_sampler_unchanged(K, dtype):
    """4 taps a sample: the plain version and the wrapper (on the CPU, the
    plain version) equal bit for bit the arithmetic from before 9 taps."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(K)
    c = np.stack([rng.uniform(-1.5, WF + 0.5, (G, 300)), rng.uniform(-1.5, HF + 0.5, (G, 300))], -1)
    c = c.astype(np.float32)
    c.reshape(-1, 2)[::37, 0] = np.nan
    anchors, wts = anchored_taps(torch.from_numpy(c), (HF, WF))
    idx = flat_taps(anchors, WF + 1)
    maps = torch.from_numpy(rng.standard_normal((G, (HF + 1) * (WF + 1), K)).astype(np.float32)).to(tdt)
    want = _sample_ref_before(maps, idx, wts.contiguous())
    assert torch.equal(gc.sample_tiles_grouped_ref(maps, idx, wts.contiguous()), want)
    assert torch.equal(gc.sample_tiles_grouped(maps, idx, wts.contiguous()), want)


def _sample_partition_before(K, itemsize, maps_addr, out_addr):
    """sample_tiles_grouped's partition rules from before 9 taps: 32 bytes
    of taps a sample."""
    V = gc.vector_width(K, itemsize, (maps_addr, out_addr))
    L = gc.sub_warp_lanes(K // V, 1)
    groups = gc.THREADS // L
    smem = lambda cells, staged: cells * 32 + (cells * K * itemsize + 16 if staged else 0)
    staged = V * itemsize < 16 and smem(groups, True) <= gc.MAX_SMEM
    S = gc.SAMPLES_PER_LANE
    while S > 1 and smem(groups * S, staged) > gc.MAX_SMEM:
        S //= 2
    return gc.Partition(V, L, S, groups * S, staged)


def test_four_tap_partition_unchanged():
    base = 1 << 20
    for K in range(1, 1300, 7):
        for size in (2, 4):
            for addr in (base, base + size):
                assert gc.sample_partition(K, size, addr, base) == _sample_partition_before(K, size, addr, base)
                assert gc.sample_partition(K, size, addr, base, 4) == gc.sample_partition(K, size, addr, base)


def test_nine_tap_partition_at_mvdet():
    """MVDet's K = 512 in bf16: 16-byte loads, a warp a sample, 8 samples a
    sub-warp, stored from registers; 72 bytes of taps a sample, and every
    9-tap block within 48 KB."""
    base = 1 << 20
    p = gc.sample_partition(512, 2, base, base, 9)
    assert p == gc.Partition(8, 32, 8, 64, False)
    assert gc.sample_smem(p.cells, 512, 2, p.staged, 9) == 64 * 72
    for K in range(1, 1300, 7):
        for size in (2, 4):
            q = gc.sample_partition(K, size, base, base, 9)
            assert gc.sample_smem(q.cells, K, size, q.staged, 9) <= gc.MAX_SMEM


def test_wrappers_take_the_taps_they_run():
    """sample_tiles_grouped takes 4 or 9 taps a sample, the backward
    kernels 4; on the CPU nothing counts as a launch."""
    maps = torch.zeros(2, 10, 8)
    for T in (4, 9):
        idx, wts = torch.zeros(2, 5, T, dtype=torch.int32), torch.zeros(2, 5, T)
        before = dict(gc.sample_tiles_grouped.launches_by_taps)
        assert gc.sample_tiles_grouped(maps, idx, wts).shape == (2, 5, 8)
        assert gc.sample_tiles_grouped.launches_by_taps == before
    for T in (3, 16):
        with pytest.raises(ValueError):
            gc.sample_tiles_grouped(maps, torch.zeros(2, 5, T, dtype=torch.int32), torch.zeros(2, 5, T))
    idx9, wts9 = torch.zeros(2, 5, 9, dtype=torch.int32), torch.zeros(2, 5, 9)
    with pytest.raises(ValueError):
        gc.scatter_taps_grouped(torch.zeros(2, 5, 8), idx9, wts9, 10)
    with pytest.raises(ValueError):
        gc.taps_dot_grouped(maps, torch.zeros(2, 5, 8), idx9)


def test_nine_tap_weights_are_not_rounded():
    """bf16 maps: a 9-tap sample multiplies the float32 weight (255 x
    1.0029 = 255.75, stored as 256), a 4-tap one the weight rounded to
    bf16 (1.0: 255)."""
    maps = torch.full((1, 9, 1), 255.0, dtype=torch.bfloat16)
    w = 1.0 + 3 * 2.0**-10
    idx, wts = torch.arange(9, dtype=torch.int32)[None, None], torch.zeros(1, 1, 9)
    wts[..., 0] = w
    assert float(gc.sample_tiles_grouped_ref(maps, idx, wts)) == 256.0
    assert float(gc.sample_tiles_grouped_ref(maps, idx[..., :4].contiguous(), wts[..., :4].contiguous())) == 255.0


MVDET = json.loads((ROOT / "benchmark" / "configs" / "wildtrack_mvdet.json").read_text())["config"]


def test_mvdet_forward_runs_no_resize_and_one_nine_tap_sample():
    """BEVNet's MVDet path at a tiny size, random weights: one call of the
    grouped sampler, 9 taps a sample over the encoder's own maps
    (P = Hf * Wf, G = B * V), no upsample and no pad in the profile, and
    the views' maps as the resize then the plain sample give them."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness.inputs import FrameSets
    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid
    from vsta_tpu_torch.models.bevnet import BEVNet

    cfg = json.loads(json.dumps(MVDET))
    cfg["DATA"].update(IMG_SIZE=[3, 64, 96], VIEWS=2)
    cfg["MODEL"].update(FEAT_SIZE=[24, 36], BEV_SIZE=[1, 8, 24])
    cfg["RUNTIME"].update(USE_AMP=False, DEVICE="cpu")
    c = from_dict(cfg)
    net = BEVNet.from_config(c)
    net.load_state_dict(init_state_dict(c, seed=0))
    net.eval()
    calls = []

    def sample(maps, idx, wts):
        calls.append((tuple(maps.shape), tuple(idx.shape)))
        return gc.sample_tiles_grouped(maps, idx, wts)

    net.grouped = gc.KERNELS._replace(sample=sample)
    b = FrameSets(cfg, 2, 2**31 + 20, "cpu").batch([0, 1])
    images, K, Rt = (torch.as_tensor(b[k]) for k in ("images", "K", "Rt"))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = net(images, K, Rt, return_per_view=True)
    names = {e.name for e in prof.events()}
    assert not any("upsample" in n or "pad" in n for n in names), sorted(n for n in names if "upsample" in n or "pad" in n)
    assert calls == [((4, 8 * 12, 512), (4, 8 * 24, 9))]
    with torch.no_grad():
        feats = net.encoder((images.float() - net.img_mean) * net.img_scale)
        coords, _ = bev_sample_coords_with_depth(K[0], Rt[0], (64, 96), (24, 36),
                                                 ground_grid(8, 24, c.model.bev_bounds))
        up = F.interpolate(feats.reshape(4, 8, 12, 512).permute(0, 3, 1, 2), size=(24, 36), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).contiguous()
        want = gc.sample_bilinear_many(up, coords[None].expand(2, -1, -1, -1, -1).reshape(4, 8 * 24, 2),
                                       grouped=gc.PLAIN).reshape(2, 2, 8, 24, 512)
    got = out["bev_per_view"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL * float(want.abs().max()))
