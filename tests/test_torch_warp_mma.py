"""The arithmetic of the tensor-core warp kernels (csrc/warp_mma.cuh, behind
warp_tiles and warp_views_sum), modelled in torch on the CPU and held to
the plain versions, which tests/test_torch_warp.py and
tests/test_torch_perframe.py hold to the JAX package.

The model does what a block does: it cuts the N cells into the kernels'
tiles, keys every live tap by (level, source row), its level the earlier
taps of its cell and view on the same row (0 for every tap of the LUT;
random taps repeat rows), numbers a tile's distinct keys in that order
(its slots), builds the padded weight tile [64 cells, slots] and the
staged rows [slots, K] as bf16 planes (one plane for bf16-rounded weights,
three for float32 weights or maps), and sums the plane products with
i + j <= 2, a piece of the weight tile at a time, in float32. The kernels themselves are held to the plain versions on the card
by chip_smoke.py.

Inputs: the flagship's LUT (7 ring cameras, BEV 120 x 360 on a 34 x 60 map,
the shapes the model runs), a calibration a frame, and random taps whose
tiles touch more rows than one piece of the weight tile holds. Tolerances
are chip_smoke.py's: bf16 outputs within one bf16 ulp of |ref| plus 1e-6
of the largest (sums in another order, rounded once); float32 within
1e-5 of the largest (products of split planes, the smallest pairs left out).
"""

import numpy as np
import pytest
import torch

from vsta_tpu_torch.data.synthetic import make_ring_camera
from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid
from vsta_tpu_torch.ops.warp import precompute_warp_lut, warp_lut_sum
from vsta_tpu_torch.ops.warp_views_cuda import (
    A_SLOTS, TILE_CELLS, distinct_rows_per_tile, tile_of_cells, warp_views_sum_ref,
)

V, IMG, FEAT, BEV = 7, (270, 480), (34, 60), (120, 360)
P, N = FEAT[0] * FEAT[1], BEV[0] * BEV[1]


def _luts(frames, radius=(20.0, 20.0), height=(6.0, 6.0), seed=0):
    """idx/wts [frames, V, N, 4] of ring cameras at the flagship's shapes,
    each frame's radius and height drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    Ks, Rts = [], []
    for _ in range(frames):
        r, h = rng.uniform(*radius), rng.uniform(*height)
        k, rt = zip(*(make_ring_camera(v, V, radius=r, height=h, img_hw=IMG) for v in range(V)))
        Ks.append(np.stack(k))
        Rts.append(np.stack(rt))
    grid = ground_grid(*BEV, (-24.0, 24.0, -7.2, 7.2))
    coords, _ = bev_sample_coords_with_depth(
        torch.tensor(np.stack(Ks), dtype=torch.float32), torch.tensor(np.stack(Rts), dtype=torch.float32),
        IMG, FEAT, grid)
    return precompute_warp_lut(coords.reshape(frames, V, N, 2), FEAT)


@pytest.fixture(scope="module")
def flagship():
    idx, wts = _luts(1)
    return idx[0], wts[0]


@pytest.fixture(scope="module")
def per_frame():
    return _luts(2, radius=(17.0, 23.0), height=(5.0, 7.0), seed=11)


def _random_taps(rng, lead, n):
    idx = torch.from_numpy(rng.integers(0, P, (*lead, n, 4)).astype(np.int32))
    wts = torch.from_numpy(rng.uniform(0.0, 1.0, (*lead, n, 4)).astype(np.float32))
    return idx, torch.where(wts < 0.2, torch.zeros_like(wts), wts)


def split_planes(x: torch.Tensor, planes: int) -> list:
    """x (float32) as ``planes`` bf16 values (as float32), each the
    rounding of what the ones before leave."""
    out, r = [], x
    for _ in range(planes):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def tile_model(feats, idx, wts, grid_w, f32_weights):
    """One frame through the kernels' arithmetic: feats [V, P, K], idx/wts
    [V, N, 4] -> [N, K] float32, and the tiles' slot counts T."""
    Vf, Pf, K = feats.shape
    n_cells, VP = idx.shape[1], Vf * Pf
    na = 3 if f32_weights or feats.dtype == torch.float32 else 1
    nb = 3 if feats.dtype == torch.float32 else 1
    w = wts if na == 3 else wts.to(torch.bfloat16).float()
    live = (w != 0) & (idx >= 0) & (idx < Pf)
    rows = torch.arange(Vf)[:, None, None] * Pf + idx.long()
    level = torch.zeros_like(rows)  # the earlier live taps of its cell and view on its row
    for t in range(4):
        for u in range(t):
            level[..., t] += (live[..., u] & (rows[..., u] == rows[..., t])).long()
    tile = tile_of_cells(n_cells, grid_w)
    if grid_w:
        cell = (torch.arange(n_cells) // grid_w % 8) * 8 + torch.arange(n_cells) % grid_w % 8
    else:
        cell = torch.arange(n_cells) % TILE_CELLS
    tiles = int(tile.max()) + 1
    tap_tile = tile[None, :, None].expand_as(rows)[live]
    tap_cell = cell[None, :, None].expand_as(rows)[live]
    # slots: a tile's distinct keys (level, row) in that order
    gk = tap_tile * 4 * VP + (level * VP + rows)[live]
    keys = torch.unique(gk)
    key_tile = keys // (4 * VP)
    T = torch.bincount(key_tile, minlength=tiles)
    start = torch.cumsum(T, 0) - T
    key_slot = torch.arange(keys.numel()) - start[key_tile]
    tap_slot = torch.searchsorted(keys, gk) - start[tap_tile]
    t_pad = max(16, -(-int(T.max()) // 16) * 16)
    # the padded weight tile, a plane a piece of each weight
    A = torch.zeros((na, tiles, TILE_CELLS, t_pad))
    for i, plane in enumerate(split_planes(w[live], na)):
        assert not A[i, tap_tile, tap_cell, tap_slot].any()  # a place no other tap has
        A[i, tap_tile, tap_cell, tap_slot] = plane
    # the staged rows, a plane a piece of each value
    Bm = torch.zeros((nb, tiles, t_pad, K))
    for j, plane in enumerate(split_planes(feats.reshape(VP, K).float()[keys % VP], nb)):
        Bm[j, key_tile, key_slot] = plane
    out = torch.zeros((tiles, TILE_CELLS, K))
    pieces = A_SLOTS[na]
    for p0 in range(0, t_pad, pieces):
        for i in range(na):
            for j in range(nb):
                if i + j <= 2:
                    out += torch.bmm(A[i, :, :, p0:p0 + pieces], Bm[j, :, p0:p0 + pieces])
    return out[tile, cell], T


def _hold(got, ref, bf16_out):
    if bf16_out:
        got, ref = got.to(torch.bfloat16).float(), ref.to(torch.bfloat16).float()
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
        assert bool(((got - ref).abs() <= ulp + 1e-6 * ref.abs().max()).all())
    else:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5 * float(ref.abs().max()), rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lut", ["flagship", "random"])
def test_tile_model_matches_warp_lut_sum(flagship, lut, dtype):
    """warp_tiles' arithmetic (bf16-rounded weights on bf16 maps, three
    planes each for f32) against warp_lut_sum on the flagship LUT in 8x8
    tiles of its 360-wide grid, and on random taps in runs of 64 cells,
    whose tiles fill the weight tile many times over."""
    rng = np.random.default_rng(1)
    if lut == "flagship":
        (idx, wts), grid_w = flagship, BEV[1]
    else:
        (idx, wts), grid_w = _random_taps(rng, (V,), 16 * 64), None
    feats = torch.from_numpy(rng.standard_normal((V, P, 16)).astype(np.float32)).to(getattr(torch, dtype))
    got, T = tile_model(feats, idx, wts, grid_w, f32_weights=False)
    ref = warp_lut_sum(feats, idx, wts)
    assert float(ref.abs().max()) > 0.5
    if lut == "random":
        assert int(T.min()) > 4 * A_SLOTS[1]  # the weight tile in five pieces or more
        # some taps repeat a row of their cell and view: keys of level 1 and more
        assert int(T.sum()) > int(distinct_rows_per_tile(idx, wts, P, grid_w).sum())
    _hold(got, ref, dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lut", ["per-frame", "random"])
def test_tile_model_matches_warp_views_sum_ref(per_frame, lut, dtype):
    """warp_views_sum's arithmetic (float32 weights as three bf16 planes)
    against its plain version, frame by frame: the per-frame LUT of two
    calibrations and random taps."""
    rng = np.random.default_rng(2)
    if lut == "per-frame":
        (idx, wts), grid_w, n_cells = per_frame, BEV[1], N
    else:
        n_cells, grid_w = 8 * 96, 96
        idx, wts = _random_taps(rng, (2, V), n_cells)
    feats = torch.from_numpy(rng.standard_normal((2, V, P, 16)).astype(np.float32)).to(getattr(torch, dtype))
    ref = warp_views_sum_ref(feats, idx, wts)
    for b in range(2):
        got, T = tile_model(feats[b], idx[b], wts[b], grid_w, f32_weights=True)
        if lut == "random":
            assert int(T.min()) > 4 * A_SLOTS[3]
        _hold(got, ref[b], False)


def test_three_bf16_planes_hold_float32_exactly(flagship, per_frame):
    """hi + mid + lo == x to the bit, for every weight of both LUTs and for
    random float32 maps: what lets the kernels keep float32 weights and
    maps on the bf16 tensor cores."""
    rng = np.random.default_rng(3)
    maps = torch.from_numpy((rng.standard_normal(200_000) * 10.0 ** rng.uniform(-6, 6, 200_000)).astype(np.float32))
    for x in (flagship[1].reshape(-1), per_frame[1].reshape(-1), maps):
        hi, mid, lo = split_planes(x, 3)
        for p in (hi, mid, lo):
            assert torch.equal(p, p.to(torch.bfloat16).float())
        assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert bool((split_planes(maps, 2)[1] != 0).any()) and bool((split_planes(maps, 3)[2] != 0).any())


def test_distinct_rows_fit_the_weight_tile(flagship, per_frame):
    """What the kernels' shared memory is sized for, on the shapes the model
    runs: in 8x8 tiles every tile of the flagship's LUT touches at most one
    piece of the bf16 weight tile (96 slots; 91 rows at most, about 53 on
    average against 1,485 live taps), and a few take two pieces of the
    three-plane one (64); a per-frame LUT's tiles take at most two pieces of
    either. Without the grid's width (runs of 64 cells) a tile touches
    about three times as many rows."""
    idx, wts = flagship
    T = distinct_rows_per_tile(idx, wts, P, BEV[1])
    assert T.numel() == (BEV[0] // 8) * (BEV[1] // 8)
    assert int(T.max()) <= A_SLOTS[1] and 45 < float(T.float().mean()) < 60
    assert 2 * A_SLOTS[3] >= int(T.max()) > A_SLOTS[3]
    runs = distinct_rows_per_tile(idx, wts, P, None)
    assert runs.numel() == N // TILE_CELLS and float(runs.float().mean()) > 2.5 * float(T.float().mean())
    for b in range(2):
        Tb = distinct_rows_per_tile(per_frame[0][b], per_frame[1][b], P, BEV[1])
        assert int(Tb.max()) <= 2 * A_SLOTS[3] <= 2 * A_SLOTS[1]
    # the model's count is the helper's
    feats = torch.zeros((V, P, 1))
    assert torch.equal(tile_model(feats, idx, wts, BEV[1], f32_weights=False)[1], T)
