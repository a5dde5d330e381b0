"""The ablation variants of the warp kernel (warp_tiles_variant), the
port's counterpart of scripts/roofline_warp.py's _resident_variant: copies
of the kernel with one part taken out, wrong by design, for cost
attribution. Here, on the CPU, each variant's plain version is held to a
direct numpy statement of what it computes (float64 sums; float32
tolerance 1e-5, bfloat16 outputs one ulp, 2**-7 of the largest value); the
kernels themselves are held to the plain versions on the card by
chip_smoke.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vsta_tpu_torch.data.synthetic import make_ring_camera
from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid
from vsta_tpu_torch.ops import warp_cuda
from vsta_tpu_torch.ops.warp import precompute_warp_lut
from vsta_tpu_torch.ops.warp_cuda import (
    VARIANTS, warp_tiles, warp_tiles_ref, warp_tiles_variant, warp_tiles_variant_ref,
)

IMG, FEAT, BEV = (108, 192), (14, 24), (16, 32)
V, K = 5, 12
N, P = BEV[0] * BEV[1], FEAT[0] * FEAT[1]


@pytest.fixture(scope="module")
def taps():
    """feats [V, P, K] float32 and the LUT of ring cameras, with
    non-finite coordinates mixed in."""
    Ks, Rts = zip(*(make_ring_camera(v, V, img_hw=IMG) for v in range(V)))
    Kt = torch.tensor(np.stack(Ks), dtype=torch.float32)
    Rt = torch.tensor(np.stack(Rts), dtype=torch.float32)
    grid = ground_grid(*BEV, (-12.0, 12.0, -6.0, 6.0))
    coords, _ = bev_sample_coords_with_depth(Kt, Rt, IMG, FEAT, grid)
    coords = coords.reshape(V, N, 2).clone()
    coords[:, ::37, 0] = float("nan")
    coords[:, 5::41, 1] = float("inf")
    idx, wts = precompute_warp_lut(coords, FEAT)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((V, P, K)).astype(np.float32))
    assert float((wts > 0).float().mean()) > 0.5 and bool((wts == 0).any())
    return feats, idx, wts


def _numpy_statement(variant, feats, idx, wts, dtype):
    """What ``variant`` computes, written out: out[n, k] in float64."""
    f = feats.to(dtype).double().numpy()
    w = wts.to(dtype).double().numpy()  # the kernel rounds weights to the maps' dtype
    i = idx.numpy()
    out = np.zeros((N, K))
    for v in range(V):
        for t in range(4):
            if variant == "const_weights":  # every tap weighs 0.25, masked or not
                out += 0.25 * f[v, i[v, :, t]]
            elif variant == "row0":  # every tap reads source row 0 of its view
                out += w[v, :, t, None] * f[v, 0][None, :]
            elif variant == "no_gather":  # no map: the sum of the cell's weights in every channel
                out += w[v, :, t, None]
            else:
                out += w[v, :, t, None] * f[v, i[v, :, t]]
    return out


def test_variants_are_the_kernel_sources_codes():
    """VARIANTS' order is the Variant enum that csrc/warp_tiles.cu takes
    from csrc/warp_mma.cuh: the wrapper passes the index."""
    csrc = Path(warp_cuda.__file__).resolve().parent.parent / "csrc"
    assert '#include "warp_mma.cuh"' in (csrc / "warp_tiles.cu").read_text()
    src = (csrc / "warp_mma.cuh").read_text()
    enum = re.search(r"enum Variant \{([^}]*)\}", src).group(1)
    codes = dict(re.findall(r"k(\w+) = (\d+)", enum))
    camel = {"full": "Full", "const_weights": "ConstWeights", "row0": "Row0", "no_gather": "NoGather"}
    assert [int(codes[camel[v]]) for v in VARIANTS] == list(range(len(VARIANTS)))
    assert int(codes["Variants"]) == len(VARIANTS)


@pytest.mark.parametrize("dtype,out_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32")])
def test_full_variant_is_the_warp(taps, dtype, out_dtype):
    feats, idx, wts = taps
    f, od = feats.to(getattr(torch, dtype)), getattr(torch, out_dtype)
    want = warp_tiles_ref(f, idx, wts, out_dtype=od)
    assert torch.equal(warp_tiles_variant_ref(f, idx, wts, "full", out_dtype=od), want)
    assert torch.equal(warp_tiles_variant(f, idx, wts, "full", out_dtype=od), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_ref_matches_its_numpy_statement(taps, variant, dtype):
    feats, idx, wts = taps
    tdt = getattr(torch, dtype)
    want = _numpy_statement(variant, feats, idx, wts, tdt)
    got = warp_tiles_variant_ref(feats.to(tdt), idx, wts, variant, out_dtype=tdt)
    assert got.shape == (N, K) and got.dtype == tdt
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2.0**-7 * np.abs(want).max(), rtol=2.0**-7)
    np.testing.assert_allclose(got.double().numpy(), want, **tol)


def test_variants_differ_from_the_warp(taps):
    """Each ablated variant is wrong by design: none equals the warp."""
    feats, idx, wts = taps
    full = warp_tiles_ref(feats, idx, wts, out_dtype=torch.float32)
    for variant in VARIANTS[1:]:
        got = warp_tiles_variant_ref(feats, idx, wts, variant, out_dtype=torch.float32)
        assert float((got - full).abs().max()) > 0.1, variant
    no_gather = warp_tiles_variant_ref(feats, idx, wts, "no_gather", out_dtype=torch.float32)
    assert torch.equal(no_gather, no_gather[:, :1].expand(-1, K))  # the same in every channel
    assert float(no_gather.max()) <= V + 1e-5  # at most one unit of weight a view


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing(taps):
    feats, idx, wts = taps
    before = (warp_tiles_variant.launches, warp_tiles.launches)
    for variant in VARIANTS:
        got = warp_tiles_variant(feats, idx, wts, variant, out_dtype=torch.float32)
        assert torch.equal(got, warp_tiles_variant_ref(feats, idx, wts, variant, out_dtype=torch.float32))
    assert (warp_tiles_variant.launches, warp_tiles.launches) == before


@pytest.mark.parametrize("fn", [warp_tiles_variant, warp_tiles_variant_ref], ids=["wrapper", "plain"])
def test_unknown_variant_is_refused(taps, fn):
    feats, idx, wts = taps
    with pytest.raises(ValueError, match="unknown warp_tiles variant"):
        fn(feats, idx, wts, "no_sbuild", out_dtype=torch.float32)


def test_variant_wrapper_checks_its_inputs(taps):
    feats, idx, wts = taps
    with pytest.raises(TypeError, match="int32 idx"):
        warp_tiles_variant(feats, idx.long(), wts, "row0", out_dtype=torch.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        warp_tiles_variant(feats, idx[:2], wts, "row0", out_dtype=torch.float32)
