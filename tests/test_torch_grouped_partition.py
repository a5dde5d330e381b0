"""The work partition of the grouped sampler's two sample-major kernels
(csrc/grouped_taps.cu: sample_tiles_grouped and taps_dot_grouped),
modelled in torch on the CPU and held to their plain versions, which
tests/test_torch_grouped.py and tests/test_torch_grouped_grads.py hold to
the Pallas kernels. The kernels themselves are held to the plain versions
on the card by chip_smoke.py, which also holds the Python mirror of the
partition rules (grouped_cuda.sample_partition, taps_dot_partition) to
the built library's.

The model does what the blocks do. sample_tiles_grouped: a sub-warp of L
lanes a sample, lane l the runs l, l + L, ... of V channels, S samples a
sub-warp in a block of (256 / L) * S consecutive samples; each element
fmaf over its 4 taps (or 9: an upsample folded in) in order, weight-0
taps skipped; a lane's V channels
stored from registers where V fills 16 bytes, else into a shared tile of
the block's output at its run's offset modulo 16 bytes, which is then
stored as 16-byte words, its head and tail element by element (a row too
long to stage: from registers). taps_dot_grouped: the
lanes' partial dots over their runs in order, then the transposing
butterfly over the L lanes, lane t < 4 storing dot t. Every output element
must be produced exactly once, every vector access aligned to its width.

Inputs: the shapes of tests/test_torch_grouped.py (G = 3, N = 300, a 6 x 9
map padded to 7 x 10) with K from 1 to 128 (ragged, narrow and wide), maps
and cotangents aligned or at an odd element offset. Tolerances:
sample_tiles_grouped bit for bit (its sums are the plain version's, in
its order); taps_dot_grouped within 1e-5 of the largest (another order).
"""

import numpy as np
import pytest
import torch

from vsta_tpu_torch.ops import grouped_cuda as gc
from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps, folded_taps, tap_weights

HF, WF = 6, 9
P = (HF + 1) * (WF + 1)
G, N = 3, 300
BASE = 1 << 20  # an allocation's address: 256-byte aligned, as the caching allocator's


def _inputs(K, dtype, seed):
    """maps [G, P, K], gout [G, N, K] in ``dtype``; idx/wts [G, N, 4] from
    random coordinates, some off the map or non-finite (weight 0)."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-1.5, WF + 0.5, (G, N)), rng.uniform(-1.5, HF + 0.5, (G, N))], -1).astype(np.float32)
    c.reshape(-1, 2)[::37, 0] = np.nan
    anchors, wts = anchored_taps(torch.from_numpy(c), (HF, WF))
    maps = torch.from_numpy(rng.standard_normal((G, P, K)).astype(np.float32)).to(dtype)
    gout = torch.from_numpy(rng.standard_normal((G, N, K)).astype(np.float32)).to(dtype)
    return maps, gout, flat_taps(anchors, WF + 1), wts.contiguous()


def _block_items(part, R, nc):
    """(sample c, run r) of every (sub-warp, sample of the sub-warp, lane,
    run pass) of a block with nc samples, in that order, the ones the
    kernel computes."""
    groups = gc.THREADS // part.lanes
    q = torch.arange(groups)[:, None, None, None]
    j = torch.arange(part.samples)[None, :, None, None]
    lane = torch.arange(part.lanes)[None, None, :, None]
    it = torch.arange(-(-R // part.lanes))[None, None, None, :]
    c = (q + j * groups).expand(-1, -1, part.lanes, it.shape[-1])
    r = (lane + it * part.lanes).expand_as(c)
    live = (c < nc) & (r < R)
    return c[live], r[live]


def sample_model(maps, idx, wts, maps_addr, out_addr=BASE):
    """sample_tiles_grouped as its blocks compute and store it; returns
    the output [G, N, K] and its partition."""
    Gm, Pm, K = maps.shape
    (Nm, taps), size = idx.shape[1:], maps.element_size()
    part = gc.sample_partition(K, size, maps_addr, out_addr, taps)
    V, R, E = part.vec, K // part.vec, 16 // size
    assert maps_addr % (V * size) == 0 and out_addr % (V * size) == 0 and K % V == 0
    assert gc.sample_smem(part.cells, K, size, part.staged, taps) <= gc.MAX_SMEM
    w = tap_weights(wts, maps.dtype) if taps == 4 else wts
    out = torch.zeros(Gm * Nm * K, dtype=maps.dtype)
    stores = torch.zeros(Gm * Nm * K, dtype=torch.int64)
    for g in range(Gm):
        for n0 in range(0, Nm, part.cells):
            nc = min(part.cells, Nm - n0)
            c, r = _block_items(part, R, nc)
            run = (g * Nm + n0) * K  # the block's output: nc * K elements from here
            run_addr = out_addr + run * size
            shift = (run_addr % 16) // size  # the tile's first element in shared memory
            # each item: V channels, fmaf over the taps in order
            ch = (r * V)[:, None] + torch.arange(V)[None, :]
            acc = torch.zeros(ch.shape)
            for t in range(taps):
                wt = w[g, n0 + c, t][:, None]
                x = maps[g, idx[g, n0 + c, t].long()[:, None], ch].float()
                acc = torch.where(wt != 0, torch.addcmul(acc, wt, x), acc)
            flat = c[:, None] * K + ch  # the element of the run
            if part.staged:
                # the vector store into the tile, then the flat store of the run
                assert bool((((shift + c * K + r * V) * size) % (V * size) == 0).all())
                tile = torch.zeros(shift + nc * K, dtype=maps.dtype)
                tile_writes = torch.bincount(shift + flat.reshape(-1), minlength=tile.numel())
                assert bool((tile_writes[shift:] == 1).all()) and not bool(tile_writes[:shift].any())
                tile[shift + flat.reshape(-1)] = acc.reshape(-1).to(maps.dtype)
                n = nc * K
                head = min(n, ((16 - run_addr % 16) % 16) // size)
                words = (n - head) // E
                assert (run_addr + head * size) % 16 == 0 and ((shift + head) * size) % 16 == 0
                word = head + torch.arange(words * E)
                rest = torch.cat([torch.arange(head), torch.arange(head + words * E, n)])
                for e in (word, rest):
                    out[run + e] = tile[shift + e]
                    stores[run + e] += 1
            else:
                assert bool((((run_addr + flat[:, 0] * size) % (V * size)) == 0).all())
                out[run + flat.reshape(-1)] = acc.reshape(-1).to(maps.dtype)
                stores[run + flat.reshape(-1)] += 1
    assert bool((stores == 1).all()), "an output element stored other than once"
    return out.reshape(Gm, Nm, K), part


def taps_dot_model(maps, gout, idx, maps_addr, gout_addr):
    """taps_dot_grouped as its sub-warps compute it: each lane's partial
    dots in its order, the transposing butterfly, lanes 0..3 storing;
    returns d_wts [G, N, 4] and the partition."""
    Gm, Pm, K = maps.shape
    Nm, size = idx.shape[1], maps.element_size()
    part = gc.taps_dot_partition(K, size, maps_addr, gout_addr)
    V, L, R = part.vec, part.lanes, K // part.vec
    assert 4 <= L <= 32 and K % V == 0 and maps_addr % (V * size) == 0 and gout_addr % (V * size) == 0
    rows = maps.float()[torch.arange(Gm)[:, None, None], idx.long()]  # [G, N, 4, K]
    g = gout.float()
    dots = torch.zeros((Gm, Nm, L, 4))  # a lane's partial dots
    lane = torch.arange(L)
    for it in range(-(-R // L)):
        r = lane + it * L
        on = (r < R)[:, None]
        for e in range(V):
            k = (r * V + e).clamp(max=K - 1)
            prod = rows[..., k].transpose(2, 3) * g[..., k][..., None]  # [G, N, L, 4]
            dots = torch.where(on, dots + prod, dots)
    # transpose_sum<4>(dot, lane, L): h = 2, 1 transposing, then plain
    # halves from 4 to L; lane l ends with the sample's dot l % 4
    v = dots.clone()
    for h in (2, 1):
        up = (lane & h) != 0
        partner = lane ^ h
        for i in range(h):
            send = torch.where(up, v[..., i], v[..., i + h])
            keep = torch.where(up, v[..., i + h], v[..., i])
            v[..., i] = keep + send[:, :, partner]
    v0 = v[..., 0]
    o = 4
    while o < L:
        v0 = v0 + v0[:, :, lane ^ o]
        o *= 2
    stores = torch.zeros((Gm, Nm, 4), dtype=torch.int64)
    d_wts = torch.zeros((Gm, Nm, 4))
    for l in range(4):  # lanes 0..3: the sample's 16 contiguous bytes
        d_wts[..., l] = v0[..., l]
        stores[..., l] += 1
    assert bool((stores == 1).all())
    return d_wts, part


KS = (1, 2, 13, 26, 32, 41, 128)
CASES = [
    pytest.param(K, dtype, offset, id=f"{dtype}-K{K}-{'odd' if offset else 'aligned'}")
    for dtype in ("bfloat16", "float32")
    for K in KS
    for offset in (0, 1)
]


@pytest.mark.parametrize("K,dtype,offset", CASES)
def test_sample_model_is_the_plain_version(K, dtype, offset):
    """Every element of sample_tiles_grouped's output stored once, and the
    model bit-equal to sample_tiles_grouped_ref; maps at an odd element
    offset take one channel a load."""
    tdt = getattr(torch, dtype)
    maps, _, idx, wts = _inputs(K, tdt, seed=K)
    size = maps.element_size()
    got, part = sample_model(maps, idx, wts, BASE + offset * size)
    if offset:
        assert part.vec == 1
    assert torch.equal(got, gc.sample_tiles_grouped_ref(maps, idx, wts))


@pytest.mark.parametrize("K,dtype,offset", [c for c in CASES if c.values[0] in (1, 13, 26, 128)])
def test_sample_model_nine_taps_is_the_plain_version(K, dtype, offset):
    """The same with 9 taps a sample, MVDet's upsample folded in (a 6 x 9
    map warped as resized to 18 x 27, its float32 weights unrounded):
    every output element stored once, bit-equal to the plain version."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(200 + K)
    c = np.stack([rng.uniform(-1.5, 27.5, (G, N)), rng.uniform(-1.5, 18.5, (G, N))], -1).astype(np.float32)
    c.reshape(-1, 2)[::37, 0] = np.nan
    idx, wts = folded_taps(torch.from_numpy(c), (HF, WF), (18, 27))
    maps = torch.from_numpy(rng.standard_normal((G, HF * WF, K)).astype(np.float32)).to(tdt)
    size = maps.element_size()
    got, part = sample_model(maps, idx, wts, BASE + offset * size)
    if offset:
        assert part.vec == 1
    assert torch.equal(got, gc.sample_tiles_grouped_ref(maps, idx, wts))


@pytest.mark.parametrize("K,dtype,offset", CASES)
def test_taps_dot_model_is_the_plain_version(K, dtype, offset):
    """Every tap's d_wts stored once, and the model (partial dots in each
    lane's order, the butterfly's order) within 1e-5 of the largest of
    taps_dot_grouped_ref; maps and gout at an odd element offset take one
    channel a load."""
    tdt = getattr(torch, dtype)
    maps, gout, idx, _ = _inputs(K, tdt, seed=100 + K)
    size = maps.element_size()
    got, part = taps_dot_model(maps, gout, idx, BASE + offset * size, BASE + offset * size)
    if offset:
        assert part.vec == 1
    ref = gc.taps_dot_grouped_ref(maps, gout, idx)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sample_model_past_the_tile(dtype):
    """Narrow loads on rows too long for the shared tile (K = 3,201 at an
    odd offset: 6.4 KB a row in bf16, 12.8 KB in f32, and a block of 8
    sub-warps may stage 48 KB) are stored from registers; every element
    once, bit-equal to the plain version."""
    rng = np.random.default_rng(7)
    tdt = getattr(torch, dtype)
    _, _, idx, wts = _inputs(8, tdt, seed=7)
    maps = torch.from_numpy(rng.standard_normal((G, P, 3201)).astype(np.float32)).to(tdt)
    i, w = idx[:, :40].contiguous(), wts[:, :40].contiguous()
    got, part = sample_model(maps, i, w, BASE + maps.element_size())
    assert not part.staged and part.vec == 1 and part.lanes == 32
    assert torch.equal(got, gc.sample_tiles_grouped_ref(maps, i, w))


def test_partition_at_the_model_shapes():
    """The partitions the model paths take, as csrc/grouped_taps.cu's
    notes give them: the flagship backward's K = 82 in bf16 at 2 channels
    a load over 16 lanes (3 passes, where 32 lanes would leave 23 of 64
    slots idle), staged; the deform sampler's K = 32 at 16 bytes, 4 lanes
    a sample (8 samples a warp), stored from registers; the query warp's
    K = 128 at 16 lanes; the unfused fusions' K = 1,280 over a warp;
    every block within 48 KB of shared memory, and interior blocks that
    start on 16 bytes."""
    s = gc.sample_partition
    d = gc.taps_dot_partition
    assert s(82, 2, BASE, BASE) == gc.Partition(2, 16, 8, 128, True) and d(82, 2, BASE, BASE)[:2] == (2, 16)
    assert s(32, 2, BASE, BASE) == gc.Partition(8, 4, 8, 512, False) and d(32, 2, BASE, BASE) == gc.Partition(8, 4, 8, 512, False)
    assert s(128, 2, BASE, BASE)[:2] == (8, 16) and d(128, 2, BASE, BASE)[:2] == (8, 16)
    assert s(1280, 2, BASE, BASE)[:3] == (8, 32, 8) and not s(1280, 2, BASE, BASE).staged
    assert d(32, 4, BASE, BASE)[:2] == (4, 8)
    for K in range(1, 300):
        for size in (2, 4):
            for addr in (BASE, BASE + size):
                p = s(K, size, addr, BASE)
                assert p.cells * size % 16 == 0  # a block of an aligned group starts on 16 bytes
                assert p.cells == (gc.THREADS // p.lanes) * p.samples
                assert gc.sample_smem(p.cells, K, size, p.staged) <= gc.MAX_SMEM
                assert p.staged == (p.vec * size < 16)
                assert 4 <= d(K, size, addr, addr).lanes <= 32
