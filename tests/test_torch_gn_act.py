"""The CenterNet head's GroupNorm and ReLU in one pass (``ops/gn_act_cuda.py``)
on the CPU: the plain version bit-equal to the path it replaced and close
to Flax's GroupNorm and ReLU, the head's dispatch rule, the head's CPU
output unchanged, the kernel's partition and the arithmetic of its
two-stage reduction. The kernel itself runs on the card
(``chip_smoke.py --gn-act`` holds it to this plain version).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vsta_tpu_torch import kernels
from vsta_tpu_torch.models.heads import GN_EPS, GN_GROUPS, BEVDetectorHead
from vsta_tpu_torch.ops import gn_act_cuda

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)

N, H, W = 2, 9, 13


def gn_inputs(C, seed=0, offset=0.0):
    """An NHWC map (numpy f32) whose channels have their own mean (plus
    ``offset``) and spread, and GroupNorm's weight and bias [C]."""
    rng = np.random.default_rng(seed)
    mean = (offset + rng.standard_normal(C)).astype(np.float32)
    std = rng.uniform(0.3, 2.0, C).astype(np.float32)
    x = (mean + std * rng.standard_normal((N, H, W, C))).astype(np.float32)
    weight = (1 + 0.5 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(C)).astype(np.float32)
    return x, torch.from_numpy(weight), torch.from_numpy(bias)


def as_layout(x_nhwc: np.ndarray, dtype, layout: str) -> torch.Tensor:
    """[N, C, H, W] in ``layout``: channels-last strides (as the head's
    convolutions give them) or NCHW-contiguous."""
    t = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
    return t if layout == "nhwc" else t.contiguous()


def kernel_refused(*_args, **_kw):
    raise AssertionError("the CUDA kernel's library was loaded on the CPU")


@pytest.mark.parametrize("C", [512, 128])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_two_step_path(dtype, layout, C):
    """``gn_act_ref`` and ``gn_act`` on the CPU: bit-equal to the head's
    path before the kernel (``F.group_norm`` in f32, the cast, ``F.relu``);
    the dtype kept."""
    x, weight, bias = gn_inputs(C)
    xt = as_layout(x, dtype, layout)
    want = F.relu(F.group_norm(xt.float(), GN_GROUPS, weight, bias, GN_EPS).to(dtype))
    got = gn_act_cuda.gn_act_ref(xt, weight, bias, GN_GROUPS, GN_EPS, "relu")
    direct = gn_act_cuda.gn_act(xt, weight, bias, GN_GROUPS, GN_EPS, "relu")
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(direct, want)
    plain = gn_act_cuda.gn_act_ref(xt, weight, bias, GN_GROUPS, GN_EPS)
    assert torch.equal(plain, F.group_norm(xt.float(), GN_GROUPS, weight, bias, GN_EPS).to(dtype))


@pytest.mark.parametrize("C", [512, 128])
def test_plain_version_matches_flax(C):
    """bf16, against ``nn.GroupNorm(32, epsilon=1e-5, dtype=bfloat16)`` and
    ``nn.relu``: |got - want| <= 1 bf16 ulp of |want| + 2^-17 (|want| +
    |bias|).

    Both take each group's mean and variance of the same bf16 values in
    f32 and round the f32 result once to bf16, so away from 0 they differ
    by one bf16 step at most, where the two f32 values straddle a rounding
    boundary. The f32 statistics differ: PyTorch's are exact-order sums,
    Flax's the fast variance E[x^2] - E[x]^2 (its mean read against the
    f64 statistics 24 to 39 bf16 ulps off where the result nears 0). Each
    side's error in the pre-activation (x - mean) * mul + bias is a few
    f32 units of its terms, at most |bias| + |y| (1,872-value sums and the
    variance's cancellation: about 2^-20 of them on these maps), so a
    result near 0, whose bf16 step is smaller than that, may lie more
    steps apart: the second term holds it, with room of 8.
    """
    x, weight, bias = gn_inputs(C, seed=1)
    m = nn.GroupNorm(num_groups=GN_GROUPS, epsilon=GN_EPS, dtype=jnp.bfloat16)
    v = {"params": {"scale": weight.numpy(), "bias": bias.numpy()}}
    want = jax.jit(lambda v, a: nn.relu(m.apply(v, a)))(v, jnp.asarray(x).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = gn_act_cuda.gn_act_ref(as_layout(x, torch.bfloat16, "nhwc"), weight, bias, GN_GROUPS, GN_EPS, "relu")
    got = got.permute(0, 2, 3, 1).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    tol = ulp + 2.0**-17 * (np.abs(want) + np.abs(bias.numpy()))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    # away from 0 the bound is one bf16 step
    far = np.abs(want) >= 2.0**-6
    assert far.mean() > 0.3 and (np.abs(got - want)[far] <= ulp[far]).all()


def make_head(dtype=torch.bfloat16, in_ch=34, mid1=64, mid2=32, seed=0):
    torch.manual_seed(seed)
    head = BEVDetectorHead(in_ch, (-12.0, 12.0, -4.0, 4.0), (H, W), mid1=mid1, mid2=mid2, dtype=dtype).eval()
    with torch.no_grad():
        for gn in (head.gn0, head.gn1, head.gn2):
            gn.weight.copy_(1 + 0.5 * torch.randn(gn.weight.shape))
            gn.bias.copy_(0.5 * torch.randn(gn.bias.shape))
        head.offset_head.weight.copy_(0.05 * torch.randn(head.offset_head.weight.shape))
    return head


@pytest.mark.parametrize(
    "case,fused",
    [("bf16 nhwc", True), ("bf16 nchw", False), ("f32", False), ("strided view", False),
     ("x requires grad", False), ("weights require grad", False), ("weights require grad, no_grad", True),
     ("x requires grad, no_grad", True)],
)
def test_dispatch_rule(monkeypatch, case, fused):
    """``BEVDetectorHead.fused``: the kernel takes a bfloat16 channels-last
    map when no gradient is wanted; NCHW, f32, a strided view and a call
    that wants a gradient take the plain version. On the CPU no call loads
    the kernel: every case equals the plain version."""
    monkeypatch.setattr(gn_act_cuda, "_library", kernel_refused)
    head = make_head()
    gn = head.gn1
    gn.weight.requires_grad_("weights require grad" in case)
    gn.bias.requires_grad_("weights require grad" in case)
    x, _, _ = gn_inputs(32, seed=2)
    xt = as_layout(x, torch.float32 if case == "f32" else torch.bfloat16, "nchw" if "nchw" in case else "nhwc")
    if case == "strided view":
        xt = torch.cat([xt, xt], dim=3)[..., ::2]
        assert not xt.is_contiguous() and not xt.is_contiguous(memory_format=torch.channels_last)
    xt.requires_grad_("x requires grad" in case)
    with torch.set_grad_enabled("no_grad" not in case):
        assert head.fused(xt, gn) is fused
        got = head._gn_relu(xt, gn)
        want = gn_act_cuda.gn_act_ref(xt, gn.weight, gn.bias, gn.num_groups, gn.eps, "relu")
        assert torch.equal(got.detach(), want.detach())
        assert got.requires_grad == want.requires_grad


@pytest.mark.parametrize("arg", ["act", "channels", "groups", "vector dtype", "ndim", "layout", "not the CPU"])
def test_kernel_refusals(arg):
    """``takes`` refuses what the kernel cannot take, on any device; the
    wrapper refuses an unknown activation, and a tensor off the CPU that
    ``takes`` refuses raises rather than fall back."""
    x, weight, bias = gn_inputs(128, seed=3)
    xt = as_layout(x, torch.bfloat16, "nhwc")
    assert gn_act_cuda.takes(xt, weight, bias, GN_GROUPS)
    if arg == "act":
        with pytest.raises(ValueError, match="act"):
            gn_act_cuda.gn_act(xt, weight, bias, GN_GROUPS, GN_EPS, "silu")
    elif arg == "channels":
        for C in (12, gn_act_cuda.MAX_CHANNELS + 8):
            t = torch.zeros(1, C, 2, 2, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
            assert not gn_act_cuda.takes(t, torch.zeros(C), torch.zeros(C), 4)
    elif arg == "groups":
        assert not gn_act_cuda.takes(xt, weight, bias, 48)
    elif arg == "vector dtype":
        assert not gn_act_cuda.takes(xt, weight.double(), bias, GN_GROUPS)
    elif arg == "ndim":
        assert not gn_act_cuda.takes(xt[0], weight, bias, GN_GROUPS)
    elif arg == "layout":
        assert not gn_act_cuda.takes(xt.contiguous(), weight, bias, GN_GROUPS)
    else:
        meta = torch.empty(xt.shape, dtype=torch.float32, device="meta")
        with pytest.raises(ValueError, match="gn_act takes"):
            gn_act_cuda.gn_act(meta, weight.to("meta"), bias.to("meta"), GN_GROUPS, GN_EPS, "relu")


def test_kernel_is_a_counted_wrapper():
    """The kernel's wrapper is listed with the others, so the launch counts
    and the card's checks see it; on the CPU it never counts a launch."""
    assert gn_act_cuda.gn_act in kernels.wrappers(ablation=False)
    before = kernels.launch_counts()["gn_act"]
    x, weight, bias = gn_inputs(128)
    gn_act_cuda.gn_act(as_layout(x, torch.bfloat16, "nhwc"), weight, bias, GN_GROUPS, GN_EPS, "relu")
    assert kernels.launch_counts()["gn_act"] == before


def parent_forward(head, bev_feat):
    """``BEVDetectorHead.forward`` as it stood before the kernel."""
    def gn(x, m):
        return F.group_norm(x.float(), m.num_groups, m.weight, m.bias, m.eps).to(x.dtype)

    d, f32 = head.dtype, torch.float32
    x = bev_feat.permute(0, 3, 1, 2)
    y = F.relu(gn(head._conv(x, head.stem0, d), head.gn0))
    y = F.relu(gn(head._conv(y, head.stem1, d), head.gn1))
    shared = F.relu(gn(head._conv(y, head.stem2, d), head.gn2))
    hm, off, size = (head._conv(shared, c, f32).permute(0, 2, 3, 1)
                     for c in (head.heatmap_head, head.offset_head, head.size_head))
    return {"heatmap_logits": hm, "heatmap": torch.sigmoid(hm), "offset_raw": off, "offset": torch.sigmoid(off),
            "size_raw": size, "size": torch.exp(size)}


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_cpu_output_unchanged(monkeypatch, dtype, grad):
    """The head on the CPU, bf16 and f32, with and without grad mode: every
    output bit-equal to the parent's forward, the kernel never loaded."""
    monkeypatch.setattr(gn_act_cuda, "_library", kernel_refused)
    head = make_head(dtype)
    bev = torch.from_numpy(np.random.default_rng(4).standard_normal((N, H, W, 34)).astype(np.float32))
    with torch.set_grad_enabled(grad):
        got, want = head(bev), parent_forward(head, bev)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_chunks_fill_the_card(monkeypatch):
    """The blocks a frame: 4 an SM over the batch (the head's 120 x 360
    cells on an H100's 132 SMs: 33 chunks a frame at batch 16, 528 at
    batch 1), never more than a block a row of cells."""
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    dev = torch.device("cuda", 0)
    assert gn_act_cuda.chunks(dev, 16, 120 * 360, 512) == 33
    assert gn_act_cuda.chunks(dev, 1, 120 * 360, 512) == 528
    assert gn_act_cuda.chunks(dev, 1, 120 * 360, 128) == 528
    assert gn_act_cuda.chunks(dev, 7, 120 * 360, 128) == 76  # 532 blocks: every SM once, a few twice
    assert gn_act_cuda.chunks(dev, 1, 40, 128) == 3  # 16 cells a row: 40 cells take 3 blocks
    assert gn_act_cuda.chunks(dev, 1000, 4, 2048) == 1


def merge(a, b):
    """Chan et al.'s pairwise update of (count, mean, M2), as the kernel's
    ``merge`` computes it in float32; an empty b changes nothing."""
    na, ma, m2a = a
    nb, mb, m2b = b
    if nb == 0:
        return a
    f32 = np.float32
    n = f32(na + nb)
    d = f32(mb - ma)
    f = f32(nb / n)
    return n, f32(ma + d * f), f32(m2a + m2b + d * d * f32(na) * f)


def kernel_moments(x, groups, n_chunks, rows):
    """The statistics of ``csrc/gn_act.cu`` for x [N, HW, C] (float32 of
    bf16 values), in its order: a thread's shifted sums over every
    ``rows``-th cell of its chunk, the rows merged channel by channel, the
    group's channels, then the chunks by 32 lanes and a shuffle tree.
    Returns mean and biased variance [N, groups] (float32)."""
    f32 = np.float32
    Nn, hw, C = x.shape
    cpg, chunk = C // groups, -(-hw // n_chunks)
    mean, var = np.zeros((Nn, groups), f32), np.zeros((Nn, groups), f32)
    for n in range(Nn):
        parts = []
        for k in range(n_chunks):
            p0, p1 = k * chunk, min(k * chunk + chunk, hw)
            per_c = [(f32(0), f32(0), f32(0))] * C
            for r in range(rows):
                cells = x[n, p0 + r:p1:rows] if p1 > p0 + r else x[n, :0]
                cnt = len(cells)
                shift = cells[0] if cnt else np.zeros(C, f32)
                s1, s2 = np.zeros(C, f32), np.zeros(C, f32)
                for v in cells:
                    d = (v - shift).astype(f32)
                    s1, s2 = (s1 + d).astype(f32), (s2 + d * d).astype(f32)
                q = s1 / f32(cnt) if cnt else np.zeros(C, f32)
                m = (shift + q).astype(f32)
                m2 = np.maximum(s2 - s1 * q, 0).astype(f32) if cnt else np.zeros(C, f32)
                per_c = [merge(per_c[c], (f32(cnt), m[c], m2[c])) for c in range(C)]
            cells = f32(max(p1 - p0, 0))
            for g in range(groups):
                s = (f32(0), f32(0), f32(0))
                for c in range(g * cpg, (g + 1) * cpg):
                    s = merge(s, (cells, per_c[c][1], per_c[c][2]))
                parts.append((k, g, f32(max(p1 - p0, 0) * cpg), s[1], s[2]))
        for g in range(groups):
            lanes = [(f32(0), f32(0), f32(0))] * 32
            for k, gg, cnt, m, m2 in parts:
                if gg == g:
                    lanes[k % 32] = merge(lanes[k % 32], (cnt, m, m2))
            o = 16
            while o:
                lanes = [merge(lanes[i], lanes[i + o]) if i < o else lanes[i] for i in range(32)]
                o //= 2
            mean[n, g], var[n, g] = lanes[0][1], lanes[0][2] / lanes[0][0]
    return mean, var


@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("C,n_chunks", [(128, 5), (512, 40)])
def test_reduction_arithmetic(C, n_chunks, offset):
    """The kernel's two-stage reduction, replayed in float32 numpy, against
    float64 statistics: means within 2 float32 units of their size and
    1e-6 of the group's spread, variances within 1e-5 relative, also where
    every mean sits 100 spreads from 0 (the shift keeps the sum of squares
    from cancelling). Row counts include rows and chunks with no cells (40
    chunks of 3 cells, the last empty, 4 rows)."""
    x, _, _ = gn_inputs(C, seed=5, offset=offset)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy().reshape(N, H * W, C)
    mean, var = kernel_moments(x, GN_GROUPS, n_chunks, rows=256 // (C // 8))
    g = x.astype(np.float64).reshape(N, H * W, GN_GROUPS, C // GN_GROUPS)
    m64, v64 = g.mean(axis=(1, 3)), g.var(axis=(1, 3))
    assert (np.abs(mean - m64) <= 2.0**-22 * np.abs(m64) + 1e-6 * np.sqrt(v64)).all()
    assert (np.abs(var - v64) <= 1e-5 * v64).all()
