"""The port's BatchNorm with its activation (``BatchNorm.forward(x, act=)``)
and the plain version of the one-pass kernel (``ops/bn_act_cuda.py``) on
the CPU: the plain version bit-equal to the two-step path it replaced,
against Flax's BatchNorm and SiLU, the dispatch rule, and training mode
unchanged. The kernel itself runs on the card (``chip_smoke.py --bn-act``
holds it to this plain version).

Tolerance against Flax, in bf16 ulps of JAX's value: 1 without the SiLU
(the f32 arithmetic may round in another order, which moves a value that
lies on a bf16 rounding boundary by one step); 3 with it (JAX's SiLU
rounds the sigmoid and the product to bf16 each, 2 ulps from the one
rounding of an f32 SiLU, plus that one step).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vsta_tpu_torch import kernels
from vsta_tpu_torch.models.encoders.norm import BN_MOMENTUM, BatchNorm
from vsta_tpu_torch.ops import bn_act_cuda

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)

N, C, H, W = 2, 24, 9, 13
EPS = 1e-3


def stats(seed=0):
    """Running mean and var, weight and bias [C] float32, and an NHWC map
    around the statistics (numpy)."""
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(C).astype(np.float32)
    var = rng.uniform(0.3, 3.0, C).astype(np.float32)
    weight = (1 + 0.5 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(C)).astype(np.float32)
    x = (mean + np.sqrt(var) * rng.standard_normal((N, H, W, C))).astype(np.float32)
    return x, mean, var, weight, bias


def make_bn(mean, var, weight, bias, train=False):
    bn = BatchNorm(C, EPS).train(train)
    with torch.no_grad():
        for t, a in zip((bn.running_mean, bn.running_var, bn.weight, bn.bias), (mean, var, weight, bias)):
            t.copy_(torch.from_numpy(a))
    return bn


def as_layout(x_nhwc: np.ndarray, dtype, layout: str) -> torch.Tensor:
    """[N, C, H, W] in ``layout``: channels-last strides (as the trunk's
    maps come) or NCHW-contiguous."""
    t = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
    return t if layout == "nhwc" else t.contiguous()


def bf16_ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    return np.abs(got - want) / ulp


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_two_step_path(dtype, layout, act):
    """Eval mode on the CPU: bit-equal to ``F.batch_norm`` in f32, the cast
    and ``F.silu``, the path the callers ran before ``act``; x's layout
    kept."""
    x, mean, var, weight, bias = stats()
    bn = make_bn(mean, var, weight, bias)
    xt = as_layout(x, dtype, layout)
    with torch.no_grad():
        got = bn(xt, act=act)
        want = F.batch_norm(xt.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, EPS)
        want = want.to(dtype)
        want = F.silu(want) if act == "silu" else want
        direct = bn_act_cuda.bn_act(xt, bn.running_mean, bn.running_var, bn.weight, bn.bias, EPS, act)
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(direct, want)
    assert bn_act_cuda.layout(got) == layout


@pytest.mark.parametrize("act", [None, "silu"])
def test_plain_version_matches_flax(act):
    """bf16, against ``nn.BatchNorm(use_running_average=True,
    dtype=bfloat16)`` and ``nn.silu``: 1 bf16 ulp without the SiLU, 3 with
    it (the module docstring says why)."""
    x, mean, var, weight, bias = stats(seed=1)
    m = nn.BatchNorm(use_running_average=True, momentum=BN_MOMENTUM, epsilon=EPS, dtype=jnp.bfloat16)
    v = {"params": {"scale": weight, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}

    def flax_fn(v, a):
        y = m.apply(v, a)
        return nn.silu(y) if act == "silu" else y

    want = jax.jit(flax_fn)(v, jnp.asarray(x).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = make_bn(mean, var, weight, bias)(as_layout(x, torch.bfloat16, "nhwc"), act=act)
    ulps = bf16_ulps(got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert ulps.max() <= (3 if act == "silu" else 1), ulps.max()


def kernel_refused(*_args, **_kw):
    raise AssertionError("the CUDA kernel's library was loaded on the CPU")


@pytest.mark.parametrize(
    "case,fused",
    [("bf16 nchw", True), ("bf16 nhwc", True), ("f32", False), ("strided view", False),
     ("x requires grad", False), ("weights require grad", False), ("weights require grad, no_grad", True),
     ("x requires grad, no_grad", True)],
)
def test_dispatch_rule(monkeypatch, case, fused):
    """``BatchNorm.fused``: the kernel takes a bfloat16 map in either dense
    layout when no gradient is wanted; an f32 map, a strided view and a
    call that wants a gradient take the plain version. On the CPU no call
    loads the kernel: every case equals the plain version."""
    monkeypatch.setattr(bn_act_cuda, "_library", kernel_refused)
    x, mean, var, weight, bias = stats(seed=2)
    bn = make_bn(mean, var, weight, bias)
    bn.weight.requires_grad_("weights require grad" in case)
    bn.bias.requires_grad_("weights require grad" in case)
    xt = as_layout(x, torch.float32 if case == "f32" else torch.bfloat16, "nhwc" if "nhwc" in case else "nchw")
    if case == "strided view":
        xt = torch.cat([xt, xt], dim=3)[..., ::2]
        assert bn_act_cuda.layout(xt) is None
    xt.requires_grad_("x requires grad" in case)
    with torch.set_grad_enabled("no_grad" not in case):
        assert bn.fused(xt) is fused
        for act in (None, "silu"):
            got = bn(xt, act=act)
            want = bn_act_cuda.bn_act_ref(xt, bn.running_mean, bn.running_var, bn.weight, bn.bias, EPS, act)
            assert torch.equal(got.detach(), want.detach())
            assert got.requires_grad == want.requires_grad


@pytest.mark.parametrize("arg", ["act", "channels", "vector dtype", "ndim"])
def test_kernel_refusals(arg):
    """``takes`` refuses what the kernel cannot take and the wrapper
    refuses an unknown activation, on any device."""
    x, mean, var, weight, bias = stats(seed=3)
    xt = as_layout(x, torch.bfloat16, "nhwc")
    vecs = [torch.from_numpy(a) for a in (mean, var, weight, bias)]
    if arg == "act":
        with pytest.raises(ValueError, match="act"):
            bn_act_cuda.bn_act(xt, *vecs, EPS, "relu")
        with pytest.raises(ValueError, match="act"):
            make_bn(mean, var, weight, bias)(xt, act="relu")
        return
    assert bn_act_cuda.takes(xt, *vecs)
    if arg == "channels":
        wide = torch.zeros(1, bn_act_cuda.MAX_CHANNELS + 1, 1, 1, dtype=torch.bfloat16)
        assert not bn_act_cuda.takes(wide, *[torch.zeros(wide.shape[1])] * 4)
    elif arg == "vector dtype":
        assert not bn_act_cuda.takes(xt, vecs[0].double(), *vecs[1:])
    else:
        assert not bn_act_cuda.takes(xt[0], *vecs)


@pytest.mark.parametrize("act", [None, "silu"])
def test_training_mode_unchanged(monkeypatch, act):
    """Training mode normalises with the batch's statistics as before (the
    float64 sums, the biased variance, the running update), then ``act``;
    it reaches neither the kernel nor its plain version."""
    monkeypatch.setattr(bn_act_cuda, "bn_act", kernel_refused)
    monkeypatch.setattr(bn_act_cuda, "bn_act_ref", kernel_refused)
    x, mean, var, weight, bias = stats(seed=4)
    bn = make_bn(mean, var, weight, bias, train=True)
    xt = as_layout(x, torch.bfloat16, "nhwc")
    got = bn(xt, act=act)
    xf = xt.float()
    dims, count = (0, 2, 3), N * H * W
    m, sq = (torch.stack([xf.sum(dims, dtype=torch.float64), (xf * xf).sum(dims, dtype=torch.float64)]) / count).float()
    b_var = torch.clamp(sq - m * m, min=0.0)
    mul = torch.rsqrt(b_var + EPS) * bn.weight
    want = ((xf - m[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]).to(torch.bfloat16)
    want = F.silu(want) if act == "silu" else want
    assert torch.equal(got, want)
    assert got.requires_grad
    torch.testing.assert_close(bn.running_mean, BN_MOMENTUM * torch.from_numpy(mean) + (1 - BN_MOMENTUM) * m,
                               rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, BN_MOMENTUM * torch.from_numpy(var) + (1 - BN_MOMENTUM) * b_var,
                               rtol=0, atol=0)


def test_kernel_is_a_counted_wrapper():
    """The kernel's wrapper is listed with the others, so the launch counts
    and the card's checks see it; on the CPU it never counts a launch."""
    assert bn_act_cuda.bn_act in kernels.wrappers(ablation=False)
    before = kernels.launch_counts()["bn_act"]
    x, mean, var, weight, bias = stats()
    bn_act_cuda.bn_act(as_layout(x, torch.bfloat16, "nhwc"),
                       *[torch.from_numpy(a) for a in (mean, var, weight, bias)], EPS, "silu")
    assert kernels.launch_counts()["bn_act"] == before
