"""The precisions the reference computes its products in.

``exact`` keeps float32. ``fp8`` rounds a tensor to float8 e4m3 with one
scale for the tensor (its largest magnitude at e4m3's largest finite
value, 448), as an fp8 product on the card takes its operands, and in the
backward rounds the gradient that reaches it to e5m2 the same way, as fp8
training does: the control of a configuration that states bfloat16.
``int8`` rounds to 127 steps of the tensor's largest magnitude, forward
and backward: the other control the contract allows for bfloat16.
``bf16`` rounds to bfloat16 (diagnostics only).
"""

from __future__ import annotations

import torch

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0, torch.int8: 127.0}


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def round_scaled(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """x rounded to ``fmt`` under one scale for the tensor, back in float32."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.where(amax > 0, amax / FORMATS[fmt], torch.ones_like(amax))
    if fmt == torch.int8:
        return torch.round(xf / scale).clamp(-127, 127) * scale
    return (xf / scale).to(fmt).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_scaled(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_scaled(g, torch.float8_e5m2)


class _Int8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_scaled(x, torch.int8)

    @staticmethod
    def backward(ctx, g):
        return round_scaled(g, torch.int8)


def fp8(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point() or x.numel() == 0:
        return x
    return _Fp8.apply(x)


def int8(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point() or x.numel() == 0:
        return x
    return _Int8.apply(x)


def bf16(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return xf + (xf.to(torch.bfloat16).float() - xf).detach()


PRECISIONS = {"exact": exact, "fp8": fp8, "int8": int8, "bf16": bf16}
