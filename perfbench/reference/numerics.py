"""The precision the reference computes its products in.

``f32`` leaves every operand as it is.  A lower precision rounds each
product's operands and result in the forward, and the gradient flowing
into it and out of it in the backward, with one scale per tensor (its
largest magnitude onto the format's largest value), the way a mixed
precision step feeds the tensor cores: ``fp8`` is e4m3 forward and e5m2
backward, ``bf16`` bfloat16 both ways.  The arithmetic itself stays
float32.
"""

from __future__ import annotations

import torch

_FORMATS = {
    "fp8": (torch.float8_e4m3fn, torch.float8_e5m2),
    "bf16": (torch.bfloat16, torch.bfloat16),
}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return x.to(dtype).to(x.dtype)
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


class Precision:
    """``q(x)``: ``x`` as a product's operand or result in this
    precision."""

    def __init__(self, name: str = "f32"):
        if name != "f32" and name not in _FORMATS:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        fwd, bwd = _FORMATS[self.name]
        return _Rounded.apply(x, fwd, bwd)


def exact_f32() -> None:
    """Turn TF32 off: a float32 product on the card stays float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
