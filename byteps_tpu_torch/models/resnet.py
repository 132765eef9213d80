"""ResNet family; port of ``byteps_tpu/models/resnet.py``.

The JAX package's conventions hold at the public function: input is
**NHWC** (the forward permutes it to a channels-last NCHW view),
convolutions and the residual path run in ``compute_dtype`` (bf16 by
default) with f32 parameters, BatchNorm and the classifier run in f32.

Numerics follow flax, not torch's defaults:

- ``SAME`` padding is XLA's: for a strided layer the extra row and
  column go on the high side.  That touches the 7x7/2 stem, the 3x3/2
  conv of each stage's first bottleneck and the 3x3/2 max-pool (padded
  with -inf); torch's symmetric ``padding=`` would give other values.
- BatchNorm (``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``) normalizes with
  the *biased* batch variance and updates the running variance with it
  too, ``ra = 0.9 * ra + 0.1 * batch`` (torch's ``momentum=0.1`` rule,
  but ``F.batch_norm``'s own running update would use the unbiased one).

Set ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` explicitly before comparing f32
runs on the card: cuDNN convolutions default to TF32.

:func:`load_flax_resnet` carries the JAX package's parameters (numpy
arrays in flax's tree) into a port model: conv kernels HWIO -> OIHW,
dense kernels (in, out) -> (out, in), BatchNorm scale, bias, mean and var
as they are.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA SAME padding (lo, hi) of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel, strides, value: float = 0.0):
    (t, b) = _same_pads(x.shape[-2], kernel[0], strides[0])
    (l, r) = _same_pads(x.shape[-1], kernel[1], strides[1])
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b), value=value)
    return x


def max_pool_same(x: torch.Tensor, window=(3, 3), strides=(2, 2)):
    """flax ``nn.max_pool(..., padding="SAME")``: -inf padding."""
    x = _pad_same(x, window, strides, value=float("-inf"))
    return F.max_pool2d(x, window, strides)


class BatchNorm(nn.Module):
    """flax BatchNorm over the channels of an NCHW f32 tensor."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, None, None, self.scale, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y


class ConvBN(nn.Module):
    """SAME conv (no bias) in the compute dtype -> f32 BatchNorm -> ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 act: bool = True):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.compute_dtype = compute_dtype
        self.act = act
        self.weight = nn.Parameter(torch.empty(features, in_ch, *kernel))
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b) = _same_pads(x.shape[-2], self.kernel[0], self.strides[0])
        (l, r) = _same_pads(x.shape[-1], self.kernel[1], self.strides[1])
        w = self.weight.to(self.compute_dtype)
        if t == b and l == r:
            x = F.conv2d(x, w, stride=self.strides, padding=(t, l))
        else:
            x = F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.strides)
        x = self.bn(x.to(torch.float32)).to(self.compute_dtype)
        return F.relu(x) if self.act else x


class Bottleneck(nn.Module):
    """ResNet-v1.5 bottleneck: 1x1 reduce, 3x3 (carries the stride),
    1x1 expand, residual add."""

    def __init__(self, in_ch: int, features: int, strides=(1, 1),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = features * 4
        cd = compute_dtype
        self.convs = nn.ModuleList([
            ConvBN(in_ch, features, (1, 1), compute_dtype=cd),
            ConvBN(features, features, (3, 3), strides, compute_dtype=cd),
            ConvBN(features, out, (1, 1), compute_dtype=cd, act=False)])
        self.proj = (ConvBN(in_ch, out, (1, 1), strides, compute_dtype=cd,
                            act=False)
                     if in_ch != out or tuple(strides) != (1, 1) else None)
        self.out_channels = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for c in self.convs:
            y = c(y)
        residual = x if self.proj is None else self.proj(x)
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    """ResNet-18/34 block: two 3x3 convs and a residual add."""

    def __init__(self, in_ch: int, features: int, strides=(1, 1),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cd = compute_dtype
        self.convs = nn.ModuleList([
            ConvBN(in_ch, features, (3, 3), strides, compute_dtype=cd),
            ConvBN(features, features, (3, 3), compute_dtype=cd, act=False)])
        self.proj = (ConvBN(in_ch, features, (1, 1), strides,
                            compute_dtype=cd, act=False)
                     if in_ch != features or tuple(strides) != (1, 1)
                     else None)
        self.out_channels = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for c in self.convs:
            y = c(y)
        residual = x if self.proj is None else self.proj(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet on NHWC input; ``stage_sizes`` and ``block`` select the
    depth.  Weights are drawn from ``generator`` (lecun-normal conv and
    dense kernels, zero biases, unit BatchNorm scales)."""

    def __init__(self, stage_sizes: Sequence[int], block,
                 num_classes: int = 1000, width: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = ConvBN(3, width, (7, 7), (2, 2),
                           compute_dtype=compute_dtype)
        blocks, in_ch = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                blk = block(in_ch, width * 2 ** i, strides,
                            compute_dtype=compute_dtype)
                blocks.append(blk)
                in_ch = blk.out_channels
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(in_ch, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, ConvBN):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
        self.fc.weight.normal_(0.0, 1.0 / math.sqrt(self.fc.in_features),
                               generator=generator)
        self.fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)   # NHWC -> NCHW
        x = max_pool_same(self.stem(x))
        for blk in self.blocks:
            x = blk(x)
        x = x.mean(dim=(2, 3))                               # global pool
        return self.fc(x.to(torch.float32))


def resnet50(num_classes: int = 1000,
             compute_dtype: torch.dtype = torch.bfloat16,
             generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes=num_classes,
                  compute_dtype=compute_dtype, generator=generator)


def resnet_tiny(num_classes: int = 10,
                compute_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> ResNet:
    """CI-sized: one basic block per stage, two stages, width 8."""
    return ResNet((1, 1), BasicBlock, num_classes=num_classes, width=8,
                  compute_dtype=compute_dtype, generator=generator)


def synthetic_images(generator: torch.Generator, batch: int, size: int = 224,
                     num_classes: int = 1000, device="cpu"):
    """A synthetic NHWC batch: ``{"images": (batch, size, size, 3) f32,
    "labels": (batch,) int64}``, drawn from ``generator``."""
    images = torch.randn(batch, size, size, 3, generator=generator)
    labels = torch.randint(0, num_classes, (batch,), generator=generator)
    return {"images": images.to(device), "labels": labels.to(device)}


@torch.no_grad()
def load_flax_resnet(model: ResNet, params, batch_stats=None) -> ResNet:
    """Copy the JAX package's ResNet variables (flax trees of numpy
    arrays) into ``model`` in place.  Every leaf must be consumed."""
    used = [0]

    def put(dst: torch.Tensor, src, perm=None) -> None:
        t = torch.from_numpy(np.array(src, dtype=np.float32))
        if perm is not None:
            t = t.permute(*perm)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(t)
        used[0] += 1

    def conv_bn(m: ConvBN, p, s) -> None:
        put(m.weight, p["Conv_0"]["kernel"], (3, 2, 0, 1))   # HWIO -> OIHW
        put(m.bn.scale, p["BatchNorm_0"]["scale"])
        put(m.bn.bias, p["BatchNorm_0"]["bias"])
        if s is not None:
            put(m.bn.mean, s["BatchNorm_0"]["mean"])
            put(m.bn.var, s["BatchNorm_0"]["var"])

    bs = batch_stats or {}
    conv_bn(model.stem, params["ConvBN_0"], bs.get("ConvBN_0"))
    kind = type(model.blocks[0]).__name__
    for i, blk in enumerate(model.blocks):
        p, s = params[f"{kind}_{i}"], bs.get(f"{kind}_{i}", {})
        for j, c in enumerate(blk.convs):
            conv_bn(c, p[f"ConvBN_{j}"], s.get(f"ConvBN_{j}"))
        if blk.proj is not None:
            j = len(blk.convs)
            conv_bn(blk.proj, p[f"ConvBN_{j}"], s.get(f"ConvBN_{j}"))
    put(model.fc.weight, params["Dense_0"]["kernel"], (1, 0))  # (in, out)
    put(model.fc.bias, params["Dense_0"]["bias"])

    def count(tree) -> int:
        return (sum(count(v) for v in tree.values())
                if isinstance(tree, Mapping) else 1)

    if used[0] != count(params) + count(bs):
        raise ValueError(f"load_flax_resnet used {used[0]} of "
                         f"{count(params) + count(bs)} flax leaves")
    return model
