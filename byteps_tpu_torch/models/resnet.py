"""ResNet and VGG; port of ``byteps_tpu/models/resnet.py``.

The JAX package's conventions hold at the public function: input is
**NHWC** (the forward permutes it to a channels-last NCHW view),
convolutions and the residual path run in ``compute_dtype`` (bf16 by
default) with f32 parameters, BatchNorm and the classifier run in f32.
A model made f16 with ``.half()`` (and ``compute_dtype=torch.float16``)
keeps BatchNorm in f32, reading its f16 parameters in f32, and runs the
classifier in f16.

Numerics follow flax, not torch's defaults:

- ``SAME`` padding is XLA's: for a strided layer the extra row and
  column go on the high side.  That touches the 7x7/2 stem, the 3x3/2
  conv of each stage's first bottleneck and the 3x3/2 max-pool (padded
  with -inf); torch's symmetric ``padding=`` would give other values.
- BatchNorm (``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``) normalizes with
  the *biased* batch variance and updates the running variance with it
  too, ``ra = 0.9 * ra + 0.1 * batch`` (torch's ``momentum=0.1`` rule,
  but ``F.batch_norm``'s own running update would use the unbiased one).
- Cross-replica BatchNorm (flax's ``axis_name``): a model built with
  ``bn_group`` (a process group, ``torch.distributed.group.WORLD`` for
  the world) takes its batch statistics over the group's global batch.
  As flax does, each rank's per-channel mean and mean of squares are
  averaged over the group in one all-reduce and ``var = E[x^2] -
  E[x]^2`` (clipped at 0); the all-reduce is
  ``torch.distributed.nn.functional.all_reduce``, whose backward
  all-reduces the cotangent, so the gradient keeps the cross-rank term.
  Running statistics then move identically on every rank.  Without a
  group the variance is the two-pass one (ROADMAP Queue C 3).
- VGG's ``nn.Conv`` and ``nn.Dense`` in bf16 round the product before
  the bias is added, and so does the port; VGG flattens its last
  feature map in NHWC order, as flax does (the port's convolutions run
  NCHW and permute first).  Dropout keeps each element with probability
  0.5 and scales kept ones by 2, drawing from the model's
  ``dropout_generator``.

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
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .gpt import Dense


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
    """flax BatchNorm over the channels of an NCHW f32 tensor; with a
    ``group`` of more than one rank, over the group's global batch."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, group: Any = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.group = group
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # an f16 model's parameters and statistics are read in f32 here
        # (``.to`` of an f32 tensor is the tensor itself)
        scale, bias = self.scale.to(x.dtype), self.bias.to(x.dtype)
        if not self.training:
            return F.batch_norm(x, self.mean.to(x.dtype),
                                self.var.to(x.dtype), scale, bias, False,
                                0.0, self.eps)
        if self.group is not None:
            y, mean, var = self._cross_replica(x, scale, bias)
        else:
            y = F.batch_norm(x, None, None, scale, bias, True, 0.0,
                             self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y

    def _cross_replica(self, x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor):
        """flax's ``_compute_stats`` with ``axis_name`` and its
        ``_normalize``: the group mean of the per-rank (mean, mean of
        squares), then ``(x - mean) * (rsqrt(var + eps) * scale) +
        bias``."""
        dims = (0, 2, 3)
        stats = torch.stack([x.mean(dims), (x * x).mean(dims)])
        n = dist.get_world_size(self.group)
        if n > 1:
            from torch.distributed.nn.functional import all_reduce
            stats = all_reduce(stats, group=self.group) / n
        mean, mean2 = stats[0], stats[1]
        var = (mean2 - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * scale
        y = (x - mean[:, None, None]) * mul[:, None, None] + bias[:, None,
                                                                  None]
        return y, mean.detach(), var.detach()


class ConvBN(nn.Module):
    """SAME conv (no bias) in the compute dtype -> f32 BatchNorm -> ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 act: bool = True, bn_group: Any = None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.compute_dtype = compute_dtype
        self.act = act
        self.weight = nn.Parameter(torch.empty(features, in_ch, *kernel))
        self.bn = BatchNorm(features, group=bn_group)

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
                 compute_dtype: torch.dtype = torch.bfloat16,
                 bn_group: Any = None):
        super().__init__()
        out = features * 4
        kw = {"compute_dtype": compute_dtype, "bn_group": bn_group}
        self.convs = nn.ModuleList([
            ConvBN(in_ch, features, (1, 1), **kw),
            ConvBN(features, features, (3, 3), strides, **kw),
            ConvBN(features, out, (1, 1), act=False, **kw)])
        self.proj = (ConvBN(in_ch, out, (1, 1), strides, act=False, **kw)
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
                 compute_dtype: torch.dtype = torch.bfloat16,
                 bn_group: Any = None):
        super().__init__()
        kw = {"compute_dtype": compute_dtype, "bn_group": bn_group}
        self.convs = nn.ModuleList([
            ConvBN(in_ch, features, (3, 3), strides, **kw),
            ConvBN(features, features, (3, 3), act=False, **kw)])
        self.proj = (ConvBN(in_ch, features, (1, 1), strides, act=False,
                            **kw)
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
    dense kernels, zero biases, unit BatchNorm scales).  ``bn_group``
    makes every BatchNorm cross-replica over that process group."""

    def __init__(self, stage_sizes: Sequence[int], block,
                 num_classes: int = 1000, width: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 bn_group: Any = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = ConvBN(3, width, (7, 7), (2, 2),
                           compute_dtype=compute_dtype, bn_group=bn_group)
        blocks, in_ch = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                blk = block(in_ch, width * 2 ** i, strides,
                            compute_dtype=compute_dtype, bn_group=bn_group)
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
        # f32 for an f32 model, f16 for one made f16 with .half()
        return self.fc(x.to(self.fc.weight.dtype))


def resnet50(num_classes: int = 1000,
             compute_dtype: torch.dtype = torch.bfloat16,
             generator: Optional[torch.Generator] = None,
             bn_group: Any = None) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes=num_classes,
                  compute_dtype=compute_dtype, generator=generator,
                  bn_group=bn_group)


def resnet18(num_classes: int = 1000,
             compute_dtype: torch.dtype = torch.bfloat16,
             generator: Optional[torch.Generator] = None,
             bn_group: Any = None) -> ResNet:
    """ResNet-18: two basic blocks in each of four stages."""
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes=num_classes,
                  compute_dtype=compute_dtype, generator=generator,
                  bn_group=bn_group)


def resnet_tiny(num_classes: int = 10,
                compute_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                bn_group: Any = None) -> ResNet:
    """CI-sized: one basic block per stage, two stages, width 8."""
    return ResNet((1, 1), BasicBlock, num_classes=num_classes, width=8,
                  compute_dtype=compute_dtype, generator=generator,
                  bn_group=bn_group)


VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class VGG(nn.Module):
    """VGG (configuration D by default: VGG-16) on NHWC input of
    ``image_size`` squared; convolutions and the two hidden dense layers
    in ``compute_dtype``, the classifier in f32.  flax infers the first
    dense layer's width at its first call; here it follows from
    ``image_size``.  Dropout (training only) draws from
    ``dropout_generator`` (None: torch's default generator)."""

    def __init__(self, cfg: Sequence = VGG16_CFG, num_classes: int = 1000,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224, device=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = tuple(cfg)
        self.compute_dtype = compute_dtype
        self.dropout_generator = dropout_generator
        self.keep_prob = 0.5                  # flax nn.Dropout(0.5)
        convs, in_ch, size = [], 3, image_size
        for v in self.cfg:
            if v == "M":
                size //= 2
            else:
                convs.append(nn.Conv2d(in_ch, v, 3, padding=1,
                                       device=device))
                in_ch = v
        self.convs = nn.ModuleList(convs)
        width = size * size * in_ch
        self.dense = nn.ModuleList([
            Dense((width,), (4096,), compute_dtype, device=device),
            Dense((4096,), (4096,), compute_dtype, device=device),
            Dense((4096,), (num_classes,), torch.float32, device=device)])
        self.reset_parameters(generator or torch.Generator(
            device=device or "cpu").manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for c in self.convs:
            c.weight.normal_(0.0, 1.0 / math.sqrt(c.weight[0].numel()),
                             generator=generator)
            c.bias.zero_()
        for d in self.dense:
            d.kernel.normal_(0.0, 1.0 / math.sqrt(d.kernel.shape[0]),
                             generator=generator)

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability ``keep_prob`` and
        divide the kept elements by it."""
        keep = torch.rand(x.shape, generator=self.dropout_generator,
                          device=x.device) < self.keep_prob
        return torch.where(keep, x / self.keep_prob, torch.zeros_like(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.permute(0, 3, 1, 2).to(cd)                     # NHWC -> NCHW
        convs = iter(self.convs)
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                c = next(convs)
                x = F.conv2d(x, c.weight.to(cd), padding=1)
                x = F.relu(x + c.bias.to(cd)[:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # flax's order
        for d in self.dense[:2]:
            x = F.relu(d(x))
            if self.training:
                x = self._dropout(x)
        return self.dense[2](x.float())


def vgg16(num_classes: int = 1000,
          compute_dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
          device=None, generator: Optional[torch.Generator] = None,
          dropout_generator: Optional[torch.Generator] = None) -> VGG:
    return VGG(num_classes=num_classes, compute_dtype=compute_dtype,
               image_size=image_size, device=device, generator=generator,
               dropout_generator=dropout_generator)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under
    ``log_softmax(logits)`` in f32, as the JAX function."""
    logp = F.log_softmax(logits.float(), dim=1)
    return -logp.gather(1, labels.long()[:, None]).squeeze(1).mean()


def make_vision_trainer(comm, model: nn.Module, optimizer):
    """The data-parallel step for the vision models (JAX
    ``resnet.py:202-248``): ``step(batch) -> loss`` on ``{"images",
    "labels"}`` batches, the loss averaged over ranks.

    ``model`` is replicated from rank 0 and put in training mode, and
    trains through ``make_dp_train_step``.  A model with BatchNorm
    (ResNet) keeps its running statistics in its buffers, updated by the
    forward and replica-identical when it was built with ``bn_group`` (the
    JAX trainer's ``make_dp_train_step_with_state``).  VGG trains with
    real dropout drawn from the model's ``dropout_generator`` (a fresh
    mask each step; the JAX trainer fixes one key for every step).
    """
    from ..parallel.data_parallel import make_dp_train_step, replicate
    replicate(comm, model)
    model.train()

    def loss_fn(m, b):
        return softmax_cross_entropy(m(b["images"]), b["labels"])

    return make_dp_train_step(comm, model, loss_fn, optimizer)


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


@torch.no_grad()
def load_flax_vgg(model: VGG, params) -> VGG:
    """Copy the JAX package's VGG parameters (``variables["params"]``,
    numpy arrays) into ``model`` in place: ``Conv_{i}`` kernels HWIO ->
    OIHW, ``Dense_{j}`` kernels as they are (the port's ``Dense`` keeps
    flax's ``(in, out)``).  Every leaf must be consumed."""
    want = ({f"Conv_{i}" for i in range(len(model.convs))}
            | {f"Dense_{j}" for j in range(len(model.dense))})
    if set(params) != want:
        raise ValueError(f"flax VGG tree has {sorted(params)}, expected "
                         f"{sorted(want)}")

    def put(dst: torch.Tensor, src, perm=None) -> None:
        t = torch.from_numpy(np.array(src, dtype=np.float32))
        if perm is not None:
            t = t.permute(*perm)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(t)

    for i, c in enumerate(model.convs):
        put(c.weight, params[f"Conv_{i}"]["kernel"], (3, 2, 0, 1))
        put(c.bias, params[f"Conv_{i}"]["bias"])
    for j, d in enumerate(model.dense):
        put(d.kernel, params[f"Dense_{j}"]["kernel"])
        put(d.bias, params[f"Dense_{j}"]["bias"])
    return model
