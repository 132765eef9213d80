"""ResNet-50 (He et al. 2016, arXiv:1512.03385, Table 1's 50-layer
column) in plain float32, v1.5 (the stride on each stage's first 3x3).

The layers as the configuration states them: NHWC input, SAME padding
as TensorFlow and XLA have it (a strided layer's odd padding row and
column on the high side: the 7x7/2 stem, each stage's first 3x3/2, the
3x3/2 max-pool padded with -inf), convolutions without bias, training
BatchNorm over the batch with the biased variance, ReLU, the identity
shortcut or a 1x1 projection where the shape changes, global average
pooling and a dense classifier.  Departure from the paper: none in the
layers; the paper pads symmetrically, the TensorFlow reference and the
configuration pad SAME.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..data import Leaf
from .numerics import Precision


def _conv_bn(out: List[Leaf], prefix: str, cin: int, cout: int,
             k: int) -> None:
    out.append((f"{prefix}.weight", (cout, cin, k, k),
                ("normal", 1.0 / math.sqrt(cin * k * k))))
    out.append((f"{prefix}.bn.scale", (cout,), ("ones",)))
    out.append((f"{prefix}.bn.bias", (cout,), ("zeros",)))


def leaves(config: dict) -> List[Leaf]:
    """Every parameter: conv kernels (out, in, kh, kw) lecun-normal,
    BatchNorm scale 1 and bias 0, the classifier (classes, features)
    lecun-normal with bias 0."""
    width, exp = config["width"], config["bottleneck_expansion"]
    out: List[Leaf] = []
    _conv_bn(out, "stem", config["channels"], width, 7)
    cin, i = width, 0
    for s, n in enumerate(config["stage_sizes"]):
        f = width * 2 ** s
        for j in range(n):
            _conv_bn(out, f"blocks.{i}.convs.0", cin, f, 1)
            _conv_bn(out, f"blocks.{i}.convs.1", f, f, 3)
            _conv_bn(out, f"blocks.{i}.convs.2", f, f * exp, 1)
            if cin != f * exp or (s > 0 and j == 0):
                _conv_bn(out, f"blocks.{i}.proj", cin, f * exp, 1)
            cin, i = f * exp, i + 1
    c = config["num_classes"]
    out.append(("fc.weight", (c, cin), ("normal", 1.0 / math.sqrt(cin))))
    out.append(("fc.bias", (c,), ("zeros",)))
    return out


def _same(size: int, k: int, s: int):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    t, b = _same(x.shape[-2], k, s)
    lft, r = _same(x.shape[-1], k, s)
    return F.pad(x, (lft, r, t, b), value=value)


def _conv_bn_apply(p: Dict[str, torch.Tensor], prefix: str, x, stride: int,
                   relu: bool, eps: float, q: Precision):
    w = p[f"{prefix}.weight"]
    x = q(F.conv2d(q(_pad(x, w.shape[-1], stride)), q(w), stride=stride))
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)
         * p[f"{prefix}.bn.scale"][:, None, None]
         + p[f"{prefix}.bn.bias"][:, None, None])
    return F.relu(x) if relu else x


def logits(p: Dict[str, torch.Tensor], batch: dict, config: dict,
           q: Precision) -> torch.Tensor:
    eps = config["bn_eps"]
    x = batch["images"].permute(0, 3, 1, 2)
    x = _conv_bn_apply(p, "stem", x, 2, True, eps, q)
    x = F.max_pool2d(_pad(x, 3, 2, float("-inf")), 3, 2)
    i = 0
    for s, n in enumerate(config["stage_sizes"]):
        for j in range(n):
            stride = 2 if s > 0 and j == 0 else 1
            pre = f"blocks.{i}"
            y = _conv_bn_apply(p, f"{pre}.convs.0", x, 1, True, eps, q)
            y = _conv_bn_apply(p, f"{pre}.convs.1", y, stride, True, eps, q)
            y = _conv_bn_apply(p, f"{pre}.convs.2", y, 1, False, eps, q)
            short = (_conv_bn_apply(p, f"{pre}.proj", x, stride, False, eps,
                                    q)
                     if f"{pre}.proj.weight" in p else x)
            x = F.relu(y + short)
            i += 1
    x = x.mean(dim=(2, 3))
    return q(q(x) @ q(p["fc.weight"]).t()) + p["fc.bias"]


def loss(p: Dict[str, torch.Tensor], batch: dict, config: dict,
         q: Precision) -> torch.Tensor:
    """Mean cross-entropy of the labels over the batch."""
    logp = F.log_softmax(logits(p, batch, config, q), dim=1)
    return -logp.gather(1, batch["labels"][:, None]).mean()


# BatchNorm takes its statistics over the whole batch: the loss of a
# batch is not a sum over blocks of its rows
ROWS_SEPARABLE = False
