"""ResNet-50's FLOPs an image, from its layer shapes.

A convolution or dense layer does ``2 * out_h * out_w * c_out * c_in *
k * k`` FLOPs forward (a multiply and an add per product term); training
adds as much again for the gradient of its weights and of its input,
except the stem's input, the images, whose gradient no one takes.
BatchNorm, ReLU, pooling, the residual adds and the loss are not counted
(elementwise, under 1 % of the products).
"""

from __future__ import annotations

from typing import List, Tuple


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def layers(config: dict) -> List[Tuple[str, int]]:
    """``(layer, forward FLOPs an image)`` of every convolution and the
    classifier, in order."""
    width, exp = config["width"], config["bottleneck_expansion"]
    s = _same_out(config["image_size"], 2)
    out = [("stem", 2 * s * s * width * config["channels"] * 49)]
    s = _same_out(s, 2)                                  # max-pool
    cin, i = width, 0
    for st, n in enumerate(config["stage_sizes"]):
        f = width * 2 ** st
        for j in range(n):
            stride = 2 if st > 0 and j == 0 else 1
            so = _same_out(s, stride)
            out.append((f"blocks.{i}.convs.0", 2 * s * s * f * cin))
            out.append((f"blocks.{i}.convs.1", 2 * so * so * f * f * 9))
            out.append((f"blocks.{i}.convs.2", 2 * so * so * f * exp * f))
            if cin != f * exp or stride != 1:
                out.append((f"blocks.{i}.proj", 2 * so * so * f * exp * cin))
            cin, s, i = f * exp, so, i + 1
    out.append(("fc", 2 * cin * config["num_classes"]))
    return out


def forward_flops(config: dict) -> int:
    return sum(f for _, f in layers(config))


def train_flops_per_sample(config: dict, traffic: dict) -> int:
    """Forward, weight gradient and input gradient of every layer, less
    the stem's input gradient."""
    stem = layers(config)[0][1]
    return 3 * forward_flops(config) - stem
