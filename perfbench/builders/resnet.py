"""ResNet through the port's ``models/resnet.py``: NHWC input, f32
parameters, compute in the configuration's dtype, the port's
cross-entropy."""

from __future__ import annotations

import torch


def build(config: dict, device) -> torch.nn.Module:
    """The model on ``device``, its own draws made there (the benchmark
    then loads its weights; a model drawn on ``meta`` would import
    ``torch._dynamo`` for the draws, seconds of set-up)."""
    from byteps_tpu_torch.models import resnet
    with torch.device(device):
        model = resnet.ResNet(tuple(config["stage_sizes"]), resnet.Bottleneck,
                              num_classes=config["num_classes"],
                              width=config["width"],
                              compute_dtype=getattr(torch,
                                                    config["compute_dtype"]),
                              generator=torch.Generator(device=device))
    return model


def loss(model: torch.nn.Module, batch: dict) -> torch.Tensor:
    from byteps_tpu_torch.models import resnet
    return resnet.softmax_cross_entropy(model(batch["images"]),
                                        batch["labels"])
