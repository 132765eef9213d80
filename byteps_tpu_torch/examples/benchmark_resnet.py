"""Synthetic ResNet-50 / ResNet-18 / VGG-16 throughput (images/s); port of
``example/jax/benchmark_resnet.py``.

Trains on random NHWC images from a seeded generator through
``models/resnet.py`` ``make_vision_trainer`` (the fused data-parallel
step; ResNet with cross-replica BatchNorm over the world), SGD 0.1 with
momentum 0.9, and prints one JSON line with the JAX script's keys.  One
process is one rank: run it alone, or one rank a card under bpslaunch.

    python -m byteps_tpu_torch.examples.benchmark_resnet --model resnet50 --batch 32
    python -m byteps_tpu_torch.examples.benchmark_resnet --model vgg16 --steps 10
    python -m byteps_tpu_torch.examples.benchmark_resnet --model tiny --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

MODELS = ("resnet50", "resnet18", "vgg16", "tiny")


def build_model(name: str, size: int, device):
    """``(model, image size, classes)`` for ``--model name``, its weights
    from seed 0 (VGG's dropout masks from seed 1)."""
    import torch
    import torch.distributed as dist

    from ..models import resnet
    if name == "vgg16":
        model = resnet.vgg16(image_size=size, device=device,
                             generator=torch.Generator(
                                 device=device).manual_seed(0),
                             dropout_generator=torch.Generator(
                                 device=device).manual_seed(1))
        return model, size, 1000
    make = {"resnet50": resnet.resnet50, "resnet18": resnet.resnet18,
            "tiny": resnet.resnet_tiny}[name]
    classes = 10 if name == "tiny" else 1000
    if name == "tiny":
        size = min(size, 32)
    model = make(num_classes=classes,
                 generator=torch.Generator().manual_seed(0),
                 bn_group=dist.group.WORLD).to(device)
    return model, size, classes


def run(comm, name: str, batch: int, size: int, steps: int, *,
        lr: float = 0.1, warmup: int = 2):
    """``warmup`` then ``steps`` timed steps of ``name`` at ``batch``
    images a rank.  Returns ``(line, losses, step_ms)``: the JSON line's
    fields, every step's loss (the warm-up's first) and each timed
    step's wall in ms (``.item()`` of the loss synchronizes)."""
    import torch

    from ..models import resnet
    model, size, classes = build_model(name, size, comm.device)
    step = resnet.make_vision_trainer(
        comm, model, torch.optim.SGD(model.parameters(), lr=lr,
                                     momentum=0.9))
    data = resnet.synthetic_images(
        torch.Generator().manual_seed(2 + comm.rank), batch, size, classes,
        comm.device)
    losses = [step(data).item() for _ in range(warmup)]
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(data).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not math.isfinite(losses[-1]):
        raise RuntimeError(f"non-finite loss {losses[-1]}")
    n = comm.size
    ips = steps * batch * n / (sum(step_ms) / 1e3)
    line = {"model": name, "images_per_sec": round(ips, 2),
            "per_chip": round(ips / n, 2), "n_devices": n,
            "batch_per_device": batch, "image_size": size,
            "loss": round(losses[-1], 4)}
    return line, losses, step_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet50", choices=MODELS)
    ap.add_argument("--batch", type=int, default=32, help="per device")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..comm.mesh import bootstrap, resolve_device
    from ..common.config import Config
    cfg = Config.from_env()
    comm = bootstrap(cfg, resolve_device(args.device, cfg.local_rank))
    try:
        line, _, _ = run(comm, args.model, args.batch, args.size,
                         args.steps)
        if comm.rank == 0:
            print(json.dumps(line), flush=True)
    finally:
        comm.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
