"""Train an MNIST-class MLP with the fused data-parallel step; port of
``example/jax/train_mnist_mlp.py``.

The whole step (forward, backward, the gradients' push_pull and SGD) is
``parallel/data_parallel.py`` ``make_dp_train_step``; synthetic data, the
global batch drawn from seed 0 and each rank training on its rows.

Run:  python -m byteps_tpu_torch.examples.train_mnist_mlp [--steps N]
      [--batch B] [--device cuda|cpu]
"""

import argparse
import sys
import time

import numpy as np
import torch


def train(comm, steps: int, batch: int, lr: float, log=print):
    """``steps`` steps of the MLP at ``batch`` rows a rank; returns every
    step's loss (the mean over ranks)."""
    from ..models.mlp import mnist_mlp, softmax_cross_entropy
    from ..parallel.data_parallel import (make_dp_train_step, replicate,
                                          shard_batch)
    n = comm.size
    rng = np.random.RandomState(0)
    gb = batch * n
    data = shard_batch(comm, {
        "x": rng.randn(gb, 784).astype(np.float32),
        "y": rng.randint(0, 10, size=(gb,)).astype(np.int64)})
    model = replicate(comm, mnist_mlp(
        generator=torch.Generator().manual_seed(0)).to(comm.device))
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)

    def loss_fn(m, b):
        return softmax_cross_entropy(m(b["x"]), b["y"])

    step = make_dp_train_step(comm, model, loss_fn, opt)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(float(step(data)))
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:4d}  loss {losses[-1]:.4f}")
    dt = time.perf_counter() - t0
    log(f"{steps / dt:.1f} steps/s, {steps * gb / dt:.0f} examples/s")
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32, help="per-device")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..comm.mesh import bootstrap, resolve_device
    from ..common.config import Config
    cfg = Config.from_env()
    comm = bootstrap(cfg, resolve_device(args.device, cfg.local_rank))
    try:
        log = print if comm.rank == 0 else (lambda *a: None)
        log(f"devices={comm.size} mesh=({comm.num_nodes} dcn x "
            f"{comm.local_size} ici)")
        train(comm, args.steps, args.batch, args.lr,
              log=lambda s: log(s, flush=True))
    finally:
        comm.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
