"""Gluon MNIST with gradient compression through the trainer's
``compression_params``; port of
``example/mxnet/train_gluon_mnist_byteps_gc.py`` (synthetic data).

The reference's compression plumbing end to end: the trainer's
``compression_params`` dict (onebit + error feedback + Nesterov momentum,
the reference's recommended chain) flows through the per-parameter
``byteps_*`` attributes into the engine's compressor registry.

mxnet is installed neither on the CPU test host nor on the card's
machine: as the JAX script, this imports mxnet inside ``main`` and
without it fails there with the ImportError, touching nothing else.

Run:  python -m byteps_tpu_torch.examples.train_gluon_mnist_byteps_gc
      [--steps N] [--compressor onebit|topk|randomk|dithering|powersgd]
      [--device cuda|cpu]
"""

import argparse

import numpy as np

import byteps_tpu_torch.mxnet as bps

COMPRESSORS = ["onebit", "topk", "randomk", "dithering", "powersgd"]


def compression_params(compressor: str) -> dict:
    """The reference's compression_params surface (mxnet/__init__.py
    compression attrs -> kwargs): with momentum configured, the
    optimizer's momentum moves into the compressor chain (worker-side
    Nesterov before compression), reference __init__.py:235-316."""
    return {
        "compressor": compressor,
        "ef": "vanilla",
        "momentum": "nesterov",
        "k": 0.1,              # topk/randomk fraction (ignored by onebit)
        "scaling": True,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--compressor", default="onebit", choices=COMPRESSORS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import mxnet as mx
    from mxnet import autograd, gluon

    bps.init(device=args.device)
    net = gluon.nn.Sequential()
    net.add(gluon.nn.Dense(128, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())

    trainer = bps.DistributedTrainer(
        net.collect_params(), "sgd",
        {"learning_rate": 0.05 * bps.size(), "momentum": 0.9},
        compression_params=compression_params(args.compressor))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    rng = np.random.RandomState(bps.rank())
    x = mx.nd.array(rng.randn(args.batch, 784).astype(np.float32))
    y = mx.nd.array(rng.randint(0, 10, args.batch))

    for i in range(args.steps):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(args.batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss.mean().asscalar()):.4f}")
    bps.shutdown()


if __name__ == "__main__":
    main()
