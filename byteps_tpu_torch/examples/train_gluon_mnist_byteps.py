"""Gluon MNIST training through the port's MXNet ``DistributedTrainer``;
port of ``example/mxnet/train_gluon_mnist_byteps.py`` (synthetic data).

mxnet is installed neither on the CPU test host nor on the card's
machine: as the JAX script, this imports mxnet inside ``main`` and
without it fails there with the ImportError, touching nothing else.

Run:  python -m byteps_tpu_torch.examples.train_gluon_mnist_byteps
      [--steps N] [--device cuda|cpu]
"""

import argparse

import numpy as np

import byteps_tpu_torch.mxnet as bps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
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
        {"learning_rate": 0.05 * bps.size()})
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
