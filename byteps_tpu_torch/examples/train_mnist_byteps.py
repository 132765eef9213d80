"""MNIST-class training with the torch adapter, synthetic data; port of
``example/pytorch/train_mnist_byteps.py``.

Run:  python -m byteps_tpu_torch.examples.train_mnist_byteps [--steps N]
      [--device cuda|cpu] [--dump DIR]

``--dump DIR`` saves ``rank<r>.npz``: the losses, this rank's gradients
of the first step and the averaged gradients the optimizer applied.
"""

import argparse
import copy
import os

import numpy as np
import torch
import torch.nn.functional as F

import byteps_tpu_torch.torch as bps


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(784, 128)
        self.fc2 = torch.nn.Linear(128, 10)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    bps.init(device=args.device)
    dev = bps.device()
    torch.manual_seed(bps.rank())  # different data per worker
    # built on the host from the seed, then moved: the same weights on
    # every device
    model = Net().to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    opt = bps.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    # consistent start across workers (reference broadcast_parameters)
    bps.broadcast_parameters(model.state_dict(), root_rank=0)

    x = torch.randn(args.batch, 784).to(dev)
    y = torch.randint(0, 10, (args.batch,)).to(dev)
    dump = {}
    if args.dump:
        # this rank's own gradients, from a copy without the hooks
        ref = copy.deepcopy(model)
        F.cross_entropy(ref(x), y).backward()
        for n, p in ref.named_parameters():
            dump[f"local/{n}"] = p.grad.cpu().numpy()
    losses = []
    for i in range(args.steps):
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if args.dump and i == 0:
            for n, p in model.named_parameters():
                dump[f"averaged/{n}"] = p.grad.cpu().numpy()
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}", flush=True)
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        np.savez(os.path.join(args.dump, f"rank{bps.rank()}.npz"),
                 losses=np.array(losses), **dump)
    bps.shutdown()


if __name__ == "__main__":
    main()
