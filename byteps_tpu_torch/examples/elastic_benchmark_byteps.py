"""Elastic training demo; port of
``example/pytorch/elastic_benchmark_byteps.py``: ``suspend()``
mid-training, then ``resume()``; the declared tensors keep their key
order, so training continues with the same scheduling.

Run:  python -m byteps_tpu_torch.examples.elastic_benchmark_byteps
      [--device cuda|cpu]
"""

import argparse

import torch
import torch.nn.functional as F

import byteps_tpu_torch.torch as bps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bps.init(device=args.device)
    dev = bps.device()
    model = torch.nn.Linear(256, 10).to(dev)
    opt = bps.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters())
    x = torch.randn(64, 256, device=dev)
    y = torch.randint(0, 10, (64,), device=dev)

    def train(steps):
        for _ in range(steps):
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
        return float(loss.detach())

    print("phase 1 loss:", round(train(args.steps), 4))
    bps.suspend()               # drain the engine, leave the group
    print("suspended (simulating topology change)...")
    bps.resume()                # rejoin; keys declared again in order
    print("resumed")
    print("phase 2 loss:", round(train(args.steps), 4))
    bps.shutdown()


if __name__ == "__main__":
    main()
