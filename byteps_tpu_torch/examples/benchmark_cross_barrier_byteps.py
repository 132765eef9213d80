"""Cross-barrier pipelining benchmark; port of
``example/pytorch/benchmark_cross_barrier_byteps.py``: no
end-of-iteration barrier, so communication overlaps the next forward
pass; each layer's averaged gradients are applied just in time.

Run:  python -m byteps_tpu_torch.examples.benchmark_cross_barrier_byteps
      [--num-iters N] [--device cuda|cpu]
"""

import argparse
import time

import torch
import torch.nn.functional as F

import byteps_tpu_torch.torch as bps
from byteps_tpu_torch.torch.parallel import CrossBarrier


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bps.init(device=args.device)
    dev = bps.device()
    model = torch.nn.Sequential(
        torch.nn.Linear(1024, 2048), torch.nn.ReLU(),
        torch.nn.Linear(2048, 2048), torch.nn.ReLU(),
        torch.nn.Linear(2048, 1000)).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    xb = CrossBarrier(model, opt)

    x = torch.randn(args.batch, 1024, device=dev)
    y = torch.randint(0, 1000, (args.batch,), device=dev)
    F.cross_entropy(model(x), y).backward()  # warm-up
    xb.step()

    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        xb.step()  # returns at once; grads applied at the next forward
    xb.synchronize()  # drain before timing stops
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{args.num_iters * args.batch / dt:.1f} examples/s "
          f"with cross-barrier overlap")
    bps.shutdown()


if __name__ == "__main__":
    main()
