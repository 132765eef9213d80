"""DistributedDataParallel benchmark; port of
``example/pytorch/benchmark_byteps_ddp.py``: gradient sync through
backward hooks with bucketing, and ``no_sync()`` accumulation.

Run:  python -m byteps_tpu_torch.examples.benchmark_byteps_ddp
      [--num-iters N] [--accumulate K] [--device cuda|cpu]
"""

import argparse
import time

import torch
import torch.nn.functional as F

import byteps_tpu_torch.torch as bps
from byteps_tpu_torch.torch.parallel import DistributedDataParallel


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--accumulate", type=int, default=1,
                    help="micro-steps under no_sync() per sync step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bps.init(device=args.device)
    dev = bps.device()
    model = torch.nn.Sequential(
        torch.nn.Linear(1024, 2048), torch.nn.ReLU(),
        torch.nn.Linear(2048, 2048), torch.nn.ReLU(),
        torch.nn.Linear(2048, 1000)).to(dev)
    ddp = DistributedDataParallel(model)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)

    x = torch.randn(args.batch, 1024, device=dev)
    y = torch.randint(0, 1000, (args.batch,), device=dev)

    def micro(sync: bool):
        if sync:
            loss = F.cross_entropy(ddp(x), y)
            loss.backward()
        else:
            with ddp.no_sync():
                loss = F.cross_entropy(ddp(x), y)
                loss.backward()
        return loss

    micro(True)  # warm-up
    opt.zero_grad()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        for _ in range(args.accumulate - 1):
            micro(sync=False)
        micro(sync=True)
        opt.step()
        opt.zero_grad()
    _sync(dev)
    dt = time.perf_counter() - t0
    ex = args.num_iters * args.accumulate * args.batch
    print(f"{ex / dt:.1f} examples/s ({args.num_iters} sync steps, "
          f"accumulate={args.accumulate})")
    bps.shutdown()


if __name__ == "__main__":
    main()
