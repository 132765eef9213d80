"""Synthetic gradient push_pull benchmark; port of
``example/pytorch/benchmark_byteps.py``: timed push_pull of model-sized
gradients, optionally compressed.  It ends with one JSON line: the rank,
the MB/s, the onebit kernel launches the engine made (and the merge's by
its ranks R), and a SHA-256 of the last iteration's results, which is the
same on every rank when every rank received the same bits.

Run:  python -m byteps_tpu_torch.examples.benchmark_byteps [--num-iters N]
      [--compressor onebit|topk|randomk|dithering] [--device cuda|cpu]
"""

import argparse
import hashlib
import json
import sys
import time

import torch

import byteps_tpu_torch.torch as bps
from byteps_tpu_torch.ops import onebit_kernels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--num-tensors", type=int, default=20)
    ap.add_argument("--tensor-mb", type=float, default=4.0)
    ap.add_argument("--compressor", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bps.init(device=args.device)
    dev = bps.device()
    n_elem = int(args.tensor_mb * 1e6 / 4)
    grads = [torch.randn(n_elem, device=dev)
             for _ in range(args.num_tensors)]
    comp = {"compressor": args.compressor} if args.compressor else None
    if comp and args.compressor in ("topk", "randomk"):
        comp["k"] = str(max(1, n_elem // 100))
    onebit_kernels.reset_launches()

    # warm-up (the kernels build at their first launch)
    hs = [bps.push_pull_async(g, name=f"bench.{i}", compression=comp)
          for i, g in enumerate(grads)]
    for h in hs:
        bps.synchronize(h)

    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        hs = [bps.push_pull_async(g, name=f"bench.{i}", compression=comp)
              for i, g in enumerate(grads)]
        outs = [bps.synchronize(h) for h in hs]
    dt = time.perf_counter() - t0
    digest = hashlib.sha256()
    for o in outs:
        digest.update(o.detach().contiguous().view(torch.uint8).cpu()
                      .numpy().tobytes())
    total_mb = args.num_iters * args.num_tensors * args.tensor_mb
    print(f"{total_mb / dt:.1f} MB/s pushed+pulled "
          f"({args.num_tensors} x {args.tensor_mb} MB x "
          f"{args.num_iters} iters in {dt:.2f}s)")
    print("engine telemetry:", bps.get_pushpull_speed())
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.core.root_order import order_stats
    eng = api.engine()
    chunks = sum(len(eng.registry.get(f"bench.{i}").chunk_bounds)
                 for i in range(args.num_tensors))
    line = json.dumps({"rank": bps.rank(), "size": bps.size(),
                       "local_rank": bps.local_rank(),
                       "backend": eng.comm.backend, "device": str(dev),
                       "mb_per_s": total_mb / dt, "chunks": chunks,
                       "iters": args.num_iters + 1,
                       "launches": dict(onebit_kernels.launches),
                       "merge_ranks": {str(r): n for r, n in sorted(
                           onebit_kernels.merge_ranks.items())},
                       "result_sha256": digest.hexdigest(),
                       **order_stats(eng.stats)})
    # one write: the ranks share the launcher's pipe
    sys.stdout.write(line + "\n")
    sys.stdout.flush()
    bps.shutdown()


if __name__ == "__main__":
    main()
