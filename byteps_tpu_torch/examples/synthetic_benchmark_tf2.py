"""push_pull throughput of TensorFlow tensors through the port's
TensorFlow adapter; port of ``example/tensorflow/synthetic_benchmark_tf2.py``.

TensorFlow exists on the CPU test host only (not on the card's machine),
so this example is held on the CPU: pass ``--device cpu``.

Run:  python -m byteps_tpu_torch.examples.synthetic_benchmark_tf2
      [--num-iters N] [--tensor-mb MB] [--num-tensors K] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--tensor-mb", type=float, default=4.0)
    ap.add_argument("--num-tensors", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import tensorflow as tf

    import byteps_tpu_torch.tensorflow as bps

    bps.init(device=args.device)
    n = int(args.tensor_mb * 1e6 / 4)
    ts = [tf.constant(np.random.randn(n).astype(np.float32))
          for _ in range(args.num_tensors)]

    for i, t in enumerate(ts):  # warm-up / declare
        bps.push_pull(t, name=f"bench.{i}")
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        for i, t in enumerate(ts):
            bps.push_pull(t, name=f"bench.{i}")
    dt = time.perf_counter() - t0
    mb = args.num_iters * args.num_tensors * args.tensor_mb
    print(f"{mb / dt:.1f} MB/s pushed+pulled")
    bps.shutdown()


if __name__ == "__main__":
    main()
