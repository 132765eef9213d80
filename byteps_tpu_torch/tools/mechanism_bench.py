"""The signature BytePS mechanisms, measured on the port; port of
``tools/mechanism_bench.py``.

Priority, partitioning and credit exist to cut the latency of the
gradients the next forward needs first (reference
docs/best-practice.md:7, operations.cc:140-180), not bulk throughput.
This harness measures exactly that, as the JAX tool does:

- **priority** (:func:`priority_latency`): the backward produces
  gradients last layer first; the next forward needs the first layer's
  first.  K tensors are pushed in reverse declaration order under a
  credit window of about two tensors, and the first-declared tensor's
  time to ready is taken with priority on and with arrival order
  (``fifo``);
- **partitioning** (:func:`partition_latency`): one big low-priority
  tensor, then a small urgent one; with partitioning the small one
  overtakes at chunk granularity instead of waiting out the transfer.

Both engines of a measurement run side by side and the repetitions
interleave across them, so a drifting load hits both alike.  At more
than one rank the root's priority order is every rank's
(``core/root_order.py``); the JSON carries each engine's root-order
counters (0 at one rank), their totals on this rank, and under
``order_worst`` each total's largest over the ranks: the root's
messages and send time, the slowest follower's waits.

    python -m byteps_tpu_torch.tools.mechanism_bench            # one card
    python -m byteps_tpu_torch.launcher.launch \\
        python -m byteps_tpu_torch.tools.mechanism_bench          # a card a rank
    python -m byteps_tpu_torch.tools.mechanism_bench --device cpu --small

Prints one JSON object (rank 0; every rank with ``--all-ranks``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ._bench_util import (conditions_block, pin_cores, print_line,
                          quantile_stats)
from ..core.root_order import ORDER_STATS, order_stats, worst_of


def _engines(comm, cfgs):
    from ..core.engine import PushPullEngine
    return {tag: PushPullEngine(comm, cfg) for tag, cfg in cfgs.items()}


def _order_stats(engines) -> dict:
    return {tag: order_stats(eng.stats) for tag, eng in engines.items()}


def priority_latency(comm, k_tensors=6, mbytes=4.0, reps=15):
    """Median time to ready of the first-declared tensor when all K are
    pushed in reverse order, priority on (``priority``) and in arrival
    order (``fifo``).  The credit window (about two tensors in flight) is
    what gives the queue depth for priority to reorder."""
    import numpy as np
    import torch
    from ..common.config import Config

    n = int(mbytes * (1 << 20)) // 4
    credit = 2 * n * 4
    xs = [torch.from_numpy(np.random.RandomState(i).randn(n).astype(
        np.float32)).to(comm.device) for i in range(k_tensors)]
    cfgs = {tag: Config(telemetry_on=False, trace_on=False,
                        enable_priority=prio, scheduling_credit=credit)
            for tag, prio in (("priority", True), ("fifo", False))}
    engines = _engines(comm, cfgs)
    lats = {tag: [] for tag in engines}
    out = {}
    try:
        for eng in engines.values():
            # declared in forward order: declared_key is the priority
            for i in range(k_tensors):
                eng.declare_tensor(f"layer{i}", xs[i].shape, xs[i].dtype)
            for i in range(k_tensors):
                eng.push_pull(xs[i], f"layer{i}")          # warm-up
        for _ in range(reps):
            for tag, eng in engines.items():
                prio = tag == "priority"
                handles = {}
                # reverse order (backward produces the last layer
                # first); fifo pins the priority to arrival order, what a
                # plain all-reduce queue executes
                for pos, i in enumerate(reversed(range(k_tensors))):
                    handles[i] = eng.push_pull_async(
                        xs[i], f"layer{i}",
                        **({} if prio else {"priority": -pos}))
                t0 = time.perf_counter()
                handles[0].wait()          # the next forward's first need
                lats[tag].append(time.perf_counter() - t0)
                for h in handles.values():
                    h.wait()
        for tag in engines:
            med, iqr = quantile_stats(lats[tag])
            out[f"layer0_ready_ms_{tag}"] = med
            out[f"layer0_ready_{tag}_iqr_ms"] = iqr
        out["order"] = _order_stats(engines)
    finally:
        for eng in engines.values():
            eng.shutdown(wait=False)
    out["speedup"] = round(out["layer0_ready_ms_fifo"]
                           / max(out["layer0_ready_ms_priority"], 1e-9), 2)
    out["speedup_range"] = [
        round(out["layer0_ready_fifo_iqr_ms"][0]
              / max(out["layer0_ready_priority_iqr_ms"][1], 1e-9), 2),
        round(out["layer0_ready_fifo_iqr_ms"][1]
              / max(out["layer0_ready_priority_iqr_ms"][0], 1e-9), 2)]
    return out


def partition_latency(comm, big_mb=64.0, small_kb=256.0, reps=15):
    """Median time to ready of a small urgent tensor pushed right after a
    big low-priority one, with 4,096,000-byte chunks (``partitioned``)
    and with the big tensor whole (``whole``)."""
    import numpy as np
    import torch
    from ..common.config import Config

    big = torch.from_numpy(np.random.RandomState(0).randn(
        int(big_mb * (1 << 20)) // 4).astype(np.float32)).to(comm.device)
    small = torch.from_numpy(np.random.RandomState(1).randn(
        int(small_kb * 1024) // 4).astype(np.float32)).to(comm.device)
    cfgs = {tag: Config(telemetry_on=False, trace_on=False,
                        partition_bytes=pbytes,
                        scheduling_credit=8 * (1 << 20))
            for tag, pbytes in (("partitioned", 4096 * 1000),
                                ("whole", 2**31 - 512))}
    engines = _engines(comm, cfgs)
    lats = {tag: [] for tag in engines}
    out = {}
    try:
        for eng in engines.values():
            eng.push_pull(small, "urgent", priority=10)
            eng.push_pull(big, "bulk", priority=-10)
        for _ in range(reps):
            for tag, eng in engines.items():
                hb = eng.push_pull_async(big, "bulk", priority=-10)
                hs = eng.push_pull_async(small, "urgent", priority=10)
                t0 = time.perf_counter()
                hs.wait()
                lats[tag].append(time.perf_counter() - t0)
                hb.wait()
        for tag in engines:
            med, iqr = quantile_stats(lats[tag])
            out[f"urgent_ready_ms_{tag}"] = med
            out[f"urgent_ready_{tag}_iqr_ms"] = iqr
        out["order"] = _order_stats(engines)
    finally:
        for eng in engines.values():
            eng.shutdown(wait=False)
    out["speedup"] = round(out["urgent_ready_ms_whole"]
                           / max(out["urgent_ready_ms_partitioned"], 1e-9),
                           2)
    out["speedup_range"] = [
        round(out["urgent_ready_whole_iqr_ms"][0]
              / max(out["urgent_ready_partitioned_iqr_ms"][1], 1e-9), 2),
        round(out["urgent_ready_whole_iqr_ms"][1]
              / max(out["urgent_ready_partitioned_iqr_ms"][0], 1e-9), 2)]
    return out


def run(device="cuda", small=False, reps=15) -> dict:
    """Both measurements in this process's group (formed from the
    BYTEPS_*/DMLC_* environment)."""
    from ..comm.mesh import bootstrap, resolve_device
    from ..common.config import Config
    cfg = Config.from_env()
    comm = bootstrap(cfg, resolve_device(device, cfg.local_rank))
    try:
        if small:
            pri = priority_latency(comm, k_tensors=6, mbytes=0.0625,
                                   reps=reps)
            part = partition_latency(comm, big_mb=1.0, small_kb=16.0,
                                     reps=reps)
        else:
            pri = priority_latency(comm, reps=reps)
            part = partition_latency(comm, reps=reps)
        result = {"priority": pri, "partitioning": part,
                  "rank": comm.rank, "size": comm.size,
                  "backend": comm.backend}
        # the root order's counters over the four engines (0 at one
        # rank): this rank's own, and under "order_worst" each one's
        # largest over the ranks (the root's messages and send time, the
        # slowest follower's waits)
        orders = [o for sec in (pri, part) for o in sec["order"].values()]
        mine = {k: round(sum(o[k] for o in orders), 3)
                for k in ORDER_STATS}
        result.update(mine)
        rows = [mine]
        if comm.size > 1:
            import torch.distributed as dist
            rows = [None] * comm.size
            dist.all_gather_object(rows, mine)
        result["order_worst"] = worst_of(rows)
    finally:
        comm.close()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="small tensors (a CPU rehearsal)")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--all-ranks", action="store_true")
    args = ap.parse_args(argv)
    pinned = pin_cores()
    import torch
    result = run(args.device, args.small, args.reps)
    result["conditions"] = conditions_block(
        pinned, device=torch.device(args.device),
        note=("wall-clock latencies; the dispatch order itself is pinned "
              "by tests/test_torch_dispatch_order.py"))
    if result["rank"] == 0 or args.all_ranks:
        print_line(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
