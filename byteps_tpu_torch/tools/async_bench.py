"""Async-PS against sync convergence; port of ``tools/async_bench.py``.

The same MNIST-style MLP (``models/mlp.py``, 16 inputs) trains on the
same synthetic data two ways and the final-loss gap is reported:

- **sync**: one barriered step per iteration, every worker's gradient
  averaged before anyone applies it;
- **async**: N workers share a ``KVStore``; each runs its own SGD step
  through ``AsyncDistributedOptimizer`` (``torch/async_opt.py``),
  pushes its weight delta with no barrier and pulls the current global
  weights; the workers are threads, so the staleness is real
  interleaving, not a simulation of it.

The data are the JAX tool's (numpy seed 42).  The initial weights are
drawn from ``torch.Generator`` seed 0, or given as the JAX model's
``params`` (``load_flax_mlp``), which is how the tests hold the sync arm
to the JAX tool's.

    python -m byteps_tpu_torch.tools.async_bench [--device cpu]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from ._bench_util import conditions_block, pin_cores

STEPS = 80
WORKERS = 2
LR = 0.05
IN_FEATURES = 16


def run(device="cuda", steps=STEPS, workers=WORKERS, lr=LR,
        params0=None) -> dict:
    import numpy as np
    import torch

    from ..comm.mesh import resolve_device
    from ..models.mlp import MLP, load_flax_mlp, softmax_cross_entropy
    from ..server import KVStore
    from ..torch.async_opt import AsyncDistributedOptimizer

    dev = resolve_device(device)
    rng = np.random.RandomState(42)
    x_np = rng.randn(64 * workers, IN_FEATURES).astype(np.float32)
    y_np = rng.randint(0, 10, 64 * workers)
    x_all = torch.from_numpy(x_np).to(dev)
    y_all = torch.from_numpy(y_np).to(dev)
    shards = [(x_all[i::workers], y_all[i::workers]) for i in range(workers)]

    def fresh():
        m = MLP(IN_FEATURES, device=dev)
        if params0 is not None:
            load_flax_mlp(m, params0)
        return m

    model = fresh()

    def loss_of(m, xb, yb):
        return softmax_cross_entropy(m(xb), yb)

    with torch.no_grad():
        loss_init = float(loss_of(model, x_all, y_all))

    # ---- sync: the barriered gradient average every step ----
    params = [p for p in model.parameters()]
    t0 = time.perf_counter()
    for _ in range(steps):
        gs = []
        for xb, yb in shards:
            model.zero_grad(set_to_none=True)
            loss_of(model, xb, yb).backward()
            gs.append([p.grad.clone() for p in params])
        with torch.no_grad():
            for i, p in enumerate(params):
                g = gs[0][i]
                for w in range(1, workers):
                    g = g + gs[w][i]
                p.sub_(lr * (g / workers))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_sync = time.perf_counter() - t0
    with torch.no_grad():
        loss_sync = float(loss_of(model, x_all, y_all))

    # ---- async: a shared store, a thread a worker, no barrier ----
    store = KVStore(dev)
    replicas = [fresh() for _ in range(workers)]
    opts = [AsyncDistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=lr),
        named_parameters=m.named_parameters(), store=store, worker_id=i)
        for i, m in enumerate(replicas)]
    errors = []

    def worker(i):
        # a crashed worker must show in the JSON, not pass for a
        # diverged async run
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            m, opt = replicas[i], opts[i]
            xb, yb = shards[i]
            for _ in range(steps):
                opt.zero_grad()
                loss_of(m, xb, yb).backward()
                opt.step()
        except Exception as e:  # noqa: BLE001
            errors.append(f"worker {i}: {type(e).__name__}: {e}"[:200])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(workers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_async = time.perf_counter() - t0

    # the final global weights live in the store
    final = fresh()
    with torch.no_grad():
        for n, p in final.named_parameters():
            p.copy_(store.pull(f"async.{n}").to(dev).reshape(p.shape))
        loss_async = float(loss_of(final, x_all, y_all))
    versions = [store.version(k) for k in store.keys()]
    progress = loss_init - loss_sync
    out = {
        "workers": workers,
        "steps_per_worker": steps,
        "lr": lr,
        "loss_init": round(loss_init, 4),
        "loss_sync": round(loss_sync, 4),
        "loss_async": round(loss_async, 4),
        "final_loss_gap": round(loss_async - loss_sync, 4),
        "gap_rel_to_progress": (round((loss_async - loss_sync) / progress, 4)
                                if progress > 1e-6 else None),
        "async_converged": bool(loss_async < loss_init * 0.5),
        "delta_pushes_per_key": (versions[0]
                                 if len(set(versions)) == 1 else
                                 {"min": min(versions),
                                  "max": max(versions)}),
        "wall_sync_s": round(wall_sync, 2),
        "wall_async_s": round(wall_async, 2),
        # unrounded, for the comparison with the JAX tool
        "loss_sync_exact": loss_sync,
        "device": str(dev),
    }
    if errors:
        out["error"] = "; ".join(errors)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pinned = pin_cores()
    import torch
    out = run(args.device)
    out["conditions"] = conditions_block(
        pinned, device=torch.device(args.device),
        note="async staleness is real thread interleaving; the gap "
             "varies run to run on a loaded host")
    print(json.dumps(out), flush=True)
    return 0 if "error" not in out else 1


if __name__ == "__main__":
    sys.exit(main())
