"""End-to-end overlap benchmark: does cross-barrier with priority and a
credit window buy step time?  Port of ``tools/overlap_bench.py``.

A real torch model trains through the engine and full steps are timed
in three modes, as in the JAX tool:

- **nocomm**: forward, backward and step with no gradient communication,
  the compute floor;
- **sync**: the port's ``DistributedDataParallel``, the gradients pushed
  during backward, a barrier at backward's end, then the step;
- **xb**: ``CrossBarrier`` with priority and a credit window: ``step()``
  returns at once and each layer's update lands at the next forward's
  pre-hook, so late layers' communication overlaps the next forward.

Reported: median step ms (and IQR) per mode, the gain ``sync/xb``, and
``overlap_fraction``, the median over rounds of each round's paired
``(t_sync - t_xb) / (t_sync - t_nocomm)``.  ``--compression`` runs the
sync and xb modes on a codec's stream (``none``, ``onebit``, ``randomk``,
``topk``, the last three with error feedback); on the card the onebit
lane runs the pack, unpack and merge kernels of ``csrc/onebit.cu``.

    python -m byteps_tpu_torch.tools.overlap_bench [--compression none,onebit]
    python -m byteps_tpu_torch.tools.overlap_bench --device cpu --rounds 1

Prints one JSON object a lane (rank 0).  The JAX tool's pinned re-measure
splits compute and XLA transport threads over disjoint cores; the port
has no host transport threads to split on the card, and on the CPU the
figures are taken unpinned (``pinned_disjoint`` says so).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from ._bench_util import conditions_block, metrics_diag, quantile_stats
from ..core.root_order import order_stats

COMPRESSION_KWARGS = {
    "none": None,
    "onebit": {"compressor": "onebit", "ef": "vanilla"},
    "randomk": {"compressor": "randomk", "k": "0.25", "ef": "vanilla"},
    "topk": {"compressor": "topk", "k": "0.25", "ef": "vanilla"},
}


def _model(width=512, depth=8, seed=0, device="cpu"):
    import torch
    torch.manual_seed(seed)
    layers = []
    for _ in range(depth):
        layers += [torch.nn.Linear(width, width), torch.nn.ReLU()]
    layers.append(torch.nn.Linear(width, 1))
    return torch.nn.Sequential(*layers).to(device)


def _sync_device(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def one_mode_pass(mode: str, device, steps=6, warmup=2, width=512,
                  depth=8, batch=64, compression=None):
    """A fresh model trained ``steps`` measured steps in one mode (fresh,
    so the wrappers' hooks never accumulate across modes)."""
    import torch

    from ..torch.parallel import CrossBarrier, DistributedDataParallel

    torch.manual_seed(1)
    x = torch.randn(batch, width).to(device)
    y = torch.randn(batch, 1).to(device)
    model = _model(width, depth, device=device)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    loss_fn = torch.nn.MSELoss()

    if mode == "nocomm":
        wrapped, stepper, sync = model, opt.step, lambda: None
    elif mode == "sync":
        wrapped = DistributedDataParallel(model, compression=compression)
        stepper, sync = opt.step, lambda: None
    else:  # xb
        xb = CrossBarrier(model, opt, compression=compression)
        wrapped, stepper, sync = model, xb.step, xb.synchronize

    times, losses = [], []
    for it in range(warmup + steps):
        _sync_device(device)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=False)
        out = wrapped(x)
        loss = loss_fn(out, y)
        loss.backward()
        stepper()
        # the loss read ends the step on the host, as in the JAX tool
        losses.append(float(loss.detach()))
        if it >= warmup:
            times.append(time.perf_counter() - t0)
    sync()                           # drain pending xb updates
    return times, losses


def measure(device, width=512, rounds=4, steps=6, compression=None):
    """The three modes interleaved at round granularity, so a drifting
    load hits every mode alike; the headline ``overlap_fraction`` is the
    median of the per-round paired fractions, the pooled one
    ``overlap_fraction_pooled``."""
    modes = ("nocomm", "sync", "xb")
    all_times = {m: [] for m in modes}
    all_losses = {m: None for m in modes}
    round_meds = []
    for _ in range(rounds):
        meds = {}
        for m in modes:
            ts, ls = one_mode_pass(m, device, steps=steps, width=width,
                                   compression=compression)
            all_times[m] += ts
            all_losses[m] = ls
            meds[m] = sorted(ts)[len(ts) // 2]
        round_meds.append(meds)

    res = {}
    for m in modes:
        med, iqr = quantile_stats(all_times[m])
        res[m] = {"step_ms": med, "iqr_ms": iqr,
                  "loss_first": round(all_losses[m][0], 5),
                  "loss_last": round(all_losses[m][-1], 5)}
    t_no, t_sync, t_xb = (res[m]["step_ms"] for m in modes)
    comm_share = max(t_sync - t_no, 0.0)
    paired = sorted((r["sync"] - r["xb"]) / (r["sync"] - r["nocomm"])
                    for r in round_meds if r["sync"] - r["nocomm"] > 1e-6)
    frac = round(statistics.median(paired), 3) if paired else None
    return {
        "modes": res,
        "gain_sync_over_xb": round(t_sync / max(t_xb, 1e-9), 3),
        "comm_share_ms": round(comm_share, 1),
        "overlap_fraction": frac,
        "overlap_fraction_rounds": [round(f, 3) for f in paired],
        "overlap_fraction_pooled": (
            round((t_sync - t_xb) / comm_share, 3)
            if comm_share > 1e-6 else None),
        "overlap_ceiling": (round(min(t_no, comm_share) / comm_share, 3)
                            if comm_share > 1e-6 else None),
    }


def run(device="cuda", compression="none", rounds=4, steps=6,
        width=512) -> dict:
    """One lane: ``init()`` from the environment, the measurement, and
    the engine's own evidence beside it."""
    from ..common.config import Config
    from ..core import api
    from ..ops import onebit_kernels

    # about two layers of gradient bytes in flight: the window that gives
    # priority something to reorder; telemetry on, as in the JAX tool
    cfg = Config.from_env()
    cfg.telemetry_on = True
    cfg.trace_on = False
    cfg.enable_priority = True
    cfg.scheduling_credit = 2 * width * width * 4
    api.init(cfg, device=device)
    try:
        eng = api.engine()
        onebit_kernels.reset_launches()
        out = measure(eng.device, width=width, rounds=rounds, steps=steps,
                      compression=COMPRESSION_KWARGS[compression])
        out["compression"] = compression
        out["pinned_disjoint"] = {"skipped": (
            "the port's collectives run on the card or in gloo's own "
            "threads; there are no host transport threads to pin apart")}
        out["engine_step_stats"] = eng.step_stats.summary()
        out["metrics"] = dict(metrics_diag(),
                              planner=eng.planner.snapshot())
        out["onebit_launches"] = dict(onebit_kernels.launches)
        out.update(order_stats(eng.stats))
        out["rank"], out["size"] = api.rank(), api.size()
        dev = eng.device
    finally:
        api.shutdown()
    out["conditions"] = conditions_block(
        device=dev, note=("step times on the host's clock, the device "
                          "synchronized before each step's start"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compression", default="none",
                    help="lanes, comma-separated, of "
                         f"{sorted(COMPRESSION_KWARGS)}: one JSON line "
                         "each, in one process")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    lanes = args.compression.split(",")
    bad = [c for c in lanes if c not in COMPRESSION_KWARGS]
    if bad:
        ap.error(f"unknown lane(s) {bad}; choose from "
                 f"{sorted(COMPRESSION_KWARGS)}")
    for lane in lanes:
        out = run(args.device, lane, args.rounds)
        if out["rank"] == 0:
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
