"""Weak scaling of the port's push_pull; port of ``tools/weak_scaling.py``.

1. **Weak scaling** (:func:`measure_weak_scaling`): N workers started by
   the port's bpslaunch (``BYTEPS_LOCAL_SIZE=N``), each pushing a fixed
   4 MiB f32 gradient a step through the engine, so the work a worker
   stays constant while the total grows.  Reported: the median step ms
   of the slowest worker per N and the efficiency ``t(first) /
   t(last)``; on the CPU both a contended curve and, where the host has
   the cores, a curve with each worker pinned to cores of its own.
2. **The dcn sweep** (:func:`measure_dcn_sweep`): the hierarchical
   all-reduce (``comm/collectives.py``) over 4 processes laid out as
   ``DMLC_NUM_WORKER`` x ``BYTEPS_LOCAL_SIZE`` = 1 x 4, 2 x 2 and 4 x 1,
   each "host" its own bpslaunch (on the card with its own cards):
   how the two-level reduce-scatter,
   cross-node all-reduce and all-gather cost grows with the node count.

Workers take ``--device``.  On the card N is at most the visible cards
(one worker a card, NCCL); on the CPU the workers use gloo.  The JAX
tool's ``analytic_v5e256`` projection and ``validate_wire_formula`` (a
TPU pod model and an HLO reading) are JAX-only and not ported.

    python -m byteps_tpu_torch.tools.weak_scaling --device cpu --counts 1,2
    python -m byteps_tpu_torch.tools.weak_scaling --counts 1,2,4  # 4 cards

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

GRAD_BYTES = 4 * 1024 * 1024   # a worker's contribution a step (f32)
STEPS = 8
LAUNCH = [sys.executable, "-m", "byteps_tpu_torch.launcher.launch"]
SELF = [sys.executable, "-m", "byteps_tpu_torch.tools.weak_scaling"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------- worker

def worker(device: str, mode: str, steps: int = STEPS) -> int:
    """One rank: ``push`` times the engine's push_pull of the gradient,
    ``hier`` the hierarchical all-reduce itself; prints ``WS_RESULT``."""
    # bpslint: ignore[env-knob] reason=a tool's pin knob, read before any Config exists (the JAX package reads it from the root tools/, outside the linted package); this tool writes it into its own workers' env, so it has no env.md row
    slices = os.environ.get("BYTEPS_WS_PIN")
    if slices:
        mine = slices.split(";")[int(os.environ["BYTEPS_LOCAL_RANK"])]
        os.sched_setaffinity(0, {int(c) for c in mine.split(",")})
    import numpy as np
    import torch

    from ._bench_util import print_line, quantile_stats
    from ..core import api
    from ..core.root_order import order_stats
    api.init(device=device)
    eng = api.engine()
    dev = eng.device
    x = torch.from_numpy(np.random.RandomState(0).randn(
        GRAD_BYTES // 4).astype(np.float32)).to(dev)
    if mode == "hier":
        from ..comm.collectives import hierarchical_all_reduce

        def one():
            hierarchical_all_reduce(eng.comm, x, "sum")
    else:
        def one():
            eng.push_pull(x, "ws.grad")
    one()                                        # warm-up
    times = []
    for _ in range(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        one()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    med, iqr = quantile_stats(times)
    res = {"rank": api.rank(), "median_ms": med, "iqr_ms": iqr,
           "steps_ms": [round(t * 1e3, 3) for t in times],
           **order_stats(eng.stats)}
    api.shutdown()
    print_line("WS_RESULT " + json.dumps(res))
    return 0


# ------------------------------------------------------------ orchestrate

def _core_slices(n_proc: int, cores_per_proc: int = 0):
    """Disjoint core sets for n_proc workers, or None when the host can't
    give each worker a core of its own (the JAX tool's rule)."""
    try:
        avail = sorted(os.sched_getaffinity(0))
    except AttributeError:
        return None
    if len(avail) < n_proc:
        return None
    per = cores_per_proc or max(1, len(avail) // n_proc)
    if per * n_proc > len(avail):
        return None
    return [avail[i * per:(i + 1) * per] for i in range(n_proc)]


def _results(procs, timeout):
    out = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(
                    f"weak-scaling launch rc={p.returncode}: {log[-800:]}")
            out += [json.loads(ln.split(" ", 1)[1])
                    for ln in log.splitlines() if ln.startswith("WS_RESULT ")]
    except BaseException:
        # a dead group must take the others down with it
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise
    return out


def _env(extra):
    env = dict(os.environ, BYTEPS_LOG_LEVEL="WARNING",
               BYTEPS_TELEMETRY_ON="0")
    for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
              "DMLC_WORKER_ID", "BYTEPS_LOCAL_RANK", "BYTEPS_WS_PIN"):
        env.pop(k, None)
    env.update(extra)
    return env


def run_group(n_proc: int, device: str, timeout: float = 420.0,
              pin: bool = False, cores_per_proc: int = 0, steps=STEPS):
    """N workers under one bpslaunch; the slowest worker's median step
    ms and IQR."""
    if device != "cpu":
        import torch
        have = torch.cuda.device_count()
        if n_proc > have:
            raise ValueError(f"{n_proc} workers need {n_proc} cards; "
                             f"{have} visible")
    extra = {"BYTEPS_LOCAL_SIZE": str(n_proc)}
    if pin:
        slices = _core_slices(n_proc, cores_per_proc)
        if slices is None:
            raise RuntimeError("not enough cores to pin")
        extra["BYTEPS_WS_PIN"] = ";".join(",".join(map(str, s))
                                          for s in slices)
    p = subprocess.Popen(
        LAUNCH + SELF + ["--worker", "--device", device, "--steps",
                         str(steps)],
        env=_env(extra), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    results = _results([p], timeout)
    if len(results) != n_proc:
        raise RuntimeError(f"{len(results)} of {n_proc} workers reported")
    slow = max(results, key=lambda r: r["median_ms"])
    return slow["median_ms"], slow.get("iqr_ms"), results


def _curve(counts, device, pin: bool, cores_per_proc: int = 0, steps=STEPS):
    """The slowest worker's median step ms at each count, beside the
    root order's counters (the root's messages and send time, the
    slowest follower's waits, over the run's ``steps + 1`` pushes)."""
    from ..core.root_order import worst_of
    out = {}
    for n in counts:
        med, iqr, res = run_group(n, device, pin=pin,
                                  cores_per_proc=cores_per_proc, steps=steps)
        out[f"{n}proc_ms"] = round(med, 2)
        # the slowest worker's every step, in order
        out[f"{n}proc_steps_ms"] = max(
            res, key=lambda r: r["median_ms"])["steps_ms"]
        if iqr:
            out[f"{n}proc_iqr_ms"] = [round(q, 2) for q in iqr]
        for k, v in worst_of(res).items():
            out[f"{n}proc_{k}"] = v
    base = out[f"{counts[0]}proc_ms"]
    last = out[f"{counts[-1]}proc_ms"]
    out[f"efficiency_{counts[-1]}proc"] = round(base / max(last, 1e-9), 3)
    return out


def measure_weak_scaling(counts=(1, 2, 4), device="cuda", pinned=True,
                         steps=STEPS):
    """The contended curve, and on the CPU (where the host has the cores)
    the curve with each worker on cores of its own, every group size at
    the same cores a worker."""
    out = {"contended": _curve(counts, device, pin=False, steps=steps)}
    ncores = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)
    per = ncores // counts[-1]
    if device != "cpu":
        out["pinned"] = {"skipped": "one worker a card: nothing to pin"}
    elif not pinned:
        out["pinned"] = {"skipped": "not asked for"}
    elif per >= 1 and _core_slices(counts[-1], per) is not None:
        out["pinned"] = _curve(counts, device, pin=True,
                               cores_per_proc=per, steps=steps)
        out["pinned"]["cores_per_proc"] = per
    else:
        out["pinned"] = {"skipped": (
            f"host has {ncores} core(s); need >= {counts[-1]} for "
            "disjoint per-worker pinning")}
    out["note"] = (f"{GRAD_BYTES >> 20} MiB a worker, push_pull through "
                   f"the engine, one process a worker on {device}")
    return out


def measure_dcn_sweep(device="cpu", procs=4, steps=STEPS, timeout=420.0):
    """The hierarchical all-reduce over ``procs`` processes at every
    ``DMLC_NUM_WORKER`` x ``BYTEPS_LOCAL_SIZE`` layout with a power-of-two
    node count: ``dcn{N}_ms`` is the slowest rank's median at N nodes."""
    if device != "cpu":
        import torch
        have = torch.cuda.device_count()
        if procs > have:
            raise ValueError(f"the sweep's {procs} processes need {procs} "
                             f"cards; {have} visible")
    res = {}
    n = 1
    while n <= procs:
        local = procs // n
        port = _free_port()
        groups = []
        for host in range(n):
            extra = {"DMLC_NUM_WORKER": str(n), "DMLC_WORKER_ID": str(host),
                     "DMLC_PS_ROOT_URI": "127.0.0.1",
                     "DMLC_PS_ROOT_PORT": str(port),
                     "BYTEPS_LOCAL_SIZE": str(local)}
            if device != "cpu":
                # each simulated host its own cards, a rank a card
                extra["CUDA_VISIBLE_DEVICES"] = ",".join(
                    str(host * local + i) for i in range(local))
            groups.append(subprocess.Popen(
                LAUNCH + SELF + ["--worker", "--mode", "hier", "--device",
                                 device, "--steps", str(steps)],
                env=_env(extra), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        out = _results(groups, timeout)
        if len(out) != procs:
            raise RuntimeError(f"dcn sweep {n}x{local}: {len(out)} of "
                               f"{procs} ranks reported")
        res[f"dcn{n}_ms"] = round(max(r["median_ms"] for r in out), 2)
        n *= 2
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="(internal) one rank's body")
    ap.add_argument("--mode", default="push", choices=("push", "hier"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--counts", default="1,2,4")
    ap.add_argument("--sweep-procs", type=int, default=4,
                    help="processes of the dcn sweep (0: no sweep)")
    ap.add_argument("--no-pinned", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.device, args.mode, args.steps)
    counts = tuple(int(c) for c in args.counts.split(","))
    from ._bench_util import conditions_block
    result = {"weak_scaling": measure_weak_scaling(
        counts, args.device, not args.no_pinned, args.steps)}
    if args.sweep_procs:
        result["dcn_sweep"] = measure_dcn_sweep(
            args.device, args.sweep_procs, args.steps)
    result["conditions"] = conditions_block(device=args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
