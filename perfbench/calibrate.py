"""The readings the limits of ``correct`` are set from, for one cell.

    python3 -m byteps_tpu_torch.launcher.launch python3 -m \\
        perfbench.calibrate --workload bert_large.dp4 \\
        --seeds 11,12,...,22 --out chiprun_out/cal
    (set BYTEPS_LOCAL_SIZE to the cell's chips, and BYTEPS_MIN_COMPRESS_BYTES
    and BYTEPS_PARTITION_BYTES to its traffic's, as ``run.py`` does)

Every rank drives the program through the cell's checked steps once a
seed at the cell's own sizes, a fresh engine each time where the
traffic's codec keeps state (error feedback's residuals), else one engine
for all (a fresh process group at more than one rank does not form
again in one process): the sound runs
on ``--seeds``, then each of ``plants.py``'s faults that the cell can
have on the first ``--fault-seeds`` of them.  Rank 0 then replays each
seed in the reference in float32, and the control, the reference in
``--control-precision`` put in the program's place, on the first
``--control-seeds``, and writes every number of ``reference/compare.py``
to ``<out>/calibration.json``: the sound runs' largest (the lower
reading), the control's and each fault's smallest (the upper readings).
A benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import spec
from .plants import PLANTS, plant
from .reference.compare import NUMBERS, numbers
from .worker import Program, _cuda_or_exit


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--faults", default=",".join(PLANTS),
                   help="the faults to plant, of those the cell can have")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--control-precision", default="fp8")
    p.add_argument("--out", required=True)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    c = spec.cell(args.workload, rehearse=args.rehearse)
    import torch
    if not args.rehearse:
        _cuda_or_exit(torch, c["cell"]["chips"])
    import byteps_tpu_torch.torch as bps
    from byteps_tpu_torch.core import api
    jobs = [("", s) for s in seeds]
    faults = [f for f in args.faults.split(",") if f
              and (f != "no_exchange" or c["cell"]["chips"] > 1)]
    jobs += [(f, s) for f in faults for s in seeds[:args.fault_seeds]]
    fresh = bool(c["traffic"].get("codec"))
    if fresh and c["cell"]["chips"] > 1:
        raise NotImplementedError("a codec's state at more than one rank")
    mine = []
    for fault, seed in jobs:
        undo = plant(fault) if fault else (lambda: None)
        try:
            bps.init(device="cpu" if args.rehearse else "cuda")
            dev, rank, size = api.device(), bps.rank(), bps.size()
            t = time.perf_counter()
            prog = Program(torch, bps, c, seed, dev, rank, {})
            r = prog.checked(rank)
            prog.close()
            del prog
            if fresh:
                bps.shutdown()
        finally:
            undo()
        r.update(fault=fault, seed=seed, seconds=time.perf_counter() - t)
        mine.append(r)
        print(f"calibrate rank {rank}: {fault or 'sound'} seed {seed} "
              f"losses {r['losses']} {r['seconds']:.1f} s", file=sys.stderr)
    bps.shutdown()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"rank{rank}.json")
    with open(path + ".part", "w") as f:
        json.dump(mine, f)
    os.replace(path + ".part", path)
    if rank != 0:
        return 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks = [mine]
    for r in range(1, size):
        other = os.path.join(args.out, f"rank{r}.json")
        end = time.monotonic() + 600
        while not os.path.exists(other):
            if time.monotonic() > end:
                raise TimeoutError(f"no readings from rank {r}")
            time.sleep(1.0)
        with open(other) as f:
            ranks.append(json.load(f))
    from .reference.replay import replay
    refs = {}
    rows = []
    for i, (fault, seed) in enumerate(jobs):
        if seed not in refs:
            refs[seed] = replay(c["config"], c["traffic"], seed, size, dev)
        r0 = ranks[0][i]
        got = {"loss": [list(x) for x in
                        zip(*[ranks[k][i]["losses"] for k in range(size)])],
               "grad_norm": r0["grad_norm"],
               "change_norm": r0["change_norm"]}
        rows.append({"kind": fault or "sound", "seed": seed,
                     **numbers(got, refs[seed])})
    for prec in (args.control_precision, "bf16"):
        for seed in seeds[:args.control_seeds]:
            low = replay(c["config"], c["traffic"], seed, size, dev,
                         precision=prec)
            rows.append({"kind": f"reference_{prec}", "seed": seed,
                         **numbers(low, refs[seed])})
    summary = {}
    for kind in sorted({row["kind"] for row in rows}):
        sel = [row for row in rows if row["kind"] == kind]
        pick = max if kind == "sound" else min
        summary[kind] = {k: pick(row[k] for row in sel) for k in NUMBERS}
    out = {"workload": args.workload, "device": (
               torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu"), "ranks": size, "rows": rows,
           "summary": summary}
    with open(os.path.join(args.out, "calibration.json"), "w") as f:
        json.dump(out, f, indent=1)
    for kind, v in summary.items():
        print(f"calibrate {args.workload} {kind}: "
              + ", ".join(f"{k} {v[k]:.4g}" for k in NUMBERS),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
