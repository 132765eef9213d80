"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m perfbench.run --workload resnet50.onebit --seed 7 \\
        --seconds 10 --trace 0

Starts the cell's ranks through the port's launcher
(``python -m byteps_tpu_torch.launcher.launch``, one process a card,
``BYTEPS_LOCAL_SIZE`` set to the cell's chips, a free rendezvous port
found by the launcher), each running ``perfbench.worker``, which writes
its readings to a fresh temporary folder.  This process reduces them:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics through the readers in ``metrics/``; and ``correct``,
the program's first steps held against the plain reference
(``reference/compare.py``) within the cell's limits (``limits/``).  The
numbers compared, each beside its limit, are the last lines on standard
error and the last key of the result, which is the last line on
standard output.

The run exits non-zero, printing no result, when the card or cards the
cell asks for are not there, when a rank fails, or when a module of JAX
or of the JAX package is loaded in a rank or here.  ``--rehearse`` runs
the cell on the CPU at the sizes its configuration and traffic files
give under ``rehearse`` (the ranks over gloo) and writes no metric, as
a CPU run measures no device; ``--plant NAME`` plants one of
``plants.py``'s faults in the program.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from perfbench import spec  # noqa: E402
from perfbench.flops.peaks import H100_SXM  # noqa: E402
from perfbench.reference.compare import numbers, verdict  # noqa: E402

# a rank's whole run, a cold checkout's builds included
RANK_TIMEOUT_S = 1150


def p90(values) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def end_to_end(ranks, t0: float) -> dict:
    r0 = ranks[0]
    w = r0["window"]
    return {
        "samples_per_s": w["samples"] / w["seconds"],
        "step_ms_p90": p90([s * 1e3 for s in w["step_s"]]),
        "peak_mem_gib": max(r["device"]["memory_peak_bytes"]
                            for r in ranks) / 2 ** 30,
        "setup_s": r0["marks"]["window"] - t0}


def layer_context(c: dict, ranks) -> dict:
    flops = spec.load_module("flops", c["config"]["flops"])
    return {"cell": c["cell"], "config": c["config"],
            "traffic": c["traffic"], "ranks": ranks,
            "flops_per_sample": flops.train_flops_per_sample(
                c["config"], c["traffic"]),
            "peaks": H100_SXM}


def _result(args, c: dict, ranks) -> dict:
    r0 = ranks[0]
    prog = {"loss": [list(x) for x in zip(*[r["losses"] for r in ranks])],
            "grad_norm": r0["grad_norm"],
            "change_norm": r0["change_norm"]}
    nums = numbers(prog, r0["reference"])
    ok, shown = verdict(nums, c["limits"])
    final = [r["window"]["final_loss"] for r in ranks]
    failed = sum(1 for v in final if not math.isfinite(v))
    window = end_to_end(ranks, T0)
    if args.trace:
        measured = spec.read_metrics(c["per_layer"], layer_context(c, ranks))
    else:
        measured = window
        units = {e["name"]: e["unit"] for e in c["end_to_end"]}
        measured = {k: {"value": v, "unit": units[k]}
                    for k, v in measured.items() if k in units}
    dev = {"platform": "cpu" if args.rehearse else "gpu",
           "kind": r0["device"]["kind"], "count": len(ranks),
           "memory_peak_bytes": max(r["device"]["memory_peak_bytes"]
                                    for r in ranks)}
    out = {"correct": ok and failed == 0,
           "attempted": r0["window"]["steps"], "failed": failed}
    if args.trace:
        profs = [r["profile"] for r in ranks]
        dev["busy_s"] = sum(p.get("busy_s", 0.0) for p in profs) / len(profs)
        dev["window_s"] = profs[0].get("window_s", 0.0)
        out["breakdown"] = {"device_ops": profs[0].get("device_ops", []),
                            "idle_gaps": profs[0].get("idle_gaps", [])}
    if args.rehearse:
        # a CPU run measures no device: what it read stays out of metrics
        out["metrics"] = {}
        out["rehearsed"] = measured
    else:
        out["metrics"] = measured
    out["device"] = dev
    out["run"] = {
        "power": r0["device"]["power"], "peak": H100_SXM["name"],
        "window_steps": r0["window"]["steps"],
        # the window's rate and tail on every line, also where the cell
        # reports them as no metric of either kind
        "window_samples_per_s": window["samples_per_s"],
        "window_step_ms_p90": window["step_ms_p90"],
        "warmup_steps": r0["warmup_steps"], "settled": r0["settled"],
        "setup_marks_s": {k: v - T0 for k, v in r0["marks"].items()},
        "first_steps_s": r0["first_step_s"],
        "reference_s": r0["reference_s"],
        "worst_leaves": [nums["grad_worst_leaf"], nums["change_worst_leaf"]],
        "left_out": nums["left_out"]}
    out["check"] = shown
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--plant", default="")
    args = p.parse_args(argv)
    c = spec.cell(args.workload, rehearse=args.rehearse)
    chips = c["cell"]["chips"]
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    # one intra-op thread a rank, as torchrun starts a job, and one hash
    # seed: the ranks' host threads are the step's critical path
    env = dict(os.environ, BYTEPS_LOCAL_SIZE=str(chips),
               PERFBENCH_T0=repr(T0), USE_FLAX="0", OMP_NUM_THREADS="1",
               PYTHONHASHSEED="0",
               BYTEPS_MIN_COMPRESS_BYTES=str(
                   c["traffic"]["min_compress_bytes"]),
               BYTEPS_PARTITION_BYTES=str(c["traffic"]["partition_bytes"]))
    cmd = [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
           sys.executable, "-m", "perfbench.worker",
           "--workload", args.workload, "--seed", str(args.seed),
           "--seconds", repr(args.seconds), "--trace", str(args.trace),
           "--out", tmp]
    if args.rehearse:
        cmd.append("--rehearse")
    if args.plant:
        cmd += ["--plant", args.plant]
    try:
        proc = subprocess.Popen(cmd, env=env, stdout=sys.stderr)
        try:
            rc = proc.wait(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            print(f"perfbench: the ranks ran past {RANK_TIMEOUT_S} s",
                  file=sys.stderr)
            return 1
        if rc != 0:
            print(f"perfbench: the ranks exited {rc}", file=sys.stderr)
            return 1
        ranks = []
        for r in range(chips):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    banned = sorted(set(spec.loaded_banned()).union(
        *[r["banned_modules"] for r in ranks]))
    if banned:
        print(f"perfbench: modules of JAX or the JAX package were loaded: "
              f"{banned}", file=sys.stderr)
        return 1
    out = _result(args, c, ranks)
    print(f"perfbench: {c['cell']['name']} on {out['device']['kind']} "
          f"x{out['device']['count']} ({out['run']['power']}), peaks of "
          f"{out['run']['peak']}; {out['run']['window_steps']} steps in the "
          f"window", file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
