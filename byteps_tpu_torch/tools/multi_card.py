"""The port's multi-rank paths with one NVIDIA card a rank over NCCL, leg
by leg, on a host of at least four cards.

    python -m byteps_tpu_torch.tools.multi_card            # every leg
    python -m byteps_tpu_torch.tools.multi_card --legs dp_resnet,onebit
    # a rehearsal on the CPU: gloo ranks, tiny models, small sizes
    python -m byteps_tpu_torch.tools.multi_card --device cpu

Each leg starts its ranks as processes of their own (the tools' own
``--spawn`` or the launcher), one card a rank; nothing falls back to
gloo, to the CPU or to two ranks on one card.  Legs, in order:

1. ``dp_resnet``: ``tools/sharded_resnet.py --ranks 4``, ResNet-50 at 32
   x 224² a rank, 1 + 3 steps through the sharded update and through the
   replicated one: every parameter of the two arms must be bit-equal on
   every rank.  Then a routing probe (this module's ``--probe-rank``): a
   ResNet-50-sized flat gradient (25,557,032 f32, 25 chunks of 4 MB) and
   a 1000-float control pushed through the engine under torch.profiler;
   the gradient must issue a reduce-scatter a chunk and one all-gather,
   no all-reduce, and the control one all-reduce (the collectives issued
   and, on the card, NCCL's kernels by name), each result the exact mean;
2. ``onebit``: bpslaunch with a worker a card around
   ``examples.benchmark_byteps`` with onebit (20 tensors of 4 MB, 1 + 10
   iterations): ``onebit_unpack_sum`` must launch at R = 4 once a chunk
   and iteration, every rank's results must have rank 0's SHA-256; the
   same at one worker for its MB/s; then ``tools/weak_scaling.py
   --counts 1,2,4``;
3. ``model_parallel``: ``tools/model_parallel.py fsdp_tp tp pp 3d
   --spawn 4 --check --control`` (Llama-3-8B width at CHECK_LAYERS
   layers, GPT-small), each arm's gradients within GRAD_TOL of the
   one-rank step's and each control beyond it; then ``fsdp_tp`` alone at
   the first depth of TIMED_LAYERS that the four cards hold, with
   ``--remat``, timed without the check;
4. ``seq_expert``: ``tools/long_context.py sp --spawn 2`` and ``--spawn
   4``, the five attention kinds each within GRAD_TOL of the one-rank
   flash step and the wrong-mask control beyond it; ``ep --spawn 2`` and
   ``--spawn 4`` (8 experts every 2nd block), the forward within MOE_TOL
   of the full stacks';
5. ``mp_worker``: ``tests/torch_mp_worker.py --spawn cuda`` at 2 and 4
   cards against the same cases over gloo on the CPU (``--compare``: the
   CPU tests' tolerances, and each control must miss).

Each leg prints one line ``MULTI_CARD {json}``: its figures, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, every rank's backend,
``ok`` and what failed.  The children's output goes to ``--out``.  The
run refuses to start with fewer than four visible cards (exit 2) and
exits 1 if any leg fails.
"""

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

LEGS = ("dp_resnet", "onebit", "model_parallel", "seq_expert", "mp_worker")
CARDS = 4
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GRAD_TOL = 2**-4                 # bf16 gradients against a one-rank step's
LOSS_RTOL = 2**-8
MOE_TOL = 2**-6                  # the MoE forward against the full stacks'
CHECK_LAYERS = 2                 # Llama layers of the checked arm
TIMED_LAYERS = (32, 24, 16)      # the timed fsdp_tp arm: the first that fits
RESNET50_PARAMS = 25_557_032     # the probe's flat gradient
PROBE_CONTROL = 1000
ONEBIT_ARGS = ("--compressor", "onebit", "--num-tensors", "20",
               "--tensor-mb", "4", "--num-iters", "10")
FLASH = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# each child command's limit (s): a hung collective costs at most this
TIMEOUT_S = {"sharded_resnet": 420, "probe": 240, "bench": 240,
             "weak_scaling": 420, "model_parallel": 480, "sp": 360,
             "ep": 240, "mp_worker": 300}
KINDS = ("ring", "striped", "ring_flash", "ulysses", "ulysses_flash")
# the rehearsal's sizes (--device cpu)
CPU_ARGS = {
    "sharded_resnet": ["--device", "cpu", "--batch", "2", "--image", "64",
                       "--steps", "1"],
    "probe_numel": 300_000,
    "onebit": ("--num-tensors", "4", "--tensor-mb", "0.5", "--num-iters",
               "2", "--device", "cpu"),
    "model_parallel": ["--device", "cpu", "--model", "tiny", "--seq", "64",
                       "--gpt-seq", "32", "--steps", "1"],
    "long_context": ["--device", "cpu", "--model", "tiny", "--steps", "1"],
}


# a rank's variables, which each leg's tools set for their own ranks
RANK_ENV = ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
            "DMLC_WORKER_ID", "BYTEPS_LOCAL_RANK", "BYTEPS_LOCAL_SIZE")




class Leg:
    """One leg's figures, checks and children's output."""

    def __init__(self, name, out_dir, smi):
        self.name, self.smi = name, smi
        self.figures, self.failed, self.backends = {}, [], []
        self.log_path = os.path.join(out_dir, f"{name}.log")
        self.t0 = time.perf_counter()

    def check(self, ok, msg):
        if not ok:
            self.failed.append(msg)
        return ok

    def run(self, argv, timeout, env=None, what=None):
        """One child command from the repo's root, RANK_ENV unset (the
        tools set their ranks');
        returns ``(rc, output)``; a child past ``timeout`` is killed."""
        full = dict(os.environ)
        for k in RANK_ENV:
            full.pop(k, None)
        full["PYTHONPATH"] = ROOT + os.pathsep + full.get("PYTHONPATH", "")
        full.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        full.update(env or {})
        t = time.perf_counter()
        p = subprocess.Popen(argv, cwd=ROOT, env=full, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             start_new_session=True)
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            out, _ = p.communicate()
            out += f"\n[killed after {timeout} s]"
        what = what or " ".join(argv[1:6])
        with open(self.log_path, "a") as f:
            f.write(f"=== {what} (rc {p.returncode}, "
                    f"{time.perf_counter() - t:.1f} s)\n{out}\n")
        self.check(p.returncode == 0,
                   f"{what}: exited {p.returncode} (see {self.log_path})")
        return p.returncode, out

    def report(self):
        line = {"leg": self.name, "ok": not self.failed,
                "device": self.smi, "backends": self.backends,
                "seconds": round(time.perf_counter() - self.t0, 1),
                **self.figures}
        if self.failed:
            line["failed"] = self.failed
        print("MULTI_CARD " + json.dumps(line), flush=True)
        return not self.failed


def result_lines(out, prefix):
    """The JSON objects that follow ``prefix`` on ``out``'s lines (an
    empty prefix: the lines that are JSON objects)."""
    rows = []
    for ln in out.splitlines():
        if ln.startswith(prefix + ("" if prefix else "{")):
            try:
                rows.append(json.loads(ln[len(prefix):]))
            except ValueError:
                continue
    return rows


def _ms(ms):
    return {"median_ms": round(statistics.median(ms), 1),
            "min_ms": round(min(ms), 1), "max_ms": round(max(ms), 1)}


def _module(name, *args):
    return [sys.executable, "-m", name, *args]


# ---------------------------------------------------------------- leg 1

def leg_dp_resnet(leg, args):
    cpu = args.device == "cpu"
    extra = CPU_ARGS["sharded_resnet"] if cpu else ["--steps", "3"]
    _, out = leg.run(_module("byteps_tpu_torch.tools.sharded_resnet",
                             "--ranks", str(CARDS), *extra),
                     TIMEOUT_S["sharded_resnet"])
    rows = sorted(result_lines(out, "SHARDED_RESNET "),
                  key=lambda r: r["rank"])
    if leg.check(len(rows) == CARDS, f"sharded_resnet: {len(rows)} ranks "
                                     f"reported, {CARDS} expected"):
        leg.backends += [r["backend"] for r in rows]
        for r in rows:
            leg.check(r["params_bit_equal"] == r["params"],
                      f"sharded_resnet rank {r['rank']}: "
                      f"{r['params_bit_equal']} of {r['params']} parameters "
                      f"bit-equal, max |d| {r['max_abs_diff']}")
        r0 = rows[0]
        leg.figures["sharded_resnet"] = {
            "params": r0["params"],
            "bit_equal_by_rank": [r["params_bit_equal"] for r in rows],
            "max_abs_diff": max(r["max_abs_diff"] for r in rows),
            "max_rel_diff": max(r["max_rel_diff"] for r in rows),
            "sharded_step": _ms(r0["step_ms"]),
            "step_ms_by_rank": [round(r["median_step_ms"], 1) for r in rows],
            "wire_per_step": r0["wire_per_step"],
            "param_bytes": r0["param_bytes"],
            "slot_state_bytes": r0["slot_state_bytes"],
            "replicated_state_bytes": r0["replicated_inner_state_bytes"]}
    numel = CPU_ARGS["probe_numel"] if cpu else RESNET50_PARAMS
    _, out = leg.run(_module("byteps_tpu_torch.tools.multi_card",
                             "--spawn-probe", "--device", args.device,
                             "--probe-numel", str(numel)), TIMEOUT_S["probe"],
                     what="routing probe")
    probes = sorted(result_lines(out, "ROUTE_RESULT "),
                    key=lambda r: r["rank"])
    if not leg.check(len(probes) == CARDS,
                     f"routing probe: {len(probes)} ranks reported"):
        return
    leg.backends += [p["backend"] for p in probes]
    for p in probes:
        g, c = p["gradient"], p["control"]
        calls = g["calls"]
        leg.check(calls.get("reduce_scatter_tensor") == g["chunks"]
                  and calls.get("all_gather_into_tensor") == 1
                  and not calls.get("all_reduce"),
                  f"probe rank {p['rank']}: the gradient's collectives "
                  f"{calls} over {g['chunks']} chunks")
        leg.check(c["calls"] == {"all_reduce": 1},
                  f"probe rank {p['rank']}: the control's collectives "
                  f"{c['calls']}")
        leg.check(g["exact"] and c["exact"],
                  f"probe rank {p['rank']}: a result is not the exact mean")
        if not cpu:
            k, kc = g["kernels"], c["kernels"]
            leg.check(k["ReduceScatter"] >= 1 and k["AllGather"] >= 1
                      and k["AllReduce"] == 0,
                      f"probe rank {p['rank']}: the gradient's NCCL kernels "
                      f"{k}")
            leg.check(kc["AllReduce"] >= 1 and kc["ReduceScatter"] == 0
                      and kc["AllGather"] == 0,
                      f"probe rank {p['rank']}: the control's NCCL kernels "
                      f"{kc}")
    p0 = probes[0]
    leg.figures["routing_probe"] = {
        "numel": numel, "chunks": p0["gradient"]["chunks"],
        "gradient_calls": p0["gradient"]["calls"],
        "gradient_kernels": p0["gradient"]["kernels"],
        "gradient_ms": p0["gradient"]["ms"],
        "control_calls": p0["control"]["calls"],
        "control_kernels": p0["control"]["kernels"]}


def probe_rank(args):
    """One rank of the routing probe: prints ``ROUTE_RESULT {json}``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..common.config import Config
    from ..core import api

    api.init(Config.from_env(), device=args.device)
    eng, dev = api.engine(), api.device()
    R, rank = api.size(), api.rank()
    names = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
             "all_gather", "broadcast")

    def push(name, n, seed):
        # multiples of 1/64: the mean over 4 ranks is exact in any order
        rows = np.round(np.random.RandomState(seed).randn(R, n) * 512) / 64
        x = torch.from_numpy(rows[rank].astype(np.float32)).to(dev)
        calls = {}
        real = {k: getattr(dist, k) for k in names}

        def wrap(k):
            def rec(*a, **kw):
                calls[k] = calls.get(k, 0) + 1
                return real[k](*a, **kw)
            return rec

        api.push_pull(x, name)              # a warm-up, outside the count
        if dev.type == "cuda":
            torch.cuda.synchronize()
        for k in names:
            setattr(dist, k, wrap(k))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                out = api.push_pull(x, name)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        finally:
            for k in names:
                setattr(dist, k, real[k])
        kernels = {"ReduceScatter": 0, "AllGather": 0, "AllReduce": 0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for k in kernels:
                    kernels[k] += k in e.name
        want = (rows.sum(0) / R).astype(np.float32)
        return {"calls": calls, "kernels": kernels, "ms": round(ms, 3),
                "chunks": len(eng.registry.get(name).chunk_bounds),
                "exact": bool(np.array_equal(out.cpu().numpy(), want))}

    res = {"rank": rank, "world": R, "backend": eng.comm.backend,
           "gradient": push("probe.gradient", args.probe_numel, 1),
           "control": push("probe.control", PROBE_CONTROL, 2)}
    api.shutdown()
    print("ROUTE_RESULT " + json.dumps(res), flush=True)
    return 0


def spawn_probe(args):
    """Every rank of the probe, a card a rank (local rank r on card r)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(CARDS):
        env = dict(os.environ, DMLC_NUM_WORKER="1", DMLC_WORKER_ID="0",
                   BYTEPS_LOCAL_SIZE=str(CARDS), BYTEPS_LOCAL_RANK=str(rank),
                   DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port))
        procs.append(subprocess.Popen(
            _module("byteps_tpu_torch.tools.multi_card", "--probe-rank",
                    "--device", args.device, "--probe-numel",
                    str(args.probe_numel)),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    rc = 0
    for p in procs:
        sys.stdout.write(p.communicate()[0])
        rc = rc or p.returncode
    return rc


# ---------------------------------------------------------------- leg 2

def leg_onebit(leg, args):
    cpu = args.device == "cpu"
    bench = _module("byteps_tpu_torch.launcher.launch", sys.executable, "-m",
                    "byteps_tpu_torch.examples.benchmark_byteps",
                    *ONEBIT_ARGS, *(CPU_ARGS["onebit"] if cpu else ()))
    # the launcher starts one worker a visible card (a CPU rehearsal
    # names its count)
    _, out = leg.run(bench, TIMEOUT_S["bench"],
                     env={"BYTEPS_LOCAL_SIZE": str(CARDS)}
                     if cpu else None, what=f"bpslaunch x{CARDS} onebit")
    rows = sorted(result_lines(out, ""), key=lambda r: r.get("rank", -1))
    rows = [r for r in rows if "mb_per_s" in r]
    if leg.check(len(rows) == CARDS, f"onebit: {len(rows)} workers "
                                     f"reported, {CARDS} expected"):
        leg.backends += [r["backend"] for r in rows]
        shas = {r["result_sha256"] for r in rows}
        leg.check(len(shas) == 1, f"onebit: the ranks' results differ "
                                  f"({len(shas)} digests)")
        for r in rows:
            c = r["chunks"] * r["iters"]
            leg.check(r["size"] == CARDS, f"onebit rank {r['rank']}: size "
                                          f"{r['size']}")
            if not cpu:
                want = {"onebit_pack": 2 * c, "onebit_unpack": c,
                        "onebit_unpack_sum": c}
                leg.check(r["launches"] == want and r["merge_ranks"]
                          == {str(CARDS): c},
                          f"onebit rank {r['rank']}: launches "
                          f"{r['launches']}, merges by R {r['merge_ranks']},"
                          f" expected {want} with every merge at R = {CARDS}")
        leg.figures["workers"] = {
            "mb_per_s_by_rank": [round(r["mb_per_s"], 1) for r in rows],
            "chunks": rows[0]["chunks"], "iters": rows[0]["iters"],
            "launches": rows[0]["launches"],
            "merge_ranks": rows[0]["merge_ranks"],
            "result_sha256": rows[0]["result_sha256"][:16]}
    _, out = leg.run(bench, TIMEOUT_S["bench"], env={"BYTEPS_LOCAL_SIZE": "1"},
                     what="bpslaunch x1 onebit")
    one = [r for r in result_lines(out, "") if "mb_per_s" in r]
    if leg.check(len(one) == 1, "onebit: the one-worker run reported "
                                f"{len(one)} lines"):
        leg.backends.append(one[0]["backend"])
        leg.figures["one_worker_mb_per_s"] = round(one[0]["mb_per_s"], 1)
        leg.figures["one_worker_merge_ranks"] = one[0]["merge_ranks"]
    _, out = leg.run(_module("byteps_tpu_torch.tools.weak_scaling",
                             "--counts", "1,2,4", "--sweep-procs", "0",
                             "--device", args.device,
                             *(("--steps", "2", "--no-pinned") if cpu
                               else ())), TIMEOUT_S["weak_scaling"],
                     what="weak_scaling 1,2,4")
    ws = [json.loads(ln) for ln in out.splitlines()
          if ln.startswith('{"weak_scaling"')]
    if leg.check(len(ws) == 1, "weak_scaling: no result line"):
        w = ws[0]["weak_scaling"]["contended"]
        leg.figures["weak_scaling"] = {
            k: w[k] for k in w if k.endswith(("proc_ms", "iqr_ms"))
            or k.startswith("efficiency")}


# ---------------------------------------------------------------- leg 3

def _mp_children(leg, argv, timeout, what):
    _, out = leg.run(_module("byteps_tpu_torch.tools.model_parallel", *argv,
                             "--spawn", str(CARDS)), timeout, what=what)
    rows = sorted(result_lines(out, "MP_RESULT "), key=lambda r: r["rank"])
    leg.check(len(rows) == CARDS, f"{what}: {len(rows)} ranks reported")
    leg.backends += [r["backend"] for r in rows]
    return rows if len(rows) == CARDS else None


def _arm_figures(a, tokens=True):
    out = dict(_ms(a["ms"])) if a.get("ms") else {}
    if tokens and a.get("tokens_per_s"):
        out["tokens_per_s"] = round(a["tokens_per_s"])
    for k in ("peak_gib", "state_bytes", "whole_state_bytes",
              "sliced_share", "flash_launches", "stage_forwards",
              "shift_path", "first_loss", "ref_loss"):
        if a.get(k) is not None:
            out[k] = (round(a[k], 3) if isinstance(a[k], float) else a[k])
    return out


def leg_model_parallel(leg, args):
    from .model_parallel import ARMS, FAULTS
    cpu = args.device == "cpu"
    extra = CPU_ARGS["model_parallel"] if cpu else [
        "--layers", str(CHECK_LAYERS), "--steps", "2"]
    rows = _mp_children(leg, list(ARMS) + extra + ["--check", "--control"],
                        TIMEOUT_S["model_parallel"], "model_parallel --check")
    if rows:
        for arm in ARMS:
            arms = [r["arms"][arm] for r in rows]
            a0 = arms[0]
            shares = a0["grad_share_by_rank"]
            leg.check(max(shares) <= GRAD_TOL,
                      f"{arm}: gradient shares {shares} > {GRAD_TOL}")
            leg.check(abs(a0["first_loss"] - a0["ref_loss"])
                      <= LOSS_RTOL * abs(a0["ref_loss"]),
                      f"{arm}: first loss {a0['first_loss']} against "
                      f"{a0['ref_loss']}")
            fig = _arm_figures(a0)
            fig["grad_share_by_rank"] = [float(f"{v:.3g}") for v in shares]
            fig["peak_gib_by_rank"] = [round(a["peak_gib"] or 0, 2)
                                       for a in arms]
            if arm in FAULTS:
                ctl = a0["control"]["grad_share_by_rank"]
                leg.check(min(ctl) > GRAD_TOL,
                          f"{arm} control: shares {ctl} within {GRAD_TOL}")
                fig["control_share_by_rank"] = [float(f"{v:.3g}")
                                                for v in ctl]
            for r, a in enumerate(arms):
                leg.check(all(math.isfinite(v)
                              for v in [a["first_loss"]] + a["loss"]),
                          f"{arm} rank {r}: losses {a['loss']}")
                if not cpu:
                    n = CHECK_LAYERS * len(a["ms"]) if arm == "fsdp_tp" else 0
                    leg.check(a["flash_launches"] == {k: n for k in FLASH},
                              f"{arm} rank {r}: flash launches "
                              f"{a['flash_launches']}, {n} each expected")
            leg.figures[f"{arm}_check"] = fig
    # the timed arm: the deepest Llama the four ranks hold
    for layers in ((None,) if cpu else TIMED_LAYERS):
        argv = ["fsdp_tp", "--steps", "2"] + (
            CPU_ARGS["model_parallel"] if cpu
            else ["--layers", str(layers), "--remat"])
        n_failed = len(leg.failed)
        rows = _mp_children(leg, argv, TIMEOUT_S["model_parallel"],
                            f"model_parallel fsdp_tp {layers} layers")
        if rows:
            arms = [r["arms"]["fsdp_tp"] for r in rows]
            fig = _arm_figures(arms[0])
            fig["layers"] = layers
            fig["remat"] = not cpu
            fig["peak_gib_by_rank"] = [round(a["peak_gib"] or 0, 2)
                                       for a in arms]
            if not cpu:
                # remat runs each block's forward twice
                n = layers * len(arms[0]["ms"])
                want = {"flash_fwd": 2 * n, "flash_bwd_dkv": n,
                        "flash_bwd_dq": n}
                leg.check(all(a["flash_launches"] == want for a in arms),
                          f"fsdp_tp {layers}: flash launches "
                          f"{[a['flash_launches'] for a in arms]}")
            leg.figures["fsdp_tp_timed"] = fig
            break
        # a depth the cards cannot hold: note it, try the next
        leg.figures.setdefault("fsdp_tp_did_not_fit", []).append(layers)
        del leg.failed[n_failed:]
    else:
        leg.check(False, f"fsdp_tp: no depth of {TIMED_LAYERS} ran")


# ---------------------------------------------------------------- leg 4

def _lc_children(leg, argv, world, timeout, what):
    _, out = leg.run(_module("byteps_tpu_torch.tools.long_context", *argv,
                             "--spawn", str(world)), timeout, what=what)
    rows = sorted(result_lines(out, "LC_RESULT "), key=lambda r: r["rank"])
    leg.check(len(rows) == world, f"{what}: {len(rows)} ranks reported")
    leg.backends += [r["backend"] for r in rows]
    return rows if len(rows) == world else None


def leg_seq_expert(leg, args):
    cpu = args.device == "cpu"
    extra = (CPU_ARGS["long_context"] + ["--seq", "128"] if cpu
             else ["--steps", "2"])
    for world in (2, CARDS):
        rows = _lc_children(leg, ["sp", "--check", "--control-qoff0"]
                            + extra, world, TIMEOUT_S["sp"], f"sp x{world}")
        if rows:
            layers = 2 if cpu else 8
            fig = {"shift_path": rows[0]["shift_path"]}
            for kind in KINDS + ("ring_flash_qoff0",):
                arms = [r["arms"][kind] for r in rows]
                a0 = arms[0]
                shares = a0["grad_share_by_rank"]
                if kind == "ring_flash_qoff0":
                    leg.check(min(shares) > GRAD_TOL,
                              f"sp x{world} control: shares {shares}")
                    fig["control_share_by_rank"] = [float(f"{v:.3g}")
                                                    for v in shares]
                    continue
                leg.check(max(shares) <= GRAD_TOL,
                          f"sp x{world} {kind}: gradient shares {shares}")
                leg.check(abs(a0["first_loss"] - a0["ref_loss"])
                          <= LOSS_RTOL * abs(a0["ref_loss"]),
                          f"sp x{world} {kind}: first loss "
                          f"{a0['first_loss']} against {a0['ref_loss']}")
                f = _arm_figures(a0)
                f["grad_share_by_rank"] = [float(f"{v:.3g}") for v in shares]
                f["flash_launches_by_rank"] = [a["flash_launches"]["flash_fwd"]
                                               for a in arms]
                f["peak_gib_by_rank"] = [round(a["peak_gib"] or 0, 2)
                                         for a in arms]
                for r, a in enumerate(arms):
                    n = {"ring_flash": r + 1,
                         "ulysses_flash": 1}.get(kind, 0)
                    n *= layers * len(a["ms"])
                    leg.check(cpu or a["flash_launches"]
                              == {k: n for k in FLASH},
                              f"sp x{world} {kind} rank {r}: flash launches "
                              f"{a['flash_launches']}, {n} each expected")
                fig[kind] = f
            leg.figures[f"sp_x{world}"] = fig
    ep_extra = (CPU_ARGS["long_context"] + ["--seq", "64", "--batch", "8"]
                if cpu else ["--steps", "3"])
    for world in (2, CARDS):
        rows = _lc_children(leg, ["ep", "--check"] + ep_extra, world,
                            TIMEOUT_S["ep"],
                            f"ep x{world}")
        if rows:
            for a in rows:
                leg.check(a["logit_share"] <= MOE_TOL
                          and a["aux_rel"] <= MOE_TOL,
                          f"ep x{world} rank {a['rank']}: logits "
                          f"{a['logit_share']}, aux {a['aux_rel']}")
                losses = [a["first_loss"]] + a["loss"]
                leg.check(all(math.isfinite(v) for v in losses),
                          f"ep x{world} rank {a['rank']}: losses {losses}")
            f = _arm_figures(rows[0])
            f.update(experts_here=rows[0]["experts_here"],
                     tokens_here=rows[0]["tokens_here"],
                     logit_share=max(a["logit_share"] for a in rows),
                     aux_rel=max(a["aux_rel"] for a in rows),
                     peak_gib_by_rank=[round(a["peak_gib"] or 0, 2)
                                       for a in rows])
            leg.figures[f"ep_x{world}"] = f


# ---------------------------------------------------------------- leg 5

def leg_mp_worker(leg, args):
    if not leg.check(os.path.exists(os.path.join(ROOT, "tests",
                                                 "torch_mp_worker.py")),
                     "tests/torch_mp_worker.py is not in this checkout"):
        return
    card, host = (os.path.join(args.out, "mp_worker", d)
                  for d in (args.device, "cpu_reference"))
    for d in (card, host):
        shutil.rmtree(d, ignore_errors=True)
    for world in (2, CARDS):
        for dev, d in ((args.device, card), ("cpu", host)):
            leg.run(_module("tests.torch_mp_worker", "--spawn", dev, d,
                            str(world)), TIMEOUT_S["mp_worker"],
                    what=f"torch_mp_worker {dev} x{world}")
    rc, out = leg.run(_module("tests.torch_mp_worker", "--compare", card,
                              host), 120, what="torch_mp_worker --compare")
    last = out.strip().splitlines()[-1:] or ["no output"]
    leg.figures["compare"] = last[0]
    import numpy as np
    for f in sorted(os.listdir(card)) if os.path.isdir(card) else ():
        if f.startswith("sp_") and f.endswith(".npz"):
            leg.backends.append(str(np.load(os.path.join(card, f))[
                "meta/backend"]))


LEG_FNS = {"dp_resnet": leg_dp_resnet, "onebit": leg_onebit,
           "model_parallel": leg_model_parallel,
           "seq_expert": leg_seq_expert, "mp_worker": leg_mp_worker}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal over gloo at tiny sizes")
    ap.add_argument("--out", default="multi_card_out",
                    help="the children's output, by leg")
    ap.add_argument("--probe-rank", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--spawn-probe", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--probe-numel", type=int, default=RESNET50_PARAMS,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.probe_rank:
        return probe_rank(args)
    if args.spawn_probe:
        return spawn_probe(args)
    legs = [g for g in args.legs.split(",") if g]
    unknown = set(legs) - set(LEGS)
    if unknown:
        ap.error(f"unknown legs {sorted(unknown)}; legs are {LEGS}")
    if args.device != "cpu":
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < CARDS:
            print(f"multi_card: needs {CARDS} visible cards, one a rank; "
                  f"{have} visible", file=sys.stderr)
            return 2
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)
    from .model_parallel import _device_line
    smi = _device_line()
    print(f"multi_card [{smi}]: legs {legs} on {args.device}", flush=True)
    ok = True
    for name in legs:
        leg = Leg(name, args.out, smi)
        try:
            LEG_FNS[name](leg, args)
        except Exception as e:  # noqa: BLE001 — a leg's crash is its failure
            leg.check(False, f"{type(e).__name__}: {e}")
        if args.device != "cpu":
            bad = sorted({b for b in leg.backends if b != "nccl"})
            leg.check(not bad and leg.backends,
                      f"backends {leg.backends}: every rank must be on nccl")
        ok = leg.report() and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
