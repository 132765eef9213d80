"""One rank of a run: the program set up, checked, timed and profiled.

Started by the port's launcher (``byteps_tpu_torch.launcher.launch``),
one process a card, from ``run.py``; writes its readings as JSON to
``<out>/rank<r>.json`` for ``run.py`` to reduce.

The rank builds the port's model, loads the benchmark's weights made
from the seed, wraps the traffic's optimizer in
``byteps_tpu_torch.torch.DistributedOptimizer`` and trains it closed
loop: forward, ``loss.backward()``, ``optimizer.step()``, a synchronise.
Set-up drives that same object through the checked steps (distinct
batches), reading each loss, the first step's gradient from the
optimizer's state and the parameters' change, then on until the
engine's planner has settled; the window then runs ``--seconds``; with
``--trace 1`` a few more steps run under ``torch.profiler``.  Once the
program is shut down and its memory freed, rank 0 replays the checked
steps in the plain reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from . import data, spec
from .profile import STEP, summarize


def _first_grad_norms(torch, model, inner, optim, o: dict) -> dict:
    """Each leaf's gradient as the optimizer got it at the first step,
    worked out from its state (``optimizers/<kind>.py``); a leaf with no
    state got no gradient (norm 0)."""
    names, norms = [], []
    with torch.no_grad():
        for name, p in model.named_parameters():
            g = optim.first_grad(inner.state.get(p, {}), p, o)
            names.append(name)
            norms.append(torch.zeros((), device=p.device) if g is None
                         else g.norm())
        return dict(zip(names, torch.stack(norms).tolist()))


def _change_norms(torch, model, leaves, seed: int, device) -> dict:
    """Each leaf's distance from its starting weights, made again from
    the seed."""
    start = data.make_weights(leaves, seed, device)
    with torch.no_grad():
        names = [n for n, _ in model.named_parameters()]
        norms = torch.stack([(p - start[n]).norm()
                             for n, p in model.named_parameters()])
        out = dict(zip(names, norms.tolist()))
    del start
    return out


def _settled(eng) -> bool:
    """Whether the engine's planner has nothing left to explore: every
    registered tensor's chunk size and codec locked."""
    ctxs = [eng.registry.get(n)
            for n in eng.registry.names_in_declaration_order()]
    return all(eng.planner.locked(c.nbytes)
               and eng.planner.compress_locked(c.nbytes) for c in ctxs)


def _power_limit(device_index: int) -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device_index),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class Program:
    """The port set up for one seed: its model with the benchmark's
    weights, the inner optimizer wrapped in ``DistributedOptimizer``,
    and a pool of distinct batches made from the seed and the rank."""

    def __init__(self, torch, bps, c: dict, seed: int, dev, rank: int,
                 marks: dict):
        from .reference.replay import model as reference_model
        self.torch, self.c, self.seed, self.dev = torch, c, seed, dev
        config, traffic = c["config"], c["traffic"]
        self.builder = spec.load_module("builders", config["builder"])
        self.leaves = reference_model(config).leaves(config)
        self.model = self.builder.build(config, dev)
        self.model.train()
        marks["build"] = time.time()
        weights = data.make_weights(self.leaves, seed, dev)
        params = dict(self.model.named_parameters())
        if sorted(params) != sorted(weights) or any(
                tuple(params[n].shape) != tuple(weights[n].shape)
                for n in params):
            raise RuntimeError("the program's parameters are not the "
                               "reference's leaves")
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(weights[n])
        del weights, params
        self.opt_spec = traffic["optimizer"]
        self.optim = spec.load_module("optimizers", self.opt_spec["kind"])
        self.inner = self.optim.program(self.model.parameters(),
                                        self.opt_spec)
        self.opt = bps.DistributedOptimizer(
            self.inner, named_parameters=self.model.named_parameters(),
            compression=traffic.get("codec"))
        self.sync()
        marks["weights"] = time.time()
        self.pool = [data.batch(config, traffic, seed, rank, i, dev)
                     for i in range(traffic["pool"])]
        self.sync()
        marks["batches"] = time.time()

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def step(self, b, label: bool = False):
        """One training step ending in a synchronise: ``(loss, start,
        backward returned, step returned, end)`` on the host clock."""
        from torch.profiler import record_function
        ta = time.perf_counter()
        self.opt.zero_grad()
        if label:
            with record_function("perfbench.forward"):
                loss = self.builder.loss(self.model, b)
            with record_function("perfbench.backward"):
                loss.backward()
        else:
            loss = self.builder.loss(self.model, b)
            loss.backward()
        tb = time.perf_counter()
        if label:
            with record_function("perfbench.optimizer_step"):
                self.opt.step()
        else:
            self.opt.step()
        tc = time.perf_counter()
        self.sync()
        return loss, ta, tb, tc, time.perf_counter()

    def checked(self, rank: int) -> dict:
        """The checked steps, on distinct batches: each loss; on rank 0
        the first step's gradient norms from the optimizer's state and
        the parameters' change norms after the last."""
        out = {"losses": [], "first_step_s": []}
        for i in range(self.c["traffic"]["checked_steps"]):
            loss, ta, *_, td = self.step(self.pool[i])
            out["first_step_s"].append(td - ta)
            out["losses"].append(float(loss.detach()))
            if i == 0 and rank == 0:
                out["grad_norm"] = _first_grad_norms(
                    self.torch, self.model, self.inner, self.optim,
                    self.opt_spec)
        if rank == 0:
            out["change_norm"] = _change_norms(self.torch, self.model,
                                               self.leaves, self.seed,
                                               self.dev)
        return out

    def close(self):
        del self.opt, self.inner, self.model, self.pool


def _cuda_or_exit(torch, chips: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s), "
              f"{n} visible", file=sys.stderr)
        sys.exit(3)


def run(args) -> dict:
    t0 = float(os.environ["PERFBENCH_T0"])
    marks = {}
    c = spec.cell(args.workload, rehearse=args.rehearse)
    traffic = c["traffic"]
    import torch
    if not args.rehearse:
        _cuda_or_exit(torch, c["cell"]["chips"])
    import torch.distributed as dist
    marks["torch"] = time.time()

    import byteps_tpu_torch.torch as bps
    from byteps_tpu_torch.core import api
    marks["port"] = time.time()
    if args.plant:
        from .plants import plant
        plant(args.plant)
    bps.init(device="cpu" if args.rehearse else "cuda")
    dev, rank, size = api.device(), bps.rank(), bps.size()
    ctrl = dist.new_group(backend="gloo") if size > 1 else None
    eng = api.engine()
    marks["init"] = time.time()
    torch.empty(1, device=dev)          # the card's context and allocator
    marks["context"] = time.time()

    def agree(flag: bool, op) -> bool:
        if ctrl is None:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=op, group=ctrl)
        return bool(t.item())

    prog = Program(torch, bps, c, args.seed, dev, rank, marks)
    out = {"rank": rank, "size": size, "marks": marks, "t0": t0}
    out.update(prog.checked(rank))
    marks["checked"] = time.time()
    pool, step = prog.pool, prog.step
    k = traffic["checked_steps"]
    while k < traffic["warmup_max"] and not (
            k >= traffic["warmup_min"] and agree(_settled(eng),
                                                 dist.ReduceOp.MIN
                                                 if ctrl else None)):
        step(pool[k % len(pool)])
        k += 1
    out["warmup_steps"] = k
    out["settled"] = _settled(eng)

    # the window: closed loop, rank 0's clock decides the end for all
    if ctrl is not None:
        dist.barrier(group=ctrl)
    marks["window"] = time.time()
    before = dict(eng.stats)
    start = time.perf_counter()
    step_s, exposed_s = [], []
    while True:
        loss, ta, tb, tc, td = step(pool[k % len(pool)])
        k += 1
        step_s.append(td - ta)
        exposed_s.append(tc - tb)
        if agree(td - start >= args.seconds and rank == 0,
                 dist.ReduceOp.MAX if ctrl else None):
            break
    end = td
    final_loss = float(loss.detach())
    after = dict(eng.stats)
    out["window"] = {
        "seconds": end - start, "steps": len(step_s),
        "samples": len(step_s) * traffic["batch_per_rank"] * size,
        "step_s": step_s, "exposed_s": exposed_s,
        "final_loss": final_loss,
        "stats": {key: after[key] - before[key] for key in before}}
    if args.trace:
        out["profile"] = _profile(torch, step, pool, k, traffic)
    if rank == 0:
        out["compressed_chunks"] = [
            ln for n in eng.registry.names_in_declaration_order()
            for ctx in [eng.registry.get(n)] if ctx.compressor
            for _, ln in ctx.chunk_bounds]
    out["device"] = {
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0),
        "power": (_power_limit(dev.index) if dev.type == "cuda"
                  else "no card")}
    out["banned_modules"] = spec.loaded_banned()
    prog.close()
    del prog, pool, step, loss, eng
    bps.shutdown()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        from .reference.replay import replay
        t = time.perf_counter()
        out["reference"] = replay(c["config"], traffic, args.seed, size, dev)
        out["reference_s"] = time.perf_counter() - t
    return out


def _profile(torch, step, pool, k: int, traffic: dict) -> dict:
    """A few steady steps under ``torch.profiler``, reduced by
    ``profile.summarize``; the exported trace is deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for j in range(traffic["profile_steps"]):
            with record_function(STEP):
                step(pool[(k + j) % len(pool)], label=True)
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return summarize(path)
    finally:
        os.remove(path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--plant", default="")
    args = p.parse_args(argv)
    out = run(args)
    path = os.path.join(args.out, f"rank{out['rank']}.json")
    with open(path + ".part", "w") as f:
        json.dump(out, f)
    os.replace(path + ".part", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
