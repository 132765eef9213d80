"""One rank of the port's sharded-update and ZeRO tests.

One process per rank, each with its DMLC_*/BYTEPS_* environment, as in
tests/torch_collectives_worker.py.  Rank r contributes row r of arrays
drawn from fixed numpy seeds (``rows``: every f32 sum of them is exact in
any order), so the caller can rebuild every input and every exact
average.  Imports neither jax nor byteps_tpu.

    # every rank of one or more layouts (tests/test_torch_sharded_update.py)
    python -m tests.torch_sharded_worker --spawn cpu OUT_DIR node_of_2 2x2 1x4

Results are per part of the cases and rank
(``OUT_DIR/<device>_<part>_<layout>_<rank>.npz``); the sharded part at
1x4 ends with an elastic shrink to 2 ranks.  The "param_codec" part runs
the quantized parameter leg (``Config.sharded_param_codec``) under each
codec spec, then a suspend/resume round trip of every slot:

    python -m tests.torch_sharded_worker --spawn cpu OUT_DIR --part param_codec node_of_2
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.core import api
from byteps_tpu_torch.parallel import zero

# name -> (num_hosts, local_size)
LAYOUTS = {"node_of_2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
PARTITION_BYTES = 4096
STEPS = 5
# the slot tensors: a multi-chunk ragged one (n % R != 0: 3 chunks of
# 1024, 1024 and 953 floats, the scatter accumulator) and a small
# single-chunk one (the parts fallback)
TENSORS = {"w": 3001, "b": 37}
OPTIMIZERS = {
    "sgd": (torch.optim.SGD, {"lr": 1e-2}),
    "momentum": (torch.optim.SGD, {"lr": 1e-2, "momentum": 0.9}),
    "adam": (torch.optim.Adam, {"lr": 1e-2}),
    "adamw": (torch.optim.AdamW, {"lr": 1e-2, "weight_decay": 0.1}),
}
# the elastic cases
ELASTIC = ("adam", 3001, 2, 3)       # optimizer, n, steps before, after
ROUNDTRIP = ("momentum", 3001, 2, 2)
# ZeRO: a two-layer MLP on a batch of ZERO_BATCH rows per rank
ZERO_IN, ZERO_HIDDEN, ZERO_OUT, ZERO_BATCH = 12, 16, 4, 4
ZERO_STEPS = 3
ZERO_ADAMW = {"lr": 1e-2, "weight_decay": 0.1}
CLIP_SGD_LR, CLIP_MAX_NORM = 5e-2, 0.05
# the quantized parameter leg: every codec spec the JAX package accepts,
# on a multi-chunk tensor (the scatter accumulator), SGD with momentum
PARAM_SPECS = ("onebit", "topk:0.25", "randomk:0.25", "dithering:16",
               "powersgd:2")
PC_N, PC_STEPS, PC_BEFORE = 3001, 4, 2
PC_OPT = (torch.optim.SGD, {"lr": 0.1, "momentum": 0.9})


def rows(seed, world, n):
    """Multiples of 1/64 under 64 in magnitude: every f32 sum of up to 4
    of them is exact in any order."""
    x = np.random.RandomState(seed).randn(world, n) * 8
    return (np.round(x * 64) / 64).astype(np.float32)


def init_param(seed, n):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def exact_averages(opt, tensor, R, n, steps, first=0):
    """The averages the engine computes, exactly: the rows' sum * (1/R)."""
    return [rows(grad_seed(opt, tensor, s), R, n).sum(0)
            * np.float32(1 / R) for s in range(first, first + steps)]


def replay(opt, p0, grads):
    """The optimizer of OPTIMIZERS[opt] on the whole tensor."""
    cls, hyper = OPTIMIZERS[opt]
    p = torch.from_numpy(p0.copy())
    o = cls([p], **hyper)
    for g in grads:
        p.grad = torch.from_numpy(np.asarray(g, np.float32))
        o.step()
    return p.numpy()


def replicated_mlp(R, steps, opt_factory, clip=None):
    """Replicated data parallelism on the MLP in one process: the average
    of the R ranks' gradients (clipped by the global norm ``clip``, the
    reference's formula), then ``opt_factory``'s step.  Returns (mean
    losses per step, parameters by name)."""
    model = TinyMLP(mlp_params())
    opt = opt_factory(list(model.parameters()))
    losses = []
    for s in range(steps):
        x, y = mlp_batch(s, R)
        grads, ls = [], []
        for r in range(R):
            model.zero_grad()
            sl = slice(r * ZERO_BATCH, (r + 1) * ZERO_BATCH)
            loss = mse(model, (torch.from_numpy(x[sl]),
                               torch.from_numpy(y[sl])))
            loss.backward()
            grads.append([p.grad.clone() for p in model.parameters()])
            ls.append(loss.item())
        avg = [sum(g[i] for g in grads) / R for i in range(len(grads[0]))]
        if clip is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in avg))
            avg = [g * min(1.0, clip / max(float(norm), 1e-16))
                   for g in avg]
        for p, g in zip(model.parameters(), avg):
            p.grad = g
        opt.step()
        losses.append(np.mean(ls))
    return losses, {k: p.detach().numpy()
                    for k, p in model.named_parameters()}


def pc_grads(spec, step, world, n=PC_N):
    """Rank rows of the parameter-leg cases' gradients (any f32: at two
    ranks every sum is one add)."""
    seed = 5000 + 10 * PARAM_SPECS.index(spec) + step
    return np.random.RandomState(seed).randn(world, n).astype(np.float32)


def grad_seed(opt, tensor, step):
    return 1000 + 100 * list(OPTIMIZERS).index(opt) + 10 * step + (
        list(TENSORS).index(tensor) if tensor in TENSORS else 7)


class TinyMLP(torch.nn.Module):
    """``relu(x @ w1 + b1) @ w2 + b2``, the parameters registered in
    sorted name order (b1, b2, w1, w2): the order in which JAX's
    ``ravel_pytree`` flattens the same dict, so both flat vectors agree."""

    def __init__(self, params):
        super().__init__()
        for k in sorted(params):
            self.register_parameter(
                k, torch.nn.Parameter(torch.as_tensor(params[k]).clone()))

    def forward(self, x):
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


def mlp_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(ZERO_IN, ZERO_HIDDEN) * 0.3).astype(np.float32),
            "b1": (rng.randn(ZERO_HIDDEN) * 0.1).astype(np.float32),
            "w2": (rng.randn(ZERO_HIDDEN, ZERO_OUT) * 0.3).astype(np.float32),
            "b2": (rng.randn(ZERO_OUT) * 0.1).astype(np.float32)}


def mlp_batch(step, world):
    """The global batch of one step: ``world * ZERO_BATCH`` rows, rank r's
    are rows ``[r * ZERO_BATCH, (r + 1) * ZERO_BATCH)``."""
    rng = np.random.RandomState(500 + step)
    x = rng.randn(world * ZERO_BATCH, ZERO_IN).astype(np.float32)
    y = rng.randn(world * ZERO_BATCH, ZERO_OUT).astype(np.float32)
    return x, y


def mse(model, batch):
    x, y = batch
    return torch.mean((model(x) - y) ** 2)


def _np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()       # the bits
    return t.float().numpy()


def slot_cases(res, prefix, opts, tensors, R, rank, dev):
    """Each optimizer on each tensor, sharded (declare_update +
    push_pull_update) and unsharded (push_pull + the optimizer on the
    whole tensor), STEPS steps of the rows' gradients.  Records both
    final parameters, each slot's master and state lengths, the inner
    wire bytes of each leg for one push."""
    eng = api.engine()
    for opt in opts:
        cls, hyper = OPTIMIZERS[opt]
        for t, n in tensors.items():
            name = f"{prefix}/{opt}/{t}"
            p0 = torch.from_numpy(init_param(7, n)).to(dev)
            api.declare_update(name, (n,), torch.float32,
                               optimizer=(cls, hyper), init_value=p0)
            ref = p0.clone()
            ref_opt = cls([ref], **hyper)
            out = None
            for s in range(STEPS):
                g = torch.from_numpy(
                    rows(grad_seed(opt, t, s), R, n)[rank]).to(dev)
                before = dict(eng.stats)
                out = api.push_pull_update(g, name)
                wire = [eng.stats[k] - before[k]
                        for k in ("wire_push", "wire_pull")]
                ref.grad = api.push_pull(g, name + ".unsharded")
                ref_opt.step()
            slot = eng.update_slots[name]
            res[f"{name}/sharded"] = _np(out)
            res[f"{name}/unsharded"] = _np(ref)
            res[f"{name}/wire"] = np.array(wire)
            st = slot.optimizer.state[slot.master]
            res[f"{name}/lengths"] = np.array(
                [slot.master.numel()] + [v.numel() for v in st.values()
                                         if torch.is_tensor(v)
                                         and v.dim() == 1])
            res[f"{name}/buffered"] = np.array(
                eng.registry.get(name).scatter_layout != "ineligible")


def bf16_case(res, R, rank, dev):
    """A bf16 parameter: the slot's f32 master against the caller's
    reference (in the test)."""
    n = TENSORS["w"]
    cls, hyper = OPTIMIZERS["adamw"]
    p0 = torch.from_numpy(init_param(7, n)).to(dev).bfloat16()
    api.declare_update("bf16/w", (n,), torch.bfloat16,
                       optimizer=(cls, hyper), init_value=p0)
    for s in range(STEPS):
        g = torch.from_numpy(rows(grad_seed("adamw", "w", s), R, n)[rank])
        out = api.push_pull_update(g.to(dev).bfloat16(), "bf16/w")
        res[f"bf16/w/{s}"] = _np(out)


def adapter_case(res, R, rank, dev):
    """DistributedOptimizer with and without sharded_update, on two copies
    of the MLP, this rank's batch, AdamW under a StepLR schedule and
    backward_passes_per_step 1; then SGD with momentum under 2."""
    import byteps_tpu_torch as bps
    for tag, (cls, hyper), bpps in (("adamw", OPTIMIZERS["adamw"], 1),
                                    ("momentum", OPTIMIZERS["momentum"], 2)):
        arms = {}
        for sharded in (True, False):
            model = TinyMLP(mlp_params()).to(dev)
            inner = cls(model.parameters(), **hyper)
            opt = bps.DistributedOptimizer(
                inner, named_parameters=[
                    (f"ad/{tag}/{sharded}/{k}", p)
                    for k, p in model.named_parameters()],
                backward_passes_per_step=bpps, sharded_update=sharded)
            sched = torch.optim.lr_scheduler.StepLR(inner, 1, gamma=0.5)
            for s in range(3):
                opt.zero_grad()
                for micro in range(bpps):
                    x, y = mlp_batch(10 * s + micro, R)
                    lo = rank * ZERO_BATCH
                    batch = (torch.from_numpy(x[lo:lo + ZERO_BATCH]).to(dev),
                             torch.from_numpy(y[lo:lo + ZERO_BATCH]).to(dev))
                    mse(model, batch).backward()
                opt.step()
                sched.step()
            arms[sharded] = model
            res[f"adapter/{tag}/inner_state/{sharded}"] = np.array(
                len(inner.state))
        for k, p in arms[True].named_parameters():
            res[f"adapter/{tag}/{k}/sharded"] = _np(p)
            res[f"adapter/{tag}/{k}/unsharded"] = _np(
                dict(arms[False].named_parameters())[k])


def zero_cases(res, prefix, R, rank, dev, layouts=("all",), clip=False):
    """ZeRO-1 and FSDP (AdamW) on the MLP, and the replicated step
    (DistributedOptimizer + AdamW), ZERO_STEPS steps each: losses and
    final parameters.  ``clip``: ZeRO-1 with SGD and
    clip_by_global_norm under ``"ici"`` (and the control that sums the
    norm over the world) at HSDP."""
    comm = api.engine().comm

    def batch(s):
        x, y = mlp_batch(s, R)
        lo = rank * ZERO_BATCH
        return (torch.from_numpy(x[lo:lo + ZERO_BATCH]).to(dev),
                torch.from_numpy(y[lo:lo + ZERO_BATCH]).to(dev))

    def adamw(ps):
        return torch.optim.AdamW(ps, **ZERO_ADAMW)

    def run(kind, axes, opt_factory=adamw, grad_transform=None):
        model = TinyMLP(mlp_params()).to(dev)
        zs = zero.init_zero_state(comm, model, opt_factory, axes)
        if kind == "zero1":
            step = zero.make_zero_train_step(comm, model, mse, axes,
                                             grad_transform)
        else:
            step = zero.make_fsdp_train_step(comm, model, mse,
                                             shard_axes=axes,
                                             grad_transform=grad_transform)
        losses = [step(zs, batch(s)).item() for s in range(ZERO_STEPS)]
        template = model if kind == "zero1" else step.views
        return losses, zero.zero_params(comm, zs, template,
                                        shard_axes=axes), zs

    for axes in layouts:
        for kind in ("zero1", "fsdp"):
            losses, params, zs = run(kind, axes)
            res[f"{prefix}/{axes}/{kind}/losses"] = np.array(losses)
            res[f"{prefix}/{axes}/{kind}/shard_lengths"] = np.array(
                [zs.master.numel()] + [
                    v.numel() for v in zs.optimizer.state[zs.master].values()
                    if torch.is_tensor(v) and v.dim() == 1])
            for k, v in params.items():
                res[f"{prefix}/{axes}/{kind}/{k}"] = _np(v)
    if not clip:
        return
    import functools
    sgd = functools.partial(torch.optim.SGD, lr=CLIP_SGD_LR)
    for tag, clip_axes in (("ici", "ici"), ("control", "all")):
        clip_fn = zero.clip_by_global_norm(CLIP_MAX_NORM, comm, clip_axes)
        losses, params, _ = run("zero1", "ici", sgd, clip_fn)
        res[f"{prefix}/clip/{tag}/losses"] = np.array(losses)
        for k, v in params.items():
            res[f"{prefix}/clip/{tag}/{k}"] = _np(v)
    clip_fn = zero.clip_by_global_norm(CLIP_MAX_NORM, comm, "all")
    losses, params, _ = run("zero1", "all", sgd, clip_fn)
    res[f"{prefix}/clip/all/losses"] = np.array(losses)
    for k, v in params.items():
        res[f"{prefix}/clip/all/{k}"] = _np(v)


def replicated_case(res, R, rank, dev):
    """The port's replicated step on the MLP: DistributedOptimizer +
    AdamW (unsharded), ZERO_STEPS steps."""
    import byteps_tpu_torch as bps
    model = TinyMLP(mlp_params()).to(dev)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **ZERO_ADAMW),
        named_parameters=[(f"rep/{k}", p)
                          for k, p in model.named_parameters()],
        sharded_update=False)
    for s in range(ZERO_STEPS):
        x, y = mlp_batch(s, R)
        lo = rank * ZERO_BATCH
        opt.zero_grad()
        mse(model, (torch.from_numpy(x[lo:lo + ZERO_BATCH]).to(dev),
                    torch.from_numpy(y[lo:lo + ZERO_BATCH]).to(dev))
            ).backward()
        opt.step()
    for k, p in model.named_parameters():
        res[f"replicated/{k}"] = _np(p)


def elastic_case(res, R, rank, dev, port2, spec, shrink_to=None):
    """``spec`` (optimizer, n, steps before, steps after) on one slot:
    steps at this world, suspend (every rank), then resume on a fresh
    rendezvous, in one node of ``shrink_to`` ranks (the first ones; the
    others leave) or, with None, in the same layout, and declare the slot
    again from the stash.  Returns False on a rank that left."""
    opt, n, before, after = spec
    cls, hyper = OPTIMIZERS[opt]
    name = f"elastic/{opt}"
    p0 = torch.from_numpy(init_param(7, n)).to(dev)
    api.declare_update(name, (n,), torch.float32, optimizer=(cls, hyper),
                       init_value=p0)
    for s in range(before):
        g = rows(grad_seed(opt, "e", s), R, n)[rank]
        api.push_pull_update(torch.from_numpy(g).to(dev), name)
    cfg = api.engine().cfg
    api.suspend()
    res["elastic/stash"] = np.array(name in api._suspended_update_state)
    if shrink_to is not None and rank >= shrink_to:
        api._suspended_update_state.clear()
        return False
    cfg = dataclasses.replace(cfg, coordinator_address=f"127.0.0.1:{port2}")
    if shrink_to is not None:
        cfg = dataclasses.replace(cfg, num_hosts=1, host_id=0,
                                  local_size=shrink_to, local_rank=rank)
    api.resume(config=cfg)
    R2 = api.size()
    # no init_value: the master comes from the stash alone
    api.declare_update(name, (n,), torch.float32, optimizer=(cls, hyper))
    res["elastic/stash_consumed"] = np.array(
        name not in api._suspended_update_state)
    out = None
    for s in range(before, before + after):
        g = rows(grad_seed(opt, "e", s), R2, n)[rank]
        out = api.push_pull_update(torch.from_numpy(g).to(dev), name)
    res["elastic/params"] = _np(out)
    res["elastic/world_after"] = np.array(R2)
    return True


def _pc_declare(spec, name, init):
    api.engine().cfg.sharded_param_codec = spec
    api.declare_update(name, (PC_N,), torch.float32, optimizer=PC_OPT,
                       init_value=init)


def param_codec_case(res, R, rank, dev, port2):
    """Each spec of PARAM_SPECS for PC_STEPS steps: the emitted
    parameters of every step, the slot's master block and its offset,
    the wire of each leg and the param-leg counter, the exported residual;
    then every spec again from the start with a suspend after PC_BEFORE
    steps and a resume on a fresh rendezvous, the slots declared again
    from the stash."""
    from byteps_tpu_torch.common.telemetry import counters
    eng = api.engine()
    p0 = torch.from_numpy(init_param(11, PC_N)).to(dev)
    for spec in PARAM_SPECS:
        name = f"pc/{spec}"
        _pc_declare(spec, name, p0)
        slot = eng.update_slots[name]
        base = counters.get("compression.param_wire_bytes")
        before = dict(eng.stats)
        for s in range(PC_STEPS):
            g = torch.from_numpy(pc_grads(spec, s, R)[rank]).to(dev)
            res[f"{name}/out/{s}"] = _np(api.push_pull_update(g, name))
        res[f"{name}/wire"] = np.array(
            [eng.stats[k] - before[k] for k in ("wire_push", "wire_pull")])
        res[f"{name}/param_wire"] = np.array(
            counters.get("compression.param_wire_bytes") - base)
        res[f"{name}/payload"] = np.array(slot.payload_nbytes)
        res[f"{name}/master"] = _np(slot.master)
        res[f"{name}/lo"] = np.array(slot.block * slot.C)
        res[f"{name}/kwargs"] = np.array(sorted(slot.codec_kwargs.items()))
    snap = eng.export_update_slots()
    for spec in PARAM_SPECS:
        res[f"pc/{spec}/export_error"] = snap[f"pc/{spec}"]["cstate"][
            "error"].numpy()
    # the round trip, on slots of their own
    for spec in PARAM_SPECS:
        _pc_declare(spec, f"pcrt/{spec}", p0)
        for s in range(PC_BEFORE):
            g = torch.from_numpy(pc_grads(spec, s, R)[rank]).to(dev)
            api.push_pull_update(g, f"pcrt/{spec}")
    cfg = api.engine().cfg
    api.suspend()
    api.resume(config=dataclasses.replace(
        cfg, coordinator_address=f"127.0.0.1:{port2}"))
    for spec in PARAM_SPECS:
        _pc_declare(spec, f"pcrt/{spec}", None)
        for s in range(PC_BEFORE, PC_STEPS):
            g = torch.from_numpy(pc_grads(spec, s, R)[rank]).to(dev)
            out = api.push_pull_update(g, f"pcrt/{spec}")
        res[f"pcrt/{spec}/params"] = _np(out)


def record_threads():
    """Wrap the collectives the port issues, and the slot's step, to
    record the threads that call them: {what: set of thread names}."""
    import threading

    import torch.distributed as dist

    from byteps_tpu_torch.core.sharded_update import ShardedUpdateSlot

    seen = {"collectives": set(), "slot_step": set()}

    def wrap(owner, attr, key):
        fn = getattr(owner, attr)

        def recorded(*a, **kw):
            seen[key].add(threading.current_thread().name)
            return fn(*a, **kw)
        setattr(owner, attr, recorded)

    for attr in ("all_reduce", "reduce_scatter_tensor",
                 "all_gather_into_tensor", "broadcast"):
        wrap(dist, attr, "collectives")
    wrap(ShardedUpdateSlot, "_step", "slot_step")
    return seen


def main(out_path, device, layout, port2, part):
    """``part``: "sharded" (the slots, the adapter, the elastic cases),
    "zero" (ZeRO-1, FSDP, the clip and the replicated step) or
    "param_codec" (the quantized parameter leg)."""
    threads = record_threads()
    cfg = Config.from_env()
    cfg.sharded_update = True
    cfg.partition_bytes = PARTITION_BYTES
    api.init(cfg, device=device)
    comm = api.engine().comm
    dev, R, rank = comm.device, comm.size, comm.rank
    res = {}
    stayed = True
    if part == "param_codec":
        cfg_pc = api.engine().cfg
        cfg_pc.min_compress_bytes = 0
        cfg_pc.compress_error_ceiling = 1.0     # PowerSGD's gate passes
        param_codec_case(res, R, rank, dev, port2)
    elif part == "sharded":
        slot_cases(res, "slot", list(OPTIMIZERS), TENSORS, R, rank, dev)
        bf16_case(res, R, rank, dev)
        adapter_case(res, R, rank, dev)
        if layout == "1x4":
            stayed = elastic_case(res, R, rank, dev, port2, ELASTIC, 2)
        else:
            stayed = elastic_case(res, R, rank, dev, port2, ROUNDTRIP)
    else:
        hsdp = comm.num_nodes > 1
        zero_cases(res, "zero", R, rank, dev,
                   layouts=("all", "ici") if hsdp else ("all",), clip=hsdp)
        replicated_case(res, R, rank, dev)
    if stayed:
        api.shutdown()
    for k, names in threads.items():
        res[f"threads/{k}"] = np.array(sorted(names))
    np.savez(out_path, **res)


def spawn(layout, device, out_dir, part="sharded", timeout=180):
    """Run every rank of ``layout`` on ``part`` of the cases; returns the
    result paths by rank."""
    hosts, local = LAYOUTS[layout]
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    here = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    for rank in range(hosts * local):
        out = os.path.join(out_dir, f"{device}_{part}_{layout}_{rank}.npz")
        env = dict(os.environ,
                   DMLC_NUM_WORKER=str(hosts),
                   DMLC_WORKER_ID=str(rank // local),
                   BYTEPS_LOCAL_SIZE=str(local),
                   BYTEPS_LOCAL_RANK=str(rank % local),
                   DMLC_PS_ROOT_URI="127.0.0.1",
                   DMLC_PS_ROOT_PORT=str(ports[0]),
                   OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(here))
        if device == "cuda" and hosts > 1:
            env["CUDA_VISIBLE_DEVICES"] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out, device, layout,
             str(ports[1]), part],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        outs.append(out)
    failed = []
    for rank, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{layout} rank {rank} rc={p.returncode}:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


if __name__ == "__main__":
    if sys.argv[1] == "--spawn":
        device, out_dir = sys.argv[2], sys.argv[3]
        os.makedirs(out_dir, exist_ok=True)
        layouts, parts = sys.argv[4:], ("sharded", "zero")
        if layouts[:1] == ["--part"]:
            parts, layouts = (layouts[1],), layouts[2:]
        for layout in layouts:
            for part in parts:
                spawn(layout, device, out_dir, part)
            print(f"{device} {layout}: ok", flush=True)
    else:
        main(*sys.argv[1:])
