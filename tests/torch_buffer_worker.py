"""One rank of the buffer-mode tests (tests/test_torch_buffer_mode.py).

Pushes one tensor at a time through the engine and records, for each,
the collectives the process issued while it was in flight (name, length,
and the group: the world, the node or across nodes), the engine's units
(kind and whether the tensor rode the scatter accumulator) and the
result.  Then, at the ``sgd`` part, trains one small model through
``DistributedOptimizer`` twice in one engine, through the sharded update
and through the replicated one, and saves both arms' parameters.  Rank r
contributes row r of seeded numpy arrays.  Imports neither jax nor
byteps_tpu.

    python -m tests.torch_buffer_worker OUT.npz PART [PART ...]

with DMLC_*/BYTEPS_LOCAL_* set (:func:`spawn` sets them), or every rank
of one layout from one command:

    python -m tests.torch_buffer_worker --spawn cpu OUT_DIR 2x2 push
"""

import os
import subprocess
import sys
import uuid

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.core import api

from .torch_order_worker import _held, _rendezvous

LAYOUTS = {"node_of_2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
ONEBIT = {"compressor": "onebit", "ef": "vanilla"}

# name -> (elements, dtype, op, compression, config fields, takes the
# accumulator).  Partitions of 4096 bytes: 3001 f32 elements are three
# chunks, 3001 bf16 two; 1000 f32 elements are one chunk under
# buffer_min_bytes; 8192 f32 elements (32 KiB) one chunk at or past a
# buffer_min_bytes of 16 KiB; 301-element chunks (1204-byte partitions,
# under the partitioner's 512-element alignment) start at odd offsets,
# which no [L, C] view of L > 1 expresses.
BASE = {"partition_bytes": 4096}
CASES = {
    "multi_f32": (3001, "float32", "average", None, BASE, True),
    "multi_bf16": (3001, "bfloat16", "average", None, BASE, True),
    "multi_int": (3001, "int32", "average", None, BASE, True),
    "multi_sum": (3001, "float32", "sum", None, BASE, True),
    "single_big": (8192, "float32", "average", None,
                   {"partition_bytes": 65536, "buffer_min_bytes": 16384},
                   True),
    # the controls: each takes the parts path
    "small_single": (1000, "float32", "average", None, BASE, False),
    "compressed": (3001, "float32", "average", ONEBIT, BASE, False),
    "sampled": (3001, "float32", "average", None,
                {**BASE, "debug_sample_tensor": "sampled"}, False),
    "odd_bounds": (1001, "float32", "average", None,
                   {"partition_bytes": 1204}, False),
}
SGD_STEPS = 3
COLLECTIVES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
               "all_gather", "broadcast")


def rows(seed, world, n, dtype="float32"):
    """Multiples of 1/64 (integers for int32): every sum of up to 4 of
    them, even of their bf16 roundings, is exact in any order."""
    x = np.random.RandomState(seed).randn(world, n) * 8
    if dtype == "int32":
        return np.round(x * 64).astype(np.int32)
    return (np.round(x * 64) / 64).astype(np.float32)


def _recorder(log):
    """Wrap the torch.distributed collectives: each call appends
    ``(name, elements, group)``, group "world", "node" or "nodes"."""
    comm = api.engine().comm
    real = {}

    def wrap(name):
        fn = real[name] = getattr(dist, name)

        def rec(*a, **kw):
            t = a[0]
            numel = (sum(x.numel() for x in t) if isinstance(t, list)
                     else t.numel())
            g = kw.get("group")
            where = ("world" if g is None else "node"
                     if g is comm.intra_group else "nodes"
                     if g is comm.inter_group else "other")
            log.append((name, numel, where))
            return fn(*a, **kw)
        setattr(dist, name, rec)

    for name in COLLECTIVES:
        wrap(name)
    return lambda: [setattr(dist, n, f) for n, f in real.items()]


def _init(tag, fields):
    """An engine on a rendezvous of its own (``torch_order_worker``'s:
    rank 0 binds a store on a port the system picks and hands it over in
    a file), with ``fields`` set on the environment's Config."""
    _rendezvous(tag)
    cfg = Config.from_env()
    for k, v in fields.items():
        setattr(cfg, k, v)
    api.init(cfg, device=os.environ.get("BUFFER_DEVICE", "cpu"))
    return api.engine()


def part_push(res):
    groups = {}
    for name, case in CASES.items():
        groups.setdefault(repr(sorted(case[4].items())), []).append(name)
    for i, names in enumerate(groups.values()):
        eng = _init(f"push{i}", CASES[names[0]][4])
        R, rank = api.size(), api.rank()
        units = []
        real_unit = eng._dispatch_unit

        def recording(kind, unit, _real=real_unit):
            units.append((kind, unit[0].pending.scatter is not None))
            _real(kind, unit)

        eng._dispatch_unit = recording
        for name in names:
            n, dt, op, comp, _, _ = CASES[name]
            x = torch.from_numpy(rows(len(name), R, n, dt)[rank])
            x = x.to(getattr(torch, dt)).to(api.device())
            log, units[:] = [], []
            undo = _recorder(log)
            try:
                out = api.push_pull(x, name, op=op, compression=comp)
            finally:
                undo()
            res[f"{name}/out"] = out.float().cpu().numpy()
            res[f"{name}/dtype"] = np.array(str(out.dtype))
            res[f"{name}/chunks"] = np.array(
                len(eng.registry.get(name).chunk_bounds))
            res[f"{name}/units"] = np.array(
                [f"{k}:{int(b)}" for k, b in units])
            res[f"{name}/collectives"] = np.array(
                [f"{c}:{k}:{g}" for c, k, g in log])
        api.shutdown()
        _held.clear()


def _mlp(seed):
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.Tanh(),
                                torch.nn.Linear(128, 10))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return model


def part_sgd(res):
    """One model, one seeded batch a rank (not multiples of 1/64: sums
    round), trained SGD_STEPS steps with SGD momentum through the sharded
    update and through the replicated one, in one engine."""
    import byteps_tpu_torch as bps
    _init("sgd", {"partition_bytes": 4096, "sharded_update": True})
    dev = api.device()
    gen = torch.Generator().manual_seed(100 + api.rank())
    x = torch.randn(16, 64, generator=gen).to(dev)
    y = torch.randint(0, 10, (16,), generator=gen).to(dev)
    sgd = {"lr": 0.1, "momentum": 0.9, "foreach": True}
    for arm, sharded in (("sharded", True), ("replicated", False)):
        model = _mlp(7).to(dev)
        opt = bps.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), **sgd),
            named_parameters=[(f"{arm}.{n}", p)
                              for n, p in model.named_parameters()],
            sharded_update=sharded)
        for _ in range(SGD_STEPS):
            opt.zero_grad()
            torch.nn.functional.cross_entropy(model(x), y).backward()
            opt.step()
        for n, p in model.named_parameters():
            res[f"sgd/{arm}/{n}"] = p.detach().cpu().numpy()
    eng = api.engine()
    res["sgd/buffered"] = np.array(sorted(
        n for n in eng.registry.names_in_declaration_order()
        if eng.registry.get(n).scatter_layout not in (None, "ineligible")))
    api.shutdown()
    _held.clear()


PARTS = {"push": part_push, "sgd": part_sgd}


def main(out_path, parts):
    res = {}
    for p in parts:
        PARTS[p](res)
    np.savez(out_path, **res)


def spawn(layout, out_dir, parts, device="cpu", timeout=240):
    """Run every rank of ``layout``; returns the result paths by rank."""
    hosts, local = LAYOUTS[layout]
    token = uuid.uuid4().hex
    here = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    for rank in range(hosts * local):
        out = os.path.join(out_dir, f"buffer_{layout}_{rank}.npz")
        env = dict(os.environ,
                   DMLC_NUM_WORKER=str(hosts),
                   DMLC_WORKER_ID=str(rank // local),
                   BYTEPS_LOCAL_SIZE=str(local),
                   BYTEPS_LOCAL_RANK=str(rank % local),
                   DMLC_PS_ROOT_URI="127.0.0.1", ORDER_DIR=out_dir,
                   ORDER_WORLD=token, BYTEPS_MIN_COMPRESS_BYTES="0",
                   OMP_NUM_THREADS="1", BUFFER_DEVICE=device,
                   PYTHONPATH=os.path.dirname(here))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_buffer_worker", out, *parts],
            cwd=os.path.dirname(here), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        outs.append(out)
    failed = []
    for rank, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{layout} rank {rank} rc={p.returncode}:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


if __name__ == "__main__":
    if sys.argv[1] == "--spawn":
        device, out_dir, layout = sys.argv[2:5]
        print(spawn(layout, out_dir, sys.argv[5:], device))
    else:
        main(sys.argv[1], sys.argv[2:])
