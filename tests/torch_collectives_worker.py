"""One rank of the port's multi-process collective tests.

One process per rank, each with its DMLC_*/BYTEPS_* environment.
Rank r contributes row r of arrays drawn from fixed numpy seeds, so the
caller can rebuild every input.  Imports neither jax nor byteps_tpu.

    # every rank of one or more layouts (tests/test_torch_collectives.py)
    python -m tests.torch_collectives_worker --spawn cpu OUT_DIR 2x2 1x4
    # the same over NCCL, one card per rank, on a 4-card host
    python -m tests.torch_collectives_worker --spawn cuda OUT_DIR 2x2 1x4
    # NCCL against gloo, to the tolerances stated at compare()
    python -m tests.torch_collectives_worker --compare DIR_A DIR_B

When the "nodes" of a layout share one host, each rank is pinned to the
card of its global rank with CUDA_VISIBLE_DEVICES.
"""

import glob
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from byteps_tpu_torch.comm import collectives, compressed
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.compression import registry
from byteps_tpu_torch.core import api
from tests import torch_sharded_worker as SW

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}
# name -> (num_hosts, local_size)
LAYOUTS = {"node_of_2": (1, 2), "2_nodes": (2, 1), "2x2": (2, 2),
           "1x4": (1, 4)}
N_ELEMS = 1001                      # odd: n % local_size != 0
CODEC_NUMEL = 5000
CODECS = {
    "onebit": {"compressor": "onebit"},
    "onebit_ef": {"compressor": "onebit", "ef": "vanilla"},
    "topk": {"compressor": "topk", "k": "0.01", "ef": "vanilla"},
    "randomk": {"compressor": "randomk", "k": "0.01", "ef": "vanilla"},
    "dithering": {"compressor": "dithering", "k": "16",
                  "partition": "linear", "normalize": "max"},
    # uint16 idx (held as int16): NCCL has no 16-bit integer type
    "dithering_sparse": {"compressor": "dithering", "k": "16",
                         "partition": "natural", "normalize": "l2",
                         "sparse_ratio": "0.05", "ef": "vanilla"},
    "powersgd": {"compressor": "powersgd", "rank": "4", "ef": "vanilla"},
    "nesterov": {"compressor": "onebit", "ef": "vanilla",
                 "momentum": "nesterov"},
}
CODEC_STEPS = 2
# the sharded weight update: a ragged multi-chunk tensor (the scatter
# accumulator), an even one, and a small one (the parts fallback)
SHARDED_TENSORS = {"w": 3001, "v": 4096, "b": 37}
SHARDED_OPTIMIZERS = ("momentum", "adam")


def rows(seed, world, n):
    """Multiples of 1/64 under 64 in magnitude: every f32 sum of up to 4
    of them, even of their f16/bf16 roundings, is exact in any order."""
    x = np.random.RandomState(seed).randn(world, n) * 8
    return (np.round(x * 64) / 64).astype(np.float32)


def main(out_path, device="cpu"):
    cfg = Config.from_env()
    # small partitions: the engine tensors below span several chunks
    cfg.partition_bytes = 4096
    cfg.sharded_update = True         # only declare_update tensors use it
    api.init(cfg, device=device)
    comm = api.engine().comm
    dev = comm.device
    R, rank = comm.size, comm.rank

    def mine(seed, n):
        return torch.from_numpy(rows(seed, R, n)[rank]).to(dev)

    res = {}
    for i, (dname, dt) in enumerate(DTYPES.items()):
        x = mine(100 + i, N_ELEMS).to(dt)
        for op in ("sum", "average"):
            for kind, fn in (("flat", collectives.all_reduce),
                             ("hier", collectives.hierarchical_all_reduce)):
                out = fn(comm, x, op)
                if out.dtype != dt or out.shape != x.shape:
                    raise RuntimeError(f"{kind}/{dname}/{op}: got "
                                       f"{out.dtype} {tuple(out.shape)}")
                res[f"{kind}/{dname}/{op}"] = out.float().cpu().numpy()
    res["broadcast"] = collectives.broadcast(comm, mine(200, 64),
                                             root=R - 1).cpu().numpy()

    # compressed push_pull: record what crosses the wire
    gathered = []
    real_gather = compressed._all_gather

    def recording_gather(c, t):
        g = real_gather(c, t)
        gathered.append(g.clone())
        return g

    compressed._all_gather = recording_gather
    for name, kw in CODECS.items():
        wc = registry.create(kw, CODEC_NUMEL)
        sc = registry.create(kw, CODEC_NUMEL, for_server=True)
        ws, ss = wc.init_state(dev), sc.init_state(dev)
        for step in range(CODEC_STEPS):
            x = mine(300 + step, CODEC_NUMEL)
            gathered.clear()
            out, ws, ss = compressed.fused_compressed_push_pull(
                comm, x, wc, sc, ws, ss)
            res[f"codec/{name}/{step}/out"] = out.cpu().numpy()
            # the gathered payload leaves, in the payload's key order
            for i, g in enumerate(gathered):
                res[f"codec/{name}/{step}/g{i}"] = g.cpu().numpy()
    compressed._all_gather = real_gather

    # the engine end to end: several multi-chunk tensors in flight at once
    kw = CODECS["onebit_ef"]
    for step in range(2):
        a = mine(400 + step, 3000).reshape(30, 100)
        b = mine(500 + step, 2500)
        c = torch.arange(12, dtype=torch.int32, device=dev) * (rank + 1)
        handles = [api.push_pull_async(a, "a", compression=kw),
                   api.push_pull_async(b, "b"),
                   api.push_pull_async(c, "c", op="sum")]
        for key, h in zip("abc", handles):
            res[f"engine/{key}/{step}"] = h.wait().cpu().numpy()
    res["engine/chunks"] = np.array(
        [len(api.engine().registry.get(k).chunk_bounds) for k in "abc"])
    # the default config groups up to 4 chunks and tunes chunk sizes at one
    # rank; at more than one every collective carries one chunk, untuned
    eng = api.engine()
    res["engine/stats"] = np.array([eng.stats["dispatches"],
                                    eng.stats["chunks"]])
    res["engine/planner_active"] = np.array(eng.planner.active)

    # the sharded weight update and ZeRO (ZeRO-1 and FSDP, "all" and, at
    # more than one node, "ici"), as tests/torch_sharded_worker.py runs
    # them
    SW.slot_cases(res, "sharded", SHARDED_OPTIMIZERS, SHARDED_TENSORS, R,
                  rank, dev)
    SW.zero_cases(res, "zero", R, rank, dev,
                  layouts=("all", "ici") if comm.num_nodes > 1 else ("all",))
    api.shutdown()
    np.savez(out_path, **res)


def spawn(layout, device, out_dir, timeout=180):
    """Run every rank of ``layout``; returns the result paths by rank."""
    hosts, local = LAYOUTS[layout]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    for rank in range(hosts * local):
        out = os.path.join(out_dir, f"{device}_{layout}_{rank}.npz")
        env = dict(os.environ,
                   DMLC_NUM_WORKER=str(hosts), DMLC_WORKER_ID=str(rank // local),
                   BYTEPS_LOCAL_SIZE=str(local),
                   BYTEPS_LOCAL_RANK=str(rank % local),
                   DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port),
                   BYTEPS_MIN_COMPRESS_BYTES="0", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.dirname(here))
        if device == "cuda" and hosts > 1:
            env["CUDA_VISIBLE_DEVICES"] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out, device],
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


# NCCL against gloo (the card against the CPU), where a sum is taken in
# another order: PowerSGD's leaves and result (products and a QR) to
# PSGD_TOL of their max-abs; the l2 dithering arm's integer leaves may
# differ in L2_SHARE of their elements (a code on a rounding threshold),
# its float leaves in L2_SHARE of them beyond 1e-5 of the max-abs; the
# other codec values and compressed results to rtol 1e-5; the optimizers'
# results (the sharded update's and ZeRO's) to rtol 1e-5 and atol 1e-7
# (the card's elementwise kernels contract multiply-adds, the matmuls of
# the MLP sum in another order); the rest exact
PSGD_TOL = 1e-5
L2_SHARE = 1e-3


def _disagreement(k, a, b):
    """None when ``a`` agrees with ``b`` under the tolerance for key
    ``k``, else what was measured."""
    if k.startswith("codec/powersgd/"):
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        return None if err <= PSGD_TOL else f"{err:.3g} of the max-abs"
    if k.startswith("codec/dithering_sparse/"):
        if a.dtype.kind in "iu":
            share = float((a != b).mean())
        else:
            share = float((np.abs(a - b) > 1e-5 * np.abs(b).max()).mean())
        return None if share <= L2_SHARE else f"{share:.3g} of the elements"
    rtol = 1e-5 if k.endswith("/out") or k.startswith(
        ("codec/", "engine/a/", "sharded/", "zero/")) else 0
    atol = 1e-7 if k.startswith(("sharded/", "zero/")) else 0
    if np.allclose(a, b, rtol=rtol, atol=atol):
        return None
    return f"max rel diff {np.abs(a - b).max() / np.abs(b).max():.3g}"


def compare(dir_a, dir_b):
    """Every result file of ``dir_a`` against its namesake in ``dir_b``
    (device prefix aside): (arrays that agree, [(file, key, what was
    measured) for each that does not])."""
    n, bad = 0, []
    for path_a in sorted(glob.glob(os.path.join(dir_a, "*.npz"))):
        name = os.path.basename(path_a).split("_", 1)[1]
        (path_b,) = glob.glob(os.path.join(dir_b, f"*_{name}"))
        a, b = np.load(path_a), np.load(path_b)
        if sorted(a.files) != sorted(b.files):
            raise AssertionError(f"{name}: different result keys")
        for k in a.files:
            what = _disagreement(k, a[k], b[k])
            if what is None:
                n += 1
            else:
                bad.append((name, k, what))
    return n, bad


if __name__ == "__main__":
    if sys.argv[1] == "--spawn":
        device, out_dir = sys.argv[2], sys.argv[3]
        os.makedirs(out_dir, exist_ok=True)
        for layout in sys.argv[4:]:
            spawn(layout, device, out_dir)
            print(f"{device} {layout}: ok", flush=True)
    elif sys.argv[1] == "--compare":
        n, bad = compare(sys.argv[2], sys.argv[3])
        for name, k, what in bad:
            print(f"DISAGREE {name} {k}: {what}")
        print(f"{n} arrays agree, {len(bad)} do not")
        sys.exit(1 if bad else 0)
    else:
        main(*sys.argv[1:])
