"""One rank of the port's fused data-parallel tests
(``tests/test_torch_data_parallel.py``).

One process per rank, each with its DMLC_*/BYTEPS_* environment; the
inputs (the JAX models' parameters and the global batches) come from an
npz the test writes, and rank r takes its rows of each global batch
through ``shard_batch``.  Imports neither jax nor byteps_tpu.

    python -m tests.torch_dp_worker IN.npz OUT.npz CASES

``CASES`` is a comma-separated list of :data:`CASES`' keys.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.mesh import bootstrap, resolve_device
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.models import bert, mlp, resnet
from byteps_tpu_torch.ops import collective_ops as co
from byteps_tpu_torch.parallel import (make_dp_train_step, replicate,
                                       shard_batch)

# name -> (num_hosts, local_size)
LAYOUTS = {"node_of_2": (1, 2), "2x2": (2, 2)}
BERT_STEPS = 3
ACCUM_STEPS = 2                   # steps of the accumulation case
BN_STEPS = 2
DP_ONEBIT_STEPS = 2
HIER_N = 3001                     # odd: padded to a multiple of local_size
# the default gate (2 MiB a shard): at 2 ranks a node a tensor of 2**20
# f32 elements gives a 2 MiB shard (compressed), one of 2**20 - 2 a shard
# 4 bytes short (all-reduced)
GATE_SIZES = (1 << 20, (1 << 20) - 2)


def rows(seed, world, n):
    """Multiples of 1/64 under 64 in magnitude: every f32 sum of up to 4
    of them is exact in any order."""
    x = np.random.RandomState(seed).randn(world, n) * 8
    return (np.round(x * 64) / 64).astype(np.float32)


def nest(flat, prefix, sep):
    """The ``prefix``-keyed leaves of ``flat`` as a nested dict."""
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        *path, leaf = k[len(prefix):].split(sep)
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def batch_of(flat, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in flat.items()
            if k.startswith(prefix)}


def case_bert(comm, inp, res):
    """bert_tiny (f32 compute) trained BERT_STEPS steps with AdamW."""
    cfg = dataclasses.replace(bert.bert_tiny(), dtype=torch.float32)
    model = bert.load_flax_bert(bert.BertForMLM(cfg),
                                nest(inp, "bert/", "."))
    replicate(comm, model)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)

    def loss_fn(m, b):
        logits = m(b["input_ids"].long(), b["attention_mask"],
                   masked_positions=b["masked_positions"])
        return bert.mlm_loss(logits, b["masked_labels"].long())

    step = make_dp_train_step(comm, model, loss_fn, opt)
    batch = shard_batch(comm, batch_of(inp, "bert_batch/"))
    names = {p: n for n, p in model.named_parameters()}

    def first_grads(o, args, kwargs):
        # what the optimizer receives at its first step: the average
        for p, n in names.items():
            res.setdefault(f"bert/grad0/{n}", p.grad.numpy().copy())

    hook = opt.register_step_pre_hook(first_grads)
    res["bert/loss"] = np.array([step(batch).item()
                                 for _ in range(BERT_STEPS)])
    hook.remove()
    for n, p in model.named_parameters():
        res[f"bert/param/{n}"] = p.detach().numpy()


def _mlp_step(comm, inp, accum):
    model = mlp.load_flax_mlp(mlp.MLP(4, features=(16, 10)),
                              nest(inp, "mlp/", "."))
    step = make_dp_train_step(
        comm, model, lambda m, b: mlp.softmax_cross_entropy(
            m(b["x"]), b["y"].long()),
        torch.optim.SGD(model.parameters(), lr=0.1), accum_steps=accum)
    return model, step


def case_accum(comm, inp, res):
    """The MLP with accum_steps=2 (SGD 0.1); then the step's ValueError
    for a per-rank batch that does not split."""
    model, step = _mlp_step(comm, inp, ACCUM_STEPS)
    batch = shard_batch(comm, batch_of(inp, "mlp_batch/"))
    res["accum/loss"] = np.array([step(batch).item()
                                  for _ in range(ACCUM_STEPS)])
    for n, p in model.named_parameters():
        res[f"accum/param/{n}"] = p.detach().numpy()
    try:
        step({k: v[:3] for k, v in batch.items()})
    except ValueError as e:
        res["accum/error"] = np.array(str(e))


def case_bn(comm, inp, res):
    """resnet_tiny with cross-replica BatchNorm over the world, trained
    through make_vision_trainer (SGD 0.1, momentum 0.9)."""
    model = resnet.load_flax_resnet(
        resnet.resnet_tiny(bn_group=dist.group.WORLD),
        nest(inp, "resnet/", "/"), nest(inp, "resnet_stats/", "/"))
    step = resnet.make_vision_trainer(
        comm, model, torch.optim.SGD(model.parameters(), lr=0.1,
                                     momentum=0.9))
    batch = shard_batch(comm, batch_of(inp, "resnet_batch/"))
    res["bn/loss"] = np.array([step(batch).item() for _ in range(BN_STEPS)])
    for n, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        res[f"bn/state/{n}"] = t.detach().numpy()


def case_hier(comm, inp, res):
    """hierarchical_push_pull raw (sum, average), with the onebit pair
    (average) and the PowerSGD pair (sum), forced past the gate; then
    the onebit pair at the default gate on both sides of 2 MiB."""
    R, rank = comm.size, comm.rank
    x = torch.from_numpy(rows(7, R, HIER_N)[rank])
    for op in ("sum", "average"):
        res[f"hier/raw/{op}"] = co.hierarchical_push_pull(comm, x, op).numpy()
    c, d = co.make_onebit_pair()
    res["hier/onebit"] = co.hierarchical_push_pull(
        comm, x, "average", c, d, compress_min_bytes=0).numpy()
    c, d = co.make_powersgd_pair(rank=4, iters=2)
    res["hier/powersgd"] = co.hierarchical_push_pull(
        comm, x, "sum", c, d, compress_min_bytes=0).numpy()
    for n in GATE_SIZES:
        g = torch.from_numpy(rows(8, R, n)[rank])
        c, d = co.make_onebit_pair()
        calls = []

        def counting(shard, c=c):
            calls.append(shard.numel())
            return c(shard)

        res[f"gate/{n}"] = co.hierarchical_push_pull(
            comm, g, "average", counting, d).numpy()
        res[f"gate/{n}/compressed"] = np.array(len(calls))


def case_dp_onebit(comm, inp, res):
    """The MLP trained DP_ONEBIT_STEPS steps (SGD 0.1) through
    make_dp_train_step with the onebit pair on the cross-node hop, every
    gradient forced past the gate."""
    model = mlp.load_flax_mlp(mlp.MLP(4, features=(16, 10)),
                              nest(inp, "mlp/", "."))
    step = make_dp_train_step(
        comm, model, lambda m, b: mlp.softmax_cross_entropy(
            m(b["x"]), b["y"].long()),
        torch.optim.SGD(model.parameters(), lr=0.1),
        compress_dcn=co.make_onebit_pair())
    batch = shard_batch(comm, batch_of(inp, "mlp_batch/"))
    os.environ["BYTEPS_DCN_COMPRESS_MIN_BYTES"] = "0"
    try:
        res["dp_onebit/loss"] = np.array([step(batch).item()
                                          for _ in range(DP_ONEBIT_STEPS)])
    finally:
        del os.environ["BYTEPS_DCN_COMPRESS_MIN_BYTES"]
    for n, p in model.named_parameters():
        res[f"dp_onebit/param/{n}"] = p.detach().numpy()


CASES = {"bert": case_bert, "accum": case_accum, "bn": case_bn,
         "hier": case_hier, "dp_onebit": case_dp_onebit}


def main(in_path, out_path, cases):
    cfg = Config.from_env()
    comm = bootstrap(cfg, resolve_device("cpu"))
    torch.manual_seed(0)
    inp = dict(np.load(in_path))
    res = {}
    try:
        for name in cases.split(","):
            CASES[name](comm, inp, res)
    finally:
        comm.close()
    np.savez(out_path, **res)


def spawn(layout, in_path, out_dir, cases, timeout=240):
    """Every rank of ``layout``; returns the result paths by rank."""
    hosts, local = LAYOUTS[layout]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    for rank in range(hosts * local):
        out = os.path.join(out_dir, f"dp_{layout}_{rank}.npz")
        env = dict(os.environ,
                   DMLC_NUM_WORKER=str(hosts),
                   DMLC_WORKER_ID=str(rank // local),
                   BYTEPS_LOCAL_SIZE=str(local),
                   BYTEPS_LOCAL_RANK=str(rank % local),
                   DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(here))
        env.pop("BYTEPS_DCN_COMPRESS_MIN_BYTES", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), in_path, out, cases],
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
    main(*sys.argv[1:])
