"""One rank of the port's sequence- and expert-parallel tests
(``tests/test_torch_sequence_parallel.py``, ``test_torch_ring_flash.py``,
``test_torch_long_context*.py``, ``test_torch_expert.py``,
``test_torch_moe_lm.py``).

One process per rank, each with its DMLC_*/BYTEPS_* environment (one
node of ``world`` ranks); the inputs (global arrays, the JAX models'
parameters) come from an npz the test writes and the cases from a JSON
list, and each rank takes its shard.  Imports neither jax nor
byteps_tpu.

    python -m tests.torch_sp_worker IN.npz CASES.json OUT.npz
    python -m tests.torch_sp_worker --spawn cuda OUT_DIR WORLD

The second form runs every rank of a built-in set of cases on the
card, a card a rank (``CUDA_VISIBLE_DEVICES``), over NCCL: the 4-card
check of the ring, Ulysses and all-to-all paths.  Its npz files are
held against a CPU run of the same cases (``--spawn cpu``) with
``--compare DIR_A DIR_B``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.mesh import bootstrap, resolve_device
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.models import gpt, llama
from byteps_tpu_torch.ops.collective_ops import push_pull_tree
from byteps_tpu_torch.parallel import (expert, long_context, mesh_util,
                                       moe_lm, sequence)

CONFIGS = {
    "gpt_tiny_f32": lambda: dataclasses.replace(gpt.gpt_tiny(),
                                                dtype=torch.float32),
    "moe_gpt_tiny_f32": lambda: dataclasses.replace(
        gpt.gpt_tiny(), dtype=torch.float32, moe_experts=4, num_layers=4),
    "llama_tiny_f32": llama.llama_tiny_f32,
}


def nest(flat, prefix, sep="/"):
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


class Meshes:
    """One mesh per (axis names, shape), made once: every rank makes the
    same meshes in the same order, as ``new_group`` requires."""

    def __init__(self, comm):
        self.comm, self.made = comm, {}

    def get(self, names, inner):
        key = (names, inner)
        if key not in self.made:
            self.made[key] = mesh_util.make_2d_mesh(self.comm, inner, names)
        return self.made[key]


def _shard_seq(mesh, x, axis="sp"):
    """This rank's ``[B/dp, T/sp, ...]`` shard of a global array."""
    dp, sp = mesh.axis("dp"), mesh.axis(axis)
    rb, rt = x.shape[0] // dp.size, x.shape[1] // sp.size
    return x[dp.index * rb:(dp.index + 1) * rb,
             sp.index * rt:(sp.index + 1) * rt].contiguous()


def case_attn(meshes, inp, res, c):
    """One attention kind over (1, world) or (dp, sp): the local output
    shard and the gradients of sum(out * w) for q, k and v.
    ``layout="striped"`` feeds striped shards to ``striped_attention``
    itself; ``path`` forces the shift path of the ring."""
    mesh = meshes.get(("dp", "sp"), c["sp"])
    dev = mesh.device
    pre = c.get("input", "attn")
    glob = {k: torch.from_numpy(inp[f"{pre}/{k}"]) for k in "qkvw"}
    if c.get("layout") == "striped":
        glob = {k: sequence.stripe_batch(v, c["sp"]) for k, v in glob.items()}
    shard = {k: _shard_seq(mesh, v).to(dev) for k, v in glob.items()}
    q, k, v = (shard[n].requires_grad_() for n in "qkv")
    if c.get("layout") == "striped":
        fn = sequence.resolve_sp_attention(
            "striped", axis=mesh.axis("sp"), causal=c["causal"])
    else:
        fn = sequence.make_sp_attention(mesh, c["kind"], causal=c["causal"])
    saved = mesh_util.shift_path
    if c.get("path"):
        mesh_util.shift_path = lambda axis, device: c["path"]
    try:
        out = fn(q, k, v)
        (out * shard["w"]).sum().backward()
    finally:
        mesh_util.shift_path = saved
    name = c["name"]
    res[f"{name}/out"] = out.detach().cpu().numpy()
    for n, t in (("dq", q), ("dk", k), ("dv", v)):
        res[f"{name}/{n}"] = t.grad.cpu().numpy()


def _lm_model(c, inp, **kw):
    cfg = CONFIGS[c["config"]]()
    model = long_context._model_for(cfg, device="cpu", **kw)
    params = nest(inp, c["params"] + "/")
    if isinstance(cfg, llama.LlamaConfig):
        return llama.load_flax_llama(model, params)
    return gpt.load_flax_gpt(model, params)


def _control_step(mesh, model, opt):
    """The port's objective before the global count: each rank's own
    mean NLL, the gradients averaged over the world (what
    DistributedOptimizer trains)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        for p in params:
            p.grad = None
        logits = model(batch["input_ids"], positions=long_context._positions(
            mesh, batch["input_ids"].shape[1], False, mesh.device))
        loss = gpt.lm_loss(logits, batch["labels"])
        loss.backward()
        push_pull_tree(mesh.comm, {str(i): p.grad for i, p in
                                   enumerate(params)}, "average",
                       inplace=True)
        opt.step()
        out = loss.detach().clone()
        dist.all_reduce(out)
        return out / mesh.size

    return step


def case_lc(meshes, inp, res, c):
    """``make_dp_sp_train_step`` for ``steps`` SGD steps: the losses and
    the parameters after.  ``control="per_rank_mean"`` trains the old
    per-rank objective instead."""
    mesh = meshes.get(("dp", "sp"), c["sp"])
    model = _lm_model(c, inp)
    long_context.replicate(mesh, model)
    opt = torch.optim.SGD(model.parameters(), lr=c["lr"])
    if c.get("control") == "per_rank_mean":
        sequence_attn = sequence.resolve_sp_attention(
            c["kind"], axis=mesh.axis("sp"))
        long_context.set_attention(model, sequence_attn)
        step = _control_step(mesh, model, opt)
    else:
        step = long_context.make_dp_sp_train_step(mesh, model, opt,
                                                  attention=c["kind"])
    glob = {k: torch.from_numpy(inp[f"{c['batch']}/{k}"]).long()
            for k in ("input_ids", "labels")}
    batch = long_context.shard_lm_batch(mesh, glob,
                                        striped=c["kind"] == "striped")
    name = c["name"]
    res[f"{name}/loss"] = np.array([step(batch).item()
                                    for _ in range(c["steps"])])
    for n, p in model.named_parameters():
        res[f"{name}/param/{n}"] = p.detach().numpy()


def case_moe_mlp(meshes, inp, res, c):
    """``moe_mlp`` over (dp, ep): this rank's tokens ``x[rank]`` through
    its experts; the output and aux, and the gradients of sum(out * w)
    for the tokens and this rank's parameters."""
    mesh = meshes.get(("dp", "ep"), c["ep"])
    full = {k: inp[f"moe/params/{k}"] for k in ("router", "w1", "b1", "w2",
                                                "b2")}
    params = expert.shard_moe_params(mesh, full)
    dev = mesh.device
    x = torch.from_numpy(inp["moe/x"][mesh.rank]).to(dev).requires_grad_()
    w = torch.from_numpy(inp["moe/w"][mesh.rank]).to(dev)
    out, aux = expert.moe_mlp(x, params, c["experts"], c["capacity"],
                              axis=mesh.axis("ep"))
    ((out * w).sum() + aux).backward()
    name = c["name"]
    res[f"{name}/out"] = out.detach().cpu().numpy()
    res[f"{name}/aux"] = aux.detach().cpu().numpy()
    res[f"{name}/dx"] = x.grad.cpu().numpy()
    for k, p in params.items():
        res[f"{name}/grad/{k}"] = p.grad.cpu().numpy()


def case_dp_ep(meshes, inp, res, c):
    """``make_dp_ep_train_step`` (SGD) on the squared error against
    ``y``: the losses and this rank's parameters after."""
    mesh = meshes.get(("dp", "ep"), c["ep"])
    full = {k: inp[f"moe/params/{k}"] for k in ("router", "w1", "b1", "w2",
                                                "b2")}
    params = expert.shard_moe_params(mesh, full)
    opt = torch.optim.SGD(params.values(), lr=c["lr"])

    def loss_fn(out, batch):
        return torch.mean((out - batch["y"]) ** 2)

    step = expert.make_dp_ep_train_step(mesh, params, c["experts"],
                                        c["capacity"], opt, loss_fn,
                                        aux_weight=c["aux_weight"])
    batch = {"x": torch.from_numpy(inp["ep/x"][mesh.rank]),
             "y": torch.from_numpy(inp["ep/y"][mesh.rank])}
    name = c["name"]
    res[f"{name}/loss"] = np.array([step(batch).item()
                                    for _ in range(c["steps"])])
    for k, p in params.items():
        res[f"{name}/param/{k}"] = p.detach().numpy()


def case_moe_lm(meshes, inp, res, c):
    """``make_moe_lm_train_step`` (SGD): the first forward's logits and
    aux losses, each step's loss and this rank's parameters after.
    ``control="ep_sum"`` sums the expert gradients over the world."""
    mesh = meshes.get(("dp", "ep"), c["ep"])
    cfg = CONFIGS[c["config"]]()
    model = gpt.GPT(cfg, ep_axis=mesh.axis("ep"))
    gpt.load_flax_gpt(model, nest(inp, c["params"] + "/"))
    opt = torch.optim.SGD(model.parameters(), lr=c["lr"])
    saved = moe_lm.moe_lm_pspec
    if c.get("control") == "ep_sum":
        moe_lm.moe_lm_pspec = lambda name, leaf: None
    try:
        step = moe_lm.make_moe_lm_train_step(mesh, model, opt,
                                             aux_weight=c["aux_weight"])
        glob = {k: torch.from_numpy(inp[f"{c['batch']}/{k}"]).long()
                for k in ("input_ids", "labels")}
        batch = moe_lm.shard_moe_lm_batch(mesh, glob)
        name = c["name"]
        with torch.no_grad():
            res[f"{name}/logits"] = model(batch["input_ids"]).numpy()
            res[f"{name}/aux"] = np.array([a.item() for a in
                                           model.moe_aux_losses()])
        res[f"{name}/loss"] = np.array([step(batch).item()
                                        for _ in range(c["steps"])])
    finally:
        moe_lm.moe_lm_pspec = saved
    for n, p in model.named_parameters():
        res[f"{name}/param/{n}"] = p.detach().numpy()


CASES = {"attn": case_attn, "lc": case_lc, "moe_mlp": case_moe_mlp,
         "dp_ep": case_dp_ep, "moe_lm": case_moe_lm}


def main(in_path, cases_path, out_path, device="cpu"):
    comm = bootstrap(Config.from_env(), resolve_device(device))
    torch.manual_seed(0)
    inp = dict(np.load(in_path))
    with open(cases_path) as f:
        cases = json.load(f)
    meshes = Meshes(comm)
    res = {}
    try:
        for c in cases:
            if comm.size in c.get("worlds", [comm.size]):
                CASES[c["type"]](meshes, inp, res, c)
    finally:
        comm.close()
    np.savez(out_path, **res)


def spawn(world, in_path, cases_path, out_dir, timeout=240, device="cpu",
          module="tests.torch_sp_worker"):
    """Every rank of a one-node world of ``world`` ranks (each ``python -m
    module``); returns the result paths by rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(out_dir, f"sp_{world}_{rank}.npz")
        env = dict(os.environ, DMLC_NUM_WORKER="1", DMLC_WORKER_ID="0",
                   BYTEPS_LOCAL_SIZE=str(world),
                   BYTEPS_LOCAL_RANK=str(rank),
                   DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(here))
        if device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, in_path, cases_path, out,
             device], cwd=os.path.dirname(here),
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
            failed.append(f"world {world} rank {rank} rc={p.returncode}:\n"
                          f"{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


# --- the card check ----------------------------------------------------------

def card_inputs(seed=0):
    """Inputs of :data:`CARD_CASES`: random q, k, v and w, MoE tokens
    and weights, all made from ``seed`` with numpy."""
    rng = np.random.RandomState(seed)
    inp = {f"attn/{k}": rng.randn(2, 64, 4, 64).astype(np.float32)
           for k in "qkvw"}
    h, f, e = 32, 64, 8
    inp.update({"moe/params/router": rng.randn(h, e).astype(np.float32),
                "moe/params/w1": (rng.randn(e, h, f) / 6).astype(np.float32),
                "moe/params/b1": np.zeros((e, f), np.float32),
                "moe/params/w2": (rng.randn(e, f, h) / 8).astype(np.float32),
                "moe/params/b2": np.zeros((e, h), np.float32),
                "moe/x": rng.randn(4, 40, h).astype(np.float32),
                "moe/w": rng.randn(4, 40, h).astype(np.float32)})
    return inp


CARD_CASES = (
    [{"type": "attn", "name": f"{kind}_{'causal' if causal else 'full'}",
      "kind": kind, "causal": causal, "sp": 2}
     for kind in ("ring", "striped", "ring_flash", "ulysses",
                  "ulysses_flash") for causal in (True, False)]
    + [{"type": "moe_mlp", "name": "moe_mlp_ep2", "ep": 2, "experts": 8,
        "capacity": 1.25}])


def spawn_card_check(device, out_dir, world):
    os.makedirs(out_dir, exist_ok=True)
    in_path = os.path.join(out_dir, "inputs.npz")
    cases_path = os.path.join(out_dir, "cases.json")
    np.savez(in_path, **card_inputs())
    with open(cases_path, "w") as f:
        json.dump(CARD_CASES, f)
    return spawn(world, in_path, cases_path, out_dir, device=device)


def compare(dir_a, dir_b, rtol=5e-4, atol=5e-4):
    """Every array of every rank's npz in ``dir_a`` against ``dir_b``'s
    (the flash kernels' f32 gradient tolerance: sums in another order);
    prints each disagreement, returns their count."""
    bad = n = 0
    for f in sorted(os.listdir(dir_a)):
        if not (f.startswith("sp_") and f.endswith(".npz")):
            continue
        a, b = np.load(os.path.join(dir_a, f)), np.load(os.path.join(dir_b, f))
        for k in a.files:
            n += 1
            if not np.allclose(a[k], b[k], rtol=rtol, atol=atol):
                bad += 1
                print(f"{f} {k}: max |diff| "
                      f"{np.abs(a[k] - b[k]).max():.3g}")
    print(f"compared {n} arrays, {bad} disagree")
    return bad


if __name__ == "__main__":
    if sys.argv[1] == "--spawn":
        spawn_card_check(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    elif sys.argv[1] == "--compare":
        sys.exit(1 if compare(sys.argv[2], sys.argv[3]) else 0)
    else:
        main(*sys.argv[1:])
