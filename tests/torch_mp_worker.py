"""One rank of the port's tensor-, pipeline- and composite-parallel tests
(``tests/test_torch_tensor_parallel.py``, ``test_torch_pipeline.py``,
``test_torch_three_d.py``, ``test_torch_fsdp_tp.py``).

One process per rank, each with its DMLC_*/BYTEPS_* environment (one node
of ``world`` ranks); the inputs (the JAX models' parameters, the batches)
come from an npz the test writes and the cases from a JSON list.  Each
case builds its mesh, loads its rank's slices of the flax parameters,
trains ``steps`` steps of SGD and writes each step's loss, and each of
its parameters after the steps under the whole model's name with its
slice's bounds.  Imports neither jax nor byteps_tpu.

    python -m tests.torch_mp_worker IN.npz CASES.json OUT.npz
"""

import dataclasses
import json
import sys

import numpy as np
import torch

from byteps_tpu_torch.comm.mesh import bootstrap, resolve_device
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.models import gpt, llama
from byteps_tpu_torch.parallel import (fsdp_tp, pipeline, tensor_parallel,
                                       three_d, tp_layers)
from byteps_tpu_torch.tools import model_parallel

from .torch_sp_worker import CONFIGS, nest, spawn as _spawn

CONFIGS = dict(CONFIGS)
CONFIGS.update({
    "gpt_tiny4_f32": lambda: dataclasses.replace(
        CONFIGS["gpt_tiny_f32"](), num_layers=4),
    "llama_odd_vocab_f32": lambda: llama.LlamaConfig(
        vocab_size=127, hidden_size=32, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=64, max_position=64,
        rope_theta=10000.0, dtype=torch.float32),
})


class Meshes:
    """One mesh per (kind, shape), made once: every rank makes the same
    meshes in the same order, as ``new_group`` requires."""

    def __init__(self, comm):
        self.comm, self.made = comm, {}

    def get(self, kind, shape):
        key = (kind, tuple(shape))
        if key not in self.made:
            c = self.comm
            self.made[key] = {
                "tp": lambda: tensor_parallel.make_tp_mesh(c, shape[1]),
                "pp": lambda: pipeline.make_pp_mesh(c, shape[1]),
                "3d": lambda: three_d.make_3d_mesh(c, shape[1], shape[2]),
                "fsdp_tp": lambda: fsdp_tp.make_fsdp_tp_mesh(c, shape[1]),
            }[kind]()
        return self.made[key]


def _kv_by_local_index():
    """A control: each query head reads K/V head ``j // groups`` of this
    rank's K/V heads, whatever its rank."""
    orig = llama.kv_heads

    def local(tp_index, q_heads, groups, kv_here, kv_split, device=None):
        return torch.arange(q_heads, device=device) // groups

    def apply(model):
        llama.kv_heads = local

    def undo():
        llama.kv_heads = orig
    return apply, undo


# each control's (apply(model), undo); the card tool's for tp and pp
CONTROLS = {"bias_every_rank": lambda: model_parallel.fault("tp"),
            "ends_over_dp": lambda: model_parallel.fault("pp"),
            "kv_local_index": _kv_by_local_index}


def build(mesh, c, inp):
    """The case's model (this rank's slices of the flax parameters), its
    step and its rows of the batch; and the global name of each local
    parameter name."""
    kind = c["type"]
    cfg = CONFIGS[c["config"]]()
    params = nest(inp, c["params"] + "/")
    names = {}
    if kind == "fsdp_tp":
        model = llama.Llama(cfg, tp_axis=mesh.axis("tp"),
                            fsdp_axis=mesh.axis("fsdp"))
        llama.load_flax_llama(model, params)
        opt = torch.optim.SGD(model.parameters(), lr=c["lr"])
        step = fsdp_tp.make_fsdp_tp_train_step(mesh, model, opt)
        shard = fsdp_tp.shard_llama_batch
    else:
        tp = mesh.axis("tp") if kind in ("tp", "3d") else None
        layers = (pipeline.stage_layers(mesh, cfg.num_layers)
                  if kind in ("pp", "3d") else None)
        model = gpt.GPT(cfg, tp_axis=tp, layers=layers)
        gpt.load_flax_gpt(model, params)
        opt = torch.optim.SGD(model.parameters(), lr=c["lr"])
        if kind == "tp":
            step = tensor_parallel.make_dp_tp_train_step(mesh, model, opt)
            shard = tensor_parallel.shard_tp_batch
        elif kind == "pp":
            step = pipeline.make_dp_pp_train_step(mesh, model, opt,
                                                  c["microbatches"])
            shard = pipeline.shard_pp_batch
        else:
            step = three_d.make_dp_pp_tp_train_step(mesh, model, opt,
                                                    c["microbatches"])
            shard = three_d.shard_3d_batch
        for n, _ in model.named_parameters():
            parts = n.split(".")
            if parts[0] == "h":
                parts[1] = str(model.layers[int(parts[1])])
            names[n] = ".".join(parts)
    glob = {k: torch.from_numpy(inp[f"{c['batch']}/{k}"]).long()
            for k in ("input_ids", "labels")}
    return model, step, shard(mesh, glob), names


def run_case(meshes, inp, res, c):
    mesh = meshes.get(c["type"], c["mesh"])
    model, step, batch, names = build(mesh, c, inp)
    apply, undo = (CONTROLS[c["control"]]() if c.get("control")
                   else (lambda m: None, lambda: None))
    apply(model)
    try:
        name = c["name"]
        res[f"{name}/loss"] = np.array([step(batch).item()
                                        for _ in range(c["steps"])])
        if hasattr(step, "stage_forwards"):
            res[f"{name}/stage_forwards"] = np.array(step.stage_forwards)
    finally:
        undo()
    places = tp_layers.param_placements(model)
    for n, p in model.named_parameters():
        g = names.get(n, n)
        res[f"{name}/param/{g}"] = p.detach().numpy()
        res[f"{name}/bounds/{g}"] = np.array(
            tp_layers.bounds(tuple(
                s * (1 if a is None else a.size)
                for s, a in zip(p.shape, places[n])), places[n]))


def flax_flat(tree, prefix):
    """A flax tree of arrays as ``{prefix + "h0/attn/qkv/kernel": f32
    array}`` (what :func:`~.torch_sp_worker.nest` takes back)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flax_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def port_names(tree, prefix=""):
    """A flax tree of arrays as ``{port name: f32 array}`` (scope
    ``h{i}`` is ``h.{i}``)."""
    out = {}
    for k, v in tree.items():
        k = f"h.{k[1:]}" if k[:1] == "h" and k[1:].isdigit() else k
        if isinstance(v, dict):
            out.update(port_names(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def compare(results, name, losses, params, loss_rtol=1e-5, loss_atol=1e-6,
            rtol=2e-4, atol=2e-5):
    """Every rank's losses of case ``name`` against ``losses`` and each of
    its parameter slices against the same slice of ``params`` (by port
    name); the disagreements, as messages (empty when all agree).  Every
    parameter must be held by some rank."""
    bad, held = [], set()
    for rank, r in enumerate(results):
        if not np.allclose(r[f"{name}/loss"], losses, rtol=loss_rtol,
                           atol=loss_atol):
            bad.append(f"rank {rank} losses {r[f'{name}/loss']} against "
                       f"{losses}")
        pre = f"{name}/param/"
        for key in r:
            if not key.startswith(pre):
                continue
            g = key[len(pre):]
            held.add(g)
            want = params[g][tuple(slice(lo, hi) for lo, hi in
                                   r[f"{name}/bounds/{g}"])]
            if want.shape != r[key].shape or not np.allclose(
                    r[key], want, rtol=rtol, atol=atol):
                err = (np.abs(r[key] - want).max()
                       if want.shape == r[key].shape else "shape")
                bad.append(f"rank {rank} {g}: max |diff| {err}")
    missing = set(params) - held
    if missing:
        bad.append(f"held by no rank: {sorted(missing)}")
    return bad


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
                run_case(meshes, inp, res, c)
    finally:
        comm.close()
    np.savez(out_path, **res)


def spawn(world, in_path, cases_path, out_dir, timeout=240):
    """Every rank of a one-node world of ``world`` ranks; returns the
    result paths by rank."""
    return _spawn(world, in_path, cases_path, out_dir, timeout=timeout,
                  module="tests.torch_mp_worker")


def lm_batch(seed, vocab, b=8, t=16):
    """Token ids and the labels shifted by one (the last ignored), made
    from ``seed`` with numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, t)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    return {"input_ids": ids, "labels": labels}


def start(tmp, inp, cases, worlds):
    """Every world's ranks in the background (the cases each world
    takes by their ``worlds``); returns a callable waiting for them:
    ``{world: [npz by rank]}``, and the pool to shut down."""
    from concurrent.futures import ThreadPoolExecutor
    path, cpath = str(tmp / "inputs.npz"), str(tmp / "cases.json")
    np.savez(path, **inp)
    with open(cpath, "w") as f:
        json.dump(cases, f)
    pool = ThreadPoolExecutor(len(worlds))
    futs = {w: pool.submit(spawn, w, path, cpath, str(tmp)) for w in worlds}
    done = {}

    def results():
        if not done:
            for w, fut in futs.items():
                done[w] = [dict(np.load(o)) for o in fut.result()]
        return done

    return results, pool


if __name__ == "__main__":
    main(*sys.argv[1:])
