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
    python -m tests.torch_mp_worker --spawn cuda OUT_DIR WORLD
    python -m tests.torch_mp_worker --spawn cpu CPU_DIR WORLD
    python -m tests.torch_mp_worker --compare OUT_DIR CPU_DIR

The ``--spawn`` form runs every rank of :data:`CARD_CASES` that take
``WORLD`` ranks: on the card, a card a rank (``CUDA_VISIBLE_DEVICES``)
over NCCL, or on the CPU over gloo.  The inputs are the CPU tests'
sizes, made without JAX (:func:`card_inputs`: the port's models drawn
from a seed, as flax trees).  ``--compare`` holds every rank's losses
and parameter slices of the card run against the CPU run's at the CPU
tests' tolerances, and each control's against its case's CPU run, which
it must miss; it prints every disagreement and exits 1 on any.
"""

import dataclasses
import json
import os
import re
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
    dev = mesh.device
    if kind == "fsdp_tp":
        model = llama.Llama(cfg, tp_axis=mesh.axis("tp"),
                            fsdp_axis=mesh.axis("fsdp"), device=dev)
        llama.load_flax_llama(model, params)
        opt = torch.optim.SGD(model.parameters(), lr=c["lr"])
        step = fsdp_tp.make_fsdp_tp_train_step(mesh, model, opt)
        shard = fsdp_tp.shard_llama_batch
    else:
        tp = mesh.axis("tp") if kind in ("tp", "3d") else None
        layers = (pipeline.stage_layers(mesh, cfg.num_layers)
                  if kind in ("pp", "3d") else None)
        model = gpt.GPT(cfg, tp_axis=tp, layers=layers, device=dev)
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
        res[f"{name}/param/{g}"] = p.detach().cpu().numpy()
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
    torch.backends.cuda.matmul.allow_tf32 = False
    comm = bootstrap(Config.from_env(), resolve_device(device))
    torch.manual_seed(0)
    inp = dict(np.load(in_path))
    with open(cases_path) as f:
        cases = json.load(f)
    meshes = Meshes(comm)
    res = {"meta/backend": np.array(comm.backend)}
    try:
        for c in cases:
            if comm.size in c.get("worlds", [comm.size]):
                run_case(meshes, inp, res, c)
    finally:
        comm.close()
    np.savez(out_path, **res)


def spawn(world, in_path, cases_path, out_dir, timeout=240, device="cpu"):
    """Every rank of a one-node world of ``world`` ranks; returns the
    result paths by rank."""
    return _spawn(world, in_path, cases_path, out_dir, timeout=timeout,
                  device=device, module="tests.torch_mp_worker")


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


# --- the card check ----------------------------------------------------------

STEPS, LR = 3, 0.1
# the CPU tests' cases and sizes (tests/test_torch_{tensor_parallel,
# pipeline,three_d,fsdp_tp}.py); a control names the case it must miss
_GPT = {"config": "gpt_tiny_f32", "params": "gpt", "batch": "gpt_batch",
        "steps": STEPS, "lr": LR}
_GPT4 = dict(_GPT, config="gpt_tiny4_f32", params="gpt4",
             batch="gpt4_batch")
_LLAMA = {"type": "fsdp_tp", "config": "llama_tiny_f32", "params": "llama",
          "batch": "llama_batch", "steps": STEPS, "lr": LR, "worlds": [4]}
CARD_CASES = (
    [dict(_GPT, type="tp", name=f"tp_{d}x{t}", mesh=[d, t], worlds=[d * t])
     for d, t in ((1, 2), (2, 2))]
    + [dict(_GPT, type="tp", name="tp_1x2_bias_control", mesh=[1, 2],
            control="bias_every_rank", misses="tp_1x2", worlds=[2])]
    + [dict(_GPT4, type="pp", name=f"pp_{d}x{p}_m{m}", mesh=[d, p],
            microbatches=m, worlds=[d * p])
       for d, p, m in ((1, 2, 1), (1, 2, 2), (1, 2, 4), (2, 2, 2),
                       (1, 4, 4))]
    + [dict(_GPT4, type="pp", name="pp_2x2_m2_ends_control", mesh=[2, 2],
            microbatches=2, control="ends_over_dp", misses="pp_2x2_m2",
            worlds=[4])]
    + [dict(_GPT4, type="3d", name="3d_1x2x2_m2", mesh=[1, 2, 2],
            microbatches=2, worlds=[4])]
    + [dict(_LLAMA, name=f"ft_{f}x{t}", mesh=[f, t])
       for f, t in ((2, 2), (1, 4), (4, 1))]
    + [dict(_LLAMA, name="ft_1x4_kv_control", mesh=[1, 4],
            control="kv_local_index", misses="ft_1x4"),
       dict(_LLAMA, name="ft_odd_2x2", mesh=[2, 2], params="odd",
            batch="odd_batch", config="llama_odd_vocab_f32")])
# the CPU tests' tolerances (loss rtol / atol, parameters rtol / atol)
LOSS_TOL, PARAM_TOL = (1e-5, 1e-6), (2e-4, 2e-5)


def flax_tree(model):
    """A port model's parameters as the flat ``{"h0/attn/q/kernel": f32
    array}`` that :func:`~.torch_sp_worker.nest` and ``load_flax_*`` take
    back (``h.{i}`` is scope ``h{i}``)."""
    return {re.sub(r"^h\.(\d+)\.", r"h\1.", n).replace(".", "/"):
            p.detach().float().cpu().numpy()
            for n, p in model.named_parameters()}


def card_inputs():
    """The inputs of :data:`CARD_CASES`: each whole model drawn from its
    seed by the port (biases drawn too, so that a bias added on every tp
    rank shows from the first step), and an LM batch of each, made with
    numpy."""
    inp = {}
    models = {"gpt": (gpt.GPT, "gpt_tiny_f32", 0),
              "gpt4": (gpt.GPT, "gpt_tiny4_f32", 1),
              "llama": (llama.Llama, "llama_tiny_f32", 3),
              "odd": (llama.Llama, "llama_odd_vocab_f32", 4)}
    for key, (cls, config, seed) in models.items():
        cfg = CONFIGS[config]()
        model = cls(cfg, generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            gen = torch.Generator().manual_seed(100 + seed)
            for n, p in model.named_parameters():
                if n.endswith("bias"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        for k, v in flax_tree(model).items():
            inp[f"{key}/{k}"] = v
        for k, v in lm_batch(seed, cfg.vocab_size).items():
            inp[f"{key}_batch/{k}"] = v
    return inp


def spawn_card_check(device, out_dir, world, timeout=300):
    """Every rank of the :data:`CARD_CASES` that take ``world`` ranks, on
    ``device``; returns the result paths by rank."""
    os.makedirs(out_dir, exist_ok=True)
    in_path = os.path.join(out_dir, "inputs.npz")
    cases_path = os.path.join(out_dir, "cases.json")
    np.savez(in_path, **card_inputs())
    with open(cases_path, "w") as f:
        json.dump(CARD_CASES, f)
    return spawn(world, in_path, cases_path, out_dir, timeout=timeout,
                 device=device)


def _agree(a, b, tol):
    return a.shape == b.shape and np.allclose(a, b, rtol=tol[0], atol=tol[1])


def compare_dirs(dir_a, dir_b):
    """Every rank's results in ``dir_a`` (the card's) against ``dir_b``'s
    (the CPU's): each case's losses and parameter slices at LOSS_TOL and
    PARAM_TOL, its bounds and stage forwards exactly; each control's
    against the case it ``misses``, which must disagree.  Returns
    ``(disagreements, arrays compared, controls that missed)``."""
    controls = {c["name"]: c["misses"] for c in CARD_CASES
                if c.get("misses")}
    bad, n, missed = [], 0, set()
    files = sorted(f for f in os.listdir(dir_a)
                   if f.startswith("sp_") and f.endswith(".npz"))
    if not files:
        bad.append(f"no results in {dir_a}")
    for f in files:
        a, b = np.load(os.path.join(dir_a, f)), np.load(os.path.join(dir_b, f))
        for k in a.files:
            case, kind = k.split("/")[:2]
            if case == "meta":
                continue
            if case in controls:
                want_key = k.replace(case, controls[case], 1)
                tol = LOSS_TOL if kind == "loss" else PARAM_TOL
                if kind in ("loss", "param") and not _agree(
                        a[k], b[want_key], tol):
                    missed.add(case)
                continue
            n += 1
            if kind in ("bounds", "stage_forwards"):
                ok = np.array_equal(a[k], b[k])
            else:
                ok = _agree(a[k], b[k], LOSS_TOL if kind == "loss"
                            else PARAM_TOL)
            if not ok:
                err = (np.abs(a[k] - b[k]).max() if a[k].shape == b[k].shape
                       else "shape")
                bad.append(f"{f} {k}: max |diff| {err}")
    ran = {k.split("/")[0] for f in files
           for k in np.load(os.path.join(dir_a, f)).files}
    ran.discard("meta")
    for c in sorted(set(controls) & ran - missed):
        bad.append(f"control {c} agrees with {controls[c]}: it must miss")
    return bad, n, sorted(missed)


if __name__ == "__main__":
    if sys.argv[1] == "--spawn":
        spawn_card_check(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    elif sys.argv[1] == "--compare":
        bad, n, missed = compare_dirs(sys.argv[2], sys.argv[3])
        for b in bad:
            print(b)
        print(f"compared {n} arrays, {len(bad)} disagree; controls that "
              f"missed {missed}")
        sys.exit(1 if bad else 0)
    else:
        main(*sys.argv[1:])
