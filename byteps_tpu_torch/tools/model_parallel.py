"""Tensor-, pipeline- and composite-parallel training on the card: the
port's layouts of ``parallel/{fsdp_tp,tensor_parallel,pipeline,three_d}``
driven at full width, one arm per layout, in one world.

    # every rank: one process with the DMLC_*/BYTEPS_* environment
    python -m byteps_tpu_torch.tools.model_parallel fsdp_tp tp pp 3d
    # all ranks from one command (their output interleaved)
    python -m byteps_tpu_torch.tools.model_parallel fsdp_tp --spawn 4 \\
        --backend gloo --check --control
    # a rehearsal on the CPU
    python -m byteps_tpu_torch.tools.model_parallel fsdp_tp tp pp 3d \\
        --spawn 4 --device cpu --model tiny --seq 64 --gpt-seq 32 --check \\
        --control

Arms (a world of 4 ranks; each arm builds its own mesh):

- ``fsdp_tp``: Llama-3-8B width (hidden 4096, 32 heads, 8 K/V heads of
  128, SwiGLU 14336, vocab 128256, bf16 compute over f32 parameters) at
  ``--layers`` layers over ``(fsdp 2, tp 2)``, ``--batch`` sequences of
  ``--seq`` tokens (one sequence an fsdp rank), AdamW 3e-4, the flash
  kernels as its attention (``ops/flash_attention.py``); weights drawn
  leaf by leaf from the seed (``init_llama_params_sharded``); with
  ``--remat`` each block is checkpointed;
- ``tp``, ``pp``, ``3d``: GPT-small (hidden 512, 8 layers, 8 heads of 64,
  vocab 32768, bf16 compute) with exact attention, ``--gpt-batch``
  sequences of ``--gpt-seq`` tokens, AdamW 3e-4, over ``(dp 2, tp 2)``,
  ``(dp 2, pp 2)`` and ``(dp 1, pp 2, tp 2)`` (the last two with
  ``--microbatches`` microbatches a dp shard).

Each arm takes a first step, then ``--steps`` timed steps.  With
``--check``, rank 0 first takes one forward and backward of the whole
model on the whole batch (one rank, the same weights and attention),
moves its gradients to the host and frees the card; after each arm's
first step every rank sends its gradient slices (the step's sums, before
the update; in bf16) to rank 0, which holds each against the same slice
of the one-rank gradient: the largest share of a tensor's max-abs by
which an element differs.  ``--control`` adds, before the first step, a
forward and backward with a known fault (no update: SGD at lr 0), whose
share must be large: ``fsdp_tp`` skips the attention's row-parallel sum
over tp, ``tp`` adds the row-parallel biases on every tp rank, ``pp``
sums the embedding and head gradients over dp only.

``--backend gloo`` runs several ranks on one card (NCCL refuses two ranks
of a communicator on one device).  Each rank prints one line ``MP_RESULT
{json}``: the card's ``nvidia-smi`` name and power limit, and per arm
the first loss, each timed step's ms and loss, tokens/s (the world's
tokens a step over the median step), the peak memory, the bytes of the
rank's parameters and AdamW state against the whole model's, the stage
forwards a step and the path of the stage shifts (``pp``, ``3d``), the
flash kernels' launches over the timed steps, and the check's
numbers.
"""

import argparse
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import time

ARMS = ("fsdp_tp", "tp", "pp", "3d")
LR = 3e-4
SEED = 0
MESHES = {"fsdp_tp": (2, 2), "tp": (2, 2), "pp": (2, 2), "3d": (1, 2, 2)}
BIAS_STD = 0.5                   # the GPT arms' biases, drawn from the seed
FAULTS = ("fsdp_tp", "tp", "pp")  # the arms with a control


def _device_line() -> str:
    from .bert_mlm import smi_line
    try:
        return smi_line()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(torch, dev):
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30


def _configs(args):
    from ..models import gpt, llama
    if args.model == "full":
        lcfg = dataclasses.replace(llama.llama3_8b(), num_layers=args.layers)
        gcfg = gpt.gpt_small()
    else:
        lcfg = llama.llama_tiny()
        gcfg = gpt.gpt_tiny()
    if args.remat:
        lcfg = dataclasses.replace(lcfg, remat=True)
    return lcfg, gcfg


def _batch(torch, cfg, batch, seq, dev, seed):
    from ..parallel.long_context import synthetic_lm_batch
    return synthetic_lm_batch(torch.Generator(device=dev).manual_seed(seed),
                              cfg, batch, seq)


def reference(torch, model, data):
    """One rank, the whole batch: the mean NLL and its gradients on the
    host (f32), by name."""
    from ..models.gpt import lm_loss
    model.zero_grad(set_to_none=True)
    loss = lm_loss(model(data["input_ids"]), data["labels"])
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    return loss.item(), grads


def _global_names(model):
    """Each local parameter name -> the whole model's (a stage's
    ``h.{j}`` is block ``layers[j]``)."""
    layers = getattr(model, "layers", None)
    out = {}
    for n, _ in model.named_parameters():
        parts = n.split(".")
        if parts[0] == "h" and layers is not None:
            parts[1] = str(layers[int(parts[1])])
        out[n] = ".".join(parts)
    return out


def _slices(model):
    """(global name, bounds, grad) of each parameter, in order."""
    from ..parallel.tp_layers import bounds, param_placements
    places = param_placements(model)
    names = _global_names(model)
    out = []
    for n, p in model.named_parameters():
        full = tuple(s * (1 if a is None else a.size)
                     for s, a in zip(p.shape, places[n]))
        out.append((names[n], bounds(full, places[n]), p.grad))
    return out


def check_grads(torch, mesh, model, ref):
    """Every rank's gradient slices against rank 0's one-rank gradients
    (``ref``; None elsewhere): on rank 0, the largest share of a tensor's
    max-abs by which any element differs, by rank, and where."""
    import torch.distributed as dist
    items = _slices(model)
    flat = torch.cat([g.reshape(-1).to(torch.bfloat16) for _, _, g in items])
    dev = flat.device
    # gloo takes no CUDA tensor in send/recv (``mesh_util.shift_path``),
    # NCCL only CUDA tensors
    wire = dev if dist.get_backend() == "nccl" else torch.device("cpu")
    index = torch.tensor(list(json.dumps([(n, b) for n, b, _ in items])
                              .encode()), dtype=torch.uint8, device=wire)
    if mesh.rank != 0:
        dist.send(torch.tensor([flat.numel(), index.numel()], device=wire),
                  dst=0)
        dist.send(flat.to(wire), dst=0)
        dist.send(index, dst=0)
        return None
    shares, wheres = [], []
    for r in range(mesh.size):
        if r:
            sizes = torch.empty(2, dtype=torch.int64, device=wire)
            dist.recv(sizes, src=r)
            buf = torch.empty(int(sizes[0]), dtype=torch.bfloat16,
                              device=wire)
            dist.recv(buf, src=r)
            raw = torch.empty(int(sizes[1]), dtype=torch.uint8, device=wire)
            dist.recv(raw, src=r)
            held = json.loads(bytes(raw.tolist()).decode())
        else:
            buf, held = flat, [(n, b) for n, b, _ in items]
        worst, where, off = 0.0, None, 0
        for name, bnd in held:
            want = ref[name][tuple(slice(lo, hi) for lo, hi in bnd)]
            got = buf[off:off + want.numel()].to(dev).float().view(want.shape)
            off += want.numel()
            want = want.to(dev)
            share = ((got - want).abs().max()
                     / want.abs().max().clamp_min(1e-30)).item()
            if share > worst:
                worst, where = share, name
        shares.append(worst)
        wheres.append(where)
    return {"grad_share_by_rank": shares, "grad_share_where": wheres}


def seed_biases(torch, model, cfg, dev):
    """Draw every bias of a GPT (zero at init) from the seed, standard
    deviation ``BIAS_STD``, each whole leaf in the whole model's order,
    and keep this model's slice of those it holds: with zero biases a
    bias added on every tp rank would change nothing, and the control
    would not show."""
    from ..models.gpt import GPT
    from ..parallel.tp_layers import param_placements, take
    whole = GPT(cfg, device="meta", generator=torch.Generator())
    mine = dict(model.named_parameters())
    places = param_placements(model)
    local = {g: n for n, g in _global_names(model).items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.no_grad():
        for name, p in whole.named_parameters():
            if not name.endswith(".bias") or ".ln" in name:
                continue
            full = torch.empty(p.shape, device=dev).normal_(
                0.0, BIAS_STD, generator=gen)
            if name in local:
                n = local[name]
                mine[n].copy_(take(full, places[n]))


def _build(torch, args, comm, arm, lcfg, gcfg):
    """This rank's mesh, model and step maker of ``arm``; the batch and a
    builder of the one-rank reference model."""
    from ..models.gpt import GPT
    from ..ops import flash_attention as fa
    from ..parallel import fsdp_tp, pipeline, tensor_parallel, three_d
    dev = comm.device
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa: E731
    if arm == "fsdp_tp":
        from ..models.llama import Llama
        mesh = fsdp_tp.make_fsdp_tp_mesh(comm, MESHES[arm][1])
        data = _batch(torch, lcfg, args.batch, args.seq, dev, SEED + 1)
        whole = lambda: Llama(lcfg, attn_fn=fa.flash_attention,  # noqa
                              device=dev, generator=gen())

        def make():
            return fsdp_tp.init_llama_params_sharded(
                mesh, lcfg, gen(), attn_fn=fa.flash_attention)

        def stepper(model, opt):
            return fsdp_tp.make_fsdp_tp_train_step(mesh, model, opt)

        return mesh, data, whole, make, stepper, fsdp_tp.shard_llama_batch
    data = _batch(torch, gcfg, args.gpt_batch, args.gpt_seq, dev, SEED + 2)

    def gpt_model(**kw):
        m = GPT(gcfg, device=dev, generator=gen(), **kw)
        seed_biases(torch, m, gcfg, dev)
        return m

    if arm == "tp":
        mesh = tensor_parallel.make_tp_mesh(comm, MESHES[arm][1])
        return (mesh, data, gpt_model,
                lambda: gpt_model(tp_axis=mesh.axis("tp")),
                lambda m, o: tensor_parallel.make_dp_tp_train_step(mesh, m,
                                                                   o),
                tensor_parallel.shard_tp_batch)
    if arm == "pp":
        mesh = pipeline.make_pp_mesh(comm, MESHES[arm][1])
        tp_axis = None
        stepper = (lambda m, o: pipeline.make_dp_pp_train_step(
            mesh, m, o, args.microbatches))
    else:
        mesh = three_d.make_3d_mesh(comm, *MESHES[arm][1:])
        tp_axis = mesh.axis("tp")
        stepper = (lambda m, o: three_d.make_dp_pp_tp_train_step(
            mesh, m, o, args.microbatches))
    layers = pipeline.stage_layers(mesh, gcfg.num_layers)
    return (mesh, data, gpt_model,
            lambda: gpt_model(tp_axis=tp_axis, layers=layers), stepper,
            pipeline.shard_pp_batch)


def fault(arm):
    """The known fault of an arm's control, as ``(apply(model), undo)``
    (None for ``3d``): ``fsdp_tp`` skips the attention's row-parallel sum
    over tp, ``tp`` adds the row-parallel biases on every tp rank before
    the sum, ``pp`` sums the embedding and head gradients over dp only.
    The CPU tests' controls use the last two too."""
    from ..models import gpt as gpt_mod
    from ..parallel import pipeline
    from ..parallel.tp_layers import reduce_from
    if arm == "fsdp_tp":
        saved = {}

        def apply(model):
            for b in model.h:
                saved[b.attn.out] = b.attn.out.row_axis
                b.attn.out.row_axis = None

        def undo():
            for m, a in saved.items():
                m.row_axis = a
        return apply, undo
    if arm == "tp":
        orig = gpt_mod.Dense.forward

        def forward(self, x):
            axis = self.row_axis
            if axis is None or self.bias is None:
                return orig(self, x)
            self.row_axis = None
            try:
                y = orig(self, x)
            finally:
                self.row_axis = axis
            return reduce_from(y, axis)

        def apply(model):
            gpt_mod.Dense.forward = forward

        def undo():
            gpt_mod.Dense.forward = orig
        return apply, undo
    if arm == "pp":
        from ..ops.collective_ops import push_pull_tree
        orig = pipeline.reduce_ends

        def over_dp(mesh, grads, plane):
            push_pull_tree(mesh.comm, grads, op="sum", inplace=True,
                           axis=mesh.axis("dp"))

        def apply(model):
            pipeline.reduce_ends = over_dp

        def undo():
            pipeline.reduce_ends = orig
        return apply, undo
    raise ValueError(f"no control for arm {arm!r}")


def _state_bytes(torch, model, opt, whole):
    """This rank's parameter and AdamW-state bytes; the whole model's
    (parameters and two moments, f32, from ``whole``'s shapes); the whole
    model's bytes of the leaves this rank holds whole; and, over the
    leaves sliced on every axis of the mesh, this rank's bytes against
    those leaves' whole bytes."""
    from ..parallel.tp_layers import param_placements
    places = param_placements(model)
    names = _global_names(model)
    numel = {n: p.numel() for n, p in whole.named_parameters()}
    n_axes = max(sum(a is not None for a in pl) for pl in places.values())
    mine = whole_held = here = full = 0
    for n, p in model.named_parameters():
        st = opt.state.get(p, {})
        b = p.numel() * p.element_size() + sum(
            v.numel() * v.element_size() for v in st.values()
            if torch.is_tensor(v) and v.dim() > 0)
        mine += b
        w = 12 * numel[names[n]]
        axes = sum(a is not None for a in places[n])
        if not axes:
            whole_held += w
        elif axes == n_axes:
            here += b
            full += w
    return {"state_bytes": mine, "whole_state_bytes": 12 * sum(numel.values()),
            "whole_held_bytes": whole_held,
            "sliced_share": here / full if full else None}


def run_arm(torch, args, comm, arm, lcfg, gcfg):
    import torch.distributed as dist
    from ..ops import flash_attention as fa
    dev = comm.device
    mesh, data, whole, make, stepper, shard = _build(torch, args, comm, arm,
                                                    lcfg, gcfg)
    cfg = lcfg if arm == "fsdp_tp" else gcfg
    out = {"mesh": dict(mesh.shape)}
    ref = None
    if args.check and comm.rank == 0:
        m = whole()
        out["ref_loss"], ref = reference(torch, m, data)
        del m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.check:
        dist.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = make()
    batch = shard(mesh, data)
    if args.control:
        if arm in FAULTS:
            apply, undo = fault(arm)
            opt0 = torch.optim.SGD(model.parameters(), lr=0.0)
            step0 = stepper(model, opt0)
            apply(model)
            try:
                step0(batch)
            finally:
                undo()
            res = check_grads(torch, mesh, model, ref)
            if res is not None:
                out["control"] = res
            model.zero_grad(set_to_none=True)
            del opt0, step0
    opt = torch.optim.AdamW(model.parameters(), lr=LR)
    step = stepper(model, opt)
    out["first_loss"] = step(batch).item()
    if args.check:
        res = check_grads(torch, mesh, model, ref)
        if res is not None:
            out.update(res)
    ref = None
    ms, losses = [], []
    fa.reset_launches()
    for _ in range(args.steps):
        _sync(torch, dev)
        t0 = time.perf_counter()
        loss = step(batch)
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    tokens = (args.batch * args.seq if arm == "fsdp_tp"
              else args.gpt_batch * args.gpt_seq)
    out.update(ms=ms, loss=losses, flash_launches=dict(fa.launches),
               peak_gib=_peak_gib(torch, dev),
               **_state_bytes(torch, model, opt, _whole(cfg)))
    if hasattr(step, "stage_forwards"):
        from ..parallel.mesh_util import shift_path
        out["stage_forwards"] = step.stage_forwards
        out["shift_path"] = shift_path(mesh.axis("pp"), dev)
    if ms:
        out["tokens_per_s"] = tokens / (statistics.median(ms) / 1e3)
    del model, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _whole(cfg):
    """The whole model on the meta device: its shapes alone."""
    import torch
    from ..models.gpt import GPT, GPTConfig
    from ..models.llama import Llama
    cls = GPT if isinstance(cfg, GPTConfig) else Llama
    return cls(cfg, device="meta", generator=torch.Generator())


def spawn(argv, world, env=None, cwd=None):
    """Every rank of a one-node world of ``world`` ranks, each this module
    with ``argv`` and its DMLC_*/BYTEPS_* environment; returns the
    processes (stdout and stderr joined, text)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        e = dict(os.environ, DMLC_NUM_WORKER="1", DMLC_WORKER_ID="0",
                 BYTEPS_LOCAL_SIZE=str(world), BYTEPS_LOCAL_RANK=str(rank),
                 DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port))
        e.update(env or {})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.tools.model_parallel"]
            + list(argv), env=e, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arms", nargs="+", choices=ARMS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--model", choices=("full", "tiny"), default="full")
    ap.add_argument("--layers", type=int, default=4,
                    help="Llama-3-8B layers (fsdp_tp)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each Llama block (fsdp_tp)")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--gpt-seq", type=int, default=1024)
    ap.add_argument("--gpt-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many ranks and wait for them")
    args = ap.parse_args(argv)
    if args.spawn:
        rest = list(sys.argv[1:] if argv is None else argv)
        i = rest.index("--spawn")
        del rest[i:i + 2]
        procs = spawn(rest, args.spawn)
        rc = 0
        for p in procs:
            sys.stdout.write(p.communicate()[0])
            rc = rc or p.returncode
        return rc

    import torch
    from ..comm.mesh import bootstrap, resolve_device
    from ..common.config import Config
    cfg = Config.from_env()
    comm = bootstrap(cfg, resolve_device(args.device, cfg.local_rank),
                     backend=args.backend)
    lcfg, gcfg = _configs(args)
    res = {"arms": {}}
    try:
        t0 = time.perf_counter()
        for arm in args.arms:
            t = time.perf_counter()
            res["arms"][arm] = run_arm(torch, args, comm, arm, lcfg, gcfg)
            res["arms"][arm]["seconds"] = time.perf_counter() - t
        res.update(rank=comm.rank, world=comm.size, backend=comm.backend,
                   device=_device_line(), seconds=time.perf_counter() - t0)
    finally:
        comm.close()
    print("MP_RESULT " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
