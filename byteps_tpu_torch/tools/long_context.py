"""Long-context and mixture-of-experts GPT training over sequence- and
expert-parallel layouts: the port's counterpart of
``example/jax/train_long_context.py`` and of the ``ep`` mode of
``example/jax/train_parallel_axes.py``.

    # every rank: one process with the DMLC_*/BYTEPS_* environment
    python -m byteps_tpu_torch.tools.long_context sp --kinds ring,ulysses
    python -m byteps_tpu_torch.tools.long_context ep
    # all ranks from one command (their output interleaved)
    python -m byteps_tpu_torch.tools.long_context sp --spawn 2
    # a rehearsal on the CPU
    python -m byteps_tpu_torch.tools.long_context sp --spawn 2 \\
        --device cpu --model tiny --seq 128 --steps 1 --check

``sp``: GPT-small (hidden 512, 8 layers, 8 heads of 64, ffn 2048, vocab
32768, bf16 compute over f32 parameters; weights from a fixed seed) trained
by ``make_dp_sp_train_step`` over ``(dp 1, sp world)`` on ``--batch``
sequences of ``--seq`` tokens (``synthetic_lm_batch`` from the seed),
AdamW 3e-4, one arm per attention kind of ``--kinds``, each from the
same weights: a first step, then ``--steps`` timed steps.  With
``--check``, rank 0 also takes one step of the whole sequence on one rank
with ``attention="flash"`` on the same weights and batch; after each
arm's first step every rank's gradients (summed over the world) go to
rank 0, which holds them against that step's: the largest share of a
tensor's max-abs by which any element differs.  ``--control-qoff0`` adds
the arm ``ring_flash_qoff0``, ``ring_flash`` with the off-diagonal
blocks given ``q_off = 0`` (a wrong causal mask), whose share must be
large.

``ep``: GPT-small width with 8 switch experts every 2nd block
(capacity 1.25) trained by ``make_moe_lm_train_step`` over ``(dp 1, ep
world)``, each rank holding ``experts / world`` of each stack, on
``--batch`` sequences of ``--seq`` tokens split over the ranks, AdamW
3e-4: a first step, then ``--steps`` timed steps.  With ``--check`` each
rank first holds the layout's forward (logits and the switch blocks' aux
losses) against the model with the full expert stacks on its own rows.

``--backend`` names the process group's backend: gloo runs several ranks
on one card (NCCL refuses two ranks of a communicator on one device).
Each rank prints one line ``LC_RESULT {json}``: the card's ``nvidia-smi``
name and power limit, the shift path of the ring, and per arm the first
loss, each timed step's ms and loss, tokens/s (the world's tokens a step
over the median step), the flash kernels' launches over the timed steps
(their counts zeroed just before), and the check's numbers.
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

KINDS = ("ring", "striped", "ring_flash", "ulysses", "ulysses_flash")
LR = 3e-4
SEED = 0
EXPERTS = 8


def _device_line() -> str:
    """``nvidia-smi``'s name and power limit, where there is one."""
    from .bert_mlm import smi_line
    try:
        return smi_line()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flat_grads(torch, model):
    """Every parameter's gradient as one f32 vector on the host, in
    ``named_parameters`` order, and the (name, numel) of each."""
    names = [(n, p.numel()) for n, p in model.named_parameters()]
    flat = torch.cat([p.grad.reshape(-1).float()
                      for _, p in model.named_parameters()]).cpu()
    return flat, names


def grad_share(torch, got, want, names):
    """The largest, over tensors, of a tensor's max |got - want| over its
    max |want|; and the tensor where it is."""
    worst, where, off = 0.0, None, 0
    for name, n in names:
        g, w = got[off:off + n], want[off:off + n]
        off += n
        share = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        if share > worst:
            worst, where = share, name
    return worst, where


def reference_step(torch, model, data, fa):
    """One rank, the whole sequence, ``attention="flash"``: the loss and
    the gradients of the global mean NLL, then the gradients cleared."""
    from ..models.gpt import lm_loss
    from ..parallel.long_context import set_attention
    from ..parallel.sequence import resolve_sp_attention
    set_attention(model, resolve_sp_attention("flash"))
    model.zero_grad(set_to_none=True)
    loss = lm_loss(model(data["input_ids"]), data["labels"])
    loss.backward()
    flat, names = _flat_grads(torch, model)
    model.zero_grad(set_to_none=True)
    return loss.item(), flat, names


def _arm(torch, args, mesh, model, init_state, data, kind, ref, fa):
    import torch.distributed as dist
    from ..parallel import ring_flash
    from ..parallel.long_context import make_dp_sp_train_step, shard_lm_batch
    model.load_state_dict(init_state)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    opt = torch.optim.AdamW(model.parameters(), lr=LR)
    control = kind == "ring_flash_qoff0"
    saved = ring_flash._q_offset
    if control:
        ring_flash._q_offset = lambda my, src, t_local, causal: 0
    try:
        step = make_dp_sp_train_step(mesh, model, opt,
                                     attention="ring_flash" if control
                                     else kind)
        shard = shard_lm_batch(mesh, data, striped=kind == "striped")
        got = {}

        def capture(o, a, k):
            got["flat"], got["names"] = _flat_grads(torch, model)

        hook = opt.register_step_pre_hook(capture)
        out = {"first_loss": step(shard).item()}
        hook.remove()
    finally:
        ring_flash._q_offset = saved
    if args.check:
        # gloo takes no CUDA tensor in send/recv (``mesh_util.shift_path``),
        # NCCL only CUDA tensors
        wire = (mesh.device if dist.get_backend() == "nccl"
                else torch.device("cpu"))
        if mesh.rank == 0:
            ref_loss, ref_flat, names = ref
            shares = [grad_share(torch, got["flat"], ref_flat, names)]
            buf = torch.empty_like(got["flat"], device=wire)
            for r in range(1, mesh.size):
                dist.recv(buf, src=r)
                shares.append(grad_share(torch, buf.cpu(), ref_flat, names))
            out["grad_share_by_rank"] = [s for s, _ in shares]
            out["grad_share_where"] = [w for _, w in shares]
            out["ref_loss"] = ref_loss
        else:
            dist.send(got["flat"].to(wire), dst=0)
    if control:
        return out
    ms, losses = [], []
    fa.reset_launches()
    for _ in range(args.steps):
        _sync(torch, mesh.device)
        t0 = time.perf_counter()
        loss = step(shard)
        _sync(torch, mesh.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    out.update(ms=ms, loss=losses, flash_launches=dict(fa.launches),
               peak_gib=_peak_gib(torch, mesh.device))
    if ms:
        out["tokens_per_s"] = (args.batch * args.seq
                               / (statistics.median(ms) / 1e3))
    return out


def _peak_gib(torch, dev):
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30


def run_sp(torch, args, comm):
    from ..models.gpt import GPT, gpt_small, gpt_tiny
    from ..ops import flash_attention as fa
    from ..parallel.long_context import replicate, synthetic_lm_batch
    from ..parallel.mesh_util import shift_path
    from ..parallel.sequence import make_sp_mesh
    mesh = make_sp_mesh(comm)
    dev = comm.device
    cfg = gpt_small() if args.model == "small" else gpt_tiny()
    model = GPT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(SEED))
    replicate(mesh, model)
    init_state = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
    data = synthetic_lm_batch(
        torch.Generator(device=dev).manual_seed(SEED + 1), cfg,
        args.batch, args.seq)
    ref = None
    if args.check and comm.rank == 0:
        ref = reference_step(torch, model, data, fa)
        model.load_state_dict(init_state)
    kinds = list(args.kinds.split(","))
    if args.control_qoff0:
        kinds.append("ring_flash_qoff0")
    arms = {}
    for kind in kinds:
        arms[kind] = _arm(torch, args, mesh, model, init_state, data, kind,
                          ref, fa)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"mode": "sp", "shift_path": shift_path(mesh.axis("sp"), dev),
            "arms": arms}


def _share(torch, got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def run_ep(torch, args, comm):
    from ..models.gpt import GPT, gpt_small, gpt_tiny
    from ..ops import flash_attention as fa
    from ..parallel.expert import make_ep_mesh
    from ..parallel.long_context import synthetic_lm_batch
    from ..parallel.moe_lm import make_moe_lm_train_step, shard_moe_lm_batch
    mesh = make_ep_mesh(comm, comm.size)
    dev = comm.device
    base = gpt_small() if args.model == "small" else gpt_tiny()
    cfg = dataclasses.replace(base, moe_experts=EXPERTS, moe_every=2,
                              moe_capacity=1.25)

    def build(ep_axis):
        return GPT(cfg, attn_fn=fa.flash_attention, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(
                       SEED), ep_axis=ep_axis)

    model = build(mesh.axis("ep"))
    data = synthetic_lm_batch(
        torch.Generator(device=dev).manual_seed(SEED + 1), cfg,
        args.batch, args.seq)
    shard = shard_moe_lm_batch(mesh, data)
    out = {"mode": "ep", "experts_here": model.h[1].moe.w1.shape[0],
           "tokens_here": shard["input_ids"].numel()}
    if args.check:
        full = build(None)
        with torch.no_grad():
            logits = model(shard["input_ids"])
            aux = torch.stack(model.moe_aux_losses())
            ref_logits = full(shard["input_ids"])
            ref_aux = torch.stack(full.moe_aux_losses())
        out["logit_share"] = _share(torch, logits, ref_logits)
        out["aux"] = aux.tolist()
        out["ref_aux"] = ref_aux.tolist()
        out["aux_rel"] = ((aux - ref_aux).abs().max()
                          / ref_aux.abs().max()).item()
        del full, logits, ref_logits
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    opt = torch.optim.AdamW(model.parameters(), lr=LR)
    step = make_moe_lm_train_step(mesh, model, opt)
    out["first_loss"] = step(shard).item()
    ms, losses = [], []
    fa.reset_launches()
    for _ in range(args.steps):
        _sync(torch, dev)
        t0 = time.perf_counter()
        loss = step(shard)
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    out.update(ms=ms, loss=losses, flash_launches=dict(fa.launches),
               peak_gib=_peak_gib(torch, dev))
    if ms:
        out["tokens_per_s"] = (args.batch * args.seq
                               / (statistics.median(ms) / 1e3))
    return out


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
            [sys.executable, "-m", "byteps_tpu_torch.tools.long_context"]
            + list(argv), env=e, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("sp", "ep"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--model", choices=("small", "tiny"), default="small")
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens a sequence (sp: 8192, ep: 1024)")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences a step, over all ranks (sp: 2, ep: 16)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--kinds", default=",".join(KINDS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--control-qoff0", action="store_true")
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many ranks and wait for them")
    args = ap.parse_args(argv)
    if args.seq is None:
        args.seq = 8192 if args.mode == "sp" else 1024
    if args.batch is None:
        args.batch = 2 if args.mode == "sp" else 16
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
    try:
        t0 = time.perf_counter()
        res = (run_sp if args.mode == "sp" else run_ep)(torch, args, comm)
        res.update(rank=comm.rank, world=comm.size, backend=comm.backend,
                   device=_device_line(), seq=args.seq, batch=args.batch,
                   seconds=time.perf_counter() - t0)
    finally:
        comm.close()
    print("LC_RESULT " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
