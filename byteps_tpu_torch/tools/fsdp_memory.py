"""Memory of the port's two FSDP designs; port of ``tools/fsdp_memory.py``.

``parallel/zero.py``'s flat FSDP gathers the whole parameter vector each
step, so its transient peak holds every parameter at once;
``parallel/fsdp_tp.py`` (here at tp 1, pure fsdp) gathers each block's
weights where they are used and, under remat, again in the backward.
Both train the JAX tool's Llama (hidden 512, 8 layers, 4 heads, SwiGLU
2048, vocabulary 256, f32, remat) on a batch of 8 x 64 tokens, over two
ranks joined as ``tools/model_parallel.py`` joins them.

Reported per rank, under the JAX tool's keys (``gspmd_fsdp`` is the
per-block design, which the JAX package gets from GSPMD):

- ``n_params`` and ``param_bytes_f32``, as the JAX tool counts them;
- per design ``arg_bytes``, the state the rank keeps between steps
  (parameters and optimizer state), and on CUDA ``temp_bytes``, the
  peak of ``torch.cuda.max_memory_allocated`` over a step above what
  was allocated before it (None on the CPU, which has no such counter);
- ``temp_ratio_flat_over_gspmd`` on CUDA.

    python -m byteps_tpu_torch.tools.fsdp_memory --spawn 2 --backend gloo
    python -m byteps_tpu_torch.tools.fsdp_memory --spawn 2 --device cpu

``--backend gloo`` puts both ranks on one card (NCCL refuses two ranks
of a communicator on one device).  Each rank prints ``FSDP_RESULT
{json}``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

SEED = 0
BATCH, SEQ = 8, 64


def llama_config():
    import torch
    from ..models.llama import LlamaConfig
    return LlamaConfig(vocab_size=256, hidden_size=512, num_layers=8,
                       num_heads=4, num_kv_heads=4, intermediate_size=2048,
                       max_position=128, dtype=torch.float32, remat=True)


def n_params(cfg) -> int:
    import torch
    from ..models.llama import Llama
    model = Llama(cfg, device="meta", generator=torch.Generator())
    return sum(p.numel() for p in model.parameters())


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev, step, steps):
    """The peak allocation of the last of ``steps`` steps above what was
    allocated before it (CUDA), else None; the earlier steps warm up."""
    import torch
    for _ in range(steps - 1):
        step()
    if dev.type != "cuda":
        step()
        return None
    _sync(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step()
    _sync(dev)
    return int(torch.cuda.max_memory_allocated(dev) - base)


def _tensor_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _opt_state_bytes(opt) -> int:
    import torch
    return _tensor_bytes(v for st in opt.state.values() for v in st.values()
                         if isinstance(v, torch.Tensor))


def measure_flat(comm, cfg, batch, steps):
    import torch
    from ..models.gpt import lm_loss
    from ..models.llama import Llama
    from ..parallel.zero import init_zero_state, make_fsdp_train_step
    dev = comm.device
    model = Llama(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    zstate = init_zero_state(comm, model,
                             lambda ps: torch.optim.SGD(ps, lr=0.1))

    def loss_fn(m, b):
        return lm_loss(m(b["input_ids"]), b["labels"])

    fstep = make_fsdp_train_step(comm, model, loss_fn)
    # the full parameters the model was built with go at the first step;
    # from then on the rank keeps its master shard and optimizer state
    fstep(zstate, batch)
    losses = []
    temp = _peak(dev, lambda: losses.append(float(fstep(zstate, batch))),
                 steps)
    arg = (zstate.master.numel() * zstate.master.element_size()
           + _opt_state_bytes(zstate.optimizer))
    return {"temp_bytes": temp, "arg_bytes": int(arg), "loss": losses[-1]}


def measure_block(comm, cfg, batch, steps):
    import torch
    from ..parallel import fsdp_tp
    dev = comm.device
    mesh = fsdp_tp.make_fsdp_tp_mesh(comm, 1)
    model = fsdp_tp.init_llama_params_sharded(
        mesh, cfg, torch.Generator(device=dev).manual_seed(SEED))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = fsdp_tp.make_fsdp_tp_train_step(mesh, model, opt)
    b = fsdp_tp.shard_llama_batch(mesh, batch)
    step(b)
    losses = []
    temp = _peak(dev, lambda: losses.append(float(step(b))), steps)
    arg = _tensor_bytes(model.parameters()) + _opt_state_bytes(opt)
    return {"temp_bytes": temp, "arg_bytes": int(arg), "loss": losses[-1]}


def run(comm, steps=2) -> dict:
    import torch
    from ..parallel.long_context import synthetic_lm_batch
    cfg = llama_config()
    dev = comm.device
    whole = synthetic_lm_batch(
        torch.Generator(device=dev).manual_seed(SEED + 1), cfg, BATCH, SEQ)
    n = n_params(cfg)
    out = {"n_params": n, "param_bytes_f32": n * 4}
    # the flat step's loss is over this rank's rows of the batch
    rows = BATCH // comm.size
    mine = {k: v[comm.rank * rows:(comm.rank + 1) * rows]
            for k, v in whole.items()}
    out["flat_fsdp"] = measure_flat(comm, cfg, mine, steps)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["gspmd_fsdp"] = measure_block(comm, cfg, whole, steps)
    ft, gt = out["flat_fsdp"]["temp_bytes"], out["gspmd_fsdp"]["temp_bytes"]
    out["temp_ratio_flat_over_gspmd"] = (round(ft / max(1, gt), 2)
                                         if ft is not None else None)
    return out


def spawn(argv, world):
    """Every rank of a one-node world, each this module with ``argv``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, DMLC_NUM_WORKER="1", DMLC_WORKER_ID="0",
                   BYTEPS_LOCAL_SIZE=str(world), BYTEPS_LOCAL_RANK=str(rank),
                   DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.tools.fsdp_memory"]
            + list(argv), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many ranks and wait for them")
    args = ap.parse_args(argv)
    if args.spawn:
        rest = list(sys.argv[1:] if argv is None else argv)
        i = rest.index("--spawn")
        del rest[i:i + 2]
        rc = 0
        for p in spawn(rest, args.spawn):
            sys.stdout.write(p.communicate()[0])
            rc = rc or p.returncode
        return rc
    from ..comm.mesh import bootstrap, resolve_device
    from ..common.config import Config
    from ._bench_util import conditions_block
    cfg = Config.from_env()
    comm = bootstrap(cfg, resolve_device(args.device, cfg.local_rank),
                     backend=args.backend)
    try:
        out = run(comm, args.steps)
        out.update(rank=comm.rank, world=comm.size, backend=comm.backend,
                   conditions=conditions_block(device=comm.device))
    finally:
        comm.close()
    print("FSDP_RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
