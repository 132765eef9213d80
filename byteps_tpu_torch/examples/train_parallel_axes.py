"""Train a small GPT with a sharded optimizer: ZeRO-1 or FSDP; port of
the ``zero`` and ``fsdp`` modes of ``example/jax/train_parallel_axes.py``.

Sharded-optimizer data parallelism over every rank (``parallel/zero.py``):
the f32 master vector and the Adam moments live 1/R a rank; ``fsdp``
also keeps the parameters only sharded between steps.  One process is one
rank, at any world size (alone, or under bpslaunch).

    python -m byteps_tpu_torch.examples.train_parallel_axes --mode zero
    python -m byteps_tpu_torch.examples.train_parallel_axes --mode fsdp --device cpu

The script's other modes have their own entry points in the port, which
run one process a rank over a mesh of processes:
``python -m byteps_tpu_torch.tools.model_parallel tp|pp|3d`` and
``python -m byteps_tpu_torch.tools.long_context ep``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

OTHER_MODES = {"tp": "tools.model_parallel tp", "pp": "tools.model_parallel pp",
               "3d": "tools.model_parallel 3d", "ep": "tools.long_context ep"}


def run(comm, mode: str, steps: int, batch: int, seq: int):
    """``steps`` steps of the JAX script's GPT (vocabulary 512, hidden
    64, 4 layers of 4 heads, f32, Adam 1e-2) on a global batch of
    ``batch`` sequences from seed 0, each rank on its rows.  Returns the
    losses (each the mean over ranks)."""
    import torch

    from ..models.gpt import GPT, GPTConfig, lm_loss
    from ..parallel import zero
    from ..parallel.data_parallel import shard_batch
    from ..parallel.long_context import synthetic_lm_batch
    cfg = GPTConfig(vocab_size=512, hidden_size=64, num_layers=4,
                    num_heads=4, intermediate_size=128, max_position=256,
                    dtype=torch.float32)
    model = GPT(cfg, device=comm.device,
                generator=torch.Generator(device=comm.device).manual_seed(0))
    data = shard_batch(comm, synthetic_lm_batch(
        torch.Generator().manual_seed(0), cfg, batch, seq))
    zstate = zero.init_zero_state(
        comm, model, lambda ps: torch.optim.Adam(ps, lr=1e-2))

    def loss_fn(m, b):
        return lm_loss(m(b["input_ids"]), b["labels"])

    make = (zero.make_zero_train_step if mode == "zero"
            else zero.make_fsdp_train_step)
    step = make(comm, model, loss_fn)
    return [float(step(zstate, data)) for _ in range(steps)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["tp", "pp", "ep", "zero", "fsdp",
                                       "3d"], default="zero")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--inner", type=int, default=0,
                    help="size of the tp/pp/ep axis (0 = largest of "
                         "4/2/1 that divides the world size); reported only")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode in OTHER_MODES:
        print(f"--mode {args.mode} runs as python -m byteps_tpu_torch."
              f"{OTHER_MODES[args.mode]}", file=sys.stderr)
        return 2

    from ..comm.mesh import bootstrap, resolve_device
    from ..common.config import Config
    cfg = Config.from_env()
    comm = bootstrap(cfg, resolve_device(args.device, cfg.local_rank))
    try:
        t0 = time.perf_counter()
        n = comm.size
        inner = args.inner or max(d for d in (4, 2, 1) if n % d == 0)
        losses = run(comm, args.mode, args.steps, args.batch, args.seq)
        if not math.isfinite(losses[-1]):
            raise RuntimeError(f"non-finite loss {losses[-1]}")
        if comm.rank == 0:
            print(json.dumps({
                "mode": args.mode, "n_devices": n, "inner_axis": inner,
                "first_loss": round(losses[0], 4),
                "last_loss": round(losses[-1], 4),
                "wall_s": round(time.perf_counter() - t0, 2)}), flush=True)
    finally:
        comm.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
