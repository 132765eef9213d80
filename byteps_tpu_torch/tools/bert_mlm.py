"""BERT-large MLM trained through the fused data-parallel step on the
card: the port's counterpart of ``bench.py``'s ``_bench_train_step``.

    python -m byteps_tpu_torch.tools.bert_mlm              # one card
    python -m byteps_tpu_torch.tools.bert_mlm --compress onebit
    # a rehearsal on the CPU at bert_tiny
    python -m byteps_tpu_torch.tools.bert_mlm --device cpu --model tiny \\
        --seq 32 --batch 2 --steps 2

BERT-large (24 layers, hidden 1024, vocab 30528; bf16 compute over f32
parameters; weights from the seed), sequence 128, 32 examples a rank
drawn by ``synthetic_batch`` from the seed, the gathered MLM head, AdamW
(lr 1e-4, weight decay 1e-4: optax.adamw's defaults) through
``make_dp_train_step``; batches reach the card through
``ShardedBatchLoader`` (pinned copies on a side stream).  3 warm-up
steps, then the better of two timed runs of ``--steps`` steps, each
ended by a synchronize.  With ``--compress onebit`` every gradient takes
``hierarchical_push_pull`` with ``make_onebit_pair()`` on its cross-node
hop (at one node the onebit kernels still run: the hop is the pair's
compress, a gather over the one node and the merge).  ``--plain`` is the
yardstick: the same forward, backward and AdamW with no push_pull.
``--profile`` adds one more step under ``torch.profiler`` (the card's
activity only): its wall ms, the device's busy ms (the union of its
kernels' intervals), the kernels launched and the five that take the
most device time.

Prints one JSON line: ``metric``, ``value`` (examples/s a rank),
``unit``, ``mfu`` (6 N T FLOPs an example over the card's dense bf16
peak, ``PEAK_BF16_FLOPS``, named in ``peak`` beside the card's
``nvidia-smi`` name and power limit), ``n_params``, ``seq_len``,
``per_dev_batch``, ``ranks``, ``step_ms``, ``loss``, ``compress`` and
``plain``, ``profile`` and ``device``.  One process drives one card;
more ranks are more processes with the DMLC_*/BYTEPS_* environment of
``comm/mesh.py``, each printing its line.
"""

import argparse
import json
import subprocess
import sys
import time

# NVIDIA's data sheet, H100 SXM, dense bf16 (no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_NAME = "H100 SXM dense bf16, 989 TFLOP/s at 700 W"


def smi_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def build(comm, cfg, per_dev_batch, seq_len, compress=None, seed=0,
          remat=False, plain=False):
    """The model, its AdamW, the fused step (``plain``: the local step,
    no push_pull) and one global host batch (``per_dev_batch *
    comm.size`` examples), all from ``seed``."""
    import dataclasses

    import torch

    from ..models import bert
    from ..ops.collective_ops import make_onebit_pair
    from ..parallel import make_dp_train_step, replicate

    cfg = dataclasses.replace(cfg, remat=remat)
    dev = comm.device
    model = bert.BertForMLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    replicate(comm, model)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)

    def loss_fn(m, b):
        logits = m(b["input_ids"], b["attention_mask"],
                   masked_positions=b["masked_positions"])
        return bert.mlm_loss(logits, b["masked_labels"])

    if plain:
        def step(b):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, b)
            loss.backward()
            opt.step()
            return loss.detach()
    else:
        pair = make_onebit_pair() if compress == "onebit" else None
        step = make_dp_train_step(comm, model, loss_fn, opt,
                                  compress_dcn=pair)
    batch = bert.synthetic_batch(torch.Generator().manual_seed(seed + 1),
                                 cfg, per_dev_batch * comm.size, seq_len)
    return model, opt, step, batch


def timed_steps(torch, comm, step, batch, k):
    """``k`` steps fed by ``ShardedBatchLoader``; (seconds, last loss)."""
    from ..utils.prefetch import ShardedBatchLoader
    sync = (torch.cuda.synchronize if comm.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    loss = None
    for b in ShardedBatchLoader(comm, [batch] * k):
        loss = step(b)
    lv = float(loss)
    sync()
    return time.perf_counter() - t0, lv


def profile_step(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``, the card's activity
    only: wall ms (host clock, ended by a synchronize), busy ms (the union
    of the kernels' and copies' intervals), their count, and the five
    names with the most device ms."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    by_name = Counter()
    for e in events:
        by_name[e.name[:60]] += (e.time_range.end - e.time_range.start) / 1e3
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "kernels": len(events),
            "top_ms": by_name.most_common(5)}


def run(args) -> dict:
    import math

    import torch

    from ..common.config import Config
    from ..comm.mesh import bootstrap, resolve_device
    from ..models import bert

    cfg = Config.from_env()
    comm = bootstrap(cfg, resolve_device(args.device, cfg.local_rank))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        mcfg = {"large": bert.bert_large, "tiny": bert.bert_tiny}[
            args.model]()
        model, _, step, batch = build(comm, mcfg, args.batch, args.seq,
                                      args.compress, remat=args.remat,
                                      plain=args.plain)
        n_params = sum(p.numel() for p in model.parameters())
        timed_steps(torch, comm, step, batch, args.warmup)
        dt, lv = min(timed_steps(torch, comm, step, batch, args.steps)
                     for _ in range(2))
        if not math.isfinite(lv):
            raise RuntimeError(f"non-finite loss {lv}")
        per_rank = args.steps * args.batch / dt
        on_card = comm.device.type == "cuda"
        prof = None
        if args.profile and on_card:
            from ..parallel import shard_batch
            b = shard_batch(comm, batch)
            prof = profile_step(torch, lambda: step(b))
        mfu = (per_rank * 6.0 * n_params * args.seq / PEAK_BF16_FLOPS
               if on_card else None)
        return {
            "metric": f"bert_{args.model}_mlm_train_throughput_per_gpu",
            "value": per_rank, "unit": "examples/s", "mfu": mfu,
            "peak": PEAK_NAME if on_card else None,
            "card": smi_line() if on_card else None,
            "n_params": n_params, "seq_len": args.seq,
            "per_dev_batch": args.batch, "ranks": comm.size,
            "step_ms": dt / args.steps * 1e3, "loss": lv,
            "compress": args.compress or "none", "remat": args.remat,
            "plain": args.plain, "profile": prof,
            "device": (torch.cuda.get_device_name(comm.device) if on_card
                       else "cpu")}
    finally:
        comm.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=("large", "tiny"),
                    default="large")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32,
                    help="examples a rank")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--compress", choices=("onebit",), default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--plain", action="store_true",
                    help="no push_pull: the local step, the yardstick")
    ap.add_argument("--profile", action="store_true",
                    help="one more step under torch.profiler")
    args = ap.parse_args(argv)
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
