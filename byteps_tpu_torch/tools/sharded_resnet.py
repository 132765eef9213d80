"""ResNet-50 trained at R ranks through ``DistributedOptimizer`` with and
without ``sharded_update``: each rank's optimizer-state bytes and wire
bytes per leg, and how far the two arms' parameters are apart.

    # 4 ranks, one card each (one process per card)
    python -m byteps_tpu_torch.tools.sharded_resnet --ranks 4
    # a rehearsal on the CPU over gloo, at a small image
    python -m byteps_tpu_torch.tools.sharded_resnet --ranks 2 \\
        --device cpu --batch 2 --image 64

Every rank builds the same seeded model and trains two copies of it on
its own seeded batch with SGD(momentum=0.9) (foreach pinned): the first
through the sharded update, the second through the replicated one, which
takes the first copy's raw gradients of each step through autograd (a
backward of its leaves), so the two see the same gradients whatever
cuDNN's determinism.  Each rank prints one JSON line: its slots' state
bytes (master and momentum, 1/R of the model's each), its two inner
optimizers' state bytes, the wire bytes per step of each leg of the
sharded arm (push N, pull N/R), its median step and the largest
difference between the two arms' parameters.  The run fails if a rank
fails, if the sharded arm's inner optimizer holds state, or if the
parameters differ by more than ``--rtol`` (at more than two ranks the
reduce-scatter and the all-reduce may add the ranks in other orders).
"""

import argparse
import copy
import json
import os
import socket
import statistics
import subprocess
import sys
import time


def rank_main(args):
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.models import resnet

    cfg = Config.from_env()
    cfg.sharded_update = True
    bps.init(cfg, device=args.device)
    eng, dev, R = api.engine(), api.device(), api.size()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    a = resnet.resnet50(num_classes=1000,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    b = copy.deepcopy(a)
    batch = resnet.synthetic_images(
        torch.Generator().manual_seed(10 + api.rank()), args.batch,
        args.image, 1000, dev)
    sgd = {"lr": 0.1, "momentum": 0.9, "foreach": True}
    inner_a = torch.optim.SGD(a.parameters(), **sgd)
    opt_a = bps.DistributedOptimizer(
        inner_a, named_parameters=[(f"sharded.{n}", p)
                                   for n, p in a.named_parameters()],
        sharded_update=True)
    inner_b = torch.optim.SGD(b.parameters(), **sgd)
    opt_b = bps.DistributedOptimizer(
        inner_b, named_parameters=[(f"replicated.{n}", p)
                                   for n, p in b.named_parameters()],
        sharded_update=False)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    wire, step_ms = [], []
    for i in range(1 + args.steps):
        before = (eng.stats["wire_push"], eng.stats["wire_pull"])
        sync()
        t0 = time.perf_counter()
        opt_a.zero_grad()
        loss = torch.nn.functional.cross_entropy(a(batch["images"]),
                                                 batch["labels"])
        loss.backward()
        opt_a.step()
        sync()
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        wire.append((eng.stats["wire_push"] - before[0],
                     eng.stats["wire_pull"] - before[1]))
        if not torch.isfinite(loss):
            raise RuntimeError(f"loss {loss.item()} at step {i}")
        opt_b.zero_grad()
        torch.autograd.backward(list(b.parameters()),
                                [p.grad for p in a.parameters()])
        opt_b.step()
    sync()

    def state_bytes(opt):
        return sum(v.numel() * v.element_size() for st in opt.state.values()
                   for v in st.values() if torch.is_tensor(v))

    worst, equal = 0.0, 0
    for p, q in zip(a.parameters(), b.parameters()):
        d = (p.detach() - q.detach()).abs().max().item()
        rel = d / max(q.detach().abs().max().item(), 1e-30)
        worst = max(worst, rel)
        equal += int(torch.equal(p, q))
    nbytes = sum(p.numel() * p.element_size() for p in a.parameters())
    out = {
        "rank": api.rank(), "world": R,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "param_bytes": nbytes,
        "slot_state_bytes": sum(s.state_nbytes()
                                for s in eng.update_slots.values()),
        "sharded_inner_state_bytes": state_bytes(inner_a),
        "replicated_inner_state_bytes": state_bytes(inner_b),
        "wire_per_step": wire[-1], "median_step_ms":
            statistics.median(step_ms), "step_ms": step_ms,
        "params_bit_equal": equal, "params": len(list(a.parameters())),
        "max_rel_diff": worst,
    }
    bps.shutdown()
    print("SHARDED_RESNET " + json.dumps(out), flush=True)
    if out["sharded_inner_state_bytes"] or worst > args.rtol:
        raise SystemExit(f"rank {out['rank']}: inner state "
                         f"{out['sharded_inner_state_bytes']} B, max rel "
                         f"diff {worst}")


def spawn(args):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(args.ranks):
        env = dict(os.environ, DMLC_NUM_WORKER="1", DMLC_WORKER_ID="0",
                   BYTEPS_LOCAL_SIZE=str(args.ranks),
                   BYTEPS_LOCAL_RANK=str(rank),
                   DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.tools.sharded_resnet",
             "--rank-main", "--device", args.device, "--steps",
             str(args.steps), "--batch", str(args.batch), "--image",
             str(args.image), "--rtol", str(args.rtol)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    rc = 0
    for rank, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        lines = [ln for ln in log.splitlines()
                 if ln.startswith("SHARDED_RESNET ")]
        print("\n".join(lines) if lines and p.returncode == 0
              else f"rank {rank} rc={p.returncode}:\n{log[-4000:]}",
              flush=True)
        rc = rc or p.returncode
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--rtol", type=float, default=1e-4)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--rank-main", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_main:
        rank_main(args)
        return 0
    return spawn(args)


if __name__ == "__main__":
    sys.exit(main())
