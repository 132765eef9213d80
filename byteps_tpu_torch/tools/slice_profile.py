"""Where the time of the port's main path goes, on one NVIDIA card.

    python -m byteps_tpu_torch.tools.slice_profile --out DIR

ResNet-50 at full width (1000 classes, 224x224 NHWC, bf16 compute,
batch 32, seeded synthetic data) takes SGD(momentum=0.9) steps in three
arms, one after another in one process on one card:

- ``plain``: torch.optim.SGD alone, no engine (the model's own time);
- ``allreduce``: DistributedOptimizer, every gradient all-reduced;
- ``onebit_ef``: DistributedOptimizer with onebit + error feedback
  (tensors of at least BYTEPS_MIN_COMPRESS_BYTES compressed), the path
  chip_smoke.py drives.

Each arm reports its mean over STEPS steps after 2 warm-up steps (host
clock around steps that end in ``torch.cuda.synchronize()``).  Then two
``onebit_ef`` steps run under ``torch.profiler``: device time by kernel
class, the device's busy share of the window, and the top kernels.  The
trace goes to ``DIR``.  The last line of standard output is one JSON
summary.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
STEPS = 5
CLASSES = (  # kernel-name substrings -> class, first match wins
    ("onebit", ("pack_kernel", "unpack_kernel", "unpack_sum_kernel")),
    ("nccl", ("nccl",)),
    ("batch_norm", ("batchnorm", "batch_norm", "welford")),
    ("conv/gemm", ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90")),
)


def _classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _arm(bps, resnet, dev, arm: str):
    gen = torch.Generator().manual_seed(0)
    model = resnet.resnet50(generator=gen).to(dev)
    batch = resnet.synthetic_images(gen, 32, 224, 1000, dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if arm != "plain":
        # names per arm: a name keeps the codec of its first push
        opt = bps.DistributedOptimizer(
            opt, named_parameters=[(f"{arm}.{n}", p)
                                   for n, p in model.named_parameters()],
            compression=ONEBIT_EF if arm == "onebit_ef" else None)

    def step():
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(batch["images"]),
                                                 batch["labels"])
        loss.backward()
        opt.step()
        return loss

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(loss):
        raise RuntimeError(f"{arm}: loss {loss.item()} is not finite")
    return step, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory for the profiler trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("slice_profile: needs an NVIDIA card")
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.models import resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    bps.init()
    dev = api.device()
    summary = {"card": card.splitlines()[0], "step_ms": {}}
    for arm in ("plain", "allreduce", "onebit_ef"):
        step, times = _arm(bps, resnet, dev, arm)
        summary["step_ms"][arm] = sum(times) / len(times)
        print(f"{arm}: steps {[round(t, 2) for t in times]} ms, mean "
              f"{summary['step_ms'][arm]:.2f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile
    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, "slice_profile_trace.json")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    window_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(trace_path)
    bps.shutdown()

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_class, by_name = {}, {}
    for e in kernels:
        c = _classify(e["name"])
        by_class[c] = by_class.get(c, 0.0) + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    summary.update({
        "profiled_steps": 2, "window_ms": window_us / 1e3,
        "kernels": len(kernels), "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / window_us if window_us else 0.0,
        "device_ms_by_class": {k: v / 1e3 for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])}})
    print(f"profiled 2 onebit_ef steps: window {window_us / 1e3:.2f} ms, "
          f"{len(kernels)} kernels, device busy {busy / 1e3:.2f} ms "
          f"({100 * summary['device_busy_share']:.1f}%)")
    for k, v in summary["device_ms_by_class"].items():
        print(f"  {k}: {v:.2f} ms")
    for name, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {dur / 1e3:8.3f} ms  {name[:110]}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
