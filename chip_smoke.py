#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (byteps_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from byteps_tpu_torch/csrc, one nvcc per
   source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's chunk shape and at ragged sizes (words and values
   bit-exact, the scale to rtol 1e-6), then timed with CUDA events against
   its plain version and its device-memory bound;
4. slice: the main path, ResNet-50 at full width (1000 classes, 224x224
   NHWC, bf16 compute, batch 32, seeded synthetic data) trained through
   ``DistributedOptimizer(SGD(momentum=0.9), compression=onebit+ef)`` ->
   the push_pull engine -> NCCL (a world of one) for 1 warm-up and 3
   timed steps.  The kernels' launch counters are zeroed just before and
   read just after; each must show the launches the compressed chunks
   need.  The loss must be finite, and for one compressed and one
   uncompressed parameter the gradient the optimizer received must equal
   the plain path's result (the same codec run on the CPU) on the same
   input.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits non-zero and prints no result.
"""

import collections
import json
import subprocess
import sys
import time

ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BATCH, IMAGE, CLASSES = 32, 224, 1000
TIMED_STEPS = 3

KERNELS = {   # wrapper name -> the Pallas kernel it replaces (def line)
    "onebit_pack": "byteps_tpu/ops/pallas_kernels.py:77",
    "onebit_unpack": "byteps_tpu/ops/pallas_kernels.py:113",
    "onebit_unpack_sum": "byteps_tpu/ops/pallas_kernels.py:142",
}


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    """A failed check fails the run (unlike assert, never compiled out)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


def build_phase(ok, build):
    t0 = time.perf_counter()
    build.build([ok.SOURCE])
    log(f"build: {time.perf_counter() - t0:.2f} s for {ok.SOURCE}")
    for line in build.build_logs.get(ok.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def device_ms(torch, fn, args_list, reps=100):
    """Device time of one call: a sleep kernel holds the stream while the
    host enqueues ``reps`` calls, so the events time the kernels back to
    back and not the host's launch overhead.  Inputs rotate over
    ``args_list`` (more bytes than the 50 MB L2), and the last outputs are
    kept alive so each call writes fresh memory."""
    keep = collections.deque(maxlen=len(args_list))
    for a in args_list:                       # warm-up
        keep.append(fn(*a))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        keep.append(fn(*args_list[i % len(args_list)]))
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(host_s, 1e-3) * 4e9))   # ~2x the enqueue
    start.record()
    for i in range(reps):
        keep.append(fn(*args_list[i % len(args_list)]))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(torch, ok, chunk_numel):
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    err = {k: 0.0 for k in KERNELS}

    def sample(numel):
        x = torch.randn(numel, generator=gen)
        x[::97] = -0.0
        x[5] = 0.0
        return x.to(dev)

    for numel in (chunk_numel, chunk_numel - 12345, 4097, 100):
        x = sample(numel)
        w, s = ok.onebit_pack(x)
        w0, s0 = ok.onebit_pack_plain(x)
        check(torch.equal(w, w0), f"pack words differ at numel={numel}")
        torch.testing.assert_close(s, s0, rtol=1e-6, atol=0)
        err["onebit_pack"] = max(err["onebit_pack"],
                                 float((s - s0).abs().max()))
        out = ok.onebit_unpack(w, s[1:], numel)
        ref = ok.onebit_unpack_plain(w, s[1], numel)
        check(torch.equal(out, ref), f"unpack differs at numel={numel}")
        for R in (1, 8):
            ws = torch.stack([torch.roll(w, r) for r in range(R)])
            ss = (torch.rand(R, generator=gen) + 0.5).to(dev)
            out = ok.onebit_unpack_sum(ws, ss, numel)
            ref = ok.onebit_unpack_sum_plain(ws, ss, numel)
            check(torch.equal(out, ref),
                  f"unpack_sum differs at numel={numel} R={R}")
    torch.cuda.synchronize()
    log(f"kernels: bit-exact against the plain versions at numel "
        f"{chunk_numel}, {chunk_numel - 12345}, 4097, 100 (R=1, 8)")

    # timing at the main path's chunk shape (R = 1: a world of one)
    n = chunk_numel
    L = ok.padded_lanes(n)
    xs = [sample(n) for _ in range(16)]                # 65.5 MB
    packed = [ok.onebit_pack(x) for x in xs]
    wss = [(w[None], s[1:]) for w, s in packed]
    timing = {
        "onebit_pack": (
            lambda x: ok.onebit_pack(x), lambda x: ok.onebit_pack_plain(x),
            [(x,) for x in xs], 4 * n + 4 * L + 8),
        "onebit_unpack": (
            lambda w, s: ok.onebit_unpack(w, s, n),
            lambda w, s: ok.onebit_unpack_plain(w, s[0], n),
            [(w, s[1:]) for w, s in packed], 4 * L + 4 + 4 * n),
        "onebit_unpack_sum": (
            lambda w, s: ok.onebit_unpack_sum(w, s, n),
            lambda w, s: ok.onebit_unpack_sum_plain(w, s, n),
            wss, 4 * L + 4 + 4 * n),
    }
    rows = {}
    for name, (kern, plain, args, nbytes) in timing.items():
        ms = device_ms(torch, kern, args)
        plain_ms = device_ms(torch, plain, args, reps=20)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "max_abs_err": err[name]}
        log(f"  {name}: {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, "
            f"bound {bound_ms * 1e3:.2f} us) at numel {n}")
    return rows


def slice_phase(torch, bps, ok, api, registry, resnet):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bps.init()                                     # NCCL, world of one
    check(bps.size() == 1, f"world of {bps.size()}, expected 1")
    dev = api.device()
    gen = torch.Generator().manual_seed(0)
    model = resnet.resnet50(num_classes=CLASSES, generator=gen).to(dev)
    batch = resnet.synthetic_images(gen, BATCH, IMAGE, CLASSES, dev)
    images, labels = batch["images"], batch["labels"]

    # the raw gradients the optimizer's hooks see (registered first, so
    # they fire before the DistributedOptimizer's hooks)
    watch = {"fc.weight": model.fc.weight, "fc.bias": model.fc.bias}
    raw = {}
    for name, p in watch.items():
        p.register_post_accumulate_grad_hook(
            lambda p, name=name: raw.__setitem__(name, p.grad.clone()))
    opt = bps.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), compression=ONEBIT_EF)

    def step():
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        return loss

    ok.reset_launches()
    t0 = time.perf_counter()
    loss = step()                                  # warm-up
    torch.cuda.synchronize()
    log(f"slice: warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"loss {loss.item():.4f}")
    eng = api.engine()
    step_ms = []
    for i in range(TIMED_STEPS):
        if i == TIMED_STEPS - 1:                   # state before the last
            snap = [(s.wstate, s.sstate) for s in
                    eng.registry.get("torch.grad.fc.weight").compressor]
            snap = [(_cpu(a), _cpu(b)) for a, b in snap]
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(loss)), f"loss {loss.item()} at step {i}")
    launches = dict(ok.launches)
    log(f"slice: steps {[round(t, 2) for t in step_ms]} ms, mean "
        f"{sum(step_ms) / len(step_ms):.2f} ms, loss {loss.item():.4f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    ctxs = [eng.registry.get(n) for n in eng.registry.names_in_declaration_order()]
    comp = [c for c in ctxs if c.compressor]
    chunks = sum(len(c.chunk_bounds) for c in comp)
    steps = 1 + TIMED_STEPS
    want = {"onebit_pack": 2 * chunks * steps,
            "onebit_unpack": 3 * chunks * steps,
            "onebit_unpack_sum": chunks * steps}
    log(f"slice: {len(ctxs)} tensors, {len(comp)} compressed in {chunks} "
        f"chunks, {len(ctxs) - len(comp)} all-reduced; launches {launches} "
        f"over {steps} steps")
    check(launches == want, f"launches {launches}, expected {want}")

    # uncompressed parameter: the all-reduce over one rank is the identity
    bias_got = model.fc.bias.grad.cpu()
    check(torch.equal(bias_got, raw["fc.bias"].cpu()),
          "fc.bias gradient differs from the plain path's")
    # compressed parameter: the same codec chain, plain versions on the CPU
    ctx = eng.registry.get("torch.grad.fc.weight")
    g = raw["fc.weight"].cpu().reshape(-1)
    ref = []
    for (off, ln), (ws, ss) in zip(ctx.chunk_bounds, snap):
        wc = registry.create(ONEBIT_EF, ln)
        sc = registry.create(ONEBIT_EF, ln, for_server=True)
        p, _ = wc.compress(g[off:off + ln], ws)
        y = wc.decompress_sum({k: v[None] for k, v in p.items()})
        p2, _ = sc.compress(y, ss)
        ref.append(sc.decompress(p2))
    got = model.fc.weight.grad.cpu().reshape(-1)
    # rtol: the scale's L1 sum is taken in another order on the card
    torch.testing.assert_close(got, torch.cat(ref), rtol=1e-5, atol=0)
    log(f"slice: fc.weight ({len(ctx.chunk_bounds)} compressed chunks) and "
        f"fc.bias gradients equal the plain path's")
    bps.shutdown()
    return launches, step_ms


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.compression import registry
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.models import resnet
    from byteps_tpu_torch.ops import build
    from byteps_tpu_torch.ops import onebit_kernels as ok

    t_start = time.perf_counter()
    device_phase(torch)
    build_phase(ok, build)
    chunk_numel = Config().partition_bytes // 4        # f32 gradients
    rows = kernel_phase(torch, ok, chunk_numel)
    launches, _ = slice_phase(torch, bps, ok, api, registry, resnet)
    kernels = []
    for name, replaces in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "byteps_tpu_torch/csrc/onebit.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
