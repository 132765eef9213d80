#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (byteps_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from byteps_tpu_torch/csrc (onebit.cu and
   flash_attention.cu), one nvcc per source, all started together, with
   ptxas's register, shared-memory and spill lines (any spill fails the
   run), and each flash kernel's count of tensor-core instructions in
   ``cuobjdump -sass``: every bf16 instance of the forward and the two
   backward kernels must have some;
3. onebit kernels: each against its plain PyTorch version on the card, at
   every chunk size of the ResNet slice (its parameters' sizes cut as the
   engine cuts them under ``Config()``) and at ragged sizes (words and
   values bit-exact, the scale to rtol 1e-6).  The merge (unpack_sum) is
   held in its bits on the pack's own words (R = 1, as on the path) and
   on ``merge_inputs`` at R = 1, 4 and 8: independent random words per
   rank, rank 0's scale 0.0 and the others of mixed magnitude, on which
   a merge in another rank order or one that starts from rank 0's
   product instead of +0.0 differs in bits (both controls are run, and
   must differ).  Then a launch of PyTorch's own (a fill_ of one float)
   is timed back to back, the cost of a kernel that moves nothing, and
   pack, unpack and unpack_sum (R = 1, and R = 4 and 8 on random words)
   are timed with CUDA events at each of those sizes (inputs rotating
   over ROTATE_BYTES, more than the L2) beside their device-memory bound,
   and summed over one ResNet step (2 packs, 3 unpacks and 1 unpack_sum
   per chunk, each at its chunk's size); at the largest chunk all three
   kernels are timed beside their plain versions too;
4. resnet slice: ResNet-50 at full width (1000 classes, 224x224 NHWC,
   bf16 compute, batch 32, seeded synthetic data) trained through
   ``DistributedOptimizer(SGD(momentum=0.9), compression=onebit+ef)`` ->
   the push_pull engine -> NCCL (a world of one) for 1 warm-up and 3
   timed steps.  The onebit launch counters are zeroed just before and
   read just after; each must show the launches the compressed chunks
   need, and the compressed chunks must be the ones phase 3 timed.  The
   loss must be finite, and for one compressed and one uncompressed
   parameter the gradient the optimizer received must equal the plain
   path's result (the same codec run on the CPU) on the same input.  One
   more step runs under torch.profiler: it prints the device's busy share
   and the onebit kernels' device time, and each onebit wrapper call must
   have been one device kernel;
5. flash kernels: the forward, dK/dV and dQ kernels against their plain
   versions on the card (same inputs, the plain lse and delta for both
   backward kernels), f32 and bf16, at the two slice shapes and at ragged
   ones (T=100 with D=48, decode Tq=64 < Tk=256, non-causal, and a ring
   step's q_off=32 with kv_len=100).  The bf16 forward's plain version is
   ``flash_fwd_plain(..., block_k=FWD_BLOCK_K)``, which rounds P to bf16
   against the running max of each 64-wide key tile, where the kernel
   (and the JAX kernel) round it; the exact softmax rounds it against the
   global row max, so it differs from a right kernel on a third of O's
   elements and is used only in the LM slices' logit check.  Tolerances:
   f32 those of the JAX package's flash tests (2e-5 forward and lse, 5e-4
   gradients: sums in another order); the bf16 lse to rtol 1e-5, atol
   1e-4.  bf16 holds each row of each output against that row's max-abs
   (``row_share``, whose floor of 2**-10 of the tensor's max-abs keeps
   rows of cancellation noise from reading as inf), so that small late
   rows cannot hide behind large early ones: all outputs to 2**-6 (two
   bf16 steps of the row's max), and to at most 2**-6 of their elements
   differing at all.  The kernels sum on tensor cores in another order
   than the plain versions, so a P or dS element can round the other way
   and an early causal row of dQ, whose terms nearly cancel, moves by
   more than one step.  A control, the plain versions with P and dS left
   in f32 (the forward's tiled as well; a third of the elements differ),
   must break the bound of every kernel, so the check sees a bf16
   instance that skips those roundings.  A second run of all three
   kernels on the Llama inputs must give the same bits (O and lse too).
   Then each kernel is timed at the Llama slice shape beside its plain
   version, its FLOP bound, and torch's scaled_dot_product_attention (its
   forward for the forward kernel; its forward+backward minus its
   forward, for both backward kernels together), and beside its bound at
   the GPT slice shape;
6. llama slice and gpt slice: Llama-3-8B at full width with 4 of its 32
   layers (batch 2 x 4096 tokens) and GPT-small (batch 1 x 8192 tokens),
   bf16 compute over f32 parameters, attention through ``flash_attention``,
   trained through ``DistributedOptimizer(SGD(momentum=0.9))`` -> the
   engine -> NCCL for 1 warm-up and 3 timed steps.  The flash launch
   counters are zeroed just before and read just after: each kernel must
   have run ``num_layers`` times per step.  The loss must be finite at
   every step, one parameter's received gradient must equal its raw
   gradient (an all-reduce over one rank is the identity), and a forward
   with ``flash_attention`` and one with the exact ``full_attention`` on
   the same weights and batch must agree to 5e-2 of the logits' max-abs
   (bf16 compute through every layer), while two controls on the same
   weights (attention output zeroed for the later half of the positions,
   and everywhere) must not.  Each slice prints its mean
   step, its peak memory and the flash kernels' share of the step
   (``num_layers`` x their device ms at its shape, over the mean step),
   and the device's busy time in one more step under torch.profiler (the
   union of its kernels' intervals, over that step's host-clock time).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits non-zero and prints no result.
"""

import collections
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
BATCH, IMAGE, CLASSES = 32, 224, 1000
TIMED_STEPS = 3
ROTATE_BYTES = 64 << 20          # inputs per timed size: more than the L2
# the merge's check inputs: rank r's scale is MERGE_SCALES[r % 8], rank 0's
# 0.0, the others of mixed magnitude (see merge_inputs)
MERGE_SCALES = (0.0, 0.1, 1.0, 0.7, 3e-8, 7.25, 1 / 3, 2.2e-3)
MERGE_RANKS = (1, 4, 8)          # unpack_sum checked and timed at these R

KERNELS = {   # wrapper name -> the Pallas kernel it replaces (def line)
    "onebit_pack": "byteps_tpu/ops/pallas_kernels.py:77",
    "onebit_unpack": "byteps_tpu/ops/pallas_kernels.py:113",
    "onebit_unpack_sum": "byteps_tpu/ops/pallas_kernels.py:142",
}
# the device kernels of csrc/onebit.cu, by name
ONEBIT_KERNEL_RE = re.compile(r"\b(pack|unpack|unpack_sum)_kernel\b")
# the backward's two kernels are two pallas_call sites of _bwd_impl (:255)
FLASH_KERNELS = {
    "flash_fwd": "byteps_tpu/ops/flash_attention.py:115",
    "flash_bwd_dkv": "byteps_tpu/ops/flash_attention.py:265",
    "flash_bwd_dq": "byteps_tpu/ops/flash_attention.py:294",
}
# matrix products of [Tq, Tk] x D per kernel, 2 FLOPs per multiply-add
FLASH_PRODUCTS = {"flash_fwd": 2, "flash_bwd_dkv": 4, "flash_bwd_dq": 3}
# (forward, gradients); see the module docstring
FLASH_F32_TOL = (2e-5, 5e-4)      # allclose rtol = atol
FLASH_BF16_TOL = (                # (row_share, share of elements differing)
    (2**-6, 2**-6),               # forward, against the tiled reference
    (2**-6, 2**-6),               # gradients
)
FLASH_LSE_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 1e-4)}
ROW_FLOOR = 2**-10                # of the tensor's max-abs, in row_share
# (name, shape [B, Tq, Tk, H, D], causal[, (q_off, kv_len)]) of the flash
# checks, each run in f32 and bf16; q_off defaults to Tk - Tq and kv_len
# to Tk, as flash_attention passes them
FLASH_CASES = [
    ("llama", (2, 4096, 4096, 32, 128), True),
    ("gpt", (1, 8192, 8192, 8, 64), True),
    ("ragged_t100_d48", (2, 100, 100, 3, 48), True),
    ("decode_tq64_tk256", (2, 64, 256, 4, 64), True),
    ("noncausal_t130_t70", (2, 130, 70, 4, 128), False),
    ("ring_qoff32_kvlen100", (3, 128, 128, 1, 64), True, (32, 100)),
]
# kernels of the flash library that must run on tensor cores
MMA_KERNELS = [f"{k}<bf16, {d}>" for k in ("fwd_kernel", "bwd_dkv_kernel",
                                           "bwd_dq_kernel")
               for d in (32, 64, 128)]
LM_LR = 1e-2
LM_LOGIT_TOL = 5e-2              # share of the exact forward's max-abs


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    """A failed check fails the run (unlike assert, never compiled out)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def same_bits(a, b):
    """Whether two f32 tensors have the same shape and bits (torch.equal
    takes -0.0 for +0.0)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def merge_inputs(R, L, seed):
    """(words, scales) of an R-rank merge, numpy: (R, L) int32 words (the
    uint32 bit pattern), independent and random for each rank, and (R,)
    f32 scales MERGE_SCALES[r % 8].  On these a merge that adds the ranks
    in another order differs in bits from the reference at R >= 4 (at
    R <= 3 only two products are not +-0.0, and their sum commutes), and
    one that starts from rank 0's product instead of +0.0 differs at R =
    1 (-0.0 where the reference gives +0.0 + -0.0 = +0.0; where a non-zero
    product follows, a zero start leaves no trace)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    words = rs.randint(0, 2**32, size=(R, L), dtype=np.uint64)
    scales = [MERGE_SCALES[r % len(MERGE_SCALES)] for r in range(R)]
    return (words.astype(np.uint32).view(np.int32),
            np.asarray(scales, np.float32))


def merge_controls(ok, words, scales, numel):
    """Two wrong merges in plain torch, which ``merge_inputs`` must tell
    from ``onebit_unpack_sum_plain`` by their bits: the ranks added in
    reverse order, and a sum that starts from rank 0's product."""
    first = ok.onebit_unpack_plain(words[0], scales[0], numel)
    for r in range(1, words.shape[0]):
        first = first + ok.onebit_unpack_plain(words[r], scales[r], numel)
    return {"reversed order": ok.onebit_unpack_sum_plain(
                words.flip(0), scales.flip(0), numel),
            "rank 0's product as the start": first}


def row_share(got, want, floor=ROW_FLOOR):
    """The largest, over rows (all but the last axis), of the row's max
    |got - want| over the row's max |want|, that max taken no smaller than
    ``floor`` times the whole tensor's max |want|.  The floor holds a row
    whose true values are cancellation noise (causal query row 0 sees one
    key, so its dS = P (dP - delta) subtracts two sums of the same
    products) to the tensor's scale; rows above it are held to their own.
    inf where ``want`` is zero everywhere and ``got`` is not."""
    import torch
    diff = (got.float() - want.float()).abs().amax(-1)
    top = want.float().abs().amax(-1)
    den = top.clamp_min(floor * float(want.float().abs().max()))
    share = torch.where(den > 0, diff / den.clamp_min(1e-30),
                        torch.where(diff > 0, math.inf, 0.0))
    return float(share.max())


def bf16_errors(got, want):
    """(row_share, the share of elements that differ at all)."""
    return row_share(got, want), float((got != want).float().mean())


def check_bf16(what, pairs, ctl):
    """Hold each bf16 kernel's outputs against its plain version's with
    FLASH_BF16_TOL, and show that each bound is tight enough to see a
    kernel that left P (and dS) in f32 (``ctl``)."""
    seen, ctl_seen = {}, {}
    for kname, (got, want) in pairs.items():
        rs_tol, frac_tol = FLASH_BF16_TOL[kname != "flash_fwd"]
        for g, w, c in zip(got, want, ctl[kname]):
            rs, frac = bf16_errors(g, w)
            crs, cfrac = bf16_errors(c.to(g.dtype), w)
            seen[kname] = tuple(map(max, seen.get(kname, (0.0, 0.0)),
                                    (rs, frac)))
            ctl_seen[kname] = tuple(map(min, ctl_seen.get(kname, (1.0, 1.0)),
                                        (crs, cfrac)))
            check(rs <= rs_tol and frac <= frac_tol,
                  f"{kname} differs from its plain version at {what}: row "
                  f"share {rs:.3g}, {frac:.3g} of elements differ")
            check(crs > rs_tol or cfrac > frac_tol,
                  f"{kname} at {what}: the bound does not see P (and dS) "
                  f"left in f32 (row share {crs:.3g}, {cfrac:.3g} of "
                  f"elements differ)")
    log(f"flash: {what}: all three within bounds of their plain versions; "
        f"(row share, share of elements differing) " + ", ".join(
            f"{k} ({a:.3e}, {b:.3e})" for k, (a, b) in seen.items())
        + "; control with P (and dS) left in f32: " + ", ".join(
            f"{k} ({a:.3e}, {b:.3e})" for k, (a, b) in ctl_seen.items()))


def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


def build_phase(build, sources, mma_source=None, pdl_source=None):
    """Build ``sources``; print ptxas's lines, which must show no spill;
    for ``pdl_source``, whose kernels launch with programmatic stream
    serialization, check in SASS that none loads before its wait for the
    kernel before it; and, for ``mma_source``, print each kernel's count
    of tensor-core instructions, which every kernel of MMA_KERNELS must
    have."""
    t0 = time.perf_counter()
    build.build(sources)
    log(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(sources)}")
    spills = []
    for src in sources:
        entry = ""
        for line in build.build_logs.get(src, "").splitlines():
            if "Compiling entry function" in line:
                entry = _kernel_name(line)
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {src} {entry}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m and (int(m.group(1)) or int(m.group(2))):
                    spills.append(f"{src} {entry}")
    check(not spills, f"register spills in {spills}")
    if pdl_source is not None:
        early = sass_loads_before_wait(build, pdl_source)
        log(f"  sass {pdl_source}: {len(early)} kernels wait for the kernel "
            f"before them; loads issued before that wait: "
            f"{sum(map(len, early.values()))}")
        check(early and not any(early.values()),
              f"loads before griddepcontrol.wait: "
              f"{ {k: v for k, v in early.items() if v} }")
    if mma_source is None:
        return
    counts = sass_mma_counts(build, mma_source)
    log(f"  sass {mma_source}: tensor-core instructions (HMMA, HGMMA) per "
        f"kernel: " + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())))
    missing = [k for k in MMA_KERNELS if not counts.get(k)]
    check(not missing, f"no tensor-core instruction in {missing}")


def sass_kernels(build, source):
    """The instructions of each kernel of the built library of
    ``source``, read from ``cuobjdump -sass``: {kernel name: [line]}."""
    tool = (shutil.which("cuobjdump")
            or os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(build.library_path(source))],
                          check=True, capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :", 1)[1])
            kernels[name] = []
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            kernels[name].append(line)
    return kernels


def sass_mma_counts(build, source):
    """Tensor-core instructions (HMMA, HGMMA) in each kernel of ``source``."""
    return {k: sum(bool(re.search(r"\bHG?MMA\b", ln)) for ln in lines)
            for k, lines in sass_kernels(build, source).items()}


def sass_loads_before_wait(build, source):
    """Each kernel of ``source`` that waits for the kernel before it
    (griddepcontrol.wait, SASS ACQBULK) -> the global loads it issues
    before that wait.  Such a load may read what the kernel before has not
    written yet, so every list must be empty."""
    out = {}
    for k, lines in sass_kernels(build, source).items():
        wait = next((i for i, ln in enumerate(lines) if "ACQBULK" in ln),
                    None)
        if wait is not None:
            out[k] = [ln.split(";")[0].split("*/", 1)[1].strip()
                      for ln in lines[:wait] if re.search(r"\bLDG?\.", ln)]
    return out


def _kernel_name(ptxas_line):
    """'fwd_kernel<bf16, 128>' or 'pack_kernel<8, true>' from ptxas's
    mangled entry name."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:I(13__nv_bfloat16|f)Li(\d+)E"
                  r"|ILi(\d+)ELb([01])E)?", ptxas_line)
    if m is None:
        return ptxas_line.strip()
    if m.group(2) is not None:
        dt = "bf16" if "bfloat16" in m.group(2) else "f32"
        return f"{m.group(1)}<{dt}, {m.group(3)}>"
    if m.group(4) is not None:
        vec = "true" if m.group(5) == "1" else "false"
        return f"{m.group(1)}<{m.group(4)}, {vec}>"
    return m.group(1)


def device_ms(torch, fn, args_list, reps=100):
    """Device time of one call: a sleep kernel holds the stream while the
    host enqueues ``reps`` calls, so the events time the kernels back to
    back and not the host's launch overhead.  Inputs rotate over
    ``args_list`` (more bytes than the 50 MB L2), the rotation going on
    from one loop to the next so that no timed call finds its inputs in
    L2 from a recent call, and the last outputs are kept alive so each
    call writes fresh memory."""
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
    for i in range(reps, 2 * reps):
        keep.append(fn(*args_list[i % len(args_list)]))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def resnet_chunks(torch, resnet, config, chunk_bounds):
    """The numel of every compressed chunk of the ResNet-50 slice, in
    declaration order: its parameters' sizes (the model built on the meta
    device) cut as the engine cuts them under ``config``."""
    with torch.device("meta"):
        model = resnet.resnet50(num_classes=CLASSES)
    return [ln for p in model.parameters()
            if p.numel() * 4 >= config.min_compress_bytes
            for _, ln in chunk_bounds(p.numel(), 4, config.partition_bytes)]


def kernel_phase(torch, ok, chunk_numel, chunks):
    """The onebit kernels against their plain versions at every chunk size
    of ``chunks`` (the ResNet slice's) and at ragged sizes, then timed at
    each of those sizes and summed over one ResNet step; returns the JSON
    rows' numbers (at ``chunk_numel``, unpack_sum at R = 1)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    err = {k: 0.0 for k in KERNELS}

    def specials(x):
        x[..., ::97] = -0.0
        x[..., 5] = 0.0
        return x

    def merge_on_card(R, L, seed):
        return [torch.from_numpy(a).to(dev) for a in merge_inputs(R, L, seed)]

    sizes = sorted(set(chunks) | {chunk_numel})
    ragged = [chunk_numel - 12345, 4097, 100]
    for numel in sizes + ragged:
        x = specials(torch.randn(numel, generator=gen)).to(dev)
        w, s = ok.onebit_pack(x)
        w0, s0 = ok.onebit_pack_plain(x)
        check(torch.equal(w, w0), f"pack words differ at numel={numel}")
        torch.testing.assert_close(s, s0, rtol=1e-6, atol=0)
        err["onebit_pack"] = max(err["onebit_pack"],
                                 float((s - s0).abs().max()))
        out = ok.onebit_unpack(w, s[1:], numel)
        ref = ok.onebit_unpack_plain(w, s[1], numel)
        check(torch.equal(out, ref), f"unpack differs at numel={numel}")
        # the merge: of the pack's own words and scale, as at one rank on
        # the path, then of the step-1 inputs at each of MERGE_RANKS
        merges = [("the pack's words", w[None], s[1:])] + [
            (f"R={R}", *merge_on_card(R, ok.padded_lanes(numel), numel + R))
            for R in MERGE_RANKS]
        for what, ws, ss in merges:
            check(same_bits(ok.onebit_unpack_sum(ws, ss, numel),
                            ok.onebit_unpack_sum_plain(ws, ss, numel)),
                  f"unpack_sum differs in bits at numel={numel}, {what}")
    torch.cuda.synchronize()
    log(f"kernels: bit-exact against the plain versions at the "
        f"{len(set(chunks))} chunk sizes of the ResNet slice {sizes} and at "
        f"numel {', '.join(map(str, ragged))} (unpack_sum on the pack's "
        f"words and on merge_inputs at R={MERGE_RANKS}, scales "
        f"{MERGE_SCALES})")
    # the check sees a merge in another order or from rank 0's product
    for R, ctl in ((8, "reversed order"), (1, "rank 0's product as the start")):
        ws, ss = merge_on_card(R, ok.padded_lanes(chunk_numel), 7)
        ref = ok.onebit_unpack_sum_plain(ws, ss, chunk_numel)
        bad = merge_controls(ok, ws, ss, chunk_numel)[ctl]
        differ = int((bad.view(torch.int32) != ref.view(torch.int32)).sum())
        check(differ > 0, f"merge_inputs at R={R} do not show {ctl}")
        log(f"kernels: control at R={R}, {ctl}: {differ} of {chunk_numel} "
            f"elements differ in bits from the plain merge")

    # the cost of a launch, back to back: PyTorch's fill_ of one float
    one = torch.empty(1, device=dev)
    launch_ms = device_ms(torch, lambda: one.fill_(1.0), [()], reps=200)
    log(f"kernels: a launch back to back (PyTorch's fill_ of one float) "
        f"takes {launch_ms * 1e3:.2f} us")

    # timing at each chunk size of the slice: pack, unpack and unpack_sum
    # at R = 1 (a world of one), on the pack's own words, and unpack_sum at
    # the other MERGE_RANKS on independent random words (the merges of a
    # 4- and an 8-rank world); the inputs of each size rotate over
    # ROTATE_BYTES, more than the L2
    dgen = torch.Generator(device=dev).manual_seed(4)
    per_size = {}
    for n in sizes:
        L = ok.padded_lanes(n)
        count = -(-ROTATE_BYTES // (4 * n))
        xs = list(specials(torch.randn(count, n, generator=dgen, device=dev)))
        packed = [ok.onebit_pack(x) for x in xs]

        def merge(w, s):
            return ok.onebit_unpack_sum(w, s, n)

        def merge_plain(w, s):
            return ok.onebit_unpack_sum_plain(w, s, n)

        timing = {
            "onebit_pack": (
                lambda x: ok.onebit_pack(x), lambda x: ok.onebit_pack_plain(x),
                [(x,) for x in xs], 4 * n + 4 * L + 8),
            "onebit_unpack": (
                lambda w, s: ok.onebit_unpack(w, s, n),
                lambda w, s: ok.onebit_unpack_plain(w, s[0], n),
                [(w, s[1:]) for w, s in packed], 4 * L + 4 + 4 * n),
            "onebit_unpack_sum": (
                merge, merge_plain, [(w[None], s[1:]) for w, s in packed],
                4 * L + 4 + 4 * n),
        }
        for R in MERGE_RANKS[1:]:
            ss = torch.tensor([MERGE_SCALES[r % len(MERGE_SCALES)]
                               for r in range(R)], device=dev)
            ws = torch.randint(-2**31, 2**31 - 1, (count, R, L),
                               generator=dgen, device=dev, dtype=torch.int32)
            timing[f"onebit_unpack_sum R={R}"] = (
                merge, merge_plain, [(w, ss) for w in ws],
                4 * R * L + 4 * R + 4 * n)
        row = {}
        for name, (kern, plain, args, nbytes) in timing.items():
            row[name] = {"ms": device_ms(torch, kern, args),
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
            if n == chunk_numel and name in KERNELS:
                row[name]["plain_ms"] = device_ms(torch, plain, args, reps=20)
                row[name]["max_abs_err"] = err[name]
        per_size[n] = row
        log(f"  numel {n} ({chunks.count(n)} chunks, {L} words, {count} "
            f"inputs): " + ", ".join(
                f"{k} {r['ms'] * 1e3:.2f} us (bound {r['bound_ms'] * 1e3:.2f}"
                f" us, {r['bound_ms'] / r['ms']:.1%})"
                for k, r in row.items()))
        del xs, packed, timing
    rows = per_size[chunk_numel]
    for name in KERNELS:
        r = rows[name]
        log(f"  {name}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} "
            f"us) at numel {chunk_numel}")

    # one ResNet step: 2 packs, 3 unpacks and 1 unpack_sum per compressed
    # chunk, each at its chunk's size; the merge also at R = 4 and 8
    step = {}
    for name, calls in (("onebit_pack", 2), ("onebit_unpack", 3),
                        ("onebit_unpack_sum", 1)):
        step[name] = {k: sum(calls * per_size[n][name][k] for n in chunks)
                      for k in ("ms", "bound_ms")}
    ms, bound = (sum(r[k] for r in step.values()) for k in ("ms", "bound_ms"))
    log(f"kernels: per ResNet step ({len(chunks)} chunks, 2 packs, 3 "
        f"unpacks and 1 unpack_sum each, each at its chunk's size, R=1): "
        + ", ".join(
            f"{k} {r['ms'] * 1e3:.2f} us (bound {r['bound_ms'] * 1e3:.2f} us)"
            for k, r in step.items())
        + f"; together {ms * 1e3:.2f} us (bound {bound * 1e3:.2f} us, "
          f"{bound / ms:.1%})")
    log("kernels: unpack_sum per ResNet step at " + ", ".join(
        "R={} {:.2f} us (bound {:.2f} us)".format(R, *(
            sum(per_size[n][f"onebit_unpack_sum R={R}"][k] for n in chunks)
            * 1e3 for k in ("ms", "bound_ms")))
        for R in MERGE_RANKS[1:]))
    return rows


def slice_phase(torch, bps, ok, api, registry, resnet, chunks):
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
    n_chunks = sum(len(c.chunk_bounds) for c in comp)
    steps = 1 + TIMED_STEPS
    want = {"onebit_pack": 2 * n_chunks * steps,
            "onebit_unpack": 3 * n_chunks * steps,
            "onebit_unpack_sum": n_chunks * steps}
    log(f"slice: {len(ctxs)} tensors, {len(comp)} compressed in {n_chunks} "
        f"chunks, {len(ctxs) - len(comp)} all-reduced; launches {launches} "
        f"over {steps} steps")
    check(launches == want, f"launches {launches}, expected {want}")
    got_chunks = [ln for c in comp for _, ln in c.chunk_bounds]
    check(sorted(got_chunks) == sorted(chunks),
          "the engine's compressed chunks are not the ones the kernel phase "
          "timed")

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

    # one more step under torch.profiler: the device's busy share, and the
    # onebit kernels' device time and device kernels per wrapper call
    before = dict(ok.launches)
    busy_ms, wall_ms, events = profiled_step(torch, step)
    calls = {k: ok.launches[k] - before[k] for k in KERNELS}
    dev_ms = onebit_device_ms(events)
    log(f"slice: a profiled step took {wall_ms:.2f} ms, the device was busy "
        f"{busy_ms:.2f} ms of it ({busy_ms / wall_ms:.1%}); onebit device "
        f"time " + ", ".join(
            f"{k} {ms:.4f} ms ({n} device kernels for {calls[k]} calls)"
            for k, (n, ms) in dev_ms.items())
        + f", together {sum(ms for _, ms in dev_ms.values()):.4f} ms")
    check(calls["onebit_pack"] == 2 * n_chunks and all(
              dev_ms[k][0] == calls[k] for k in KERNELS),
          f"the profiled step shows onebit calls {calls} and device kernels "
          f"{dev_ms}: each call must be one device kernel")
    bps.shutdown()
    return launches, step_ms


def flash_kernel_phase(torch, fa):
    """Each flash kernel against its plain version, then timed at both
    slice shapes; returns the JSON rows' numbers per kernel (at the Llama
    shape) and each kernel's ms at each slice shape."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    err = {k: 0.0 for k in FLASH_KERNELS}
    for name, (b, tq, tk, h, d), causal, *mask in FLASH_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, do = (torch.randn(b * h, tq, d, generator=gen, device=dev)
                     .to(dt) for _ in range(2))
            k, v = (torch.randn(b * h, tk, d, generator=gen, device=dev)
                    .to(dt) for _ in range(2))
            args = (1.0 / math.sqrt(d), causal,
                    *(mask[0] if mask else (tk - tq, tk)))
            o0, lse0 = fa.flash_fwd_plain(q, k, v, *args)
            dl = fa.delta(do, o0)
            bwd = (q, k, v, do, lse0, dl, *args)
            # the bf16 forward's reference rounds P where the kernel does,
            # against the running max of each FWD_BLOCK_K-wide key tile
            fwd_ref = (fa.flash_fwd_plain(q, k, v, *args,
                                          block_k=fa.FWD_BLOCK_K)
                       if dt == torch.bfloat16 else (o0, lse0))
            o, lse = fa.flash_fwd(q, k, v, *args)
            pairs = {
                "flash_fwd": ([o], [fwd_ref[0]]),
                "flash_bwd_dkv": (fa.flash_bwd_dkv(*bwd),
                                  fa.flash_bwd_dkv_plain(*bwd)),
                "flash_bwd_dq": ([fa.flash_bwd_dq(*bwd)],
                                 [fa.flash_bwd_dq_plain(*bwd)]),
            }
            torch.cuda.synchronize()
            what = f"{name} {str(dt)[6:]} causal={causal}"
            for kname, (got, want) in pairs.items():
                for g, w in zip(got, want):
                    check(g.dtype == dt and g.shape == w.shape,
                          f"{kname} {what}: {g.dtype} {tuple(g.shape)}")
                    err[kname] = max(err[kname], float(
                        (g.float() - w.float()).abs().max()))
            rtol, atol = FLASH_LSE_TOL[str(dt)[6:]]
            lse_err = float((lse - fwd_ref[1]).abs().max())
            check(lse.shape == fwd_ref[1].shape and torch.allclose(
                lse, fwd_ref[1], rtol=rtol, atol=atol),
                f"flash_fwd lse differs from its plain version at {what}: "
                f"max |diff| {lse_err:.3g}")
            if dt == torch.float32:
                for kname, (got, want) in pairs.items():
                    tol = FLASH_F32_TOL[kname != "flash_fwd"]
                    check(all(torch.allclose(g, w, rtol=tol, atol=tol)
                              for g, w in zip(got, want)),
                          f"{kname} differs from its plain version at {what}")
                log(f"flash: {what}: all three within the JAX tests' "
                    f"tolerances of their plain versions; lse max |diff| "
                    f"{lse_err:.3e}")
            else:
                # the control: the plain versions with P and dS left in f32
                f32 = [t.float() for t in (q, k, v, do)]
                fbwd = (*f32, lse0, dl, *args)
                ctl = {"flash_fwd": [fa.flash_fwd_plain(
                           *f32[:3], *args, block_k=fa.FWD_BLOCK_K)[0]],
                       "flash_bwd_dkv": fa.flash_bwd_dkv_plain(*fbwd),
                       "flash_bwd_dq": [fa.flash_bwd_dq_plain(*fbwd)]}
                check_bf16(what, pairs, ctl)
                log(f"flash: {what}: forward lse max |diff| {lse_err:.3e}")
                if name == "llama":
                    check_repeatable(torch, fa, (q, k, v, *args), lse, bwd,
                                     pairs, what)
            del o0, dl, bwd, pairs, fwd_ref, o, lse
            ctl = fbwd = f32 = None
            torch.cuda.empty_cache()

    # timing at both slice shapes, bf16; the JSON rows are the Llama one's
    shapes = {}
    for name, (b, t, _, h, d), causal in FLASH_CASES[:2]:
        shapes[name] = time_flash(torch, fa, gen, b, t, h, d, causal,
                                  full=name == "llama")
    rows = shapes["llama"]
    for kname, r in rows.items():
        r["max_abs_err"] = err[kname]
    return rows, {name: {k: r["ms"] for k, r in rs.items()}
                  for name, rs in shapes.items()}


def check_repeatable(torch, fa, fwd, lse, bwd, pairs, what):
    """A second run of each kernel on the same inputs gives the same bits
    as the first (no atomics, no order that changes); ``lse`` is the first
    forward's."""
    o2, lse2 = fa.flash_fwd(*fwd)
    again = {"flash_fwd": [o2, lse2],
             "flash_bwd_dkv": fa.flash_bwd_dkv(*bwd),
             "flash_bwd_dq": [fa.flash_bwd_dq(*bwd)]}
    first = {k: list(got) for k, (got, _) in pairs.items()}
    first["flash_fwd"].append(lse)
    torch.cuda.synchronize()
    for kname, got in again.items():
        check(all(torch.equal(a, b) for a, b in zip(got, first[kname])),
              f"{kname} at {what}: two runs differ")
    log(f"flash: {what}: a second run of the forward (O and lse), dK/dV "
        f"and dQ gives the same bits")


def time_flash(torch, fa, gen, b, t, h, d, causal, full):
    """Device ms of each flash kernel at [b, t, h, d] bf16 and its FLOP
    bound; with ``full`` also its plain version's and the SDPA
    yardstick."""
    dev, bh, dt = gen.device, b * h, torch.bfloat16
    q, k, v, do = (torch.randn(bh, t, d, generator=gen, device=dev).to(dt)
                   for _ in range(4))
    args = (1.0 / math.sqrt(d), causal, 0, t)
    o, lse = fa.flash_fwd(q, k, v, *args)
    bwd = [(q, k, v, do, lse, fa.delta(do, o), *args)]
    live = (t + 1) / (2 * t) if causal else 1.0       # causal share of T^2
    def fwd_plain(*a):   # the bf16 forward's reference
        return fa.flash_fwd_plain(*a, block_k=fa.FWD_BLOCK_K)

    timing = {
        "flash_fwd": (fa.flash_fwd, fwd_plain, [(q, k, v, *args)]),
        "flash_bwd_dkv": (fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, bwd),
        "flash_bwd_dq": (fa.flash_bwd_dq, fa.flash_bwd_dq_plain, bwd),
    }
    rows = {}
    for kname, (kern, plain, targs) in timing.items():
        flops = 2 * FLASH_PRODUCTS[kname] * bh * t * t * d * live
        rows[kname] = {"ms": device_ms(torch, kern, targs, reps=10),
                       "bound_ms": flops / BF16_FLOP_PER_S * 1e3}
        if full:
            rows[kname]["plain_ms"] = device_ms(torch, plain, targs, reps=3)
        torch.cuda.empty_cache()
    shape = f"[{b}, {t}, {h}, {d}] bf16 causal={causal}"
    if not full:
        log(f"  at {shape}: " + ", ".join(
            f"{kname} {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms = "
            f"{r['bound_ms'] / r['ms']:.1%})" for kname, r in rows.items()))
        return rows
    lib_fwd, lib_bwd = sdpa_ms(torch, q, k, v, do, b, h, causal)
    rows["flash_fwd"]["library_ms"] = lib_fwd
    rows["flash_bwd_dkv"]["library_ms"] = lib_bwd
    rows["flash_bwd_dq"]["library_ms"] = lib_bwd
    for kname, r in rows.items():
        log(f"  {kname}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms = {r['bound_ms'] / r['ms']:.1%} "
            f"of the kernel's time, sdpa {r['library_ms']:.3f} ms"
            f"{' (whole backward)' if kname != 'flash_fwd' else ''}) at "
            f"{shape}")
    return rows


def sdpa_ms(torch, q3, k3, v3, do3, b, h, causal):
    """torch's scaled_dot_product_attention on the same bf16 inputs, a
    yardstick only: (forward ms, forward+backward minus forward ms)."""
    import torch.nn.functional as F

    def to4(x):
        return x.reshape(b, h, x.shape[1], x.shape[2])

    q, k, v, do = map(to4, (q3, k3, v3, do3))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd(*xs):
        return F.scaled_dot_product_attention(*xs, is_causal=causal)

    def fwd_bwd(*xs):
        return torch.autograd.grad(fwd(*xs), xs, do)

    with torch.no_grad():
        f_ms = device_ms(torch, fwd, [(q, k, v)], reps=10)
    fb_ms = device_ms(torch, fwd_bwd, [tuple(leaves)], reps=10)
    return f_ms, fb_ms - f_ms


def lm_slice_phase(torch, bps, api, fa, name, model_fn, cfg, batch, seq,
                   watch, kernel_ms):
    """Train ``cfg`` through the port's main path with flash attention;
    returns the flash launches of its run.  ``kernel_ms`` (each flash
    kernel's device ms at this slice's shape) gives the flash share of
    the step."""
    from byteps_tpu_torch.models.gpt import lm_loss
    from byteps_tpu_torch.ops.flash_attention import flash_attention
    from byteps_tpu_torch.parallel.long_context import synthetic_lm_batch
    from byteps_tpu_torch.parallel.sequence import full_attention

    bps.init()                                     # NCCL, world of one
    dev = api.device()
    gen = torch.Generator(device=dev).manual_seed(3)
    model = model_fn(cfg, attn_fn=flash_attention, device=dev, generator=gen)
    data = synthetic_lm_batch(gen, cfg, batch, seq)
    ids, labels = data["input_ids"], data["labels"]
    n_params = sum(p.numel() for p in model.parameters())
    param = dict(model.named_parameters())[watch]
    raw = {}
    param.register_post_accumulate_grad_hook(
        lambda p: raw.__setitem__(watch, p.grad.clone()))
    opt = bps.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LM_LR, momentum=0.9),
        named_parameters=model.named_parameters())

    def step():
        opt.zero_grad()
        loss = lm_loss(model(ids), labels)
        loss.backward()
        opt.step()
        return loss

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_ms = [], []
    for i in range(1 + TIMED_STEPS):               # warm-up, timed steps
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        check(math.isfinite(losses[-1]), f"{name}: loss {losses[-1]} at "
                                         f"step {i}")
    launches = dict(fa.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    busy_ms, wall_ms, _ = profiled_step(torch, step)
    timed = step_ms[1:]
    mean_ms = sum(timed) / len(timed)
    log(f"{name}: {n_params} parameters, {cfg.num_layers} layers, batch "
        f"{batch} x {seq}; warm-up {step_ms[0]:.1f} ms, steps "
        f"{[round(t, 2) for t in timed]} ms, mean {mean_ms:.2f} ms; losses "
        f"{[round(x, 4) for x in losses]}; peak memory {peak_gib:.2f} GiB")
    want = {k: cfg.num_layers * (1 + TIMED_STEPS) for k in FLASH_KERNELS}
    flash_ms = cfg.num_layers * sum(kernel_ms.values())
    log(f"{name}: flash launches {launches} over {1 + TIMED_STEPS} steps; "
        f"flash kernels {flash_ms:.2f} ms per step ({cfg.num_layers} x "
        f"their device ms at this shape), {flash_ms / mean_ms:.1%} of the "
        f"mean step")
    log(f"{name}: a profiled step took {wall_ms:.2f} ms, the device was "
        f"busy {busy_ms:.2f} ms of it ({busy_ms / wall_ms:.1%})")
    check(launches == want, f"{name}: flash launches {launches}, expected "
                            f"{want}")
    check(torch.equal(param.grad, raw[watch]),
          f"{name}: {watch} gradient differs from the raw gradient")

    # flash against exact attention, same weights and batch
    del opt
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    def late_rows_zeroed(q, k, v, **kw):   # a control: a fault in late rows
        out = full_attention(q, k, v, **kw)
        out[:, out.shape[1] // 2:] = 0
        return out

    def zeroed(q, k, v, **kw):             # a control: no attention at all
        return torch.zeros_like(q)

    def logits(attn_fn):
        for m in model.modules():
            if hasattr(m, "attn_fn"):
                m.attn_fn = attn_fn
        with torch.no_grad():
            return model(ids)

    got = logits(flash_attention)
    exact = logits(full_attention)
    check(bool(torch.isfinite(got).all()) and got.shape == exact.shape,
          f"{name}: non-finite or misshapen logits")
    shares = {}
    for what, out in (("flash", got), ("late rows zeroed", None),
                      ("attention zeroed", None)):
        if out is None:
            out = logits(late_rows_zeroed if what.startswith("late")
                         else zeroed)
        d = (out - exact).float()
        shares[what] = {
            "max": float(d.abs().max() / exact.abs().max()),
            "rms": float(d.norm() / exact.float().norm()),
            "row": row_share(out, exact)}
        del d, out
    log(f"{name}: logits against exact attention (max: max |diff| / max "
        f"|logit|; rms: |diff| / |logits|; row: row_share over positions; "
        f"bound {LM_LOGIT_TOL} on max): " + "; ".join(
            f"{what} " + ", ".join(f"{k} {v:.3e}" for k, v in sh.items())
            for what, sh in shares.items()))
    check(shares["flash"]["max"] <= LM_LOGIT_TOL,
          f"{name}: flash and exact attention disagree")
    check(min(shares["late rows zeroed"]["max"],
              shares["attention zeroed"]["max"]) > LM_LOGIT_TOL,
          f"{name}: the logit bound does not see a faulty attention")
    bps.shutdown()
    del model, got, exact, raw, param
    torch.cuda.empty_cache()
    return launches


def profiled_step(torch, step):
    """(device-busy ms, host ms, device events) of one ``step`` under
    torch.profiler: the union of the intervals of the kernels and copies
    on the card (user annotations left out), the host clock around the
    step, and those kernels and copies as (name, ms)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, -math.inf
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy_us / 1e3, wall_ms, [
        (e.name, (e.time_range.end - e.time_range.start) / 1e3)
        for e in events]


def onebit_device_ms(events):
    """The device events of the onebit kernels, by wrapper: {wrapper:
    (number of device kernels, their summed ms)}."""
    out = {k: [0, 0.0] for k in KERNELS}
    for name, ms in events:
        m = ONEBIT_KERNEL_RE.search(name)
        if m:
            r = out[f"onebit_{m.group(1)}"]
            r[0] += 1
            r[1] += ms
    return {k: tuple(v) for k, v in out.items()}


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
    from byteps_tpu_torch.common.partitioner import chunk_bounds
    from byteps_tpu_torch.compression import registry
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.models import gpt, llama, resnet
    from byteps_tpu_torch.ops import build
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_kernels as ok

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions
    t_start = time.perf_counter()
    device_phase(torch)
    build_phase(build, [ok.SOURCE, fa.SOURCE], mma_source=fa.SOURCE,
                pdl_source=ok.SOURCE)
    config = Config()
    chunk_numel = config.partition_bytes // 4          # f32 gradients
    chunks = resnet_chunks(torch, resnet, config, chunk_bounds)
    rows = kernel_phase(torch, ok, chunk_numel, chunks)
    launches, _ = slice_phase(torch, bps, ok, api, registry, resnet, chunks)
    torch.cuda.empty_cache()
    flash_rows, shape_ms = flash_kernel_phase(torch, fa)
    flash_launches = {k: 0 for k in FLASH_KERNELS}
    for name, model_fn, cfg, batch, seq, watch, shape in (
            ("llama slice", llama.Llama,
             dataclasses.replace(llama.llama3_8b(), num_layers=4), 2, 4096,
             "norm_f.scale", "llama"),
            ("gpt slice", gpt.GPT, gpt.gpt_small(), 1, 8192, "ln_f.scale",
             "gpt")):
        run = lm_slice_phase(torch, bps, api, fa, name, model_fn, cfg,
                             batch, seq, watch, shape_ms[shape])
        for k in flash_launches:
            flash_launches[k] += run[k]
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
    for name, replaces in FLASH_KERNELS.items():
        r = flash_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "byteps_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": flash_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations", "library_ms": r["library_ms"]})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
