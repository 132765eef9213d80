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
   the push_pull engine (its defaults; compressed chunks are never
   grouped or re-carved) -> NCCL (a world of one) for 1 warm-up and 3
   timed steps.  The onebit launch counters are zeroed just before and
   read just after; each must show the launches the compressed chunks
   need, and the compressed chunks must be the ones phase 3 timed.  The
   loss must be finite, and for one compressed and one uncompressed
   parameter the gradient the optimizer received must equal the plain
   path's result (the same codec run on the CPU) on the same input.  One
   more step runs under torch.profiler: it prints the device's busy share,
   the host ops' CPU time by thread and the onebit kernels' device time,
   and each onebit wrapper call must have been one device kernel;
5. codec slice: ResNet-50 as in phase 4 (full width, seeded weights and
   batch, NCCL at a world of one, the engine's defaults), through each
   arm of CODEC_ARMS in turn, each on a fresh engine: DistributedOptimizer
   with topk (k 0.01 + EF), randomk (k 0.01 + EF), dithering (16 linear
   levels, max norm, dense), dithering_sparse (16 natural levels, l2
   norm, sparse ratio 0.05 + EF), powersgd (rank 4 + EF) and nesterov
   (onebit + EF + Nesterov momentum over SGD without momentum);
   DistributedDataParallel and CrossBarrier with onebit + EF;
   HalfPrecisionDistributedOptimizer (fp16 parameters and compute, fp32
   masters, loss scale 1024, uncompressed); and autotune,
   DistributedOptimizer under ``Config(compress_autotune=True)`` with no
   compression given, which first runs until the compressor ladder has
   locked a codec in every size bucket (at most AUTOTUNE_MAX_STEPS steps)
   and prints the codec locked per bucket.  Each arm: 1 warm-up and 3
   timed steps, the loss finite at every step; the onebit launch
   counters zeroed at its start, and the onebit arms must show 2 packs,
   3 unpacks and 1 merge per compressed chunk and step (autotune: some of
   each, since every bucket explores onebit; the others none).  Then one
   checked step: for fc.weight (compressed, except in half) and fc.bias
   (an all-reduce), the gradient the inner optimizer received (a step
   pre-hook; half: the fp32 master's, times the loss scale) must equal
   the port's codec chain run on the CPU on the same raw gradient from
   the states before that step: bit for bit for topk, randomk, dithering
   with the max norm, every uncompressed gradient and half; to rtol 1e-5
   for the onebit arms (the scale's L1 sum is taken in another order on
   the card), whose Nesterov momentum must be bit-exact; for dithering
   with the l2 norm (a sum of squares in another order, which can move a
   code where it sits on a rounding threshold), at most L2_CODE_SHARE of
   the elements more than L2_TOL of the max-abs apart; for PowerSGD
   (cuBLAS and cuSOLVER against the CPU's BLAS and LAPACK) at most
   PSGD_CARD_TOL of the max-abs, and a control with rank 1 in place of
   4 must break that bound.  One more step under torch.profiler gives the
   busy share.  Each arm prints its median step (min-max), the busy
   share, and the bytes its compressed chunks put on the wire per step
   (the sum of their payload_nbytes) beside their raw bytes;
6. flash kernels: the forward, dK/dV and dQ kernels against their plain
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
7. llama slice and gpt slice: Llama-3-8B at full width with 4 of its 32
   layers (batch 2 x 4096 tokens) and GPT-small (batch 1 x 8192 tokens),
   bf16 compute over f32 parameters, attention through ``flash_attention``,
   SGD(momentum=0.9), in three arms on the same weights and batch from
   the seed, one process:
   - ``plain``: SGD alone, no engine;
   - ``ungrouped``: ``DistributedOptimizer`` -> an engine started with
     ``UNGROUPED_ENGINE`` (one chunk per collective, no planner, the
     Python scheduler: the engine before chunk groups) -> NCCL; every
     collective must carry one chunk;
   - ``defaults``, the main path: ``bps.init()`` with the engine's
     defaults (groups of up to 4 chunks, the planner, the native
     scheduler, which must be the one in use).  Its warm-up runs until
     every planner bucket has locked a chunk size, at most LM_WARMUP_MAX
     steps; over the run, dispatches must be fewer than chunks.
   Each arm then takes LM_TIMED_STEPS timed steps (median, min-max, step
   minus the plain step, thread CPU seconds from /proc), and one more
   under torch.profiler: the device's busy time (the union of its kernels'
   intervals, over that step's host-clock time) and the host ops' self
   CPU time by thread (main, bps-dispatch, bps-sync, the autograd
   thread).  The flash launch counters are zeroed at the start of each
   arm and read after its timed steps: each kernel must have run
   ``num_layers`` times per step.  The loss must be finite at every step.
   The main path prints its engine stats per step (dispatches, chunks),
   the planner's locked chunk per size bucket and its credit window, and
   its peak memory, which must stay under 80 GB (it is printed beside
   EARLIER_LLAMA_PEAK_GIB); in one more step every parameter's received gradient
   must equal its raw gradient bit for bit (an all-reduce over one rank
   is the identity, whatever the grouping and chunk sizes).  Then a
   forward with ``flash_attention`` and one with the exact
   ``full_attention`` on the main path's weights and batch must agree to
   5e-2 of the logits' max-abs (bf16 compute through every layer), while
   two controls on the same weights (attention output zeroed for the
   later half of the positions, and everywhere) must not.  Each slice
   prints the flash kernels' share of the main path's median step
   (``num_layers`` x their device ms at its shape);
8. sharded update: the sharded weight update and ZeRO at a world of one
   over NCCL (a shard is the whole tensor), four arms, each freed before
   the next, each 1 warm-up and SHARDED_STEPS timed steps with the loss
   finite at every step, foreach pinned in every optimizer an arm
   compares:
   - ``llama_sharded``: Llama-3-8B width with 4 layers, bf16 parameters,
     the LM slice's batch (2 x 4096) and data, AdamW through
     ``DistributedOptimizer(sharded_update=True)``.  For the embedding,
     one attention and one MLP weight (LLAMA_WATCH) a reference f32
     master with its own AdamW takes the raw gradient (at one rank the
     averaged one) after each step; cast to bf16 it must equal the
     emitted parameter bit for bit.  Control: the bf16 parameter stepped
     by AdamW without a master must differ;
   - ``resnet_sharded``: ResNet-50 at full width (f32 parameters), the
     ResNet slice's batch, SGD(momentum=0.9): a sharded and an unsharded
     ``DistributedOptimizer`` on two copies in one engine, the unsharded
     copy fed the sharded copy's raw gradients through autograd (so the
     check does not rest on cuDNN's determinism); after the steps every
     parameter must be equal, bit for bit;
   - ``gpt_zero1``, ``gpt_fsdp``: GPT-small at full width, AdamW through
     ``make_zero_train_step`` (bf16 parameters) and
     ``make_fsdp_train_step`` (bf16 compute of an f32 template), against
     a plain step with an f32 master per parameter fed the same raw
     gradients, its loss from a forward of its masters: losses and
     masters bit for bit (the tolerance is 0: at one rank the
     collectives are identities, the division by 1 is exact and AdamW is
     elementwise).  Control: the bf16 parameters stepped by AdamW
     without a master must differ.
   Each arm prints its median step (min-max), its peak memory (reset at
   its start, references included), the bytes of state in the slots or
   the ZeroState beside those of the inner optimizer (which must be 0 in
   the engine arms), and the engine's wire bytes per step of each leg,
   which at one rank must be N and N.

9. async parameter server: two ResNet-50 replicas on the card (full
   width, the ResNet slice's batch per worker from its own seed, f32
   parameters, bf16 compute, SGD momentum 0.9), each with an
   ``AsyncDistributedOptimizer`` over one ``KVStore``, stepping in turn
   for 1 warm-up and ASYNC_STEPS timed steps each; after every step the
   stepping worker's parameters must equal the store's value bit for bit
   and every key ends at 2 x (1 + ASYNC_STEPS) versions.  Arms:
   - ``async_resnet``: raw deltas, integrity on; the store must equal a
     numpy replay (the initial value plus every delta in arrival order)
     bit for bit, and a replay without one delta must differ;
   - ``async_resnet_chaos``: the same workers fed the first arm's raw
     gradients (so the check does not rest on cuDNN's determinism) under
     ASYNC_SPEC (bitflip and drop at ``kv_push``): store and parameters
     bit-identical to ``async_resnet``, with CRC rejects, retransmits and
     lost acks counted; control: the same faults with integrity off must
     change the store;
   - ``async_resnet_onebit``: onebit + EF on every parameter; the store
     must equal the CPU replay (the landed frames decoded by the plain
     versions, summed in order) bit for bit; the onebit launch counters,
     zeroed before the arm and read after it, must show a pack and two
     unpacks per parameter and push (the worker's compress and EF
     residual, the store's decode), as must the device kernels of one
     profiled step;
   - ``server_engine_resnet``: a 4-thread ``ServerEngine`` takes the
     161 recorded gradients of two workers: each pull equals ``a + b``
     bit for bit; under SERVER_SPEC the round is bit-identical; one
     onebit round through ``push_compressed``/``pull_compressed`` merges
     to the CPU chain's decode bit for bit and re-encodes to its words,
     the scale to ONEBIT_SCALE_RTOL.
   Each arm prints its median step (min-max), the host ms of each stage
   (the optimizer's d2h, push, pull, h2d; inside the push seal + CRC,
   open + CRC, screen, decode, sum; the pull's copy), the busy share of
   one profiled step, wire and store bytes and its peak memory, beside
   the card's name and power limit.

10. observed sharded update: the quantized parameter leg with the whole
   observability plane on.  First the onebit kernels at the Llama
   embedding's size (525,336,576 floats, the block one rank holds): words
   and values bit-exact against the plain versions on the card, the L1
   sum within ONEBIT_SCALE_RTOL of the plain version's on the CPU.  Then
   two arms through ``DistributedOptimizer(sharded_update=True)``, each
   on an engine with tracing (the step window over one step, sampling),
   the device profiler over the window (``trace_jax``), the endpoint on
   port 0, the sampler every OBS_TS_INTERVAL_S, health on and the lock
   witness armed:
   - ``llama_param_onebit``: Llama-3-8B width, OBS_LLAMA_LAYERS layers,
     2 x 4096, bf16 parameters, f32 masters, AdamW in the slots,
     flash attention, ``sharded_param_codec="onebit"``;
   - ``resnet_param_auto``: ResNet-50 at full width, f32, SGD with
     momentum, batch 32, ``"auto"`` (onebit from 4 MiB, topk:0.25 from
     64 KiB, full precision below).
   Each: 1 warm-up, OBSERVED_STEPS timed steps in each tracing mode, off,
   sampled at 1/4 and at 1/1, the modes in turns (off, 1/4, 1/1, then
   back; median, min-max each), then the window step and the step that
   closes it.  Checks: for the watched tensors (OBS_WATCH
   and the first topk tensor) the warm-up and both window steps are
   replayed from the slot's recorded update and state by the plain codec
   chain on the CPU (onebit: signs exact, the scale to
   ONEBIT_SCALE_RTOL, the residual to the scales' difference and a
   rounding; topk bit for bit), the master is its previous value plus
   the dequantized update and the emitted parameter that master in the
   declared dtype, bit for bit, and the same tensor without the codec
   (an f32 master with the same optimizer fed the raw gradients)
   differs; the onebit launch counters (zeroed at the arm's start) show
   one pack and one unpack per onebit slot and step, the flash counters
   ``num_layers`` per step; ``compression.param_wire_bytes`` equals the
   slots' payload bytes over the steps, less the per-chunk rounding of
   the reference's formula; the flushed trace passes ``bps_trace``'s
   validation, has a ``queued`` and a ``push_pull`` span (the JAX
   engine's names for the enqueue -> dispatch and dispatch -> retirement
   stages) for every chunk of the window step, and paired flows; the
   device profile names the onebit kernels (and the three flash
   kernels); the last step's ``other`` is its wall time less the
   components, clamped at 0 (they overlap on this engine, ROADMAP Queue
   C 17); ``/metrics`` serves ``step.attrib_*`` and the parameter-leg
   counter, ``/healthz`` answers 200 (503 naming the rules if one
   fires), ``/debug/state`` has its trace section and ``/timeseries``
   points; a flight dump holds ``engine.init``, ``step_stats`` and
   ``engine.shutdown``; no LockOrderError.  Each arm prints its steps,
   peak memory and the parameter leg's host ms per stage (the slot's
   step, quantize, gather, dequantize, apply), beside the card's name
   and power limit.

The run prints its total time.  The line before the last is a JSON
object with one entry per kernel (launches: the main paths' runs, phase
4, the two LM slices' and phase 10's arms);
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits non-zero and prints no result.
"""

import collections
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
LM_TIMED_STEPS = 10              # timed steps of each LM arm
LM_WARMUP_MAX = 8                # the main path's warm-up: until every
#                                  planner bucket locks, at most this many
UNGROUPED_ENGINE = {"group_size": 1, "autotune": False, "use_native": False}
# the Llama slice's peak memory before chunk groups and the planner
# (PERF.md, section 6)
EARLIER_LLAMA_PEAK_GIB = 42.54
# the codec slice: (arm, wrapper, SGD momentum, compression kwargs)
CODEC_ARMS = (
    ("topk", "optimizer", 0.9,
     {"compressor": "topk", "k": "0.01", "ef": "vanilla"}),
    ("randomk", "optimizer", 0.9,
     {"compressor": "randomk", "k": "0.01", "ef": "vanilla"}),
    ("dithering", "optimizer", 0.9,
     {"compressor": "dithering", "k": "16", "partition": "linear",
      "normalize": "max"}),
    ("dithering_sparse", "optimizer", 0.9,
     {"compressor": "dithering", "k": "16", "partition": "natural",
      "normalize": "l2", "sparse_ratio": "0.05", "ef": "vanilla"}),
    ("powersgd", "optimizer", 0.9,
     {"compressor": "powersgd", "rank": "4", "ef": "vanilla"}),
    # the decorator replaces the optimizer's momentum
    ("nesterov", "optimizer", 0.0,
     {"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov"}),
    ("ddp", "ddp", 0.9, ONEBIT_EF),
    ("cross_barrier", "cross_barrier", 0.9, ONEBIT_EF),
    ("half", "half", 0.9, None),
    ("autotune", "optimizer", 0.9, None),     # the ladder owns every tensor
)
AUTOTUNE_MAX_STEPS = 40          # the autotune arm's cap on steps to lock
HALF_LOSS_SCALE = 1024.0
# received gradients of the l2 dithering arm: an element agrees within
# L2_TOL of the max-abs; at most L2_CODE_SHARE of them may not (see
# check_received)
L2_TOL = 1e-5
L2_CODE_SHARE = 1e-3
# PowerSGD on the card against the CPU: max |diff| over max-abs.  cuBLAS
# and cuSOLVER sum in another order than the CPU's BLAS and LAPACK (read:
# 7.07e-07 on fc.weight, H100 80GB HBM3 at 700 W); products in TF32, a
# 10-bit mantissa, would be ~1e-3 off, and rank 1 in place of 4 ~0.8
PSGD_CARD_TOL = 1e-5
# the sharded-update phase: AdamW for the LM arms, SGD with momentum for
# ResNet, foreach pinned in every optimizer an arm compares
SHARDED_ADAMW = {"lr": 3e-4, "weight_decay": 0.1, "foreach": True}
SHARDED_SGD = {"lr": 0.1, "momentum": 0.9, "foreach": True}
SHARDED_STEPS = 3                # timed steps of each arm, after 1 warm-up
SHARDED_LM_BATCH = {"llama": (2, 4096), "gpt": (1, 8192)}   # the LM slices'
LLAMA_WATCH = ("wte.embedding", "h.0.attn.q.kernel", "h.0.mlp.up.kernel")
# the async parameter-server phase (9)
ASYNC_SGD = {"lr": 0.1, "momentum": 0.9}
ASYNC_STEPS = 3                  # timed steps per worker, after 1 warm-up
ASYNC_SPEC = "bitflip:site=kv_push:p=0.05;drop:site=kv_push:p=0.1"
SERVER_SPEC = "bitflip:site=server_push:p=0.05"
FAULT_SEED = 7
ASYNC_DEVICE = "cuda"            # where the workers and codecs run
ONEBIT_SCALE_RTOL = 1e-5         # an L1 sum in another order (Queue C 6)
# the observed sharded update (10)
OBS_DEVICE = "cuda"
OBS_LLAMA_LAYERS = 4             # of Llama-3-8B's 32 (phase 8's cut)
OBSERVED_STEPS = 3               # timed steps of each tracing mode
OBS_TS_INTERVAL_S = 0.1          # the time-series sampler's cadence
OBS_WATCH = {"llama": ("h.0.attn.k.kernel", "h.0.attn.q.kernel"),
             "resnet": ("fc.weight", "blocks.13.convs.1.weight")}


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    """A failed check fails the run (unlike assert, never compiled out)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def same_bits(a, b):
    """Whether two f32 (or two 16-bit float) tensors have the same shape,
    dtype and bits (torch.equal takes -0.0 for +0.0)."""
    import torch
    bits = torch.int32 if a.element_size() == 4 else torch.int16
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(bits), b.view(bits)))


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
    return smi.splitlines()[0]


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
    want, _ = codec_reference(torch, registry, ONEBIT_EF, ctx,
                              raw["fc.weight"], snap)
    # rtol: the scale's L1 sum is taken in another order on the card
    torch.testing.assert_close(model.fc.weight.grad.cpu(), want, rtol=1e-5,
                               atol=0)
    log(f"slice: fc.weight ({len(ctx.chunk_bounds)} compressed chunks) and "
        f"fc.bias gradients equal the plain path's")

    # one more step under torch.profiler: the device's busy share, and the
    # onebit kernels' device time and device kernels per wrapper call
    before = dict(ok.launches)
    busy_ms, wall_ms, events, host_ms = profiled_step(torch, step,
                                                      thread_labels(eng))
    calls = {k: ok.launches[k] - before[k] for k in KERNELS}
    dev_ms = onebit_device_ms(events)
    log(f"slice: a profiled step took {wall_ms:.2f} ms, the device was busy "
        f"{busy_ms:.2f} ms of it ({busy_ms / wall_ms:.1%}); host ops' self "
        f"CPU ms by thread {_fmt(host_ms)}; onebit device "
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


# ----------------------------------------------------------- codec slice

def codec_reference(torch, registry, kw, ctx, raw, snap):
    """The compressed push_pull of ``raw`` at one rank, run chunk by chunk
    by the port's codec chain on the CPU from the states ``snap``
    (``comm/compressed.py`` without the all-gather): (result, the
    worker's new states)."""
    g = raw.detach().cpu().reshape(-1)
    outs, states = [], []
    for (off, ln), (ws, ss) in zip(ctx.chunk_bounds, snap):
        wc = registry.create(kw, ln, ctx.dtype)
        sc = registry.create(kw, ln, ctx.dtype, for_server=True)
        p, ws = wc.compress(g[off:off + ln], ws)
        y = wc.decompress_sum({k: v[None] for k, v in p.items()}).float()
        if wc.bidirectional:
            p2, _ = sc.compress(y, ss)
            y = sc.decompress(p2).float()
        outs.append(y.to(ctx.dtype))
        states.append(ws)
    return torch.cat(outs).reshape(raw.shape), states


def max_share(got, want):
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def off_share(got, want, tol=L2_TOL):
    """The share of elements farther than ``tol`` x max |want| apart."""
    return float(((got - want).abs() > tol * want.abs().max()).float()
                 .mean())


def check_received(torch, registry, arm, name, kw, ctx, raw, got, snap,
                   slots):
    """The gradient the optimizer received for ``name`` against the
    port's codec chain on the CPU on the same raw gradient; returns what
    was compared, for the log."""
    if ctx.compressor is None:              # an all-reduce over one rank
        check(same_bits(got.float(), raw.cpu().float()),
              f"codec {arm}: {name} (uncompressed) differs from its raw "
              f"gradient")
        return "bit-exact (uncompressed)"
    want, states = codec_reference(torch, registry, kw, ctx, raw, snap)
    codec = kw["compressor"]
    if codec in ("topk", "randomk") or (
            codec == "dithering" and kw.get("normalize", "max") == "max"):
        check(same_bits(got, want), f"codec {arm}: {name} differs from the "
              f"codec chain on the CPU (max share {max_share(got, want)})")
        return f"bit-exact ({codec})"
    if codec == "onebit":
        # the scale's L1 sum is taken in another order on the card
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        if kw.get("momentum") == "nesterov":
            for slot, ws in zip(slots, states):
                check(same_bits(slot.wstate["momentum"].cpu(),
                                ws["momentum"]),
                      f"codec {arm}: {name}'s momentum differs from the "
                      f"CPU's")
            return "rtol 1e-5 (onebit scale), momentum bit-exact"
        return "rtol 1e-5 (onebit scale)"
    if codec == "dithering":
        share = off_share(got, want)
        check(share <= L2_CODE_SHARE,
              f"codec {arm}: {name}: {share:.2e} of the elements farther "
              f"than {L2_TOL:g} of the max-abs from the CPU's")
        return (f"{share:.2e} of elements off by > {L2_TOL:g} x max-abs "
                f"(limit {L2_CODE_SHARE:g}), max share "
                f"{max_share(got, want):.2e}")
    if codec == "powersgd":
        err = max_share(got, want)
        # the control: rank 1 in place of the configured rank, from the
        # first column of the same warm start
        ckw = dict(kw, rank="1")
        csnap = [({"error": ws["error"], "inner": {"q": ws["inner"]["q"]
                                                   [:, :1]}}, ss)
                 for ws, ss in snap]
        control, _ = codec_reference(torch, registry, ckw, ctx, raw, csnap)
        cerr = max_share(control, want)
        check(err <= PSGD_CARD_TOL,
              f"codec {arm}: {name} {err:.2e} of the max-abs from the CPU's "
              f"(limit {PSGD_CARD_TOL:g})")
        check(cerr > PSGD_CARD_TOL,
              f"codec {arm}: the rank-1 control is within {PSGD_CARD_TOL:g} "
              f"({cerr:.2e}): the check cannot see a wrong rank")
        return (f"{err:.2e} of the max-abs (limit {PSGD_CARD_TOL:g}; rank-1 "
                f"control {cerr:.2e})")
    raise RuntimeError(f"chip_smoke: no check for codec {codec}")


def codec_slice_phase(torch, bps, ok, api, registry, resnet, Config):
    """Train ResNet-50 at full width through each arm of CODEC_ARMS;
    returns {arm: results}."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    init = resnet.resnet50(num_classes=CLASSES, generator=gen).state_dict()
    batch = resnet.synthetic_images(gen, BATCH, IMAGE, CLASSES, "cpu")
    out = {}
    for arm, wrapper, momentum, kw in CODEC_ARMS:
        t0 = time.perf_counter()
        out[arm] = codec_arm(torch, bps, ok, api, registry, resnet, Config,
                             arm, wrapper, momentum, kw, init, batch)
        log(f"codec {arm}: arm took {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    log("codec slice: arm, median step ms (min-max), busy, wire/raw bytes "
        "per step: " + "; ".join(
            f"{a} {r['median_ms']:.2f} ({r['min_ms']:.2f}-{r['max_ms']:.2f})"
            f" {r['busy']:.1%} {r['wire']}/{r['raw']}"
            for a, r in out.items()))
    return out


def codec_arm(torch, bps, ok, api, registry, resnet, Config, arm, wrapper,
              momentum, kw, init, batch):
    t_arm = time.perf_counter()
    bps.init(Config(compress_autotune=True) if arm == "autotune" else None)
    try:
        return _codec_arm(torch, bps, ok, api, registry, resnet, arm,
                          wrapper, momentum, kw, init, batch, t_arm)
    finally:
        bps.shutdown()


def _codec_arm(torch, bps, ok, api, registry, resnet, arm, wrapper,
               momentum, kw, init, batch, t_arm):
    check(bps.size() == 1, f"world of {bps.size()}, expected 1")
    dev = api.device()
    check(dev.type == "cuda", f"codec {arm} runs on {dev}")
    half = wrapper == "half"
    with torch.device("meta"):
        model = resnet.resnet50(num_classes=CLASSES, compute_dtype=(
            torch.float16 if half else torch.bfloat16))
    model = model.to_empty(device=dev)
    model.load_state_dict(init)
    if half:
        model.half()
    images, labels = batch["images"].to(dev), batch["labels"].to(dev)
    ce = torch.nn.functional.cross_entropy

    # the raw gradients (hooks registered before the wrapper's, so they
    # fire first) and the gradients the optimizer receives (a step
    # pre-hook of the inner optimizer)
    watch = {"fc.weight": model.fc.weight, "fc.bias": model.fc.bias}
    raw, received = {}, {}
    for name, p in watch.items():
        p.register_post_accumulate_grad_hook(
            lambda p, name=name: raw.__setitem__(name, p.grad.clone()))
    target = dict(watch)
    if wrapper == "half":
        p16 = [p for p in model.parameters() if p.requires_grad]
        p32 = [p.detach().float().requires_grad_() for p in p16]
        inner = torch.optim.SGD(p32, lr=0.1, momentum=momentum)
        for name, p in watch.items():
            target[name] = next(m for q, m in zip(p16, p32) if q is p)
        opt = bps.HalfPrecisionDistributedOptimizer(
            inner, fp16_params=p16, fp32_params=p32,
            loss_scale=HALF_LOSS_SCALE,
            named_parameters=model.named_parameters(), compression=kw)
        prefix = "Gradient."

        def step():
            opt.zero_grad()
            loss = ce(model(images).float(), labels)
            opt.scale_loss(loss).backward()
            opt.step()
            return loss
    else:
        inner = torch.optim.SGD(model.parameters(), lr=0.1,
                                momentum=momentum)
    if wrapper == "optimizer":
        opt = bps.DistributedOptimizer(
            inner, named_parameters=model.named_parameters(),
            compression=kw)
        prefix = "torch.grad."

        def step():
            opt.zero_grad()
            loss = ce(model(images), labels)
            loss.backward()
            opt.step()
            return loss
    elif wrapper == "ddp":
        ddp = bps.DistributedDataParallel(model, compression=kw)
        prefix = "ddp.grad."

        def step():
            inner.zero_grad()
            loss = ce(ddp(images), labels)
            loss.backward()
            inner.step()
            return loss
    elif wrapper == "cross_barrier":
        xb = bps.CrossBarrier(model, inner, compression=kw)
        prefix = "xb.grad."

        def step():
            # the forward's pre-hooks apply the last step's updates
            loss = ce(model(images), labels)
            loss.backward()
            xb.step()
            return loss

    def record(optimizer, args, kwargs):
        for name, p in target.items():
            if p.grad is not None:
                received[name] = p.grad.detach().clone()

    inner.register_step_pre_hook(record)

    def settle():
        if wrapper == "cross_barrier":
            xb.synchronize()
        torch.cuda.synchronize()

    eng = api.engine()
    secs = {"set-up": time.perf_counter() - t_arm}
    ok.reset_launches()
    t0 = t_steps = time.perf_counter()
    loss = step()
    settle()
    check(bool(torch.isfinite(loss)), f"codec {arm}: loss {loss.item()} at "
          f"the warm-up step")
    log(f"codec {arm}: warm-up step {(time.perf_counter() - t0) * 1e3:.1f} "
        f"ms, loss {loss.item():.4f}")
    steps = 1
    ctxs = [eng.registry.get(n) for n in
            eng.registry.names_in_declaration_order()]
    ctxs = [c for c in ctxs if c is not None and c.initialized]
    if arm == "autotune":
        # until every size bucket of a compressible tensor locks a codec
        while not all(eng.planner.locked(c.nbytes)
                      and eng.planner.compress_locked(c.nbytes)
                      for c in ctxs):
            check(steps < AUTOTUNE_MAX_STEPS,
                  f"codec autotune: buckets not locked after {steps} steps: "
                  f"{eng.planner.snapshot()['compression']['buckets']}")
            loss = step()
            steps += 1
            check(bool(torch.isfinite(loss)),
                  f"codec autotune: loss {loss.item()} at step {steps}")
        torch.cuda.synchronize()
        snap = eng.planner.snapshot()["compression"]["buckets"]
        locked = {int(b): s["locked_codec"] for b, s in snap.items()}
        log(f"codec autotune: every bucket locked after {steps} steps; "
            f"locked codec per bucket (nbytes < 2**b): "
            + ", ".join(f"2**{b} {c}" for b, c in sorted(locked.items()))
            + "; golden errors " + str(next(iter(snap.values()))
                                       ["golden_error"] if snap else {}))
    step_ms = []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(loss)),
              f"codec {arm}: loss {loss.item()} at timed step {i}")
    steps += TIMED_STEPS
    settle()
    launches = dict(ok.launches)
    comp = [c for c in ctxs if c.compressor]
    n_chunks = sum(len(c.chunk_bounds) for c in comp)
    wire = sum(s.worker.payload_nbytes() for c in comp for s in c.compressor)
    raw_bytes = sum(c.nbytes for c in comp)
    onebit = kw is not None and kw.get("compressor") == "onebit"
    if onebit:
        want = {"onebit_pack": 2 * n_chunks * steps,
                "onebit_unpack": 3 * n_chunks * steps,
                "onebit_unpack_sum": n_chunks * steps}
        check(launches == want, f"codec {arm}: onebit launches {launches}, "
              f"expected {want}")
    elif arm == "autotune":
        check(all(v > 0 for v in launches.values()),
              f"codec autotune: the ladder explored onebit, but the launches "
              f"are {launches}")
    else:
        check(not any(launches.values()),
              f"codec {arm}: onebit launches {launches} without onebit")

    secs["steps"] = time.perf_counter() - t_steps
    t0 = time.perf_counter()
    # one more step, checked: each watched gradient the optimizer received
    # against the port's codec chain on the CPU on the same raw gradient
    raw.clear()
    received.clear()
    names = {n: eng.registry.get(prefix + n) for n in watch}
    snaps = {n: [(_cpu(s.wstate), _cpu(s.sstate)) for s in c.compressor]
             if c.compressor else None for n, c in names.items()}
    slots = {n: c.compressor for n, c in names.items()}
    loss = step()
    settle()
    check(bool(torch.isfinite(loss)), f"codec {arm}: loss {loss.item()} at "
          f"the checked step")
    how = {}
    for name, ctx in names.items():
        got = received[name].cpu()
        r = raw[name]
        if half:        # the master gradient: the fp16 one, unscaled
            got = got * HALF_LOSS_SCALE
            check(received[name].dtype == torch.float32,
                  f"codec half: the master gradient is "
                  f"{received[name].dtype}")
            r = r.float()
        how[name] = check_received(torch, registry, arm, name,
                                   ctx.compression_kwargs or None, ctx, r,
                                   got.reshape(r.shape), snaps[name],
                                   slots[name])
    secs["check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    busy_ms, wall_ms, _, _ = profiled_step(
        torch, lambda: (step(), settle()), by_thread=False)
    secs["profile"] = time.perf_counter() - t0
    check(busy_ms > 0, f"codec {arm}: the profiled step shows no device "
          f"work")
    med = statistics.median(step_ms)
    codec = {n: (c.compression_kwargs or {}).get("compressor", "none")
             for n, c in names.items()}
    log(f"codec {arm}: steps {[round(t, 2) for t in step_ms]} ms, median "
        f"{med:.2f} ms; a profiled step {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}); {len(comp)} of "
        f"{len(ctxs)} tensors "
        f"compressed in {n_chunks} chunks, wire {wire} B per step against "
        f"{raw_bytes} B raw ({wire / max(raw_bytes, 1):.4f}); onebit "
        f"launches {launches} over {steps} steps; received gradients "
        f"(codec {codec}): {how}; seconds {_fmt(secs)}")
    return {"median_ms": med, "min_ms": min(step_ms), "max_ms": max(step_ms),
            "busy": busy_ms / wall_ms, "wire": wire, "raw": raw_bytes}


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


def lm_slice_phase(torch, bps, api, fa, Config, name, model_fn, cfg, batch,
                   seq, kernel_ms):
    """Train ``cfg`` in three arms, each on the same weights and batch
    from the seed: ``plain`` (SGD alone), ``ungrouped``
    (``UNGROUPED_ENGINE``) and the engine's defaults, the main path.  Returns the flash launches
    of the main path's run.  ``kernel_ms`` (each flash kernel's device ms
    at this slice's shape) gives the flash share of the step."""
    from byteps_tpu_torch.ops.flash_attention import flash_attention

    arms = {}
    for arm, engine, config in (("plain", False, None),
                                ("ungrouped", True,
                                 Config(**UNGROUPED_ENGINE)),
                                ("defaults", True, None)):
        arms[arm] = lm_arm(torch, bps, api, fa, name, model_fn, cfg, batch,
                           seq, arm, engine, config)
    main = arms["defaults"]
    plain_ms = arms["plain"]["median_ms"]
    for arm, r in arms.items():
        log(f"{name}: {arm}: median {r['median_ms']:.2f} ms (min "
            f"{min(r['step_ms']):.2f}, max {max(r['step_ms']):.2f}) over "
            f"{len(r['step_ms'])} steps after {r['warmup']} warm-up; step - "
            f"plain step {r['median_ms'] - plain_ms:.2f} ms; profiled step "
            f"{r['wall_ms']:.2f} ms, device busy {r['busy_ms']:.2f} ms "
            f"({r['busy_ms'] / r['wall_ms']:.1%}); host ops' self CPU ms by "
            f"thread {_fmt(r['host_ms'])}; thread CPU s over the timed steps "
            f"{_fmt(r['cpu_s'], 3)}; peak memory {r['peak_gib']:.2f} GiB")
    losses = {a: r["losses"][0] for a, r in arms.items()}
    log(f"{name}: first losses {losses} (same weights and batch in each "
        f"arm)")
    flash_ms = cfg.num_layers * sum(kernel_ms.values())
    log(f"{name}: flash kernels {flash_ms:.2f} ms per step ({cfg.num_layers}"
        f" x their device ms at this shape), {flash_ms / main['median_ms']:.1%}"
        f" of the main path's median step")
    check_logits(torch, name, main["model"], main["ids"], flash_attention)
    main["model"] = main["ids"] = None
    torch.cuda.empty_cache()
    return main["launches"]


def lm_arm(torch, bps, api, fa, name, model_fn, cfg, batch, seq, arm,
           engine, config):
    """One arm of an LM slice: build the model and batch from the seed,
    without the engine, or through ``DistributedOptimizer`` and an engine
    started by ``bps.init(config)`` (``None``: the environment's config,
    the defaults; that arm is the main path); take warm-up steps (the
    main path's until every planner bucket has locked, at most
    LM_WARMUP_MAX), LM_TIMED_STEPS timed steps, then for the main path one
    step whose every received gradient must equal its raw gradient bit
    for bit, and one step under torch.profiler."""
    from byteps_tpu_torch.models.gpt import lm_loss
    from byteps_tpu_torch.ops.flash_attention import flash_attention
    from byteps_tpu_torch.parallel.long_context import synthetic_lm_batch

    from byteps_tpu_torch.comm.mesh import resolve_device

    main = engine and config is None
    if engine:
        bps.init(config)                           # NCCL, world of one
        dev = api.device()
    else:
        dev = resolve_device("cuda")               # this process's card
    gen = torch.Generator(device=dev).manual_seed(3)
    model = model_fn(cfg, attn_fn=flash_attention, device=dev, generator=gen)
    data = synthetic_lm_batch(gen, cfg, batch, seq)
    ids, labels = data["input_ids"], data["labels"]
    opt = torch.optim.SGD(model.parameters(), lr=LM_LR, momentum=0.9)
    eng = None
    if engine:
        eng = api.engine()
        opt = bps.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
        if main:
            ec = eng.cfg
            check((ec.group_size, ec.autotune, ec.use_native)
                  == (4, True, True) and not ec.partition_pinned,
                  f"{name}: the main path runs with the engine's defaults, "
                  f"got {ec}")
            check(type(eng.scheduler).__name__ == "NativeChunkScheduler",
                  f"{name}: scheduler {type(eng.scheduler).__name__}, "
                  f"expected the native one")

    def step():
        opt.zero_grad()
        loss = lm_loss(model(ids), labels)
        loss.backward()
        opt.step()
        return loss

    losses, per_step, peak_gib = [], [], []

    def run_step():
        before = dict(eng.stats) if eng is not None else None
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak_gib.append(torch.cuda.max_memory_allocated() / 2**30)
        losses.append(loss.item())
        check(math.isfinite(losses[-1]), f"{name} {arm}: loss {losses[-1]} "
                                         f"at step {len(losses)}")
        if eng is not None:
            per_step.append(tuple(eng.stats[k] - before[k]
                                  for k in ("dispatches", "chunks")))
        return ms

    fa.reset_launches()
    warm = [run_step()]
    while main and not planner_locked(eng):
        check(len(warm) < LM_WARMUP_MAX,
              f"{name}: planner buckets not all locked after "
              f"{len(warm)} warm-up steps: {eng.planner.snapshot()}")
        warm.append(run_step())
    threads = thread_labels(eng)
    cpu0 = thread_cpu_s(threads)
    step_ms = [run_step() for _ in range(LM_TIMED_STEPS)]
    cpu_s = {k: v - cpu0.get(k, 0.0)
             for k, v in thread_cpu_s(threads).items()}
    launches = dict(fa.launches)
    steps = len(warm) + LM_TIMED_STEPS
    want = {k: cfg.num_layers * steps for k in FLASH_KERNELS}
    check(launches == want, f"{name} {arm}: flash launches {launches}, "
                            f"expected {want}")
    if eng is not None:
        d, c = (sum(x[i] for x in per_step) for i in range(2))
        log(f"{name}: {arm}: scheduler {type(eng.scheduler).__name__}, "
            f"engine stats per step (dispatches, chunks) {per_step}, "
            f"{d} dispatches for {c} chunks in all; peak memory per step "
            f"{[round(g, 2) for g in peak_gib]} GiB")
        if main:
            check(d < c, f"{name}: {d} dispatches for {c} chunks: no chunk "
                         f"was grouped")
            snap = eng.planner.snapshot()
            log(f"{name}: planner locked after {len(warm)} warm-up steps: "
                + ", ".join(f"bucket {b} -> {v['locked_partition_bytes']} B"
                            for b, v in sorted(snap["buckets"].items(),
                                               key=lambda kv: int(kv[0])))
                + f"; credit window {snap['credit_bytes']} B; least "
                f"seconds per candidate {[(b, v['explored']) for b, v in snap['buckets'].items()]}")
            check(max(peak_gib) * 2**30 < 80e9,
                  f"{name}: peak memory {max(peak_gib):.2f} GiB")
            log(f"{name}: peak memory {max(peak_gib):.2f} GiB over the arm, "
                f"{max(peak_gib[len(warm):]):.2f} GiB over the timed steps "
                f"(before chunk groups and the planner: "
                f"{EARLIER_LLAMA_PEAK_GIB} GiB for the Llama slice)")
            check_every_gradient(torch, name, model, step)
        else:
            check(d == c, f"{name}: {arm}: {d} dispatches for {c} chunks")
    busy_ms, wall_ms, _, host_ms = profiled_step(torch, step, threads)
    out = {"step_ms": step_ms, "median_ms": statistics.median(step_ms),
           "warmup": len(warm), "losses": losses, "busy_ms": busy_ms,
           "wall_ms": wall_ms, "host_ms": host_ms, "cpu_s": cpu_s,
           "peak_gib": max(peak_gib), "launches": launches}
    if engine:
        bps.shutdown()
    del opt, step, run_step
    if main:
        model.zero_grad(set_to_none=True)
        out["model"], out["ids"] = model, ids
    else:
        del model
    del data, labels
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- sharded update

def _timed_arm_steps(torch, name, step, after=None):
    """1 warm-up and SHARDED_STEPS timed steps of ``step`` (which returns
    the loss), each ending in a synchronize; the loss must be finite at
    every step.  ``after(i)`` runs after step i, outside the timing (the
    checks).  Returns (timed step ms, losses)."""
    ms, losses = [], []
    for i in range(1 + SHARDED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(loss.detach().item())
        check(math.isfinite(losses[-1]),
              f"{name}: loss {losses[-1]} at step {i}")
        if i:
            ms.append(dt)
        if after is not None:
            after(i)
    return ms, losses


def _state_nbytes(torch, opt):
    """Bytes of the tensors a torch optimizer's state holds."""
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if torch.is_tensor(v))


def _engine_arm_report(torch, eng, inner, ms, wire, nbytes, name):
    """The slots' and the inner optimizer's state bytes, the wire per step
    (at one rank push N and pull N), and the arm's row."""
    slot_bytes = sum(s.state_nbytes() for s in eng.update_slots.values())
    inner_bytes = _state_nbytes(torch, inner)
    check(inner_bytes == 0, f"{name}: the inner optimizer holds "
                            f"{inner_bytes} B of state")
    check(all(w == (nbytes, nbytes) for w in wire),
          f"{name}: wire (push, pull) per step {wire}, expected "
          f"({nbytes}, {nbytes}) at one rank")
    return {"arm": name, "step_ms": ms, "peak_gib":
            torch.cuda.max_memory_allocated() / 2**30,
            "state_bytes": slot_bytes, "inner_bytes": inner_bytes,
            "wire": wire[-1]}


def llama_sharded_arm(torch, bps, api, Config, llama):
    """Llama-3-8B width, 4 layers, bf16 parameters, the LM slice's batch and
    data, AdamW through DistributedOptimizer(sharded_update=True): each
    slot's f32 master and moments live in the engine.  For the embedding,
    one attention and one MLP weight, an f32 master of its own with its
    own AdamW takes the raw gradient (the averaged one, at one rank) after
    each step, and cast to bf16 it must equal the emitted parameter bit
    for bit; the control, the bf16 parameter stepped by AdamW without a
    master, must differ."""
    from byteps_tpu_torch.models.gpt import lm_loss
    from byteps_tpu_torch.ops.flash_attention import flash_attention
    from byteps_tpu_torch.parallel.long_context import synthetic_lm_batch

    name = "llama_sharded"
    torch.cuda.reset_peak_memory_stats()
    bps.init(Config(sharded_update=True))               # NCCL, world of one
    eng, dev = api.engine(), api.device()
    cfg = dataclasses.replace(llama.llama3_8b(), num_layers=4)
    gen = torch.Generator(device=dev).manual_seed(3)
    model = llama.Llama(cfg, attn_fn=flash_attention, device=dev,
                        generator=gen).to(torch.bfloat16)
    data = synthetic_lm_batch(gen, cfg, *SHARDED_LM_BATCH["llama"])
    ids, labels = data["input_ids"], data["labels"]
    params = dict(model.named_parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    inner = torch.optim.AdamW(model.parameters(), **SHARDED_ADAMW)
    opt = bps.DistributedOptimizer(
        inner, named_parameters=model.named_parameters(),
        sharded_update=True)
    refs = {n: params[n].detach().float() for n in LLAMA_WATCH}
    ref_opts = {n: torch.optim.AdamW([r], **SHARDED_ADAMW)
                for n, r in refs.items()}
    ctrls = {n: params[n].detach().clone() for n in LLAMA_WATCH}
    ctrl_opts = {n: torch.optim.AdamW([c], **SHARDED_ADAMW)
                 for n, c in ctrls.items()}
    wire, differ = [], {}

    def step():
        before = (eng.stats["wire_push"], eng.stats["wire_pull"])
        opt.zero_grad()
        loss = lm_loss(model(ids), labels)
        loss.backward()
        opt.step()
        wire.append((eng.stats["wire_push"] - before[0],
                     eng.stats["wire_pull"] - before[1]))
        return loss

    def after(i):
        for n in LLAMA_WATCH:
            g = params[n].grad
            refs[n].grad = g.float()
            ref_opts[n].step()
            refs[n].grad = None
            ctrls[n].grad = g.clone()
            ctrl_opts[n].step()
            ctrls[n].grad = None
            check(same_bits(refs[n].bfloat16(), params[n].detach()),
                  f"{name}: {n} after step {i} differs from its f32-master "
                  f"reference cast to bf16")
            differ[n] = not same_bits(ctrls[n], params[n].detach())

    ms, losses = _timed_arm_steps(torch, name, step, after)
    check(all(differ.values()), f"{name}: the control (bf16 parameters "
                                f"stepped without a master) did not differ: "
                                f"{differ}")
    row = _engine_arm_report(torch, eng, inner, ms, wire, nbytes, name)
    log(f"{name}: {len(params)} tensors, {nbytes} B of bf16 parameters; "
        f"{', '.join(LLAMA_WATCH)} equal their f32-master references cast "
        f"to bf16 after each of {len(losses)} steps, the bf16-stepped "
        f"control differs; losses {[round(x, 4) for x in losses]}")
    bps.shutdown()
    del opt, inner, model, params, refs, ref_opts, ctrls, ctrl_opts, data
    torch.cuda.empty_cache()
    return row


def resnet_sharded_arm(torch, bps, api, Config, resnet):
    """ResNet-50 at full width (f32 parameters), the ResNet slice's batch,
    SGD(momentum=0.9) with foreach pinned: DistributedOptimizer with
    sharded_update on one copy, the unsharded DistributedOptimizer on
    another, in one engine.  The unsharded copy takes the sharded copy's
    raw gradients of each step through autograd (a backward of its
    leaves), so the comparison is independent of cuDNN's determinism;
    after the steps every parameter of the two must be equal, bit for
    bit."""
    import copy

    name = "resnet_sharded"
    torch.cuda.reset_peak_memory_stats()
    bps.init(Config(sharded_update=True))
    eng, dev = api.engine(), api.device()
    gen = torch.Generator().manual_seed(0)
    a = resnet.resnet50(num_classes=CLASSES, generator=gen).to(dev)
    b = copy.deepcopy(a)
    batch = resnet.synthetic_images(gen, BATCH, IMAGE, CLASSES, dev)
    images, labels = batch["images"], batch["labels"]
    nbytes = sum(p.numel() * p.element_size() for p in a.parameters())
    inner = torch.optim.SGD(a.parameters(), **SHARDED_SGD)
    opt_a = bps.DistributedOptimizer(
        inner, named_parameters=[(f"sharded.{n}", p)
                                 for n, p in a.named_parameters()],
        sharded_update=True)
    inner_b = torch.optim.SGD(b.parameters(), **SHARDED_SGD)
    opt_b = bps.DistributedOptimizer(
        inner_b, named_parameters=[(f"replicated.{n}", p)
                                   for n, p in b.named_parameters()],
        sharded_update=False)
    wire = []

    def step():
        before = (eng.stats["wire_push"], eng.stats["wire_pull"])
        opt_a.zero_grad()
        loss = torch.nn.functional.cross_entropy(a(images), labels)
        loss.backward()
        opt_a.step()
        wire.append((eng.stats["wire_push"] - before[0],
                     eng.stats["wire_pull"] - before[1]))
        return loss

    def after(i):
        opt_b.zero_grad()
        torch.autograd.backward(list(b.parameters()),
                                [p.grad for p in a.parameters()])
        opt_b.step()

    ms, losses = _timed_arm_steps(torch, name, step, after)
    diff = [n for (n, p), q in zip(a.named_parameters(), b.parameters())
            if not same_bits(p.detach(), q.detach())]
    check(not diff, f"{name}: {len(diff)} parameters differ from the "
                    f"unsharded arm's, first {diff[:3]}")
    row = _engine_arm_report(torch, eng, inner, ms, wire, nbytes, name)
    row["unsharded_inner_bytes"] = _state_nbytes(torch, inner_b)
    log(f"{name}: every one of {len(list(a.parameters()))} parameters equals "
        f"the unsharded arm's bit for bit after {len(losses)} steps; the "
        f"unsharded inner optimizer holds {row['unsharded_inner_bytes']} B; "
        f"losses {[round(x, 4) for x in losses]}")
    bps.shutdown()
    del opt_a, opt_b, inner, inner_b, a, b, batch, images, labels
    torch.cuda.empty_cache()
    return row


def gpt_zero_arm(torch, bps, api, gpt, kind):
    """GPT-small at full width (1 x 8192 tokens, flash attention), AdamW
    through ZeRO-1 (bf16 parameters, an f32 master) or flat FSDP (an f32
    template, bf16 compute), at a world of one.  The plain step with an
    f32 master: a master per parameter from the template's values, its
    own AdamW fed the raw gradients of each step (captured by hooks), and
    its loss from a forward of a bf16 copy of the model holding its
    masters.  Losses and masters must be equal bit for bit (at one rank
    the reduce-scatter and the all-gather are identities, the division
    by 1 is exact, and AdamW on the flat vector is AdamW on each tensor
    element for element); the control, the bf16 parameters stepped by
    AdamW without a master, must differ."""
    from byteps_tpu_torch.models.gpt import lm_loss
    from byteps_tpu_torch.ops.flash_attention import flash_attention
    from byteps_tpu_torch.parallel import zero
    from byteps_tpu_torch.parallel.long_context import synthetic_lm_batch

    name = f"gpt_{kind}"
    torch.cuda.reset_peak_memory_stats()
    bps.init()
    comm, dev = api.engine().comm, api.device()
    cfg = gpt.gpt_small()
    gen = torch.Generator(device=dev).manual_seed(3)
    model = gpt.GPT(cfg, attn_fn=flash_attention, device=dev, generator=gen)
    if kind == "zero1":
        model = model.to(torch.bfloat16)
    data = synthetic_lm_batch(gen, cfg, *SHARDED_LM_BATCH["gpt"])
    batch = (data["input_ids"], data["labels"])
    masters = {n: p.detach().float().clone()
               for n, p in model.named_parameters()}
    ref_opt = torch.optim.AdamW(list(masters.values()), **SHARDED_ADAMW)
    ctrls = {n: m.bfloat16() for n, m in masters.items()}
    ctrl_opt = torch.optim.AdamW(list(ctrls.values()), **SHARDED_ADAMW)
    plain = gpt.GPT(cfg, attn_fn=flash_attention, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4)
                    ).to(torch.bfloat16)
    raw = {}
    for n, p in model.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, n=n: raw.__setitem__(n, p.grad.clone()))
    zs = zero.init_zero_state(
        comm, model, lambda ps: torch.optim.AdamW(ps, **SHARDED_ADAMW))

    def loss_fn(m, b):
        return lm_loss(m(b[0]), b[1])

    if kind == "zero1":
        zstep = zero.make_zero_train_step(comm, model, loss_fn)
    else:
        zstep = zero.make_fsdp_train_step(comm, model, loss_fn,
                                          compute_dtype=torch.bfloat16)
    n = sum(m.numel() for m in masters.values())
    differ = []

    def plain_loss():
        """The plain step's loss at its current masters (bf16 copies)."""
        with torch.no_grad():
            for (_, p), m in zip(plain.named_parameters(), masters.values()):
                p.copy_(m)
            return float(loss_fn(plain, batch))

    ref_losses = [plain_loss()]

    def after(i):
        for k, m in masters.items():
            m.grad = raw[k].float()
            ctrls[k].grad = raw[k]
        ref_opt.step()
        ctrl_opt.step()
        raw.clear()
        flat = torch.cat([m.reshape(-1) for m in masters.values()])
        check(same_bits(zs.master[:n], flat),
              f"{name}: the master after step {i} differs from the plain "
              f"step's f32 masters")
        differ.append(not all(same_bits(c, m.bfloat16())
                              for c, m in zip(ctrls.values(),
                                              masters.values())))
        ref_losses.append(plain_loss())        # the next step's

    ms, losses = _timed_arm_steps(torch, name, lambda: zstep(zs, batch),
                                  after)
    check(losses == ref_losses[:-1], f"{name}: losses {losses}, the plain "
                                     f"step's {ref_losses[:-1]}")
    check(differ[-1], f"{name}: the control (bf16 parameters stepped "
                      f"without a master) did not differ")
    state = (zs.master.numel() * 4 + _state_nbytes(torch, zs.optimizer))
    log(f"{name}: {n} parameters; losses {[round(x, 4) for x in losses]} "
        f"and the f32 masters equal the plain step's bit for bit after each "
        f"of {len(losses)} steps, the bf16-stepped control differs")
    row = {"arm": name, "step_ms": ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "state_bytes": state, "inner_bytes": None, "wire": None}
    bps.shutdown()
    del zs, zstep, model, plain, masters, ref_opt, ctrls, ctrl_opt, data
    torch.cuda.empty_cache()
    return row


def sharded_phase(torch, bps, api, Config, llama, gpt, resnet):
    """Phase 8: the sharded weight update and ZeRO on the card, four arms,
    each freed before the next (the docstring at the top)."""
    rows = [llama_sharded_arm(torch, bps, api, Config, llama),
            resnet_sharded_arm(torch, bps, api, Config, resnet),
            gpt_zero_arm(torch, bps, api, gpt, "zero1"),
            gpt_zero_arm(torch, bps, api, gpt, "fsdp")]
    for r in rows:
        ms = r["step_ms"]
        inner = ("none (ZeRO)" if r["inner_bytes"] is None
                 else f"{r['inner_bytes']} B")
        wire = ("not through the engine" if r["wire"] is None
                else f"push {r['wire'][0]} B, pull {r['wire'][1]} B")
        log(f"sharded update: {r['arm']}: median {statistics.median(ms):.2f}"
            f" ms (min {min(ms):.2f}, max {max(ms):.2f}) over {len(ms)} "
            f"steps after 1 warm-up; peak {r['peak_gib']:.2f} GiB; state "
            f"{r['state_bytes']} B in the slots/ZeroState, inner optimizer "
            f"{inner}; wire per step {wire}")
    return rows


def planner_locked(eng):
    """Whether every planner bucket (tensors above the base bound) has
    locked its chunk size; False while there is none yet."""
    buckets = eng.planner.snapshot()["buckets"]
    return bool(buckets) and all(b["locked_partition_bytes"] is not None
                                 for b in buckets.values())


def check_every_gradient(torch, name, model, step):
    """One step in which every parameter's received gradient (what the
    optimizer steps with) must equal its raw gradient bit for bit: an
    all-reduce over one rank is the identity, whatever the grouping and
    the chunk sizes.  The raw gradients are cloned by hooks registered
    after the DistributedOptimizer's, which only enqueue."""
    raw, hooks = {}, []
    params = dict(model.named_parameters())
    for pname, p in params.items():
        hooks.append(p.register_post_accumulate_grad_hook(
            lambda p, pname=pname: raw.__setitem__(pname, p.grad.clone())))
    try:
        step()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    differ = [n for n, p in params.items()
              if not torch.equal(p.grad.view(torch.int32),
                                 raw[n].view(torch.int32))]
    check(len(raw) == len(params) and not differ,
          f"{name}: received gradients differ from the raw ones: "
          f"{differ[:5]} ({len(differ)} of {len(params)})")
    log(f"{name}: every one of {len(params)} received gradients equals its "
        f"raw gradient bit for bit")
    del raw


def check_logits(torch, name, model, ids, flash_attention):
    """A forward with ``flash_attention`` and one with the exact
    ``full_attention`` on the same weights and batch must agree to
    LM_LOGIT_TOL of the logits' max-abs, while two controls (attention
    zeroed for the later half of the positions, and everywhere) must
    not."""
    from byteps_tpu_torch.parallel.sequence import full_attention

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


def thread_labels(eng):
    """{OS thread id: label} of the threads a step's host time is split
    over: main, and the engine's dispatcher and syncer; any other thread
    (PyTorch's autograd thread, which runs the hooks) goes by its name."""
    import threading
    out = {threading.main_thread().native_id: "main"}
    if eng is not None:
        out[eng._dispatcher.native_id] = "bps-dispatch"
        out[eng._syncer.native_id] = "bps-sync"
    return out


def _thread_name(tid, labels):
    if tid in labels:
        return labels[tid]
    try:
        with open(f"/proc/self/task/{tid}/comm") as f:
            return f.read().strip()
    except OSError:
        return f"thread {tid}"


def thread_cpu_s(labels):
    """User + system CPU seconds so far of each thread of this process
    (``/proc/self/task``), by label; threads of one name are summed."""
    tick = os.sysconf("SC_CLK_TCK")
    out = collections.defaultdict(float)
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue            # the thread ended meanwhile
        out[_thread_name(int(tid), labels)] += (
            int(fields[11]) + int(fields[12])) / tick
    return dict(out)


def _fmt(d, digits=2):
    return "{" + ", ".join(f"{k} {v:.{digits}f}" for k, v in sorted(
        d.items(), key=lambda kv: -kv[1]) if v) + "}"


def _union_us(spans):
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def profiled_step(torch, step, threads=None, by_thread=True):
    """(device-busy ms, host ms, device events, host ms by thread) of one
    ``step`` under torch.profiler: the union of the intervals of the
    kernels and copies on the card (user annotations left out), the host
    clock around the step, those kernels and copies as (name, ms), and
    for each thread the union of its host events' intervals, which is
    their self CPU time summed (events nest), labelled by ``threads``
    ({OS thread id: label}) or the thread's name.  ``by_thread=False``
    skips the split by thread (a chrome trace exported and read back),
    and the last item is then empty."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    try:
        from torch._C._profiler import _ExperimentalConfig
        every_thread = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        every_thread = None       # then only the profiling thread is seen
    # without the split by thread only the card's activity is traced:
    # thousands of host ops a ResNet step cost seconds to read back
    activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if by_thread
                  else [ProfilerActivity.CUDA])
    with profile(activities=activities,
                 experimental_config=every_thread if by_thread else None
                 ) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in events)
    dev_events = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                  for e in events]
    if not by_thread:
        return busy_us / 1e3, wall_ms, dev_events, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    spans = collections.defaultdict(list)
    for e in trace:
        if (e.get("ph") == "X" and isinstance(e.get("tid"), int)
                and e.get("cat") in ("cpu_op", "cuda_runtime",
                                     "cuda_driver")):
            spans[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0)))
    host_ms = collections.defaultdict(float)
    for tid, sp in spans.items():
        host_ms[_thread_name(tid, threads or {})] += _union_us(sp) / 1e3
    if every_thread is None:
        host_ms["(other threads not recorded)"] = 0.0
    return busy_us / 1e3, wall_ms, dev_events, dict(host_ms)


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


# ------------------------------------------------- 9. async parameter server

def _stage_timers(targets):
    """Wrap each ``(module, attribute, stage)`` so that its calls add their
    host seconds to ``acc[stage]``; returns (acc, restore)."""
    acc = collections.defaultdict(float)
    saved = []
    for mod, attr, stage in targets:
        real = getattr(mod, attr)

        def timed(*a, _real=real, _stage=stage, **kw):
            t0 = time.perf_counter()
            try:
                return _real(*a, **kw)
            finally:
                acc[_stage] += time.perf_counter() - t0

        saved.append((mod, attr, real))
        setattr(mod, attr, timed)

    def restore():
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return acc, restore


def _median_line(ms):
    return (f"median {statistics.median(ms):.2f} ms "
            f"({min(ms):.2f}-{max(ms):.2f})")


def async_arm(torch, bps, ok, resnet, smi, name, *, replay=None,
              spec=None, compression=None, integrity=True):
    """Two ResNet-50 replicas on the card, one ``AsyncDistributedOptimizer``
    each (SGD with momentum), sharing one ``KVStore``, stepping in turn:
    1 warm-up and ASYNC_STEPS timed steps each.  ``replay``: the raw
    gradients of an earlier arm, set as ``p.grad`` in place of a forward
    and backward (so the comparison does not rest on cuDNN's
    determinism).  ``spec``: a fault spec armed for the run.  After every
    step the stepping worker's parameters must equal the store's value
    bit for bit, and every key ends at 2 x (1 + ASYNC_STEPS) versions.
    Returns the arm's record."""
    import copy
    from byteps_tpu_torch.common import config as cfg_mod
    from byteps_tpu_torch.common import integrity as integ
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.fault import injector
    from byteps_tpu_torch.server import kv_store

    torch.cuda.reset_peak_memory_stats()
    cfg_mod.set_config(cfg_mod.Config(integrity_on=integrity))
    counters.reset()
    store = bps.KVStore(ASYNC_DEVICE)
    dev = store.device
    gen = torch.Generator().manual_seed(0)
    models = [resnet.resnet50(num_classes=CLASSES, generator=gen).to(dev)]
    models.append(copy.deepcopy(models[0]))
    names = [n for n, _ in models[0].named_parameters()]
    keys = [f"async.{n}" for n in names]
    init = [p.detach().cpu().numpy().copy() for p in models[0].parameters()]
    batches = [resnet.synthetic_images(torch.Generator().manual_seed(1 + w),
                                       BATCH, IMAGE, CLASSES, dev)
               for w in range(2)]
    opts = [bps.AsyncDistributedOptimizer(
        torch.optim.SGD(m.parameters(), **ASYNC_SGD),
        named_parameters=m.named_parameters(), store=store,
        compression=compression, worker_id=w)
        for w, m in enumerate(models)]
    # what lands, in arrival order (chaos-free arms: one call per push)
    pushed = []
    push_attr = "push_delta_wire" if compression else "push_delta"
    real_push = getattr(store, push_attr)

    def recording(key, payload, **kw):
        t0 = time.perf_counter()
        pushed.append((key, payload if compression else
                       payload.numpy().copy()))
        record_s[0] += time.perf_counter() - t0
        return real_push(key, payload, **kw)

    record_s = [0.0]
    if spec is None:
        setattr(store, push_attr, recording)
    acc, restore = _stage_timers([
        (integ, "seal_array", "seal+crc"), (integ, "seal_bytes", "seal+crc"),
        (integ, "open_array", "open+crc"), (integ, "open_bytes", "open+crc"),
        (integ, "screen_nonfinite", "screen"),
        (kv_store, "decode", "decode"), (kv_store, "inplace_add", "sum"),
        (kv_store, "_copy_outside_lock", "pull copy")])
    grads = {}

    def step(w, i):
        m, opt = models[w], opts[w]
        opt.zero_grad()
        loss = None
        if replay is None:
            images, labels = batches[w]["images"], batches[w]["labels"]
            loss = torch.nn.functional.cross_entropy(m(images), labels)
            loss.backward()
            grads.setdefault((w, i), [p.grad.clone()
                                      for p in m.parameters()])
        else:
            for p, g in zip(m.parameters(), replay[(w, i)]):
                p.grad = g
        opt.step()
        return loss

    if spec is not None:
        injector.arm(spec, seed=FAULT_SEED)
    ok.reset_launches()
    step_ms, stages, mismatch = [], collections.defaultdict(float), []
    try:
        for i in range(1 + ASYNC_STEPS):
            for w in range(2):
                for k in acc:
                    acc[k] = 0.0
                record_s[0] = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = step(w, i)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                if loss is not None:
                    check(math.isfinite(loss.item()),
                          f"{name}: loss {loss.item()} at step {i}")
                if i:
                    step_ms.append(dt)
                    for k, v in opts[w].stage_ms.items():
                        stages[k] += v / (2 * ASYNC_STEPS)
                    for k, v in acc.items():
                        stages[k] += v * 1e3 / (2 * ASYNC_STEPS)
                    stages["record"] += record_s[0] * 1e3 / (2 * ASYNC_STEPS)
                # the worker's parameters are the store's value at its pull
                mismatch += [(w, i, k) for k, p in zip(
                    keys, models[w].parameters())
                    if not same_bits(p.detach().cpu(), store.pull(k))]
    finally:
        injector.disarm()
        restore()
        setattr(store, push_attr, real_push)
    launches = dict(ok.launches)
    check(not mismatch, f"{name}: {len(mismatch)} parameters differ from "
                        f"the store after their worker's pull, first "
                        f"{mismatch[:3]}")
    versions = {store.version(k) for k in keys}
    check(versions == {2 * (1 + ASYNC_STEPS)},
          f"{name}: versions {sorted(versions)}, expected "
          f"{2 * (1 + ASYNC_STEPS)} pushes per key")
    snap = {"store": {k: store.pull(k) for k in keys},
            "params": [[p.detach().to("cpu", copy=True)
                        for p in m.parameters()] for m in models]}
    ctr = {k: counters.get(k) for k in (
        "integrity.crc_reject", "integrity.retransmit",
        "integrity.dup_dropped", "fault.bitflip", "fault.drop",
        "retry.attempt")}
    # one more step of worker 0 under the profiler: the busy share, and
    # the onebit kernels on the card per step
    last = (0, ASYNC_STEPS)
    busy_ms, wall_ms, events, _ = profiled_step(
        torch, lambda: step(*last) if replay is None else (
            [setattr(p, "grad", g) for p, g in zip(
                models[0].parameters(), replay[last])],
            opts[0].step()), by_thread=False)
    kernels = onebit_device_ms(events)
    raw_bytes = sum(p.numel() * p.element_size()
                    for p in models[0].parameters())
    rec = {"arm": name, "step_ms": step_ms, "stages": dict(stages),
           "busy": busy_ms / wall_ms, "counters": ctr, "pushed": pushed,
           "init": init, "keys": keys, "snap": snap, "grads": grads,
           "launches": launches, "kernels": kernels, "store": store,
           "wire": (store.wire_bytes, store.wire_bytes_wasted),
           "raw_bytes": raw_bytes, "host_bytes": store.nbytes(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"{name} [{smi}]: {_median_line(step_ms)} a worker step over "
        f"{len(step_ms)}; busy {100 * rec['busy']:.1f} % of a profiled step "
        f"({busy_ms:.2f} of {wall_ms:.2f} ms); host ms a step "
        f"{_fmt(rec['stages'])}; pushed {raw_bytes} B raw a worker step, "
        f"wire landed {rec['wire'][0]} B, wasted {rec['wire'][1]} B; store "
        f"host {rec['host_bytes']} B; peak {rec['peak_gib']:.2f} GiB; "
        f"counters {ctr}")
    cfg_mod.reset_config()
    del opts, models, batches
    torch.cuda.empty_cache()
    return rec


def _replay_raw(rec, drop=None):
    """The store's final value by numpy: the initial value plus every
    recorded delta in arrival order (``drop``: the index of one delta to
    leave out)."""
    import numpy as np
    acc = {k: np.array(v) for k, v in zip(rec["keys"], rec["init"])}
    for j, (key, delta) in enumerate(rec["pushed"]):
        if j != drop:
            acc[key] += delta.reshape(acc[key].shape)
    return acc


def _replay_onebit(torch, registry, rec):
    """The onebit arm's store by the CPU: every landed wire frame decoded
    by the server chain's plain versions and summed in arrival order."""
    import numpy as np
    acc = {k: np.array(v) for k, v in zip(rec["keys"], rec["init"])}
    codecs = {}
    for key, wire in rec["pushed"]:
        a = acc[key]
        comp = codecs.get(key) or codecs.setdefault(key, registry.create(
            ONEBIT_EF, a.size, torch.float32, for_server=True))
        acc[key] += comp.decompress(comp.wire_decode(wire)).numpy() \
            .reshape(a.shape)
    return acc


def _same_store(torch, store_snap, replay):
    return [k for k, v in store_snap.items()
            if not same_bits(v, torch.from_numpy(replay[k]))]


def server_engine_arm(torch, bps, registry, ok, smi, grads, keys):
    """A ServerEngine with 4 threads on the card takes ResNet-50's 161
    gradients from 2 simulated workers (the async arm's recorded raw
    gradients of step 0) per round: each pull must equal ``a + b`` bit
    for bit; a onebit round through push_compressed/pull_compressed must
    merge to the CPU chain's decode bit for bit and re-encode to its
    words (the scale, an L1 sum in another order, to ONEBIT_SCALE_RTOL);
    and with
    SERVER_SPEC armed the round must equal the clean one bit for bit."""
    import numpy as np
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.fault import injector

    a = [g.cpu() for g in grads[(0, 0)]]
    b = [g.cpu() for g in grads[(1, 0)]]
    want = [x + y for x, y in zip(a, b)]

    def dense_round():
        eng = bps.ServerEngine(num_threads=4, device=ASYNC_DEVICE)
        try:
            t0 = time.perf_counter()
            for k, x, y in zip(keys, a, b):
                eng.push(k, x, worker_id=0, num_workers=2)
                eng.push(k, y, worker_id=1, num_workers=2)
            out = [eng.pull(k, timeout=60) for k in keys]
            return out, (time.perf_counter() - t0) * 1e3
        finally:
            eng.shutdown()

    counters.reset()
    clean, clean_ms = dense_round()
    bad = [k for k, g, w in zip(keys, clean, want) if not same_bits(g, w)]
    check(not bad, f"server_engine_resnet: {len(bad)} pulls differ from "
                   f"a + b, first {bad[:3]}")
    loopback = counters.get("integrity.loopback_fast")
    injector.arm(SERVER_SPEC, seed=FAULT_SEED)
    try:
        chaos, chaos_ms = dense_round()
    finally:
        injector.disarm()
    rejects = counters.get("integrity.crc_reject")
    bad = [k for k, g, w in zip(keys, chaos, clean) if not same_bits(g, w)]
    check(not bad, f"server_engine_resnet under {SERVER_SPEC}: {len(bad)} "
                   f"pulls differ from the clean round")
    check(rejects > 0 and counters.get("integrity.retransmit") > 0,
          f"server_engine_resnet: no CRC reject under {SERVER_SPEC}")
    # one onebit round: worker frames packed on the card
    kw = {"compressor": "onebit"}
    wires = []
    for x in (a, b):
        row = []
        for t in x:
            wc = registry.create(kw, t.numel())
            payload, _ = wc.compress(t.reshape(-1).to(ASYNC_DEVICE), {})
            row.append(wc.wire_encode(payload))
        wires.append(row)
    ok.reset_launches()
    eng = bps.ServerEngine(num_threads=4, device=ASYNC_DEVICE)
    try:
        for k, t in zip(keys, a):
            eng.register_compression(k, kw, t.numel())
        t0 = time.perf_counter()
        for k, wa, wb in zip(keys, *wires):
            eng.push_compressed(k, wa, worker_id=0, num_workers=2)
            eng.push_compressed(k, wb, worker_id=1, num_workers=2)
        merged = [eng.pull(k, timeout=60) for k in keys]
        pulled = [eng.pull_compressed(k, timeout=60) for k in keys]
        onebit_ms = (time.perf_counter() - t0) * 1e3
    finally:
        eng.shutdown()
    launches = dict(ok.launches)
    bad_merge, bad_wire, scale_err = [], [], 0.0
    for k, t, wa, wb, m, p in zip(keys, a, *wires, merged, pulled):
        sc = registry.create(kw, t.numel(), for_server=True)
        ref = (sc.decompress(sc.wire_decode(wa))
               + sc.decompress(sc.wire_decode(wb))).reshape(t.shape)
        if not same_bits(m.reshape(t.shape), ref):      # merged flat
            bad_merge.append(k)
        payload, _ = sc.compress(ref.reshape(-1), {})
        w = sc.wire_encode(payload)
        if len(w) != len(p) or w[:4] != p[:4] or w[8:] != p[8:]:
            bad_wire.append(k)
        s_ref = float(np.frombuffer(w[4:8], "<f4")[0])
        s_got = float(np.frombuffer(p[4:8], "<f4")[0])
        scale_err = max(scale_err, abs(s_got - s_ref) / max(abs(s_ref),
                                                            1e-30))
    check(not bad_merge, f"server_engine_resnet onebit: {len(bad_merge)} "
                         f"merges differ from the CPU decode")
    check(not bad_wire and scale_err <= ONEBIT_SCALE_RTOL,
          f"server_engine_resnet onebit: {len(bad_wire)} re-encoded frames "
          f"differ from the CPU chain's, scale error {scale_err:.3g}")
    check(launches["onebit_unpack"] == 2 * len(keys)
          and launches["onebit_pack"] == len(keys),
          f"server_engine_resnet onebit: launches {launches}")
    log(f"server_engine_resnet [{smi}]: 4 threads, {len(keys)} keys x 2 "
        f"workers; dense round {clean_ms:.2f} ms (loopback fast path "
        f"{loopback} pushes), under {SERVER_SPEC} {chaos_ms:.2f} ms "
        f"({rejects} CRC rejects), bit-identical; onebit round "
        f"{onebit_ms:.2f} ms, merges equal the CPU decode, frames its words "
        f"(scale within {scale_err:.3g}); launches {launches}")
    return {"clean_ms": clean_ms, "chaos_ms": chaos_ms,
            "onebit_ms": onebit_ms}


def async_phase(torch, bps, ok, registry, resnet, smi):
    """Phase 9: the async parameter server at ResNet-50's full width."""
    clean = async_arm(torch, bps, ok, resnet, smi, "async_resnet")
    replay = _replay_raw(clean)
    bad = _same_store(torch, clean["snap"]["store"], replay)
    check(not bad, f"async_resnet: {len(bad)} keys differ from the host "
                   f"replay, first {bad[:3]}")
    fc = clean["keys"].index("async.fc.weight")
    drop = next(j for j, (k, _) in enumerate(clean["pushed"])
                if k == clean["keys"][fc])
    ctl = _replay_raw(clean, drop=drop)
    check(bool(_same_store(torch, clean["snap"]["store"], ctl)),
          "async_resnet: a replay without one delta matched the store")
    log(f"async_resnet: the store equals the host replay of "
        f"{len(clean['pushed'])} deltas bit for bit; without one it differs")

    chaos = async_arm(torch, bps, ok, resnet, smi, "async_resnet_chaos",
                      replay=clean["grads"], spec=ASYNC_SPEC)
    diff = _same_store(torch, clean["snap"]["store"],
                       {k: v.numpy() for k, v in
                        chaos["snap"]["store"].items()})
    diff += [(w, j) for w in range(2) for j, (p, q) in enumerate(zip(
        chaos["snap"]["params"][w], clean["snap"]["params"][w]))
        if not same_bits(p, q)]
    c = chaos["counters"]
    check(not diff, f"async_resnet_chaos: {len(diff)} values differ from "
                    f"async_resnet, first {diff[:3]}")
    check(c["integrity.crc_reject"] > 0 and c["integrity.retransmit"] > 0
          and (c["integrity.dup_dropped"] > 0 or c["fault.drop"] > 0),
          f"async_resnet_chaos: counters {c}")
    off = async_arm(torch, bps, ok, resnet, smi, "async_resnet_chaos_off",
                    replay=clean["grads"], spec=ASYNC_SPEC, integrity=False)
    check(bool(_same_store(torch, clean["snap"]["store"],
                           {k: v.numpy() for k, v in
                            off["snap"]["store"].items()})),
          "async_resnet_chaos with BYTEPS_INTEGRITY=0 matched the clean "
          "store (the control must differ)")
    log("async_resnet_chaos: store and parameters bit-identical to "
        "async_resnet; with integrity off the same faults change the store")

    onebit = async_arm(torch, bps, ok, resnet, smi, "async_resnet_onebit",
                       compression=ONEBIT_EF)
    bad = _same_store(torch, onebit["snap"]["store"],
                      _replay_onebit(torch, registry, onebit))
    check(not bad, f"async_resnet_onebit: {len(bad)} keys differ from the "
                   f"CPU replay, first {bad[:3]}")
    n = len(onebit["keys"])
    pushes = 2 * (1 + ASYNC_STEPS)
    want = {"onebit_pack": n * pushes, "onebit_unpack": 2 * n * pushes,
            "onebit_unpack_sum": 0}
    check(onebit["launches"] == want,
          f"async_resnet_onebit: launches {onebit['launches']}, expected "
          f"{want}")
    k = onebit["kernels"]
    check(k["onebit_pack"][0] == n and k["onebit_unpack"][0] == 2 * n,
          f"async_resnet_onebit: device kernels in one step {k}")
    raw = onebit["raw_bytes"] * pushes
    log(f"async_resnet_onebit: store equals the CPU replay of "
        f"{len(onebit['pushed'])} frames bit for bit; landed wire "
        f"{onebit['wire'][0]} B against {raw} B raw "
        f"({onebit['wire'][0] / raw:.4f}); launches {onebit['launches']}; "
        f"device kernels in one profiled step {k}")
    server = server_engine_arm(torch, bps, registry, ok, smi, clean["grads"],
                               clean["keys"])
    return {"clean": clean, "chaos": chaos, "onebit": onebit,
            "server": server}


# ------------------------------------------- 10. observed sharded update

def large_pack_check(torch, ok, numel):
    """The onebit kernels at the Llama embedding's block (one rank holds
    all of it): pack's words and unpack's values against the plain
    versions on the card, bit for bit; pack's f32 L1 sum against the
    plain version's on the CPU to ONEBIT_SCALE_RTOL.  Run before the
    arms, outside their counted launches."""
    gen = torch.Generator(device=OBS_DEVICE).manual_seed(11)
    x = torch.randn(numel, generator=gen, device=OBS_DEVICE)
    words, sums = ok.onebit_pack(x)
    w0, _ = ok.onebit_pack_plain(x)
    check(torch.equal(words, w0), f"onebit_pack at {numel}: words differ "
                                  f"from the plain version")
    del w0
    x_h = x.cpu()
    L = ok.padded_lanes(numel)
    cpu_sum = torch.nn.functional.pad(x_h, (0, 32 * L - numel)).view(
        32, L).abs().sum()
    err = abs(float(sums[0]) - float(cpu_sum)) / float(cpu_sum)
    check(err <= ONEBIT_SCALE_RTOL,
          f"onebit_pack at {numel}: L1 sum {float(sums[0])} against the "
          f"CPU's {float(cpu_sum)} (rel {err:.2e})")
    del x_h, x
    scale = sums[1:]
    out = ok.onebit_unpack(words, scale, numel)
    check(same_bits(out, ok.onebit_unpack_plain(words, scale[0], numel)),
          f"onebit_unpack at {numel}: values differ from the plain version")
    del out, words
    torch.cuda.empty_cache()
    log(f"onebit at {numel} elements ({L} words, "
        f"{ok.launch_geometry(L, 'onebit_pack')[1]} pack blocks): words and "
        f"values bit-exact, L1 sum {float(sums[0]):.6e} within {err:.2e} of "
        f"the CPU's")


def _get(port, route):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _watch_codec(torch, registry, slot, name, rec):
    """Wrap ``slot``'s block codec: each step is replayed by the plain
    codec chain on the CPU from the same update and state, and held to
    it (onebit: signs exact, the scale to ONEBIT_SCALE_RTOL, the
    residual to the scales' difference plus a rounding of the
    subtraction; the others bit for bit);
    the parameters before the step and the dequantized update are kept
    for the step's end (``_check_watched``).  Only while ``rec["on"]``:
    the replay is host work that the timed steps must not carry."""
    real = slot.codec.step
    chain = registry.create(dict(slot.codec_kwargs), slot.n)

    def checked(u, state):
        if not rec["on"]:
            return real(u, state)
        u_h = u.detach().to("cpu", copy=True)
        st_h = {"error": state["error"].to("cpu", copy=True),
                "inner": {k: v.to("cpu", copy=True)
                          for k, v in state["inner"].items()}}
        rec["prev"] = slot.full.detach().to("cpu", copy=True)
        d, new = real(u, state)
        payload, ref_st = chain.compress(u_h, st_h)
        d_ref = chain.decompress(payload)
        d_h = d[:slot.n].cpu()
        err_h = new["error"].cpu()[:slot.n]
        if slot.codec.kind == "onebit":
            sc, sr = float(d_h.abs().max()), float(d_ref.abs().max())
            check(torch.equal(d_h > 0, d_ref > 0),
                  f"{name}: onebit signs differ from the CPU chain")
            check(abs(sc - sr) <= ONEBIT_SCALE_RTOL * sr,
                  f"{name}: onebit scale {sc} against the CPU chain's {sr}")
            # err = fl(x - d): the two residuals differ by the scales'
            # difference and each subtraction's rounding
            bound = abs(sc - sr) + 2.0**-22 * ref_st["error"].abs()
            check(bool(((err_h - ref_st["error"]).abs() <= bound).all()),
                  f"{name}: residual differs from the CPU chain's by more "
                  f"than the scales' difference {abs(sc - sr)} and a "
                  f"rounding")
        else:
            check(same_bits(d_h, d_ref) and same_bits(err_h,
                                                      ref_st["error"]),
                  f"{name}: {slot.codec.kind} update or residual differs "
                  f"from the CPU chain's")
        rec["d"] = d_h
        rec["steps"] = rec.get("steps", 0) + 1
        return d, new

    slot.codec.step = checked


def _check_watched(torch, slot, param, name, rec):
    """At a step's end: the replica copy is its value before the step plus
    the dequantized update, bit for bit, and the emitted parameter is that
    copy in the declared dtype."""
    full = slot.full[:slot.n].detach().cpu()
    check(same_bits(full, rec["prev"][:slot.n] + rec["d"]),
          f"{name}: the master is not its previous value plus the "
          f"dequantized update")
    check(same_bits(param.detach().reshape(-1).cpu(), full.to(slot.dtype)),
          f"{name}: the emitted parameter is not the master in "
          f"{slot.dtype}")


def observed_arm(torch, bps, api, Config, ok, fa, registry, name, spec,
                 build_model, watch, flash_layers, smi):
    """One arm of phase 10: ``build_model(dev)`` -> (model, inner
    optimizer, loss function, the optimizer's keywords), trained through DistributedOptimizer
    (sharded_update, ``sharded_param_codec=spec``) with the
    observability plane on; see the module docstring."""
    from byteps_tpu_torch.common import flight_recorder as flight
    from byteps_tpu_torch.common import (lock_witness, obs_server,
                                         timeseries, tracing)
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.tools import bps_trace

    tmp = tempfile.mkdtemp(prefix=f"bps_{name}_")
    window = 2 * OBSERVED_STEPS + 1          # the tracer's step of the window
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tracing.set_tracer(None)                 # a tracer of this arm's config
    # the sampler is process-lifetime (an earlier phase's init started it
    # at the default 2 s): restart it at this phase's cadence
    timeseries.stop_for_tests()
    cfg = Config(sharded_update=True, sharded_param_codec=spec,
                 trace_on=True, trace_start_step=window,
                 trace_end_step=window, trace_jax=True, trace_sample="1/1",
                 trace_dir=os.path.join(tmp, "trace"), obs_port=0,
                 ts_interval_s=OBS_TS_INTERVAL_S, health_on=True,
                 lock_witness=True, flight_dir=os.path.join(tmp, "flight"))
    bps.init(cfg, device=OBS_DEVICE)
    eng, dev = api.engine(), api.device()
    tr = eng.tracer
    tr.enabled, tr.sample_n = False, 0       # warm-up and "off": no tracer
    model, inner, step_fn, opt_kw = build_model(dev)
    opt = bps.DistributedOptimizer(
        inner, named_parameters=model.named_parameters(),
        sharded_update=True)
    params = dict(model.named_parameters())
    slots = eng.update_slots
    # the adapter's slot of each parameter (its push_pull name)
    slot_of = {n: slots[f"torch.grad.{n}"] for n in params}
    kinds = collections.Counter(
        s.codec.kind if s.codec is not None else "none"
        for s in slots.values())
    watch = [n for n in watch if n in params] + [
        next((n for n, s in slot_of.items() if s.codec is not None
              and s.codec.kind == "topk"), None)]
    watch = [n for n in watch if n is not None]
    recs = {n: {"on": True} for n in watch}
    for n in watch:
        _watch_codec(torch, registry, slot_of[n], f"{name}: {n}", recs[n])
    # the control: each watched tensor without the codec (an f32 master
    # and the same optimizer, on the card, fed the raw gradients)
    refs = {n: params[n].detach().float().clone() for n in watch}
    ref_opts = {n: type(inner)([r], **opt_kw) for n, r in refs.items()}
    stage = collections.defaultdict(list)
    # Σ of the codec payloads this run's pushes put on the pull leg, and
    # the per-chunk rounding of the JAX formula; per step, since the
    # planner may re-carve a tensor between pushes
    expect = {"payload": 0, "slack": 0}

    def after(checked):
        for n, s in slots.items():
            ctx = eng.registry.get(n)
            if s.codec is not None and ctx.scatter_layout != "ineligible":
                expect["payload"] += s.payload_nbytes
                expect["slack"] += len(ctx.chunk_bounds)
        for n in watch:
            if checked:
                _check_watched(torch, slot_of[n], params[n],
                               f"{name}: {n}", recs[n])
            refs[n].grad = params[n].grad.float()
            ref_opts[n].step()
            refs[n].grad = None
        legs = collections.Counter()
        for s in slots.values():
            for k, v in s.stage_ms.items():
                legs[k] += v
        for k, v in legs.items():
            stage[k].append(v)

    def run(i, checked=False):
        for n in watch:
            recs[n]["on"] = checked
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = step_fn(model)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        check(math.isfinite(loss.item()), f"{name}: loss {loss.item()} at "
                                          f"step {i}")
        after(checked)
        return dt

    ok.reset_launches()
    fa.reset_launches()
    pw0 = counters.get("compression.param_wire_bytes")
    run(0, checked=True)                             # warm-up
    # the tracing modes in turns (off, 1/4, 1/1, then back), so that a
    # drift over the run does not read as the cost of a mode
    modes = (("off", 0), ("1/4", 4), ("1/1", 1))
    ms = {m: [] for m, _ in modes}
    for r in range(OBSERVED_STEPS):
        for mode, sample_n in (modes if r % 2 == 0 else modes[::-1]):
            tr.sample_n = sample_n
            ms[mode].append(run(1 + sum(map(len, ms.values()))))
    log(f"{name}: step " + "; ".join(
        f"tracing {m} {_median_line(v)}" for m, v in ms.items()))
    # the window: from the first push of one step to the first push of the
    # next (the device profiler opens and closes there), both replayed
    tr.enabled = True
    run(1 + 3 * OBSERVED_STEPS, checked=True)
    run(2 + 3 * OBSERVED_STEPS, checked=True)
    steps = 3 + 3 * OBSERVED_STEPS
    launches = dict(ok.launches)
    flash = dict(fa.launches)
    param_wire = counters.get("compression.param_wire_bytes") - pw0
    # the endpoint, before the engine stops
    port = obs_server.get_server().port
    status, metrics_text = _get(port, "/metrics")
    for series in ("byteps_step_attrib_other_ms",
                   "byteps_compression_param_wire_bytes_total"):
        check(status == 200 and series in metrics_text,
              f"{name}: /metrics ({status}) has no {series}")
    hstatus, hbody = _get(port, "/healthz")
    hdoc = json.loads(hbody)
    check(hstatus == (200 if hdoc["ok"] else 503) and (
        hdoc["ok"] or hdoc["alerts"]),
        f"{name}: /healthz {hstatus} {hbody[:200]}")
    dstatus, dbody = _get(port, "/debug/state")
    check(dstatus == 200 and "trace" in json.loads(dbody),
          f"{name}: /debug/state {dstatus} has no trace section")
    tdoc = json.loads(_get(port, "/timeseries")[1])
    check(tdoc.get("len", 0) >= 1, f"{name}: /timeseries has no points")
    chunks = {n: len(eng.registry.get(n).chunk_bounds) for n in slots}
    bps.shutdown()                    # flushes the trace, stops the profiler
    last = eng.step_stats.last()
    dump = flight.dump("chip_smoke")
    # --- the parameter leg
    onebit = kinds["onebit"]
    check(launches["onebit_pack"] == onebit * steps
          and launches["onebit_unpack"] == onebit * steps,
          f"{name}: launches {launches}, expected {onebit} pack and unpack "
          f"per step over {steps} steps")
    for n in watch:
        check(recs[n].get("steps") == 3, f"{name}: {n} was replayed "
                                         f"{recs[n].get('steps')} times")
        full = slot_of[n].full[:slot_of[n].n].view(refs[n].shape)
        check(not same_bits(refs[n], full),
              f"{name}: {n} without the codec (the control) equals the "
              f"quantized leg's master")
    payload, slack = expect["payload"], expect["slack"]
    check(payload - slack <= param_wire <= payload,
          f"{name}: compression.param_wire_bytes {param_wire}, Σ payload "
          f"{payload} B (per-chunk rounding at most {slack} B)")
    if flash_layers:
        want = flash_layers * steps
        check(all(v == want for v in flash.values()),
              f"{name}: flash launches {flash}, expected {want} each")
    # --- the trace
    tdir = os.path.join(tmp, "trace")
    merged = bps_trace.merge(bps_trace.load_trace_files(tdir))
    errors = bps_trace.validate(merged)
    check(not errors, f"{name}: bps_trace --validate: {errors[:3]}")
    evs = merged["traceEvents"]
    names = {(e["pid"], e["tid"]): e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    spans = collections.Counter(
        (e["name"], names.get((e["pid"], e["tid"]))) for e in evs
        if e.get("ph") == "X" and e.get("args", {}).get("step") == window)
    for n, c in chunks.items():
        for kind in ("queued", "push_pull"):
            check(spans[(kind, n)] == c,
                  f"{name}: {spans[(kind, n)]} {kind} spans of {n} at the "
                  f"window step, {c} chunks")
    flows = collections.defaultdict(list)
    for e in evs:
        if e.get("ph") in ("s", "f"):
            flows[e["id"]].append(e["ph"])
    check(flows and all(sorted(v) == ["f", "s"] for v in flows.values()),
          f"{name}: unpaired flow arcs")
    # --- the device profile
    check(tr.profile_path is not None and os.path.exists(tr.profile_path),
          f"{name}: no device profile")
    with open(tr.profile_path) as f:
        prof = json.load(f)["traceEvents"]
    knames = {e.get("name", "") for e in prof if e.get("cat") == "kernel"}
    want_k = ["pack_kernel", "unpack_kernel"] + (
        ["fwd_kernel", "bwd_dkv_kernel", "bwd_dq_kernel"]
        if flash_layers else [])
    missing = [k for k in want_k if not any(k in n for n in knames)]
    check(not missing, f"{name}: the device profile has no {missing}")
    # --- attribution, flight recorder, witness
    comps = sum(v for k, v in last.attrib.items() if k != "other")
    check(abs(last.attrib["other"] - max(0.0, last.wall_ms - comps)) < 0.01
          and sum(last.attrib.values()) >= last.wall_ms - 0.01,
          f"{name}: attribution {last.attrib} against wall {last.wall_ms}")
    with open(dump) as f:
        fkinds = {e["kind"] for e in json.load(f)["events"]}
    check({"engine.init", "step_stats", "engine.shutdown"} <= fkinds,
          f"{name}: the flight dump holds {sorted(fkinds)}")
    edges = len(lock_witness.witness_edges())
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {m: statistics.median(v) for m, v in ms.items()}
    log(f"{name}: {len(slots)} slots, codecs {dict(kinds)}, {steps} steps; "
        f"step median (min-max) tracing off {_median_line(ms['off'])}, "
        f"1/4 {_median_line(ms['1/4'])}, 1/1 {_median_line(ms['1/1'])}; "
        f"peak {peak:.2f} GiB  [{smi}]")
    log(f"{name}: parameter-leg host ms per step (mean over {steps} steps, "
        f"summed over slots): " + ", ".join(
            f"{k} {statistics.mean(v):.2f}" for k, v in stage.items()))
    log(f"{name}: watched {watch} replayed by the CPU chain at the warm-up "
        f"and the two window steps (after the timed ones); "
        f"controls without the codec differ; launches {launches}, flash "
        f"{flash}; compression.param_wire_bytes {param_wire} B of Σ "
        f"payload {payload} B; trace {len(evs)} events, "
        f"{len(flows)} paired flows, 0 validation errors; device profile "
        f"{os.path.basename(tr.profile_path)} with {len(knames)} kernel "
        f"names; last step {last.wall_ms} ms, components "
        f"{round(comps, 3)} ms + other {last.attrib['other']} ms; "
        f"/healthz {hstatus} {hdoc['alerts']}; /timeseries {tdoc['len']} "
        f"points; flight dump {os.path.basename(dump)}; lock witness: "
        f"{edges} orderings, no cycle")
    del opt, inner, model, params, refs, ref_opts, slots, slot_of
    tracing.set_tracer(None)
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"arm": name, "ms": ms, "median": med, "peak_gib": peak,
            "launches": launches, "flash": flash,
            "stages": {k: statistics.mean(v) for k, v in stage.items()}}


def observed_phase(torch, bps, api, Config, ok, fa, registry, llama, resnet,
                   smi):
    """Phase 10: the quantized parameter leg and the observability plane,
    at Llama-3-8B width (onebit) and ResNet-50 (auto)."""
    from byteps_tpu_torch.models.gpt import lm_loss
    from byteps_tpu_torch.parallel.long_context import synthetic_lm_batch

    cfg = dataclasses.replace(llama.llama3_8b(), num_layers=OBS_LLAMA_LAYERS)
    large_pack_check(torch, ok, cfg.vocab_size * cfg.hidden_size)

    def llama_model(dev):
        gen = torch.Generator(device=dev).manual_seed(3)
        model = llama.Llama(cfg, attn_fn=fa.flash_attention, device=dev,
                            generator=gen).to(torch.bfloat16)
        data = synthetic_lm_batch(gen, cfg, *SHARDED_LM_BATCH["llama"])
        inner = torch.optim.AdamW(model.parameters(), **SHARDED_ADAMW)
        return model, inner, lambda m: lm_loss(m(data["input_ids"]),
                                               data["labels"]), SHARDED_ADAMW

    def resnet_model(dev):
        gen = torch.Generator().manual_seed(0)
        model = resnet.resnet50(num_classes=CLASSES, generator=gen).to(dev)
        batch = resnet.synthetic_images(gen, BATCH, IMAGE, CLASSES, dev)
        inner = torch.optim.SGD(model.parameters(), **SHARDED_SGD)
        return model, inner, lambda m: torch.nn.functional.cross_entropy(
            m(batch["images"]), batch["labels"]), SHARDED_SGD

    rows = [observed_arm(torch, bps, api, Config, ok, fa, registry,
                         "llama_param_onebit", "onebit", llama_model,
                         OBS_WATCH["llama"], cfg.num_layers, smi),
            observed_arm(torch, bps, api, Config, ok, fa, registry,
                         "resnet_param_auto", "auto", resnet_model,
                         OBS_WATCH["resnet"], 0, smi)]
    return rows


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
    smi = device_phase(torch)
    build_phase(build, [ok.SOURCE, fa.SOURCE], mma_source=fa.SOURCE,
                pdl_source=ok.SOURCE)
    config = Config()
    chunk_numel = config.partition_bytes // 4          # f32 gradients
    chunks = resnet_chunks(torch, resnet, config, chunk_bounds)
    rows = kernel_phase(torch, ok, chunk_numel, chunks)
    launches, _ = slice_phase(torch, bps, ok, api, registry, resnet, chunks)
    torch.cuda.empty_cache()
    codec_slice_phase(torch, bps, ok, api, registry, resnet, Config)
    torch.cuda.empty_cache()
    flash_rows, shape_ms = flash_kernel_phase(torch, fa)
    flash_launches = {k: 0 for k in FLASH_KERNELS}
    for name, model_fn, cfg, batch, seq, shape in (
            ("llama slice", llama.Llama,
             dataclasses.replace(llama.llama3_8b(), num_layers=4), 2, 4096,
             "llama"),
            ("gpt slice", gpt.GPT, gpt.gpt_small(), 1, 8192, "gpt")):
        run = lm_slice_phase(torch, bps, api, fa, Config, name, model_fn,
                             cfg, batch, seq, shape_ms[shape])
        for k in flash_launches:
            flash_launches[k] += run[k]
    t_phase = time.perf_counter()
    sharded_phase(torch, bps, api, Config, llama, gpt, resnet)
    log(f"sharded update phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    async_phase(torch, bps, ok, registry, resnet, smi)
    log(f"async parameter-server phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    observed = observed_phase(torch, bps, api, Config, ok, fa, registry,
                              llama, resnet, smi)
    log(f"observed sharded update phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    # the main paths' launches: phase 4's and the LM slices', and phase 10's
    for row in observed:
        for k in KERNELS:
            launches[k] += row["launches"][k]
        for k in FLASH_KERNELS:
            flash_launches[k] += row["flash"][k]
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
