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
   ones (T=100 with D=48, decode Tq=64 < Tk=256, non-causal, a ring
   step's q_off=32 with kv_len=100, and the off-diagonal blocks of phase
   15's ring, [2*8, 4096, 64] at q_off = 4096 and 8192 with kv_len =
   4096, where every key is visible).  The bf16 forward's plain version is
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

11. the fault plane and the TCP transport (``fault_phase``): every child
   a fresh interpreter (``python -m byteps_tpu_torch.tools.fault_resnet
   ROLE``) on the card, ports free on 127.0.0.1, every child killed in a
   ``finally``; a child that exits with another code than its expected
   one (0; 1 for the killed trainer), runs past FAULT_TIMEOUT_S or prints
   no result line fails the run.  Each arm's children start while the
   parent checks the arm before (their start-up overlaps the check);
   each arm prints its seconds.  ResNet-50
   at full width (1000 classes, 224x224 NHWC, bf16 compute, f32
   parameters, batch 32 a worker, weights and data from the seed), 1
   warm-up and FAULT_STEPS timed worker steps an arm:
   - (a) ``tcp_async_resnet``: a ``KVStore`` on the card behind a
     ``TransportServer`` in one process, two worker processes each
     running forward, backward and a local SGD(momentum=0.9) step, then
     pushing ``p' - p`` per parameter with ``TcpEndpoint.push_delta``
     (the step as seq token) and pulling every parameter with
     ``kv_pull``.  The server records the order in which it applies the
     deltas, ``(key, worker, seq)`` under the store's lock; the store
     must equal a host replay of the workers' logged deltas in that
     order, bit for bit, and a replay without one delta must differ.
     Prints the median worker step (min-max) beside phase 9's in-process
     ``async_resnet`` step of the same run, the host ms of each stage
     (the local step, device to host, seal + CRC, send to ack, pull, host
     to device), each worker's request round trip p50 and p99 and the
     bytes on the wire a worker step;
   - (b) ``tcp_async_resnet_onebit``: as (a) with onebit + EF packed on
     the card by each worker (``push_delta_wire``) and decoded on the
     card by the store; the store must equal the CPU replay of the
     frames in the applied order, and each process's onebit launches
     must be exactly a pack and an unpack per key and push in a worker,
     an unpack per applied push in the server, and no merge;
   - (c) ``tcp_async_resnet_chaos``: (a)'s gradients replayed under
     FAULT_CHAOS_SPEC (``bitflip:site=kv_push`` in both workers,
     ``conn_reset:site=transport`` in worker 1) and one deliberate
     duplicate of a landed token per worker: every (worker, seq) of
     every key applied exactly once, the store equal to the replay of
     its own log, and CRC rejects, retransmits, connection resets,
     reconnects and duplicates dropped all above 0;
   - (d) ``kill_and_recover_resnet``: two trainers, each its own engine
     at a world of one (NCCL) training through
     ``DistributedOptimizer(SGD(momentum=0.9))``, sharing a heartbeat
     server (0.2 s / 2 s) and a checkpoint directory; rank 0 saves
     ``{model, optimizer, step}`` every 2 steps; rank 1 runs under
     ``kill:rank=1:step=FAULT_KILL_STEP`` and must exit 1, its flight
     recorder's dump holding the ``fault.kill`` event; rank 0's
     ``RecoveryCoordinator`` must complete suspend, ``resume(
     num_workers=1)`` and ``restore_latest`` once (``recovery.attempt ==
     recovery.completed == 1``, no failure, exit 0), its restored
     parameters and momenta must equal the saved ones bit for bit on the
     card, and 2 more steps must have finite losses.  Prints the time
     from the kill to the detection, the ms of suspend, resume and
     restore, and the checkpoint's save ms and bytes;
   - (e) ``sync_deadline``, in this process: an engine with
     ``sync_deadline_s=SYNC_DEADLINE_S`` and an installed failure action;
     a SYNC_DELAY_MS chaos delay at ``site=sync`` on one unit of four
     small tensors must fire the action once with a gap above the
     deadline, ``engine.sync_deadline_trips`` must read 1, the process
     must not exit, and the next push_pull must complete.

12. elastic membership and gossip (``elastic_phase``): three members,
   each a fresh ``python -m byteps_tpu_torch.tools.elastic_resnet`` on
   the card with its own engine at a world of one (NCCL), sharing one
   membership bus and one membership-managed heartbeat server (0.2 s /
   2 s) on free 127.0.0.1 ports; each trains ResNet-50 at full width
   (batch 32, weights from the seed, data from the seed and its rank)
   through ``DistributedOptimizer(SGD(momentum=0.9), compression=
   onebit)`` for ELASTIC_STEPS steps, all-gathering its averaged
   gradient (host f32) with CRC32Cs of its parameters and momenta over
   ``step_sync``, and applying the rank-order mean.  A member that exits
   with an unexpected code, runs past ELASTIC_TIMEOUT_S or prints no
   result line fails the run; every member is killed in a ``finally``.
   The members of arms (b) and (c) start with arm (a)'s and wait at a go
   file until their arm begins (their start-up overlaps arm (a)).  At
   every step of every arm the members' CRCs must agree.
   - (a) ``elastic_resnet_shrink_rejoin``: member 2 under
     ``kill:rank=2:step=ELASTIC_KILL_STEP`` must exit 1; members 0 and 1
     shrink in place to epoch 1, world (0, 1) and go on; a restarted
     member 2 (started at once, parked once the bus shows epoch 1) is
     admitted at a step boundary at epoch 2, world (0, 1, 2), with the
     survivors' parameters and momenta equal to the received bytes on
     the card; every member ends at epoch 2; member 0's stale probes
     (dispatch and retirement drops, stale KVStore and ServerEngine
     pushes) must all be dropped and counted;
   - (b) ``elastic_resnet_coordinator_kill``: ``BYTEPS_GOSSIP_ON=1`` and
     ``kill:site=coordinator:step=ELASTIC_KILL_STEP`` in every member:
     only member 0 dies; member 1 re-binds the bus from its replica
     (``membership.coordinator_failover`` 1) and the heartbeat server
     follows it; members 1 and 2 end at epoch 1, world (1, 2); the
     parent's ``cluster_metrics()`` from the new bus names coordinator 1
     and carries the gossip states, and ``bps_top`` renders a frame;
   - (c) ``elastic_resnet_wedge``: ``BYTEPS_SYNC_DEADLINE_S=
     ELASTIC_DEADLINE_S`` and a one-visit ELASTIC_WEDGE_MS slow fault at
     ``site=sync`` on member 1 at step ELASTIC_WEDGE_STEP: the deadline
     trips, the installed action reconciles the current world (epoch 1,
     world (0, 1, 2)), no member exits.
   Each arm prints, beside the card's name and power limit, the median
   member step (min-max), the ``step_sync`` round trip p50 / p99 and the
   bytes a member sends, the kill -> detection, detection -> resumed,
   rejoin, failover and reconcile times, each member's onebit launches
   and resume ms, and its seconds.

13. serving and durability (``serving_phase``): a trainer (``python -m
   byteps_tpu_torch.tools.serve_resnet train``) on the card: ``init()``
   opens the durable store in a fresh ``BYTEPS_DURABLE_DIR``
   (``BYTEPS_WAL_FSYNC=always``); ResNet-50 at full width (batch 32,
   weights and data from the seed) trains through two
   ``AsyncDistributedOptimizer(SGD(momentum=0.9))``: onebit + EF on the
   52 tensors of ``min_compress_bytes`` and more, raw on the other 109;
   a ``ServingTier`` ships each cut (two replicas a key) to two
   ``serve_host`` processes on the card that the parent's
   ``FleetReconciler`` (target 2) keeps over the parent's membership
   bus; a ``PullClient`` on the card in the parent pulls through the
   ring.  The trainer runs in lockstep with the parent (command files),
   prints the value's CRC32C at every acknowledged push and, at every
   cut, each raw key's CRC32C and each onebit key's CPU-chain frame.
   Every child logs to a file; one that exits early or runs past
   SERVE_TIMEOUT_S fails the run; every child is killed in a
   ``finally``.
   - (a) ``serve_resnet_tier``: SERVE_STEPS_A steps, each cut followed
     by a blocking pull: every key at the cut's version; raw keys bit
     for bit the trainer's value; onebit keys' sign words bit for bit
     the CPU chain's ``compress`` of the cut's value, the scale within
     ONEBIT_SCALE_RTOL; a second pull inside the bound is a cache hit
     with no bytes;
   - (b) ``serve_resnet_host_kill``: ``kill:site=serve_host:step=
     SERVE_KILL_PULL`` armed on host 1 over ``serve_ctl``; pulls go on
     while it is down, held as in (a); the reconciler restarts it once
     (``reconcile.restarted`` 1), it prints ``HOST-RESTORED`` from its
     ``arc.bin``, and a cut without a step ships it 0 B;
   - (c) ``serve_resnet_cold_start``: the trainer stops after
     SERVE_PAUSE_ACKS acknowledged pushes of a step and is SIGKILLed; a
     fresh process (``serve_resnet recover``) recovers the store: every
     key's version and CRC32C equal its last acknowledged push, every
     key's last token replayed is absorbed, and a fresh tier's cut
     pulled in full is held as in (a).
   Each arm prints, beside the card's name and power limit, the median
   trainer step (min-max), the journal's ms a push (append, fsync), cut,
   encode and durable-save ms and bytes, ship ms and bytes a host, pull
   p50 / p99 and bytes received against raw, kill -> ``HOST-RESTORED``,
   the recovery's ms and bytes, each process's onebit launches and its
   seconds.

14. the fused data-parallel step and the benchmark's models
   (``fused_step_phase``), one rank, NCCL at a world of one:
   - (a) BERT-large MLM at full width (24 layers, hidden 1024, vocab
     30528, 32 examples of 128 tokens, weights and batch from the seed,
     AdamW 1e-4, the gathered head) through ``make_dp_train_step``
     (``tools/bert_mlm.py``'s ``build``), batches through
     ``ShardedBatchLoader`` (pinned copies on a side stream), in two
     arms: ``flat`` (``push_pull_tree``) and ``onebit``
     (``compress_dcn=make_onebit_pair()``: the 148 gradients of at least
     2 MiB take the compressed hop).  FUSED_WARMUP steps, then the onebit
     counters zeroed and FUSED_STEPS timed steps: ms a step, examples/s,
     the loss finite, onebit launches a step (flat: none; onebit: a pack
     and a merge per gradient past the gate, no unpack).  One checked
     step each: the flat arm's averaged gradients equal the local ones
     bit for bit; the onebit hop of the largest gradient equals the plain
     merge of its words and scale bit for bit, its words the plain
     pack's, its scale the plain pack's to rtol 1e-6;
   - (b) Llama-3-8B width with OBS_LLAMA_LAYERS layers (2 x 4096, flash
     attention), one forward and backward each of ``plain``,
     ``plain_again`` and ``remat``: the loss bit for bit, each gradient
     of ``remat`` no further from ``plain`` than ``plain_again`` is (bit
     for bit where a plain step repeats its bits), the flash forward
     launched twice a layer under remat; ms and peak memory of each;
   - (c) ResNet-50 (cross-replica BatchNorm over the world) and VGG-16
     at full width, 32 images of 224x224, through the function behind
     ``examples.benchmark_resnet`` (``make_vision_trainer``): 1 warm-up
     and VISION_STEPS timed steps, the loss finite; it prints the
     example's JSON line (images/s) for each.
   Every time is printed beside the card's name and power limit.

15. sequence and expert parallelism (``seqpar_phase``): SEQPAR_RANKS
   processes on the one card (``python -m
   byteps_tpu_torch.tools.long_context``), joined over gloo (NCCL refuses
   two ranks of a communicator on one device; gloo stages its
   collectives' CUDA tensors through the host, and takes none in send and
   recv, so the ring's shift goes as an all-to-all with one non-empty
   split, printed as the shift path).  Tensors, models and kernels stay
   on the card.  A rank that exits with another code than 0, runs past
   SEQPAR_TIMEOUT_S or prints no result fails the run.
   - (a) GPT-small at full width (hidden 512, 8 layers, 8 heads of 64,
     vocab 32768, bf16 compute, weights and batch from the seed) through
     ``make_dp_sp_train_step`` over ``(dp 1, sp 2)`` on SEQPAR_SP (2
     sequences of 8192 tokens, 4096 a rank), AdamW 3e-4, one arm per
     kind: ``ring``, ``striped`` (the batch striped), ``ring_flash``,
     ``ulysses``, ``ulysses_flash``.  Rank 0 also takes one step of the
     whole sequence with ``attention="flash"`` on the same weights and
     batch; after each arm's first step both ranks' gradients (summed
     over the ranks) go to rank 0 and must be within SEQPAR_GRAD_TOL of
     that step's, as a share of each tensor's max-abs, and the first loss
     within SEQPAR_LOSS_RTOL.  A control, ``ring_flash`` with the
     off-diagonal blocks given ``q_off = 0``, must break the bound.  Then
     the flash counters are zeroed and each arm takes its timed steps:
     ms a step, tokens/s, the loss finite, and the flash kernels'
     launches on each rank, which must be ``(rank + 1) * 8`` a kernel and
     step for ``ring_flash`` (the causal skip), 8 for ``ulysses_flash``,
     0 for the others;
   - (b) GPT-small width with 8 switch experts every 2nd block (capacity
     1.25, flash attention) through ``make_moe_lm_train_step`` over
     ``(dp 1, ep 2)``, 4 experts a rank, SEQPAR_EP (16 sequences of 1024
     tokens, 8 a rank): each rank's forward (logits and the 4 aux losses)
     within SEQPAR_MOE_TOL of the full-stack model's on its own rows; then
     a first and the timed steps, the loss finite and falling, 8 flash
     launches a kernel and step.
   Every time is printed beside the card's name and power limit.
16. tensor, pipeline and composite parallelism (``modelpar_phase``):
   MODELPAR_RANKS processes on the one card (``python -m
   byteps_tpu_torch.tools.model_parallel``) over gloo, one world, the
   arms in order, each on its own mesh.  A rank that exits with another
   code than 0, runs past MODELPAR_TIMEOUT_S or prints no result fails
   the run.  Rank 0 first takes each arm's one-rank forward and backward
   on the same weights and batch (its gradients to the host, the card
   freed); after each arm's first step every rank's gradient slices must
   be within MODELPAR_GRAD_TOL of that step's (share of each tensor's
   max-abs) and the first loss within MODELPAR_LOSS_RTOL; each control
   (a fault run before the first step, no update) must break the bound;
   then MODELPAR_STEPS timed steps: ms, tokens/s, peak memory a rank.
   - (a) ``fsdp_tp``: Llama-3-8B width (hidden 4096, 32 heads, 8 K/V heads
     of 128, SwiGLU 14336, vocab 128256, bf16 compute, f32 parameters) at
     MODELPAR_LLAMA (2 of 32 layers, 2 sequences of 4096 tokens, one an
     fsdp rank) over ``(fsdp 2, tp 2)``, AdamW, the flash kernels at
     ``[1, 4096, 16, 128]`` a rank, weights drawn leaf by leaf from the
     seed; control: the attention's row-parallel sum skipped.  Each flash
     kernel must launch once a layer a step on every rank, and each rank's
     parameters and AdamW state must be 1/4 of the whole model's but for
     the RMSNorm scales, which every rank holds whole;
   - (b) GPT-small (hidden 512, 8 layers, 8 heads of 64, vocab 32768,
     bf16 compute, exact attention, the biases drawn from the seed too)
     on MODELPAR_GPT (8 sequences of 1024 tokens), AdamW: ``tp`` at
     ``(dp 2, tp 2)`` (control: the row-parallel biases added on every tp
     rank), ``pp`` at ``(dp 2, pp 2)`` with M = 4 (control: the embedding
     and head gradients summed over dp only) and ``3d`` at ``(dp 1, pp 2,
     tp 2)`` with M = 4; a pipeline stage must run M stage forwards a
     step.
17. the launcher, the examples and the bench tools (``launcher_phase``):
   every command from the repo's root with the DMLC_* and BYTEPS_LOCAL_*
   variables unset; one that exits with another code than 0, runs past
   LAUNCH_TIMEOUT_S or prints no result fails the run.
   - (a) ``python -m byteps_tpu_torch.launcher.launch python -m
     byteps_tpu_torch.examples.benchmark_byteps`` with LAUNCH_BENCH (20
     tensors of 4 MB, onebit, 10 timed iterations and a warm-up): exactly
     one worker (one visible card), at local rank 0, NCCL at a world of
     one; it prints MB/s, and its onebit launches must be 2 packs (the
     worker's and the server's re-pack), 1 unpack and 1 merge a chunk
     and iteration of the chunks its engine carved;
   - (b) ``--restart 1`` around a worker that exits 17 once and then runs
     ``examples.train_mnist_byteps`` for LAUNCH_MNIST_STEPS steps on the
     card: exactly one restart, the loss finite and falling (run beside
     ``fsdp_memory``, whose figures are memory a process, to keep the
     phase short);
   - (c) the bench tools at one rank on the card, their figures printed
     with no bound: ``mechanism_bench`` (priority and partition
     latencies), ``overlap_bench`` (the none and onebit lanes, 2 rounds;
     the onebit lane must launch each onebit kernel), ``serve_bench`` (in
     process, 2 s, 4 clients; no failed read, the delta check), and
     ``async_bench`` (the sync arm's loss must fall); then
     ``fsdp_memory``, two ranks over gloo on the one card, each with a
     peak above its kept state for both FSDP designs.
   Every figure is printed beside the card's name and power limit, and
   the phase's time.

18. the frontends and the bench-smoke gate (``frontends_phase``), one
   rank, NCCL at a world of one:
   - (a) ResNet-50 at full width (f32 parameters, bf16 compute, 32 images
     of 224x224, weights and batch from the seed), 1 warm-up and MX_STEPS
     timed steps: each step's 161 gradients are copied to host arrays in
     an NDArray stand-in and handed to
     ``byteps_tpu_torch.mxnet.DistributedOptimizer`` over numpy SGD
     (``update`` of every index), every gradient of MX_ONEBIT_BYTES or
     more declared with ``byteps_compressor_type=onebit``, the others
     raw; then the host weights go back to the card.  The onebit counters
     are zeroed before the timed steps and must read 2 packs, 1 merge and
     1 unpack a onebit chunk and step.  On the last step every reduced
     gradient must equal ``api.push_pull`` of the same device tensor with
     the same dict (fresh names) bit for bit, each onebit one the plain
     chain's on the CPU (``codec_reference``) to rtol 1e-5, and the host
     weights numpy SGD of the reduced gradients; a control, the raw dict
     on the largest onebit gradient, must break the bit check.  One more
     step under torch.profiler must show as many onebit device kernels
     of each kind as the counters read a step.  It prints a step's ms
     with forward and backward, host staging (d2h, h2d), the engine and
     numpy SGD apart, and the profiled step's device-busy share;
   - (b) the engine and compressed lanes of
     ``byteps_tpu_torch.tools.bench_smoke`` (``_measure``,
     ``_measure_compressed``) on the card: the engine's result equals the
     bare collective's bit for bit, the onebit lane launches every onebit
     kernel, and the compressed lanes' wire ratio and golden error are
     within the committed floor's ceilings.  The timing verdict against
     the floor is printed, not checked.
   Every figure is printed beside the card's name and power limit, and
   the phase's time.

19. repairs and entry points (``repairs_phase``), one rank:
   - (a) the ``dcn`` chaos site over NCCL at a world of one: one push of
     DCN_NUMEL floats through each collective entry (``push_pull_array``
     and its scaled form, ``push_pull_arrays_batched``,
     ``push_pull_chunk_scatter``, ``fused_compressed_push_pull`` with
     onebit, which launches pack, merge and unpack), a warm-up and
     DCN_PLAIN_RUNS times undelayed, then under ``delay:site=dcn:p=1:ms=DCN_DELAY_MS`` and under
     a control naming ``site=sync``.  Each delayed push must fire once and
     take at least DCN_DELAY_MS a fire, the control must fire nothing and
     take less than DCN_DELAY_MS, and every delayed result (onebit's too)
     must be the undelayed one bit for bit;
   - (b) the four metrics: a small engine under METRIC_KW pushes a bare
     tensor of METRIC_NUMEL floats until its partition and codec lock:
     ``compression.planner_locked`` must grow by the buckets locked, each
     with a ``compression.codec_locked`` gauge of 1.0 and flight event,
     and ``engine.credit_bytes`` must equal the scheduler's installed
     window; then a sharded slot steps SLOT_STEPS times beside one
     unsharded push, and ``engine.sharded_updates`` must grow by the slot
     steps;
   - (c) ``examples.train_mnist_mlp --steps MLP_STEPS`` on the card: its
     losses finite and falling.
   Every figure is printed beside the card's name and power limit, and
   the phase's time.

20. buffer mode (``buffer_phase``), one rank, NCCL at a world of one, the
   engine's defaults with the chunk size pinned: a flat gradient of
   ResNet-50's parameter count (BUFFER_NUMEL floats, several chunks) and
   a control of BUFFER_CONTROL_NUMEL floats (one chunk under
   ``buffer_min_bytes``), each pushed once under torch.profiler after a
   warm-up.  The gradient
   must ride the scatter accumulator: every unit a run on it, its slabs
   covering every chunk once, one ``assemble_scatter`` and no
   ``push_pull_array``; the control the parts path (one
   ``push_pull_array``, no accumulator).  The collectives issued
   (``torch.distributed``) and the NCCL kernels the profile shows are
   printed for each: at a world of one the node's reduce-scatter and
   all-gather are a copy and a cast, so the gradient must issue no
   collective at all and the control one all-reduce (the NCCL kernels of
   the reduce-scatters and the all-gather show at four cards,
   ``tools/multi_card.py``).  The gradient's result must be the parts
   path's bit for bit (the same push with debug sampling on, which keeps
   every tensor off the accumulator).  Figures beside the card's name
   and power limit, and the phase's time.

The run prints its total time.  The line before the last is a JSON
object with one entry per kernel (launches: the main paths' runs, phase
4, the two LM slices', phase 10's arms, phase 11's, 12's, 13's, 15's,
16's and 17's processes, which count their own, and phase 14's, 18's and
19's runs; phase 20 launches none of them);
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
    # the off-diagonal blocks of phase 15's ring: every key visible
    ("ring_gpt_qoff4096", (2, 4096, 4096, 8, 64), True, (4096, 4096)),
    ("ring_gpt_qoff8192", (2, 4096, 4096, 8, 64), True, (8192, 4096)),
    # phase 16's fsdp_tp rank: one sequence, 32 heads over tp 2
    ("llama_fsdp_tp_rank", (1, 4096, 4096, 16, 128), True),
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
ASYNC_STEPS = 2                  # timed steps per worker, after 1 warm-up
#                                  (3 before phase 12 lengthened the run)
ASYNC_SPEC = "bitflip:site=kv_push:p=0.05;drop:site=kv_push:p=0.1"
SERVER_SPEC = "bitflip:site=server_push:p=0.05"
FAULT_SEED = 7
ASYNC_DEVICE = "cuda"            # where the workers and codecs run
ONEBIT_SCALE_RTOL = 1e-5         # an L1 sum in another order (Queue C 6)
# the observed sharded update (10)
OBS_DEVICE = "cuda"
FAULT_DEVICE = "cuda"             # where phase 11's children run
FAULT_STEPS = 2                  # timed worker steps of each TCP arm
#                                  (3 before phase 12 lengthened the run)
FAULT_CHAOS_SPEC = {             # worker -> the faults it runs under (arm c)
    0: "bitflip:site=kv_push:p=0.02",
    1: "bitflip:site=kv_push:p=0.02;conn_reset:site=transport:p=0.005"}
FAULT_KILL_STEP = 2 * 161 + 80   # rank 1's push_pull enqueues: mid step 3
FAULT_TIMEOUT_S = 240            # each arm's children, in all
SYNC_DEADLINE_S = 0.5            # arm (e)'s engine
SYNC_DELAY_MS = 1500             # the chaos delay at site=sync in arm (e)
OBS_LLAMA_LAYERS = 4             # of Llama-3-8B's 32 (phase 8's cut)
OBSERVED_STEPS = 3               # timed steps of each tracing mode
OBS_TS_INTERVAL_S = 0.1          # the time-series sampler's cadence
OBS_WATCH = {"llama": ("h.0.attn.k.kernel", "h.0.attn.q.kernel"),
             "resnet": ("fc.weight", "blocks.13.convs.1.weight")}
# elastic membership (12)
ELASTIC_DEVICE = "cuda"          # where phase 12's members run
ELASTIC_STEPS = 8                # steps a member
ELASTIC_KILL_STEP = 2 * 161 + 80  # a member's push_pull enqueues: mid step 3
ELASTIC_DEADLINE_S = 2.0         # arm (c)'s BYTEPS_SYNC_DEADLINE_S
ELASTIC_WEDGE_MS = 5000          # arm (c)'s one-visit slow fault at site=sync
ELASTIC_WEDGE_STEP = 3
ELASTIC_TIMEOUT_S = 150          # each arm's children, in all
# serving and durability (13)
SERVE_DEVICE = "cuda"            # the trainer's, the hosts' and the client's
SERVE_MODEL = "resnet50"
SERVE_STEPS_A = 4                # arm (a)'s steps, a cut after each
SERVE_KILL_PULL = 2              # host 1 dies at this answered pull (b)
SERVE_PAUSE_ACKS = 80            # of 161 pushes: arm (c)'s kill, mid-step
SERVE_PULL_DEADLINE_S = 5.0      # a pull's deadline at one host
SERVE_TIMEOUT_S = 300            # the phase's children, in all


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


# ------------------------------------ 11. the fault plane and the TCP transport

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_role(role, argv, env=None):
    """One child of phase 11: a fresh interpreter running a role of
    ``byteps_tpu_torch/tools/fault_resnet.py`` from the repo's root."""
    root = os.path.dirname(os.path.abspath(__file__))
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = root + os.pathsep + full_env.get(
        "PYTHONPATH", "")
    full_env.pop("BYTEPS_FAULT_SPEC", None)
    full_env.update(env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.tools.fault_resnet", role,
         "--device", FAULT_DEVICE, "--batch", str(BATCH), "--image",
         str(IMAGE), "--steps", str(FAULT_STEPS)] + list(argv),
        cwd=root, env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _run_children(name, procs, expect=None):
    """Wait for every child within FAULT_TIMEOUT_S in all; each must exit
    with its expected code (0 unless ``expect`` names another) and, if
    it exits 0, print its result line.  A child that exits with another
    code fails the arm at once.  Every child still running when this
    returns or raises is killed.  Returns {child: result or None}."""
    import threading
    expect = expect or {}
    outs = {}

    def drain(who, p):
        outs[who] = p.communicate()[0]

    readers = [threading.Thread(target=drain, args=item, daemon=True)
               for item in procs.items()]
    for t in readers:
        t.start()
    deadline = time.monotonic() + FAULT_TIMEOUT_S
    killed = set()
    try:
        while any(p.poll() is None for p in procs.values()):
            bad = [who for who, p in procs.items() if p.poll() is not None
                   and p.returncode != expect.get(who, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for who, p in procs.items():
            if p.poll() is None:
                killed.add(who)
                p.kill()
        for t in readers:
            t.join(timeout=30)
    results = {}
    # the children that ended on their own first: a killed one only says
    # that another failed (or that the arm ran past its time)
    for who in sorted(procs, key=lambda w: w in killed):
        p, want = procs[who], expect.get(who, 0)
        out = outs.get(who, "")
        check(p.returncode == want,
              f"{name}: {who} exited {p.returncode}, expected {want}"
              + (f" (killed: another child failed, or the arm ran past "
                 f"{FAULT_TIMEOUT_S} s)" if who in killed else "")
              + ":\n" + out[-3000:])
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("FAULT_RESULT ")]
        if want == 0:
            check(len(lines) == 1, f"{name}: {who} printed no result:\n"
                                   + out[-3000:])
        results[who] = (json.loads(lines[0][len("FAULT_RESULT "):])
                        if lines else None)
    return results


def _spawn_tcp(arm, out, worker_env=None, replay=""):
    """Start the server and the two workers of one TCP arm."""
    port = _free_port()
    procs = {"server": _spawn_role("server", ["--port", str(port), "--arm",
                                              arm, "--out", out])}
    for w in (0, 1):
        argv = ["--rank", str(w), "--port", str(port), "--arm", arm,
                "--out", out]
        if replay:
            argv += ["--replay", replay]
        procs[f"worker{w}"] = _spawn_role(
            "worker", argv, env=(worker_env or {}).get(w))
    return procs


def _collect_tcp(torch, name, procs, out):
    """Wait for a TCP arm's children; returns their results and what the
    server and the workers wrote."""
    res = _run_children(name, procs)
    for w in (0, 1):
        losses = res[f"worker{w}"]["losses"]
        check(all(math.isfinite(x) for x in losses),
              f"{name}: worker {w} losses {losses}")

    def load(f):
        return torch.load(os.path.join(out, f), weights_only=False)

    pushed = {}
    for w in (0, 1):
        for key, wid, seq, payload in load(f"pushed_w{w}.pt"):
            pushed[(key, wid, seq)] = payload
    return {"res": res, "init": load("init.pt"), "store": load("store.pt"),
            "order": load("order.pt"), "pushed": pushed}


def _tcp_replay(torch, registry, rec, decode=False, drop=None):
    """The store by the host: the initial values plus every pushed delta
    (``decode``: each wire frame decoded by the server chain's plain
    versions) in the order the server applied them (``drop``: the index
    of one to leave out)."""
    import numpy as np
    acc = {k: v.numpy().copy() for k, v in rec["init"].items()}
    codecs = {}
    for j, tok in enumerate(rec["order"]):
        if j == drop:
            continue
        key = tok[0]
        payload = rec["pushed"][tuple(tok)]
        if decode:
            comp = codecs.get(key) or codecs.setdefault(
                key, registry.create(ONEBIT_EF, acc[key].size, torch.float32,
                                     for_server=True))
            delta = comp.decompress(comp.wire_decode(payload)).numpy()
        else:
            delta = payload.numpy()
        acc[key] += delta.reshape(acc[key].shape)
    return acc


def _exactly_once(rec, name):
    """Every (key, worker, seq) pushed was applied once: no duplicate, no
    gap."""
    order = [tuple(t) for t in rec["order"]]
    keys = rec["init"].keys()
    want = {(k, w, s) for k in keys for w in (0, 1)
            for s in range(1, 2 + FAULT_STEPS)}
    check(len(order) == len(set(order)),
          f"{name}: {len(order) - len(set(order))} tokens applied twice")
    check(set(order) == want,
          f"{name}: applied {len(set(order))} tokens, expected {len(want)}; "
          f"missing {sorted(want - set(order))[:3]}")


def _tcp_report(name, rec, smi, async_ms):
    ws = [rec["res"][f"worker{w}"] for w in (0, 1)]
    steps = [t for r in ws for t in r["step_ms"]]
    stages = {k: statistics.mean(r["stages_ms"][k] for r in ws)
              for k in ws[0]["stages_ms"]}
    rtt = [(round(r["rtt_ms"]["p50"], 3), round(r["rtt_ms"]["p99"], 3))
           for r in ws]
    log(f"{name} [{smi}]: {_median_line(steps)} a worker step over "
        f"{len(steps)} (phase 9's in-process async_resnet this run: "
        f"{_median_line(async_ms)}); host ms a step, mean of the workers, "
        f"{_fmt(stages)}; rtt ms p50/p99 per worker {rtt} over "
        f"{ws[0]['rtt_ms']['n']} requests each; wire bytes a worker "
        f"step {ws[0]['wire_bytes_per_step']:.0f}; server "
        f"{rec['res']['server']['counters']}; workers "
        f"{[r['counters'] for r in ws]}")
    return statistics.median(steps)


def _same_tcp_store(torch, rec, replay):
    return [k for k, v in rec["store"].items()
            if not same_bits(v, torch.from_numpy(replay[k]))]


def sync_deadline_arm(torch, bps, api, Config):
    """Arm (e): an engine with ``sync_deadline_s`` and an installed
    failure action; a chaos delay at ``site=sync`` longer than the
    deadline on one unit of four small tensors trips it once, the
    process stays up and the next push_pull completes."""
    from byteps_tpu_torch.common import flight_recorder as flight
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.fault import injector
    from byteps_tpu_torch.utils import failure_detector as fd

    calls = []
    exits = []
    real_exit = fd._exit
    fd._exit = exits.append
    prev = fd.install_failure_action(lambda stale: calls.append(
        (set(stale), time.monotonic())))
    bps.init(Config(sync_deadline_s=SYNC_DEADLINE_S, group_size=-1))
    try:
        eng = api.engine()
        xs = [torch.full((1024,), float(i + 1), device=api.device())
              for i in range(4)]
        for i, x in enumerate(xs):
            api.push_pull(x, f"deadline.{i}")
        trips0 = counters.get("engine.sync_deadline_trips")
        d0 = eng.stats["dispatches"]
        injector.arm(f"delay:site=sync:p=1:ms={SYNC_DELAY_MS}", seed=1)
        eng.pause_dispatch()
        t0 = time.monotonic()
        hs = [api.push_pull_async(x, f"deadline.{i}")
              for i, x in enumerate(xs)]
        eng.resume_dispatch()
        outs = [h.wait(timeout=60) for h in hs]
        injector.disarm()
        torch.cuda.synchronize()
        units = eng.stats["dispatches"] - d0
        trips = counters.get("engine.sync_deadline_trips") - trips0
        gaps = [e["gap_s"] for e in flight.recorder.snapshot()
                if e.get("kind") == "engine.sync_deadline"]
        check(units == 1, f"sync_deadline: the set took {units} units")
        check(len(calls) == 1 and calls[0][0] == set() and trips == 1,
              f"sync_deadline: action calls {calls}, trips {trips}")
        # the flight event rounds the gap to the ms (the JAX format): a
        # trip past the deadline by less than 0.5 ms reads as equal
        fired_after = calls[0][1] - t0
        check(gaps and gaps[-1] >= SYNC_DEADLINE_S
              and fired_after > SYNC_DEADLINE_S,
              f"sync_deadline: gap {gaps[-1:]} s, action {fired_after:.3f} "
              f"s after the push, deadline {SYNC_DEADLINE_S} s")
        check(not exits, f"sync_deadline: exit called {exits}")
        check(all(same_bits(o, x) for o, x in zip(outs, xs)),
              "sync_deadline: the delayed set's averages changed")
        after = api.push_pull(xs[0] * 2, "deadline.after")
        torch.cuda.synchronize()
        check(same_bits(after, xs[0] * 2),
              "sync_deadline: the next push_pull is wrong")
        log(f"sync_deadline: a {SYNC_DELAY_MS} ms chaos delay at site=sync "
            f"on one unit of 4 tensors tripped the {SYNC_DEADLINE_S} s "
            f"deadline once (gap {gaps[-1]:.3f} s, action fired "
            f"{fired_after:.3f} s after the push), no exit; the next "
            f"push_pull completed")
    finally:
        injector.disarm()
        fd.install_failure_action(prev)
        fd._exit = real_exit
        bps.shutdown()


def _spawn_recover(out):
    """Start arm (d)'s two trainers."""
    hb_port = _free_port()
    procs = {}
    for rank in (0, 1):
        env = {"DMLC_NUM_WORKER": "1", "DMLC_WORKER_ID": "0",
               "BYTEPS_FLIGHT_DIR": os.path.join(out, f"flight{rank}")}
        if rank == 1:
            env.update(BYTEPS_FAULT_SPEC=f"kill:rank=1:step={FAULT_KILL_STEP}",
                       BYTEPS_FAULT_SEED="7")
        procs[f"rank{rank}"] = _spawn_role(
            "recover", ["--rank", str(rank), "--hb-port", str(hb_port),
                        "--out", out], env=env)
    return procs


def kill_recover_arm(torch, procs, out):
    """Arm (d): two trainers, one killed mid-step by the injector, the
    other detecting it by heartbeat and recovering from a checkpoint."""
    res = _run_children("kill_and_recover_resnet", procs,
                        expect={"rank1": 1})["rank0"]
    kills = []
    flight_dir = os.path.join(out, "flight1")
    for f in sorted(os.listdir(flight_dir)) if os.path.isdir(
            flight_dir) else ():
        with open(os.path.join(flight_dir, f)) as fh:
            kills += [e for e in json.load(fh)["events"]
                      if e.get("kind") == "fault.kill"]
    check(len(kills) == 1 and kills[0]["step"] == FAULT_KILL_STEP,
          f"kill_and_recover_resnet: rank 1's kill events {kills}")
    c = res["counters"]
    check(c["recovery.attempt"] == c["recovery.completed"] == 1
          and c["recovery.failed"] == 0,
          f"kill_and_recover_resnet: counters {c}")
    check(res["failed_ranks"] == [1] and res["num_workers"] == 1,
          f"kill_and_recover_resnet: recovered {res['failed_ranks']} to "
          f"{res['num_workers']} worker(s)")
    check(res["n_differ"] == 0 and res["momenta"] == 161
          and res["restored_on_card"],
          f"kill_and_recover_resnet: {res['n_differ']} restored tensors "
          f"differ from the saved ones ({res['differ']}), "
          f"{res['momenta']} momenta, on the card {res['restored_on_card']}")
    check(len(res["losses_after"]) == 2 and all(
        math.isfinite(x) for x in res["losses_after"]),
        f"kill_and_recover_resnet: losses after {res['losses_after']}")
    detect_s = res["detected_at"] - kills[0]["t"]
    log(f"kill_and_recover_resnet: rank 1 killed at enqueue "
        f"{FAULT_KILL_STEP} (exit 1); rank 0 detected it after "
        f"{detect_s:.3f} s (heartbeat 0.2 s / timeout 2 s), suspend "
        f"{res['suspend_ms']:.1f} ms, resume {res['resume_ms']:.1f} ms, "
        f"restore {res['restore_ms']:.1f} ms (recovery "
        f"{res['recovery_s']:.3f} s), restored step {res['restored_step']} "
        f"of {res['steps_before']} bit for bit (161 parameters' tensors and "
        f"momenta on the card), 2 more steps with losses "
        f"{[round(x, 4) for x in res['losses_after']]}; checkpoint save "
        f"{_median_line(res['save_ms'])} for {res['save_bytes'][-1]} B")
    return res


def fault_phase(torch, bps, api, Config, registry, smi, async_ms):
    """Phase 11: ResNet-50 workers push to a store in another process
    over localhost TCP (raw, onebit, under chaos), a killed trainer's
    peer recovers from a checkpoint, and the sync deadline trips.  Each
    arm's children start while the parent checks the arm before (their
    start-up overlaps the check).  Returns the onebit launches its
    children counted."""
    out = tempfile.mkdtemp(prefix="bps_fault_")
    dirs = {a: os.path.join(out, a) for a in "abcd"}
    launches = collections.Counter()
    live = []               # every arm's children, killed in the finally
    t_arm = time.perf_counter()

    def arm_done(name):
        nonlocal t_arm
        log(f"{name}: {time.perf_counter() - t_arm:.1f} s")
        t_arm = time.perf_counter()

    try:
        live.append(_spawn_tcp("raw", dirs["a"]))
        raw = _collect_tcp(torch, "tcp_async_resnet", live[-1], dirs["a"])
        live.append(_spawn_tcp("onebit", dirs["b"]))
        _exactly_once(raw, "tcp_async_resnet")
        bad = _same_tcp_store(torch, raw, _tcp_replay(torch, registry, raw))
        check(not bad, f"tcp_async_resnet: {len(bad)} keys differ from the "
                       f"replay in the applied order, first {bad[:3]}")
        ctl = _tcp_replay(torch, registry, raw, drop=0)
        check(bool(_same_tcp_store(torch, raw, ctl)),
              "tcp_async_resnet: a replay without one delta matched")
        log(f"tcp_async_resnet: the store equals the host replay of "
            f"{len(raw['order'])} deltas in the server's applied order bit "
            f"for bit; without one it differs")
        raw_med = _tcp_report("tcp_async_resnet", raw, smi, async_ms)
        for r in raw["res"].values():
            launches.update(r["launches"])
        del raw
        arm_done("tcp_async_resnet")

        onebit = _collect_tcp(torch, "tcp_async_resnet_onebit", live[-1],
                              dirs["b"])
        live.append(_spawn_tcp(
            "chaos", dirs["c"], replay=dirs["a"],
            worker_env={w: {"BYTEPS_FAULT_SPEC": spec,
                            "BYTEPS_FAULT_SEED": str(7 + w)}
                        for w, spec in FAULT_CHAOS_SPEC.items()}))
        _exactly_once(onebit, "tcp_async_resnet_onebit")
        bad = _same_tcp_store(torch, onebit, _tcp_replay(
            torch, registry, onebit, decode=True))
        check(not bad, f"tcp_async_resnet_onebit: {len(bad)} keys differ "
                       f"from the CPU replay, first {bad[:3]}")
        n = len(onebit["init"])
        pushes = 1 + FAULT_STEPS
        for w in (0, 1):
            got = onebit["res"][f"worker{w}"]["launches"]
            want = {"onebit_pack": n * pushes, "onebit_unpack": n * pushes,
                    "onebit_unpack_sum": 0}
            check(got == want, f"tcp_async_resnet_onebit: worker {w} "
                               f"launches {got}, expected {want}")
        got = onebit["res"]["server"]["launches"]
        want = {"onebit_pack": 0, "onebit_unpack": len(onebit["order"]),
                "onebit_unpack_sum": 0}
        check(got == want, f"tcp_async_resnet_onebit: server launches "
                           f"{got}, expected {want}")
        for r in onebit["res"].values():
            launches.update(r["launches"])
        srv = onebit["res"]["server"]
        log(f"tcp_async_resnet_onebit: the store equals the CPU replay of "
            f"{len(onebit['order'])} frames bit for bit; launches: workers "
            f"a pack and an unpack per key and push, server an unpack per "
            f"applied push ({want['onebit_unpack']}); landed wire "
            f"{srv['wire_bytes']} B")
        _tcp_report("tcp_async_resnet_onebit", onebit, smi, async_ms)
        del onebit
        arm_done("tcp_async_resnet_onebit")

        chaos = _collect_tcp(torch, "tcp_async_resnet_chaos", live[-1],
                             dirs["c"])
        live.append(_spawn_recover(dirs["d"]))
        _exactly_once(chaos, "tcp_async_resnet_chaos")
        bad = _same_tcp_store(torch, chaos, _tcp_replay(torch, registry,
                                                        chaos))
        check(not bad, f"tcp_async_resnet_chaos: {len(bad)} keys differ "
                       f"from the replay of its own log, first {bad[:3]}")
        sc = chaos["res"]["server"]["counters"]
        wc = [chaos["res"][f"worker{w}"]["counters"] for w in (0, 1)]
        check(sc["integrity.crc_reject"] > 0
              and sc["integrity.dup_dropped"] > 0
              and sum(c["integrity.retransmit"] for c in wc) > 0
              and wc[1]["transport.conn_resets"] > 0
              and wc[1]["transport.reconnects"] > 0,
              f"tcp_async_resnet_chaos: server {sc}, workers {wc}")
        log(f"tcp_async_resnet_chaos: every (worker, seq) of every key "
            f"applied exactly once; the store equals the replay of its own "
            f"log; server {sc}; workers {wc}")
        med = _tcp_report("tcp_async_resnet_chaos", chaos, smi, async_ms)
        log(f"tcp_async_resnet_chaos: median worker step {med:.2f} ms "
            f"against tcp_async_resnet's {raw_med:.2f} ms")
        del chaos
        arm_done("tcp_async_resnet_chaos")

        kill_recover_arm(torch, live[-1], dirs["d"])
        arm_done("kill_and_recover_resnet")
        sync_deadline_arm(torch, bps, api, Config)
        arm_done("sync_deadline")
    finally:
        for procs in live:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        shutil.rmtree(out, ignore_errors=True)
    return dict(launches)

def _spawn_member(who, rank, out, bus, hb, argv=(), env=None):
    """One member of phase 12: a fresh interpreter running
    ``byteps_tpu_torch/tools/elastic_resnet.py`` from the repo's root, its
    output in ``out/<who>.log`` (a file, so no pipe can fill while the
    parent waits on the bus)."""
    root = os.path.dirname(os.path.abspath(__file__))
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = root + os.pathsep + full_env.get(
        "PYTHONPATH", "")
    for k in ("BYTEPS_FAULT_SPEC", "BYTEPS_GOSSIP_ON",
              "BYTEPS_SYNC_DEADLINE_S"):
        full_env.pop(k, None)
    full_env.update(DMLC_NUM_WORKER="1", DMLC_WORKER_ID=str(rank),
                    BYTEPS_FLIGHT_DIR=os.path.join(out, f"flight_{who}"))
    full_env.update(env or {})
    path = os.path.join(out, f"{who}.log")
    with open(path, "w") as logf:
        p = subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.tools.elastic_resnet",
             "--rank", str(rank), "--bus", f"127.0.0.1:{bus}", "--hb-port",
             str(hb), "--steps", str(ELASTIC_STEPS), "--device",
             ELASTIC_DEVICE, "--batch", str(BATCH), "--image", str(IMAGE),
             "--out", out] + list(argv),
            cwd=root, env=full_env, stdout=logf, stderr=subprocess.STDOUT)
    p.log_path = path
    return p


def _member_log(p):
    with open(p.log_path) as f:
        return f.read()


def _members_wait(name, procs, until, expect, deadline):
    """Poll until ``until()``; a member that exits with another code than
    its expected one (``expect``, default 0) or the arm's deadline fails
    the run."""
    while not until():
        for who, p in procs.items():
            rc = p.poll()
            want = expect.get(who, 0)
            if rc is not None and rc != want:
                check(False, f"{name}: {who} exited {rc}, expected {want}:\n"
                             + _member_log(p)[-3000:])
        check(time.monotonic() < deadline,
              f"{name}: past its {ELASTIC_TIMEOUT_S} s; logs:\n" + "\n".join(
                  f"--- {who}\n{_member_log(p)[-1500:]}"
                  for who, p in procs.items()))
        time.sleep(0.05)


def _members_results(name, procs, expect, deadline):
    """Wait for every member to end; each with its expected code, and
    one result line from each that exits 0.  Returns {who: result}."""
    _members_wait(name, procs,
                  lambda: all(p.poll() is not None for p in procs.values()),
                  expect, deadline)
    out = {}
    for who, p in procs.items():
        text = _member_log(p)
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("ELASTIC_RESULT ")]
        if expect.get(who, 0) == 0:
            check(len(lines) == 1, f"{name}: {who} printed no result:\n"
                                   + text[-3000:])
            check("FINAL " in text, f"{name}: {who} has no FINAL line")
        out[who] = (json.loads(lines[0][len("ELASTIC_RESULT "):])
                    if lines else None)
    return out


def _flight_events(out, who, kind):
    found = []
    d = os.path.join(out, f"flight_{who}")
    for f in sorted(os.listdir(d)) if os.path.isdir(d) else ():
        with open(os.path.join(d, f)) as fh:
            found += [e for e in json.load(fh)["events"]
                      if e.get("kind") == kind]
    return found


def _bus_view(bus):
    from byteps_tpu_torch.fault.membership import bus_request
    try:
        pong = bus_request(("127.0.0.1", bus), {"op": "ping"}, timeout=2.0)
    except (ConnectionError, TimeoutError):
        return None
    return (pong.get("epoch"), sorted(pong.get("world") or ())) \
        if pong.get("ok") else None


def _check_steps(name, res):
    """Every member's every step: finite loss, and the parameter and
    momentum CRC32Cs of the epoch's members equal."""
    for who, r in res.items():
        if r is None:
            continue
        check(r["steps"], f"{name}: {who} took no step")
        for s in r["steps"]:
            check(s["crc_agree"] and s["mcrc_agree"],
                  f"{name}: {who} step {s['step']} (epoch {s['epoch']}, "
                  f"world {s['world']}): the members' parameter or momentum "
                  f"CRCs differ")
            check(math.isfinite(s["loss"]),
                  f"{name}: {who} step {s['step']} loss {s['loss']}")


def _elastic_report(name, res, smi, t0, extra):
    steps = [s["ms"] for r in res.values() if r for s in r["steps"]]
    sync = sorted(s["sync_ms"] for r in res.values() if r
                  for s in r["steps"])
    frame = max(r["frame_bytes"] or 0 for r in res.values() if r)
    reply = max(s["reply_bytes"] for r in res.values() if r
                for s in r["steps"])
    p99 = sync[min(len(sync) - 1, int(0.99 * len(sync)))]
    log(f"{name} [{smi}]: member step {_median_line(steps)}; step_sync "
        f"round trip p50 {sync[len(sync) // 2]:.1f} ms p99 {p99:.1f} ms, "
        f"{frame} B up a member a step (pickled payload), up to {reply} B "
        f"of gradients down")
    for k, v in extra.items():
        log(f"{name}: {k} {v}")
    for who, r in sorted(res.items()):
        if r:
            # the first step at each new epoch pays the fresh engine's
            # first collectives (NCCL opens its communicator lazily)
            first = [round(b["ms"], 1) for a, b in zip(r["steps"],
                                                       r["steps"][1:])
                     if b["epoch"] != a["epoch"]]
            log(f"{name}: {who} onebit launches {r['launches']}, suspend "
                f"{[round(x, 1) for x in r['events']['suspend_ms']]} ms, "
                f"resume "
                f"{[round(x, 1) for x in r['events']['resume_ms']]} ms, "
                f"first step at a new epoch {first} ms, epochs "
                f"{sorted({s['epoch'] for s in r['steps']})}")
    log(f"{name}: {time.perf_counter() - t0:.1f} s")


def elastic_phase(torch, smi):
    """Phase 12: three ResNet-50 members on the card shrink past a killed
    peer and readmit it in place, fail over a dead coordinator, and
    reconcile a wedged step.  Returns the onebit launches its members
    counted."""
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.tools import bps_top
    root = tempfile.mkdtemp(prefix="bps_elastic_")
    launches = collections.Counter()
    live = []

    def spawn(who, rank, out, bus, hb, argv=(), env=None):
        p = _spawn_member(who, rank, out, bus, hb, argv, env)
        live.append(p)
        return p

    def count(res):
        for r in res.values():
            if r:
                launches.update(r["launches"])
                check(all(r["launches"][k] > 0 for k in KERNELS),
                      f"elastic: a member launched no onebit kernel of "
                      f"some kind: {r['launches']}")

    try:
        # arms (b) and (c) start with (a) and wait at their go file, so
        # their interpreters and CUDA contexts come up while (a) runs
        outs = {arm: os.path.join(root, arm) for arm in "abc"}
        for d in outs.values():
            os.makedirs(d)
        ports = {arm: (_free_port(), _free_port()) for arm in "abc"}
        env_b = {"BYTEPS_GOSSIP_ON": "1", "BYTEPS_FAULT_SEED": "7",
                 "BYTEPS_FAULT_SPEC":
                     f"kill:site=coordinator:step={ELASTIC_KILL_STEP}"}
        env_c = {"BYTEPS_SYNC_DEADLINE_S": str(ELASTIC_DEADLINE_S)}
        wedge = ["--wedge-step", str(ELASTIC_WEDGE_STEP), "--wedge-ms",
                 str(ELASTIC_WEDGE_MS)]
        later = {}
        for arm, env in (("b", env_b), ("c", env_c)):
            go = ["--go", os.path.join(outs[arm], "go")]
            later[arm] = {f"m{r}": spawn(
                f"m{r}", r, outs[arm], *ports[arm],
                go + (["--linger"] if arm == "b" and r else [])
                + (wedge if arm == "c" and r == 1 else []), env)
                for r in (0, 1, 2)}

        # (a) kill member 2, shrink, readmit a restarted member 2
        name, t0 = "elastic_resnet_shrink_rejoin", time.perf_counter()
        out = outs["a"]
        bus, hb = ports["a"]
        kill = {"BYTEPS_FAULT_SPEC": f"kill:rank=2:step={ELASTIC_KILL_STEP}",
                "BYTEPS_FAULT_SEED": "7"}
        procs = {"m0": spawn("m0", 0, out, bus, hb, ["--hold-for-rejoin",
                                                      "--stale-probe"]),
                 "m1": spawn("m1", 1, out, bus, hb),
                 "m2": spawn("m2", 2, out, bus, hb, env=kill),
                 "rejoin2": spawn("rejoin2", 2, out, bus, hb,
                                  ["--rejoin", "--go",
                                   os.path.join(out, "go")])}
        expect = {"m2": 1}
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        _members_wait(name, procs, lambda: procs["m2"].poll() is not None,
                      expect, deadline)
        _members_wait(name, procs, lambda: _bus_view(bus) == (1, [0, 1]),
                      expect, deadline)
        open(os.path.join(out, "go"), "w").close()
        res = _members_results(name, procs, expect, deadline)
        kills = _flight_events(out, "m2", "fault.kill")
        check(len(kills) == 1 and kills[0]["step"] == ELASTIC_KILL_STEP,
              f"{name}: member 2's kill events {kills}")
        for who in ("m0", "m1"):
            r = res[who]
            worlds = [(w["epoch"], w["world"]) for w in r["events"]["world"]]
            check(worlds == [(1, [0, 1]), (2, [0, 1, 2])],
                  f"{name}: {who} went through {worlds}")
            check(any(s["world"] == [0, 1] for s in r["steps"]),
                  f"{name}: {who} took no step in the world (0, 1)")
        rj = res["rejoin2"]
        check(rj["rejoined"] and rj["admitted_epoch"] == 2
              and rj["admitted_world"] == [0, 1, 2]
              and rj["state_bits_equal"],
              f"{name}: the rejoiner was admitted at epoch "
              f"{rj['admitted_epoch']}, world {rj['admitted_world']}, state "
              f"bits equal {rj['state_bits_equal']}")
        for who in ("m0", "m1", "rejoin2"):
            r = res[who]
            check(r["final_epoch"] == 2 and r["final_world"] == [0, 1, 2],
                  f"{name}: {who} ended at epoch {r['final_epoch']}, world "
                  f"{r['final_world']}")
        _check_steps(name, res)
        pr = res["m0"]["probes"]
        check(pr["dispatch"] == "StaleEpochError"
              and pr["retire"] == "StaleEpochError"
              and pr["chunks_dropped"] == 2 and pr["kv_value"] == 1.0
              and pr["server_value"] == 2.0 and pr["pushes_dropped"] >= 2,
              f"{name}: stale probes {pr}")
        detect = min(e["t"] for e in res["m0"]["events"]["detect"])
        shrunk = res["m0"]["events"]["world"][0]["t"]
        count(res)
        _elastic_report(name, res, smi, t0, {
            "kill -> detection ms": round((detect - kills[0]["t"]) * 1e3, 1),
            "detection -> resumed (shrink) ms": round(
                (shrunk - detect) * 1e3, 1),
            "rejoin request -> admitted ms": round(
                (rj["t_admitted"] - rj["t_request"]) * 1e3, 1),
            "rejoiner state step": rj["state_step"],
            "stale probes": pr})

        # (b) kill whoever coordinates: member 0; member 1 takes the bus
        name, t0 = "elastic_resnet_coordinator_kill", time.perf_counter()
        out = outs["b"]
        bus, hb = ports["b"]
        procs = later["b"]
        open(os.path.join(out, "go"), "w").close()
        expect = {"m0": 1}
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        _members_wait(name, procs, lambda: all(
            os.path.exists(os.path.join(out, f"member{r}.json"))
            for r in (1, 2)), expect, deadline)
        cluster = api.cluster_metrics(bus=f"127.0.0.1:{bus}")
        check(cluster.get("coordinator") == 1
              and cluster.get("bus_rank") == 1
              and cluster.get("world") == [1, 2]
              and set(cluster.get("states") or ()) == {0, 1, 2},
              f"{name}: cluster_metrics from the new bus: coordinator "
              f"{cluster.get('coordinator')}, bus rank "
              f"{cluster.get('bus_rank')}, world {cluster.get('world')}, "
              f"gossip states {cluster.get('states')}")
        log(bps_top.render(cluster))
        open(os.path.join(out, "release"), "w").close()
        res = _members_results(name, procs, expect, deadline)
        kills = _flight_events(out, "m0", "fault.kill")
        check(len(kills) == 1 and kills[0]["step"] == ELASTIC_KILL_STEP,
              f"{name}: member 0's kill events {kills}")
        for who in ("m1", "m2"):
            r = res[who]
            check(r["final_epoch"] == 1 and r["final_world"] == [1, 2],
                  f"{name}: {who} ended at epoch {r['final_epoch']}, world "
                  f"{r['final_world']}")
            check([e["stale"] for e in r["events"]["detect"]] == [[0]],
                  f"{name}: {who} detected {r['events']['detect']}")
            check(r["counters"]["membership.heartbeat_rehosted"] >= 2,
                  f"{name}: {who} re-hosted its heartbeat "
                  f"{r['counters']['membership.heartbeat_rehosted']} times")
        c1 = res["m1"]["counters"]
        check(c1["membership.coordinator_failover"] == 1
              and res["m2"]["counters"]["membership.coordinator_failover"]
              == 0, f"{name}: failovers {c1}")
        _check_steps(name, res)
        detect = res["m1"]["events"]["detect"][0]["t"]
        moved = res["m1"]["events"]["world"][0]["t"]
        count(res)
        _elastic_report(name, res, smi, t0, {
            "kill -> detection ms": round((detect - kills[0]["t"]) * 1e3, 1),
            "failover (detection -> resumed on member 1's bus) ms": round(
                (moved - detect) * 1e3, 1),
            "gossip states": {r: e["state"]
                              for r, e in cluster["states"].items()}})

        # (c) a wedged step on member 1: the deadline trips, reconcile
        name, t0 = "elastic_resnet_wedge", time.perf_counter()
        procs = later["c"]
        open(os.path.join(outs["c"], "go"), "w").close()
        res = _members_results(name, procs, {},
                               time.monotonic() + ELASTIC_TIMEOUT_S)
        for who, r in res.items():
            check(r["final_epoch"] == 1 and r["final_world"] == [0, 1, 2],
                  f"{name}: {who} ended at epoch {r['final_epoch']}, world "
                  f"{r['final_world']}")
        c1 = res["m1"]["counters"]
        check(c1["engine.sync_deadline_trips"] >= 1
              and c1["membership.reconcile_started"] >= 1
              and res["m1"]["events"]["reconcile"],
              f"{name}: member 1's counters {c1}")
        _check_steps(name, res)
        count(res)
        _elastic_report(name, res, smi, t0, {
            "reconcile (trip -> resumed on member 1) ms": [
                round(e["ms"], 1) for e in res["m1"]["events"]["reconcile"]],
            "deadline trips": c1["engine.sync_deadline_trips"],
            "reconciles started": c1["membership.reconcile_started"]})
    finally:
        for p in live:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    return dict(launches)


# ------------------------------------------- 13. serving and durability

class _Tail:
    """A child's output file, read as it grows."""

    def __init__(self, path):
        self.path = path

    def lines(self):
        try:
            with open(self.path) as f:
                return f.read().splitlines()
        except FileNotFoundError:
            return []

    def tagged(self, tag):
        return [ln[len(tag) + 1:] for ln in self.lines()
                if ln.startswith(tag + " ")]


def _serve_child(argv, out, name, env):
    root = os.path.dirname(os.path.abspath(__file__))
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = root + os.pathsep + full_env.get(
        "PYTHONPATH", "")
    full_env.pop("BYTEPS_FAULT_SPEC", None)
    full_env.update(env)
    path = os.path.join(out, f"{name}.log")
    with open(path, "w") as logf:
        p = subprocess.Popen([sys.executable] + argv, cwd=root, env=full_env,
                             stdout=logf, stderr=subprocess.STDOUT)
    p.tail = _Tail(path)
    return p


def _serve_wait(name, pred, procs, deadline):
    """Poll ``pred()`` until it holds; a child that exits early (with
    another code than 0, or at all while it is awaited) or the deadline
    fails the run."""
    while True:
        got = pred()
        if got:
            return got
        for who, p in procs.items():
            rc = p.poll()
            check(rc is None or rc == 0,
                  f"{name}: {who} exited {rc}:\n"
                  + "\n".join(p.tail.lines()[-40:]))
        check(time.monotonic() < deadline,
              f"{name}: past its {SERVE_TIMEOUT_S} s; logs:\n" + "\n".join(
                  f"--- {who}\n" + "\n".join(p.tail.lines()[-20:])
                  for who, p in procs.items()))
        time.sleep(0.02)


class _ServeLedger:
    """What each cut published, by (key, version): a raw key's CRC32C,
    a onebit key's CPU-chain frame (sign words' CRC32C, scale)."""

    def __init__(self):
        self.raw, self.onebit, self.cuts = {}, {}, []

    def add(self, doc):
        for k, c in doc["crc"].items():
            self.raw[(k, doc["versions"][k])] = c
        for k, f in doc["onebit"].items():
            self.onebit[(k, doc["versions"][k])] = f
        self.cuts.append(doc)


def _check_pulled(torch, registry, name, client, vals, ledger, want):
    """Every pulled key at the versions ``want`` (the latest cut's): a raw
    key bit for bit the trainer's value at that version; a onebit key's
    sign words bit for bit the CPU chain's and its magnitude the chain's
    scale within ONEBIT_SCALE_RTOL."""
    from byteps_tpu_torch.native import crc32c
    check(sorted(vals) == sorted(want),
          f"{name}: pulled {len(vals)} keys, the cut has {len(want)}")
    cpu = torch.device("cpu")
    worst = 0.0
    for k, x in vals.items():
        v = client.version(k)
        check(v == want[k], f"{name}: {k} at version {v}, the cut's is "
                            f"{want[k]}")
        host = x.detach().cpu().contiguous()
        if (k, v) in ledger.raw:
            got = crc32c(memoryview(host.numpy()).cast("B"))
            check(got == ledger.raw[(k, v)],
                  f"{name}: raw {k} v{v} CRC32C {got:#x}, the trainer's "
                  f"{ledger.raw[(k, v)]:#x}")
            continue
        check((k, v) in ledger.onebit, f"{name}: {k} v{v} not in any cut")
        words_crc, scale = ledger.onebit[(k, v)]
        comp = registry.create(ONEBIT_EF, host.numel(), torch.float32,
                               for_server=True)
        payload, _ = comp.compress(host.reshape(-1), comp.init_state(cpu))
        got = crc32c(memoryview(payload["words"].numpy()).cast("B"))
        check(got == words_crc, f"{name}: onebit {k} v{v}: sign words "
                                f"differ from the CPU chain's")
        mag = host.abs()
        check(bool((mag == mag[0]).all()), f"{name}: onebit {k} v{v} is "
                                           f"not sign x scale")
        err = abs(float(mag[0]) - scale) / max(abs(scale), 1e-30)
        worst = max(worst, err)
        check(err <= ONEBIT_SCALE_RTOL,
              f"{name}: onebit {k} v{v} scale {float(mag[0])!r}, the CPU "
              f"chain's {scale!r} (rel {err:.3g})")
    return worst


def serving_phase(torch, smi):
    """Phase 13: a ResNet-50 async store on the card, durable, serves its
    onebit-encoded cuts through a serving tier to two serving-host
    processes kept by a fleet reconciler, survives a host's death, and
    comes back from its journal after a SIGKILL.  Returns the onebit
    launches of every process."""
    import signal
    import threading

    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.comm.transport import TcpEndpoint
    from byteps_tpu_torch.compression import registry
    from byteps_tpu_torch.fault.membership import (SERVE_RANK_BASE,
                                                   MembershipView,
                                                   _BusServer)
    from byteps_tpu_torch.launcher.reconciler import FleetReconciler
    from byteps_tpu_torch.ops import onebit_kernels as ok
    from byteps_tpu_torch.server.serve_client import PullClient
    from byteps_tpu_torch.server.serving_tier import (TierDirectory,
                                                      TierRouter)

    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="bps_serve_")
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    bus_port = _free_port()
    bus = _BusServer(("127.0.0.1", bus_port), MembershipView(0, (0,)),
                     5.0, 5.0)
    busaddr = f"127.0.0.1:{bus_port}"
    hosts = collections.defaultdict(list)     # host id -> its processes
    deaths = {}

    def spawn_host(hid, env):
        n = len(hosts[hid])
        p = _serve_child(["-m", "byteps_tpu_torch.server.serve_host",
                          "--device", SERVE_DEVICE], out,
                         f"host{hid}.{n}", env)
        hosts[hid].append(p)
        return p

    rec = FleetReconciler(bus=busaddr, spawn_fn=spawn_host, interval_s=0.1,
                          max_hosts=2, device=SERVE_DEVICE,
                          spawn_env={"BYTEPS_DURABLE_DIR":
                                     os.path.join(out, "hosts")})
    stop = threading.Event()
    loop = threading.Thread(target=rec.run, args=(stop,), daemon=True)
    directory = TierDirectory(bus=busaddr)
    procs = {}
    ncmd = [0]
    launches = collections.Counter()
    launches_trainer = launches_recover = {}
    client = None

    def command(*words):
        ncmd[0] += 1
        tmp = os.path.join(out, f".cmd.{ncmd[0]}")
        with open(tmp, "w") as f:
            f.write(" ".join(str(w) for w in words))
        os.replace(tmp, os.path.join(out, f"cmd.{ncmd[0]}"))

    def next_cut(p, ledger, seen):
        docs = _serve_wait("serving", lambda: (
            p.tail.tagged("CUT")[seen:] or None), procs, deadline)
        doc = json.loads(docs[0])
        ledger.add(doc)
        return doc

    def watch():
        # the killed host's death, to the millisecond
        while not stop.is_set():
            for hid, ps in list(hosts.items()):
                for i, p in enumerate(list(ps)):
                    if (hid, i) not in deaths and p.poll() is not None:
                        deaths[(hid, i)] = time.monotonic()
            time.sleep(0.005)

    watcher = threading.Thread(target=watch, daemon=True)
    try:
        env = {"BYTEPS_DURABLE_DIR": os.path.join(out, "durable"),
               "BYTEPS_WAL_FSYNC": "always", "DMLC_NUM_WORKER": "1",
               "DMLC_WORKER_ID": "0"}
        argv = ["-m", "byteps_tpu_torch.tools.serve_resnet"]
        common = ["--bus", busaddr, "--device", SERVE_DEVICE, "--model",
                  SERVE_MODEL, "--batch", str(BATCH), "--image", str(IMAGE),
                  "--out", out]
        directory.set_target(2)
        loop.start()
        watcher.start()
        procs["trainer"] = trainer = _serve_child(
            argv + ["train"] + common, out, "trainer", env)
        up = json.loads(_serve_wait("serving", lambda: (
            trainer.tail.tagged("TRAINER-UP") or [None])[0], procs,
            deadline))
        _serve_wait("serving", lambda: sorted(
            directory.hosts(force=True)[1]) == [0, 1], procs, deadline)
        for hid in (0, 1):
            procs[f"host{hid}"] = hosts[hid][0]
        log(f"serving [{smi}]: trainer and hosts up in "
            f"{time.perf_counter() - t_phase:.1f} s; {up['keys']} keys, "
            f"{up['compressed']} onebit + EF, {up['raw_bytes']} B raw")
        ok.reset_launches()
        client = PullClient(TierRouter(TierDirectory(bus=busaddr),
                                       replicas=2,
                                       pull_deadline_s=SERVE_PULL_DEADLINE_S),
                            max_staleness_s=60.0, device=SERVE_DEVICE,
                            stale_on_error=False)
        ledger = _ServeLedger()
        pull_ms, pull_done, worst = [], [], [0.0]

        def pull_and_check(name, want):
            t0 = time.perf_counter()
            vals = client.pull(max_staleness_s=0.0)
            if SERVE_DEVICE == "cuda":
                torch.cuda.synchronize()
            pull_ms.append((time.perf_counter() - t0) * 1e3)
            pull_done.append(time.monotonic())
            worst[0] = max(worst[0], _check_pulled(
                torch, registry, name, client, vals, ledger, want))

        # (a) a cut after every step, a blocking pull after every cut
        t_arm = time.perf_counter()
        name = "serve_resnet_tier"
        for _ in range(SERVE_STEPS_A):
            command("step")
            doc = next_cut(trainer, ledger, len(ledger.cuts))
            pull_and_check(name, doc["versions"])
            b0, h0 = client.bytes_received, counters.get("serve.cache_hits")
            client.pull()                  # inside the staleness bound
            check(client.bytes_received == b0
                  and counters.get("serve.cache_hits") == h0 + 1,
                  f"{name}: the pull inside the bound was no cache hit")
        _serve_report(name, ledger.cuts, smi, pull_ms, client, up,
                      t_arm, worst[0])
        # (b) host 1 dies at its SERVE_KILL_PULL-th answered pull
        t_arm = time.perf_counter()
        name = "serve_resnet_host_kill"
        addr = directory.hosts(force=True)[1][1]
        ep = TcpEndpoint(addr, peer=SERVE_RANK_BASE + 1, rank=0)
        ep.serve_ctl(cmd="chaos_arm", seed=FAULT_SEED,
                     spec=f"kill:site=serve_host:step={SERVE_KILL_PULL}")
        ep.close(drain=False)
        f0 = counters.get("serve.tier_failover")
        command("step")
        doc = next_cut(trainer, ledger, len(ledger.cuts))
        del procs["host1"]
        while (1, 0) not in deaths or len(hosts[1]) < 2 or not any(
                ln.startswith("HOST-RESTORED") for ln in
                hosts[1][-1].tail.lines()):
            pull_and_check(name, doc["versions"])
            check(time.monotonic() < deadline, f"{name}: host 1 was not "
                  f"killed and restored within {SERVE_TIMEOUT_S} s")
            time.sleep(0.2)
        t_restored = time.monotonic()
        procs["host1"] = hosts[1][-1]
        restored = [ln for ln in hosts[1][-1].tail.lines()
                    if ln.startswith("HOST-RESTORED")][0]
        _serve_wait(name, lambda: directory.hosts(force=True)[1].get(1)
                    not in (None, addr), procs, deadline)
        check(counters.get("reconcile.restarted") == 1
              and counters.get("reconcile.crashed") == 1,
              f"{name}: reconcile restarted "
              f"{counters.get('reconcile.restarted')} crashed "
              f"{counters.get('reconcile.crashed')}, expected 1 and 1")
        dead = [t for t in pull_done if deaths[(1, 0)] < t < t_restored]
        check(dead, f"{name}: no pull completed while host 1 was down")
        command("cut")                     # no step: nothing changed
        recut = next_cut(trainer, ledger, len(ledger.cuts))
        check(recut["arc_probe_hits"] == 1 and recut["ship_bytes"] == 0,
              f"{name}: the restarted host was re-shipped "
              f"{recut['ship_bytes']} B (probe hits "
              f"{recut['arc_probe_hits']})")
        pull_and_check(name, recut["versions"])
        command("step")
        doc = next_cut(trainer, ledger, len(ledger.cuts))
        pull_and_check(name, doc["versions"])
        kill_ms = (t_restored - deaths[(1, 0)]) * 1e3
        _serve_report(name, ledger.cuts[SERVE_STEPS_A:], smi, pull_ms,
                      client, up, t_arm, worst[0],
                      extra={"kill -> HOST-RESTORED": f"{kill_ms:.1f} ms "
                             f"({restored})",
                             "pulls while host 1 was down": len(dead),
                             "failovers along the arc": counters.get(
                                 "serve.tier_failover") - f0})
        # (c) the trainer killed mid-step; a fresh process recovers
        t_arm = time.perf_counter()
        name = "serve_resnet_cold_start"
        command("pause", SERVE_PAUSE_ACKS)
        paused = _serve_wait(name, lambda: (trainer.tail.tagged("PAUSED")
                                            or [None])[0], procs, deadline)
        trainer.send_signal(signal.SIGKILL)
        trainer.wait(timeout=30)
        del procs["trainer"]
        launches_trainer = json.loads(paused.split(" ", 1)[1])
        launches.update(launches_trainer)
        last = {}
        for ln in trainer.tail.tagged("ACK"):
            k, v, c = ln.split()
            last[k] = (int(v), int(c))
        procs["recover"] = recov = _serve_child(
            argv + ["recover"] + common, out, "recover", env)
        got = json.loads(_serve_wait(name, lambda: (
            recov.tail.tagged("RECOVERED") or [None])[0], procs, deadline))
        bad = [k for k, (v, c) in last.items()
               if (got["versions"].get(k), got["crc"].get(k)) != (v, c)]
        check(not bad and sorted(last) == sorted(got["versions"]),
              f"{name}: {len(bad)} keys differ from their last "
              f"acknowledged push, e.g. {bad[:3]}")
        check(got["replayed"] == got["absorbed"] == len(got["versions"]),
              f"{name}: {got['absorbed']} of {got['replayed']} replayed "
              f"tokens absorbed ({len(got['versions'])} keys)")
        rdoc = next_cut(recov, ledger, 0)
        fresh = PullClient(TierRouter(TierDirectory(bus=busaddr),
                                      replicas=2,
                                       pull_deadline_s=SERVE_PULL_DEADLINE_S),
                           max_staleness_s=0.0, device=SERVE_DEVICE,
                           stale_on_error=False)
        t0 = time.perf_counter()
        vals = fresh.pull()
        full_ms = (time.perf_counter() - t0) * 1e3
        check(rdoc["versions"] == got["versions"],
              f"{name}: the fresh tier's cut is not the recovered store")
        worst[0] = max(worst[0], _check_pulled(
            torch, registry, name, fresh, vals, ledger, rdoc["versions"]))
        fresh.close()
        command_done = os.path.join(out, "cmd.done")
        with open(command_done, "w") as f:
            f.write("done")
        _serve_wait(name, lambda: recov.poll() is not None, {}, deadline)
        check(recov.returncode == 0, f"{name}: recover exited "
              f"{recov.returncode}")
        rl = launches_recover = json.loads(
            recov.tail.tagged("RECOVER-LAUNCHES")[0])
        launches.update(rl)
        st = got["stats"]
        log(f"{name} [{smi}]: trainer SIGKILLed after {SERVE_PAUSE_ACKS} "
            f"acknowledged pushes of step {SERVE_STEPS_A + 3}; recovery "
            f"{got['recover_ms']:.1f} ms (snapshot lsn "
            f"{st['snapshot_lsn']}, {st['applied']} records replayed, "
            f"{st['bytes']} B of journal read); {len(last)} keys at their "
            f"last acknowledged version and CRC32C; {got['absorbed']} "
            f"replayed tokens absorbed; fresh tier cut {rdoc['cut_ms']:.1f} "
            f"ms, shipped {rdoc['ship_bytes']} B; full pull "
            f"{full_ms:.1f} ms, {fresh.bytes_received} B; recover onebit "
            f"launches {rl}; {time.perf_counter() - t_arm:.1f} s")
    finally:
        stop.set()
        if loop.is_alive():
            loop.join(timeout=10)
        rec.close(kill_hosts=True)
        for p in list(procs.values()) + [p for ps in hosts.values()
                                         for p in ps]:
            if p.poll() is None:
                p.kill()
                p.wait()
        if client is not None:
            client.close()
        bus.close()
    parent = dict(ok.launches)             # this process's client
    launches.update(parent)
    # each process's kernels: the trainer packs (EF, the cuts) and
    # unpacks (EF, the store's decode), a host unpacks at receipt, the
    # client unpacks, the recovering process packs at its cut
    each = {"trainer": (launches_trainer, ("onebit_pack", "onebit_unpack")),
            "parent": (parent, ("onebit_unpack",)),
            "recover": (launches_recover, ("onebit_pack",))}
    for hid, ps in sorted(hosts.items()):
        for i, p in enumerate(ps):
            lines = p.tail.tagged("HOST-LAUNCHES")
            if lines:
                hl = json.loads(lines[0].split(" ", 1)[1])
                launches.update(hl)
                each[f"host {hid}.{i}"] = (hl, ("onebit_unpack",))
    for who, (got, need) in each.items():
        log(f"serving: {who} onebit launches {got}")
        check(SERVE_DEVICE != "cuda" or all(got.get(k, 0) > 0
                                            for k in need),
              f"serving: {who} launched {got}, expected {need}")
    check(SERVE_DEVICE != "cuda" or len(each) == 5,
          f"serving: launches reported by {sorted(each)}")
    log(f"serving phase: {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(out, ignore_errors=True)
    return dict(launches)


def _serve_report(name, cuts, smi, pull_ms, client, up, t0, worst,
                  extra=None):
    steps = [c["step_ms"] for c in cuts if c.get("step_ms")]
    appends = sum(c.get("wal_appends", 0) for c in cuts)
    append_ms = sum(c.get("wal_append_ms", 0.0) for c in cuts)
    fsync_ms = sum(c.get("wal_fsync_ms", 0.0) for c in cuts)
    ships = [ms for c in cuts for ms in c["ship_ms"].values()]
    p = sorted(pull_ms)
    log(f"{name} [{smi}]: trainer step {_median_line(steps)}; journal "
        f"{append_ms / max(appends, 1):.3f} ms a push (append, of which "
        f"fsync {fsync_ms / max(appends, 1):.3f}), {appends} pushes; cut "
        f"{statistics.median(c['cut_ms'] for c in cuts):.1f} ms (encode "
        f"{statistics.median(c['encode_ms'] for c in cuts):.1f} ms, "
        f"{cuts[-1]['encodes']} keys), durable cut save "
        f"{statistics.median(c['save_ms'] for c in cuts):.1f} ms "
        f"{cuts[-1]['save_bytes']} B; ship "
        f"{statistics.median(ships) if ships else 0.0:.1f} ms a host, "
        f"{statistics.median(c['ship_bytes'] for c in cuts) / 2:.0f} B a "
        f"host a cut; pull p50 {p[len(p) // 2]:.1f} ms p99 "
        f"{p[min(len(p) - 1, int(0.99 * len(p)))]:.1f} ms over {len(p)}, "
        f"{client.bytes_received} B received against "
        f"{up['raw_bytes'] * client.refreshes} B raw; worst onebit scale "
        f"rel err {worst:.3g}; trainer onebit launches "
        f"{cuts[-1]['launches']}")
    for k, v in (extra or {}).items():
        log(f"{name}: {k} {v}")
    log(f"{name}: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: the fused data-parallel step and the benchmark's models
# ---------------------------------------------------------------------------

FUSED_DEVICE = "cuda"
FUSED_BERT = ("bert_large", 32, 128)     # config, examples a rank, sequence
FUSED_WARMUP = 3                         # steps before each BERT arm's timing
FUSED_STEPS = 10                         # timed steps of each BERT arm
FUSED_LLAMA = ("llama3_8b", OBS_LLAMA_LAYERS, 2, 4096)  # layers, batch, seq
FUSED_VISION = (32, 224)                 # images a step, their size
VISION_STEPS = 2                         # timed steps of each vision model


def fused_step_phase(torch, ok, fa, smi):
    """Phase 14: (a) BERT MLM through ``make_dp_train_step``, flat and
    with the onebit hop; (b) Llama with ``remat`` off and on; (c) ResNet-50
    and VGG-16 through ``make_vision_trainer``.  Returns the onebit and
    the flash launches of its runs."""
    from byteps_tpu_torch.comm.mesh import bootstrap, resolve_device
    from byteps_tpu_torch.common.config import Config

    t_phase = time.perf_counter()
    comm = bootstrap(Config(), resolve_device(FUSED_DEVICE))
    try:
        onebit = fused_bert_arms(torch, ok, comm, smi)
        torch.cuda.empty_cache()
        flash = remat_arms(torch, fa, comm.device, smi)
        torch.cuda.empty_cache()
        vision_arms(torch, comm, smi)
    finally:
        comm.close()
    torch.cuda.empty_cache()
    log(f"fused step phase: {time.perf_counter() - t_phase:.1f} s")
    return onebit, flash


def fused_bert_arms(torch, ok, comm, smi):
    """BERT MLM at FUSED_BERT through ``make_dp_train_step`` (the tool's
    ``build``: AdamW 1e-4, the gathered head, batches through
    ``ShardedBatchLoader``), in three arms on the same weights and batch:
    ``plain`` (the tool's yardstick: no push_pull), ``flat``
    (``push_pull_tree``) and ``onebit`` (``compress_dcn=
    make_onebit_pair()``).  After FUSED_WARMUP steps the onebit counters
    are zeroed, FUSED_STEPS steps are timed and the counters read: the
    plain and flat arms launch none, the onebit arm one pack and one merge
    a step for each gradient of at least the 2 MiB gate, and no unpack.
    One more step under torch.profiler gives each arm's device-busy share
    and kernel count.  Then one
    checked step per arm: at one rank the flat arm's averaged gradients
    equal the local ones bit for bit; the onebit arm's output for its
    largest gradient equals the plain merge of the kernel's words and
    scale bit for bit, its words equal the plain pack's and its scale
    the plain pack's to rtol 1e-6 (phase 3's bounds).  Returns the onebit
    arm's launches over its timed steps."""
    import math

    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.ops import collective_ops as co
    from byteps_tpu_torch.parallel import data_parallel as dp
    from byteps_tpu_torch.tools import bert_mlm

    name, per_rank, seq = FUSED_BERT
    cfg = getattr(bert, name)()
    gate = co.dcn_compress_min_bytes()
    on_card = comm.device.type == "cuda"
    counted, step_ms = {}, {}
    for arm in ("plain", "flat", "onebit"):
        model, opt, step, batch = bert_mlm.build(
            comm, cfg, per_rank, seq, "onebit" if arm == "onebit" else None,
            plain=arm == "plain")
        params = list(model.parameters())
        n_hop = sum(p.numel() * p.element_size() >= gate for p in params)
        bert_mlm.timed_steps(torch, comm, step, batch, FUSED_WARMUP)
        ok.reset_launches()
        dt, loss = bert_mlm.timed_steps(torch, comm, step, batch,
                                        FUSED_STEPS)
        got = dict(ok.launches)
        check(math.isfinite(loss), f"fused bert {arm}: loss {loss}")
        want = ({"onebit_pack": n_hop * FUSED_STEPS, "onebit_unpack": 0,
                 "onebit_unpack_sum": n_hop * FUSED_STEPS}
                if arm == "onebit" else {k: 0 for k in KERNELS})
        check(not on_card or got == want,
              f"fused bert {arm}: onebit launches {got}, expected {want}")
        ms = step_ms[arm] = dt / FUSED_STEPS * 1e3
        b = dp.shard_batch(comm, batch)
        prof = (bert_mlm.profile_step(torch, lambda: step(b)) if on_card
                else {"wall_ms": 0.0, "busy_ms": 0.0, "kernels": 0,
                      "top_ms": []})
        log(f"fused bert {arm} [{smi}]: {name} {per_rank} x {seq} a rank, "
            f"{sum(p.numel() for p in params)} parameters; {ms:.2f} ms a "
            f"step ({ms - step_ms['plain']:.2f} over plain), "
            f"{FUSED_STEPS * per_rank / dt:.1f} examples/s over "
            f"{FUSED_STEPS} steps after {FUSED_WARMUP}; loss {loss:.4f}; "
            f"{n_hop} gradients of {len(params)} at or past the "
            f"{gate} B gate; onebit launches a step "
            f"{ {k: v / FUSED_STEPS for k, v in got.items()} }; profiled "
            f"step {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['busy_ms']:.2f} ms "
            f"({prof['busy_ms'] / max(prof['wall_ms'], 1e-9):.1%}), "
            f"{prof['kernels']} kernels, the most device ms "
            f"{[(k, round(v, 2)) for k, v in prof['top_ms']]}")
        if arm == "flat":
            _check_flat_step(torch, dp, step, b)
        elif arm == "onebit":
            _check_onebit_step(torch, ok, dp, step, b,
                               max(params, key=lambda p: p.numel()))
        counted[arm] = got
        del model, opt, step, params
        torch.cuda.empty_cache()
    return counted["onebit"]


def _check_flat_step(torch, dp, step, batch):
    """One step with ``push_pull_tree`` watched: every averaged gradient
    equals the gradient it was given, bit for bit (one rank)."""
    real, seen = dp.push_pull_tree, {}

    def watch(comm, grads, op="average", inplace=False):
        seen["before"] = {n: g.clone() for n, g in grads.items()}
        seen["after"] = grads
        return real(comm, grads, op, inplace=inplace)

    dp.push_pull_tree = watch
    try:
        step(batch)
    finally:
        dp.push_pull_tree = real
    bad = [n for n, g in seen["before"].items()
           if not same_bits(g, seen["after"][n])]
    check(not bad, f"fused bert flat: {len(bad)} averaged gradients differ "
          f"from the local ones at one rank, e.g. {bad[:3]}")
    log(f"fused bert flat: {len(seen['before'])} averaged gradients equal "
        f"the local ones bit for bit")


def _check_onebit_step(torch, ok, dp, step, batch, target):
    """One step with the hop of ``target``'s gradient watched: its
    output against the plain versions on the same input."""
    real, cap = dp.hierarchical_push_pull, {}

    def watch(comm, x, op, compress, decompress, *a, **kw):
        if x is not target.grad:
            return real(comm, x, op, compress, decompress, *a, **kw)

        def spy(shard):
            payload = compress(shard)
            cap["payload"] = {k: v.clone() for k, v in payload.items()}
            return payload

        cap["in"] = x.detach().reshape(-1).clone()
        out = real(comm, x, op, spy, decompress, *a, **kw)
        cap["out"] = out.reshape(-1).clone()
        return out

    dp.hierarchical_push_pull = watch
    try:
        step(batch)
    finally:
        dp.hierarchical_push_pull = real
    check("payload" in cap, "fused bert onebit: the largest gradient did "
          "not take the compressed hop")
    x, numel = cap["in"], cap["in"].numel()
    words, scale = cap["payload"]["words"], cap["payload"]["scale"]
    w0, s0 = ok.onebit_pack_plain(x)
    check(torch.equal(words, w0), "fused bert onebit: the hop's words "
          "differ from the plain pack's")
    rel = float((scale - s0[1]).abs() / s0[1].abs())
    check(rel <= 1e-6, f"fused bert onebit: scale rel err {rel:.3g}")
    want = ok.onebit_unpack_sum_plain(words[None], scale.reshape(1), numel)
    check(same_bits(cap["out"], want), "fused bert onebit: the hop's "
          "output differs from the plain merge of its words and scale")
    log(f"fused bert onebit: the hop of the largest gradient ({numel} "
        f"elements) equals the plain versions: words and output bit for "
        f"bit, scale rel err {rel:.3g}")


def remat_arms(torch, fa, dev, smi):
    """Llama at FUSED_LLAMA (flash attention), one forward and backward
    each of ``plain``, ``plain_again`` and ``remat`` on the same weights
    and batch.  The loss must keep its bits; each gradient of ``remat``
    must differ from ``plain``'s by no more than ``plain_again``'s does
    (bit for bit wherever a plain step repeats its own bits); the flash
    kernels run ``num_layers`` times a step each, the forward twice as
    often under ``remat``.  Prints each run's ms, loss and peak memory
    (and the step's own, above the memory held before it).  Returns the
    flash launches of the three runs."""
    import dataclasses

    from byteps_tpu_torch.models import gpt, llama
    from byteps_tpu_torch.ops.flash_attention import flash_attention
    from byteps_tpu_torch.parallel.long_context import synthetic_lm_batch

    name, layers, batch, seq = FUSED_LLAMA
    base = dataclasses.replace(getattr(llama, name)(), num_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(3)
    model = llama.Llama(base, attn_fn=flash_attention, device=dev,
                        generator=gen)
    data = synthetic_lm_batch(gen, base, batch, seq)
    on_card = dev.type == "cuda"
    total = {k: 0 for k in FLASH_KERNELS}
    runs = {}
    for arm, remat in (("plain", False), ("plain_again", False),
                       ("remat", True)):
        model.cfg = dataclasses.replace(base, remat=remat)
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        loss = gpt.lm_loss(model(data["input_ids"]), data["labels"])
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        got = dict(fa.launches)
        for k in total:
            total[k] += got[k]
        want = {"flash_fwd": layers * (2 if remat else 1),
                "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
        check(not on_card or got == want,
              f"remat {arm}: flash launches {got}, expected {want}")
        runs[arm] = {"loss": loss.detach(), "ms": ms, "peak": peak,
                     "step_peak": peak - held,
                     "grads": {n: p.grad for n, p in
                               model.named_parameters()}}
        log(f"remat {arm} [{smi}]: {name} with {layers} layers, {batch} x "
            f"{seq}; forward + backward {ms:.1f} ms; loss "
            f"{loss.item():.6f}; peak memory {peak / 2**30:.2f} GiB, "
            f"{(peak - held) / 2**30:.2f} GiB above the "
            f"{held / 2**30:.2f} GiB held before the step; flash launches "
            f"{got}")
        loss = None
    plain, again, rem = runs["plain"], runs["plain_again"], runs["remat"]
    check(same_bits(plain["loss"], rem["loss"]),
          f"remat: loss {rem['loss'].item()} against "
          f"{plain['loss'].item()} without remat")
    worse, equal, floor, d_max = [], 0, {}, 0.0
    for n, g in plain["grads"].items():
        d_rep = float((again["grads"][n] - g).abs().max())
        d = float((rem["grads"][n] - g).abs().max())
        d_max = max(d_max, d)
        if same_bits(rem["grads"][n], g):
            equal += 1
        else:
            floor[n] = (d, d_rep)
        if d > d_rep:
            worse.append((n, d, d_rep))
    check(not worse, f"remat: gradients further from the plain step than "
          f"a second plain step is: {worse[:5]}")
    log(f"remat: loss bit for bit; max |d| over every gradient {d_max}; "
        f"{equal} of {len(plain['grads'])} gradients bit for bit; the others (max |d| with remat, max |d| "
        f"of a second plain step) {floor}; peak memory "
        f"{plain['peak'] / 2**30:.2f} GiB plain, {rem['peak'] / 2**30:.2f} "
        f"GiB remat (the step's own {plain['step_peak'] / 2**30:.2f} and "
        f"{rem['step_peak'] / 2**30:.2f} GiB) [{smi}]")
    runs.clear()
    return total


def vision_arms(torch, comm, smi):
    """ResNet-50 (cross-replica BatchNorm over the world) and VGG-16 at
    full width, FUSED_VISION images a step, through the function behind
    ``examples.benchmark_resnet`` (``make_vision_trainer``, SGD momentum
    0.9; lr 0.1 for ResNet-50 as the example, 0.01 for VGG-16, which has
    no BatchNorm): 1 warm-up and VISION_STEPS timed steps each, the loss
    finite at every step.  Prints the example's JSON line for each."""
    from byteps_tpu_torch.examples import benchmark_resnet

    n, size = FUSED_VISION
    for name, lr in (("resnet50", 0.1), ("vgg16", 0.01)):
        line, losses, ms = benchmark_resnet.run(
            comm, name, n, size, VISION_STEPS, lr=lr, warmup=1)
        check(all(math.isfinite(v) for v in losses),
              f"vision {name}: losses {losses}")
        log(f"vision {name} [{smi}]: {n} x {size}x{size}; "
            f"{sum(ms) / len(ms):.2f} ms a step "
            f"({', '.join(f'{v:.2f}' for v in ms)}) over {VISION_STEPS} "
            f"steps after 1; losses {[round(v, 4) for v in losses]}")
        log(f"benchmark_resnet [{smi}]: {json.dumps(line)}")
        torch.cuda.empty_cache()


# --------------------------- 15. sequence and expert parallelism

SEQPAR_DEVICE = "cuda"
SEQPAR_MODEL = "small"                   # tools/long_context.py --model
SEQPAR_SP = (2, 8192, 2)                 # sequences, tokens each, timed steps
SEQPAR_EP = (16, 1024, 3)
SEQPAR_RANKS = 2                         # processes on the one card, gloo
# bf16 through 8 layers: the layouts' gradients (summed over the ranks)
# against the one-rank flash step's, as a share of each tensor's max-abs
SEQPAR_GRAD_TOL = 2**-4
SEQPAR_LOSS_RTOL = 2**-8
# the MoE layout's forward against the full-stack model on the same rows
# (share of the logits' max-abs; the aux losses' relative difference)
SEQPAR_MOE_TOL = 2**-6
SEQPAR_TIMEOUT_S = 420


def _seqpar_children(name, argv):
    """Every rank of one layout (``tools/long_context.py`` ``argv``), on
    the card over gloo; each must exit 0 within SEQPAR_TIMEOUT_S and
    print its result line.  Returns the results by rank."""
    from byteps_tpu_torch.tools import long_context as lc
    root = os.path.dirname(os.path.abspath(__file__))
    env = {"PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""),
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    procs = lc.spawn(list(argv) + ["--device", SEQPAR_DEVICE, "--backend",
                                   "gloo", "--model", SEQPAR_MODEL],
                     SEQPAR_RANKS, env=env, cwd=root)
    outs = [""] * len(procs)
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(timeout=SEQPAR_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("LC_RESULT ")]
        check(p.returncode == 0 and len(lines) == 1,
              f"{name}: rank {i} exited {p.returncode} without its result "
              f"(or ran past {SEQPAR_TIMEOUT_S} s):\n{out[-3000:]}")
        res.append(json.loads(lines[0][len("LC_RESULT "):]))
    res.sort(key=lambda r: r["rank"])
    return res


def _ms_line(ms):
    return (f"{statistics.median(ms):.1f} ms a step "
            f"({min(ms):.1f}-{max(ms):.1f})")


def seqpar_phase(torch, smi):
    """Phase 15: GPT-small trained over ``(dp 1, sp 2)`` with each
    sequence-parallel attention, held against the one-rank flash step,
    and the switch-MoE GPT over ``(dp 1, ep 2)``, held against the
    full-stack model; SEQPAR_RANKS processes on the one card.  Returns
    the flash launches of their timed steps."""
    from byteps_tpu_torch.tools.long_context import KINDS

    t_phase = time.perf_counter()
    on_card = SEQPAR_DEVICE == "cuda"     # the plain versions count nothing
    total = {k: 0 for k in FLASH_KERNELS}
    batch, seq, steps = SEQPAR_SP
    sp = _seqpar_children("sp", ["sp", "--batch", str(batch), "--seq",
                                 str(seq), "--steps", str(steps), "--check",
                                 "--control-qoff0"])
    layers = 8
    log(f"sequence parallelism [{smi}]: GPT-small, {batch} x {seq} tokens "
        f"(a rank {seq // SEQPAR_RANKS} of each), {SEQPAR_RANKS} ranks on "
        f"the card over {sp[0]['backend']}; the ring's shift went by "
        f"{sp[0]['shift_path']}; ranks up {sp[0]['seconds']:.1f} s")
    for kind in KINDS + ("ring_flash_qoff0",):
        arms = [r["arms"][kind] for r in sp]
        shares = arms[0]["grad_share_by_rank"]
        where = arms[0]["grad_share_where"]
        ref_loss = arms[0]["ref_loss"]
        first = arms[0]["first_loss"]
        if kind == "ring_flash_qoff0":
            check(min(shares) > SEQPAR_GRAD_TOL,
                  f"sp control {kind}: gradient shares {shares} within "
                  f"{SEQPAR_GRAD_TOL}: the check cannot see a wrong mask")
            log(f"sp control {kind}: gradient share {shares} (at "
                f"{where}) > {SEQPAR_GRAD_TOL}; first loss {first:.6f} "
                f"against {ref_loss:.6f}")
            continue
        check(max(shares) <= SEQPAR_GRAD_TOL,
              f"sp {kind}: gradients by rank differ from the one-rank "
              f"flash step by {shares} of their max-abs (at {where}), "
              f"bound {SEQPAR_GRAD_TOL}")
        check(abs(first - ref_loss) <= SEQPAR_LOSS_RTOL * abs(ref_loss),
              f"sp {kind}: first loss {first} against the one-rank step's "
              f"{ref_loss}")
        for r, a in enumerate(arms):
            check(all(math.isfinite(v) for v in a["loss"]),
                  f"sp {kind} rank {r}: losses {a['loss']}")
            got = a["flash_launches"]
            n = {"ring_flash": r + 1, "ulysses_flash": 1}.get(kind, 0)
            want = {k: n * layers * steps for k in FLASH_KERNELS}
            check(not on_card or got == want,
                  f"sp {kind} rank {r}: flash launches {got}, expected "
                  f"{want}")
            for k in total:
                total[k] += got[k]
        per_step = [{k: v // steps for k, v in a["flash_launches"].items()}
                    for a in arms]
        log(f"sp {kind} [{smi}]: {_ms_line(arms[0]['ms'])} on rank 0, "
            f"{arms[0]['tokens_per_s']:.0f} tokens/s; gradient share by "
            f"rank {[f'{v:.2e}' for v in shares]} (at {where[0]}) <= "
            f"{SEQPAR_GRAD_TOL}; first loss {first:.6f} against "
            f"{ref_loss:.6f}; losses {[round(v, 4) for v in arms[0]['loss']]}"
            f"; flash launches a step by rank {per_step}; peak memory by "
            f"rank {[a['peak_gib'] for a in arms]} GiB")
    batch, seq, steps = SEQPAR_EP
    ep = _seqpar_children("ep", ["ep", "--batch", str(batch), "--seq",
                                 str(seq), "--steps", str(steps), "--check"])
    for r, a in enumerate(ep):
        check(a["logit_share"] <= SEQPAR_MOE_TOL
              and a["aux_rel"] <= SEQPAR_MOE_TOL,
              f"ep rank {r}: the layout's forward differs from the full "
              f"stacks' by {a['logit_share']} of the logits' max-abs, aux "
              f"{a['aux']} against {a['ref_aux']}")
        losses = [a["first_loss"]] + a["loss"]
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"ep rank {r}: losses {losses} not finite and falling")
        got = a["flash_launches"]
        want = {k: layers * steps for k in FLASH_KERNELS}
        check(not on_card or got == want,
              f"ep rank {r}: flash launches {got}, expected {want}")
        for k in total:
            total[k] += got[k]
        log(f"ep rank {r} [{smi}]: GPT-small, 8 experts ({a['experts_here']}"
            f" here) every 2nd block, {a['tokens_here']} tokens here; "
            f"{_ms_line(a['ms'])}, {a['tokens_per_s']:.0f} tokens/s; logits "
            f"{a['logit_share']:.2e} of their max-abs from the full stacks', "
            f"aux {[round(v, 5) for v in a['aux']]} against "
            f"{[round(v, 5) for v in a['ref_aux']]}; losses "
            f"{[round(v, 4) for v in losses]}; peak memory {a['peak_gib']} "
            f"GiB")
    log(f"sequence and expert parallelism phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# --------------------------- 16. tensor, pipeline and composite parallelism

MODELPAR_DEVICE = "cuda"
MODELPAR_MODEL = "full"                  # tools/model_parallel.py --model
MODELPAR_RANKS = 4                       # processes on the one card, gloo
# layers (2 of 32: half of phase 8's cut, for the script's time limit),
# sequences, tokens
MODELPAR_LLAMA = (2, 2, 4096)
MODELPAR_GPT = (8, 1024, 4)              # sequences, tokens, microbatches
MODELPAR_STEPS = 2                       # timed steps an arm, after the first
# bf16: each rank's gradient slices after the first step against the
# one-rank step's, as a share of each tensor's max-abs (PR 17's bound)
MODELPAR_GRAD_TOL = 2**-4
MODELPAR_LOSS_RTOL = 2**-8
MODELPAR_TIMEOUT_S = 600
MODELPAR_CONTROLS = {"fsdp_tp": "the attention's row-parallel sum skipped",
                     "tp": "row-parallel biases added on every tp rank",
                     "pp": "embedding and head gradients summed over dp "
                           "only"}


def _modelpar_children(argv):
    """Every rank of ``tools/model_parallel.py`` ``argv`` on the card over
    gloo; each must exit 0 within MODELPAR_TIMEOUT_S and print its
    result line.  Returns the results by rank."""
    from byteps_tpu_torch.tools import model_parallel as mp
    root = os.path.dirname(os.path.abspath(__file__))
    env = {"PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""),
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    procs = mp.spawn(list(argv) + ["--device", MODELPAR_DEVICE, "--backend",
                                   "gloo", "--model", MODELPAR_MODEL],
                     MODELPAR_RANKS, env=env, cwd=root)
    outs = [""] * len(procs)
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(timeout=MODELPAR_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MP_RESULT ")]
        check(p.returncode == 0 and len(lines) == 1,
              f"model parallelism: rank {i} exited {p.returncode} without "
              f"its result (or ran past {MODELPAR_TIMEOUT_S} s):\n"
              f"{out[-3000:]}")
        res.append(json.loads(lines[0][len("MP_RESULT "):]))
    res.sort(key=lambda r: r["rank"])
    return res


def modelpar_phase(torch, smi):
    """Phase 16: Llama-3-8B width (MODELPAR_LLAMA's layers) over
    ``(fsdp 2, tp 2)`` through the flash kernels, and GPT-small over
    ``(dp 2, tp 2)``, GPipe ``(dp 2, pp 2)`` and ``(dp 1, pp 2, tp 2)``:
    MODELPAR_RANKS processes on the one card, the arms in one world, each
    first step's gradients held against a one-rank step and each
    control's broken.  Returns the flash launches of the timed steps."""
    from byteps_tpu_torch.tools.model_parallel import ARMS, FAULTS
    t_phase = time.perf_counter()
    on_card = MODELPAR_DEVICE == "cuda"   # the plain versions count nothing
    layers, batch, seq = MODELPAR_LLAMA
    gbatch, gseq, m = MODELPAR_GPT
    res = _modelpar_children(list(ARMS) + [
        "--layers", str(layers), "--batch", str(batch), "--seq", str(seq),
        "--gpt-batch", str(gbatch), "--gpt-seq", str(gseq),
        "--microbatches", str(m), "--steps", str(MODELPAR_STEPS), "--check",
        "--control"])
    total = {k: 0 for k in FLASH_KERNELS}
    log(f"model parallelism [{smi}]: {MODELPAR_RANKS} ranks on the card "
        f"over {res[0]['backend']}; the stage shifts went by "
        f"{res[0]['arms']['pp']['shift_path']}; rank 0 ran "
        f"{res[0]['seconds']:.1f} s")
    for arm in ARMS:
        arms = [r["arms"][arm] for r in res]
        a0 = arms[0]
        shares, where = a0["grad_share_by_rank"], a0["grad_share_where"]
        check(max(shares) <= MODELPAR_GRAD_TOL,
              f"{arm}: gradient slices by rank differ from the one-rank "
              f"step's by {shares} of their max-abs (at {where}), bound "
              f"{MODELPAR_GRAD_TOL}")
        check(abs(a0["first_loss"] - a0["ref_loss"])
              <= MODELPAR_LOSS_RTOL * abs(a0["ref_loss"]),
              f"{arm}: first loss {a0['first_loss']} against the one-rank "
              f"step's {a0['ref_loss']}")
        if arm in FAULTS:
            ctl = a0["control"]["grad_share_by_rank"]
            check(min(ctl) > MODELPAR_GRAD_TOL,
                  f"{arm} control ({MODELPAR_CONTROLS[arm]}): gradient "
                  f"shares {ctl} within {MODELPAR_GRAD_TOL}: the check "
                  f"cannot see it")
            log(f"{arm} control ({MODELPAR_CONTROLS[arm]}): gradient share "
                f"by rank {[f'{v:.3g}' for v in ctl]} (at "
                f"{a0['control']['grad_share_where']}) > {MODELPAR_GRAD_TOL}")
        steps = len(a0["ms"])
        n = layers if arm == "fsdp_tp" else 0   # GPT: exact attention
        for r, a in enumerate(arms):
            check(all(math.isfinite(v) for v in [a["first_loss"]]
                      + a["loss"]),
                  f"{arm} rank {r}: losses {a['first_loss']}, {a['loss']}")
            got = a["flash_launches"]
            want = {k: n * steps for k in FLASH_KERNELS}
            check(not on_card or got == want,
                  f"{arm} rank {r}: flash launches {got}, expected {want}")
            for k in total:
                total[k] += got[k]
            if arm in ("pp", "3d"):
                check(a["stage_forwards"] == m,
                      f"{arm} rank {r}: {a['stage_forwards']} stage "
                      f"forwards a step, expected {m}")
        if arm == "fsdp_tp":
            # every leaf but the RMSNorm scales is sliced on both axes at
            # this width: a rank holds a quarter of it, state included
            check(all(a["sliced_share"] == 0.25 for a in arms),
                  f"fsdp_tp: parameter and optimizer bytes of the sliced "
                  f"leaves a rank {[a['sliced_share'] for a in arms]} of "
                  f"the whole leaves', expected 1/4")
            want = [a["whole_held_bytes"] + (a["whole_state_bytes"]
                                             - a["whole_held_bytes"]) // 4
                    for a in arms]
            check([a["state_bytes"] for a in arms] == want,
                  f"fsdp_tp: parameter and optimizer bytes by rank "
                  f"{[a['state_bytes'] for a in arms]}, expected {want}: "
                  f"the whole leaves held whole, a quarter of the rest")
        extra = ""
        if "stage_forwards" in a0:
            extra = (f"; {a0['stage_forwards']} stage forwards a step a "
                     f"rank (M = {m}, bubbles skipped)")
        log(f"{arm} [{smi}] mesh {a0['mesh']}: {_ms_line(a0['ms'])} on rank "
            f"0, {a0['tokens_per_s']:.0f} tokens/s; gradient share by rank "
            f"{[f'{v:.2e}' for v in shares]} (at {where[0]}) <= "
            f"{MODELPAR_GRAD_TOL}; first loss {a0['first_loss']:.6f} "
            f"against {a0['ref_loss']:.6f}; losses "
            f"{[round(v, 4) for v in a0['loss']]}; peak memory by rank "
            f"{[a['peak_gib'] for a in arms]} GiB; parameters and AdamW "
            f"state {a0['state_bytes'] / 2**30:.3f} GiB a rank against the "
            f"whole model's {a0['whole_state_bytes'] / 2**30:.3f} (sliced "
            f"leaves: {a0['sliced_share']}); flash launches a step "
            f"{ {k: v // max(steps, 1) for k, v in a0['flash_launches'].items()} }"
            f"{extra}; arm {a0['seconds']:.1f} s")
    log(f"tensor, pipeline and composite parallelism phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# phase 17: the launcher, the examples and the bench tools
LAUNCH_DEVICE = "cuda"
LAUNCH_TIMEOUT_S = 120           # each child command of phase 17
LAUNCH_BENCH = ("--compressor", "onebit", "--num-tensors", "20",
                "--tensor-mb", "4", "--num-iters", "10")
LAUNCH_MNIST_STEPS = 20
# a worker that exits with the restartable code once, then trains
LAUNCH_RESTART_WRAPPER = (
    "import os, sys\n"
    "mark = sys.argv[1]\n"
    "if not os.path.exists(mark):\n"
    "    open(mark, 'w').close()\n"
    "    sys.exit(17)\n"
    "os.execv(sys.executable, [sys.executable, '-m',\n"
    "         'byteps_tpu_torch.examples.train_mnist_byteps'] + sys.argv[2:])\n")
LOSS_LINE = re.compile(r"step +(\d+) +loss (\S+)")


def _launch_start(argv, env=None):
    """Start one command of phase 17 from the repo's root, with the
    DMLC_* and BYTEPS_LOCAL_* variables unset (the launcher sets its
    workers')."""
    root = os.path.dirname(os.path.abspath(__file__))
    full_env = {k: v for k, v in os.environ.items()
                if not k.startswith(("DMLC_", "BYTEPS_LOCAL_"))}
    full_env["PYTHONPATH"] = root + os.pathsep + full_env.get("PYTHONPATH",
                                                              "")
    full_env.update(env or {})
    return subprocess.Popen([sys.executable] + list(argv), cwd=root,
                            env=full_env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _launch_wait(name, p):
    """The command must exit 0 within LAUNCH_TIMEOUT_S of this call;
    returns (stdout, stderr)."""
    try:
        out, err = p.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        check(False, f"{name}: ran past {LAUNCH_TIMEOUT_S} s:\n"
                     f"{out[-2000:]}\n{err[-2000:]}")
    check(p.returncode == 0, f"{name}: exited {p.returncode}:\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    return out, err


def _launch_child(name, argv, env=None):
    return _launch_wait(name, _launch_start(argv, env))


def _json_lines(name, out, want=None, prefix=""):
    rows = [json.loads(ln[len(prefix):]) for ln in out.splitlines()
            if ln.startswith(prefix + "{")]
    check(rows and (want is None or len(rows) == want),
          f"{name}: {len(rows)} result line(s), expected "
          f"{want or 'some'}:\n{out[-3000:]}")
    return rows


def launcher_phase(torch, smi):
    """Phase 17: bpslaunch with one worker per visible card around the
    onebit benchmark, a restart on the card, and the bench tools at one
    rank.  Returns the onebit launches its processes counted."""
    t_phase = time.perf_counter()
    launch = ["-m", "byteps_tpu_torch.launcher.launch"]
    launches = {k: 0 for k in KERNELS}

    # (a) the onebit benchmark under the launcher, BYTEPS_LOCAL_SIZE unset
    t = time.perf_counter()
    out, _ = _launch_child("launcher onebit", launch + [
        sys.executable, "-m", "byteps_tpu_torch.examples.benchmark_byteps",
        *LAUNCH_BENCH])
    (r,) = _json_lines("launcher onebit", out, want=1)
    check((r["rank"], r["size"], r["local_rank"], r["backend"])
          == (0, 1, 0, "nccl") and r["device"].startswith("cuda"),
          f"launcher onebit: one worker at local rank 0 over NCCL at a "
          f"world of one expected, got {r}")
    check("MB/s pushed+pulled" in out, f"launcher onebit: no MB/s:\n{out}")
    c = r["chunks"] * r["iters"]
    # a chunk and iteration: the worker's pack and the server's re-pack,
    # one merge, the server's unpack
    want = {"onebit_pack": 2 * c, "onebit_unpack": c,
            "onebit_unpack_sum": c}
    check(r["launches"] == want,
          f"launcher onebit: launches {r['launches']}, expected {want} "
          f"({r['chunks']} chunks x {r['iters']} iterations)")
    for k in KERNELS:
        launches[k] += r["launches"][k]
    log(f"launcher onebit [{smi}]: 1 worker (local rank 0, "
        f"{r['backend']}, {r['device']}), {r['mb_per_s']:.1f} MB/s over "
        f"{r['chunks']} chunks x {r['iters']} iterations; launches "
        f"{r['launches']}; {time.perf_counter() - t:.1f} s")

    # (c) the bench tools at one rank on the card (figures only)
    t = time.perf_counter()
    out, _ = _launch_child("mechanism_bench", [
        "-m", "byteps_tpu_torch.tools.mechanism_bench", "--device",
        LAUNCH_DEVICE])
    (m,) = _json_lines("mechanism_bench", out, want=1)
    pr, pa = m["priority"], m["partitioning"]
    log(f"mechanism_bench [{smi}]: layer-0 ready {pr['layer0_ready_ms_priority']}"
        f" ms with priority {pr['layer0_ready_priority_iqr_ms']}, "
        f"{pr['layer0_ready_ms_fifo']} ms in arrival order "
        f"{pr['layer0_ready_fifo_iqr_ms']}; urgent ready "
        f"{pa['urgent_ready_ms_partitioned']} ms partitioned "
        f"{pa['urgent_ready_partitioned_iqr_ms']}, "
        f"{pa['urgent_ready_ms_whole']} ms whole "
        f"{pa['urgent_ready_whole_iqr_ms']}; {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    out, _ = _launch_child("overlap_bench", [
        "-m", "byteps_tpu_torch.tools.overlap_bench", "--device",
        LAUNCH_DEVICE, "--compression", "none,onebit", "--rounds", "2"])
    for o in _json_lines("overlap_bench", out, want=2):
        md = o["modes"]
        if o["compression"] == "onebit":
            got = o["onebit_launches"]
            check(all(got[k] > 0 for k in KERNELS),
                  f"overlap_bench onebit lane: launches {got}")
            for k in KERNELS:
                launches[k] += got[k]
        log(f"overlap_bench {o['compression']} [{smi}]: step ms nocomm "
            f"{md['nocomm']['step_ms']} {md['nocomm']['iqr_ms']}, sync "
            f"{md['sync']['step_ms']} {md['sync']['iqr_ms']}, xb "
            f"{md['xb']['step_ms']} {md['xb']['iqr_ms']}; overlap fraction "
            f"{o['overlap_fraction']} (rounds "
            f"{o['overlap_fraction_rounds']}); onebit launches "
            f"{o['onebit_launches']}")
    log(f"overlap_bench: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    out, _ = _launch_child("serve_bench", [
        "-m", "byteps_tpu_torch.tools.serve_bench", "--device",
        LAUNCH_DEVICE, "--seconds", "2", "--clients", "4"])
    (sv,) = _json_lines("serve_bench", out, want=1)
    check(sv["failed_reads"] == 0 and sv["delta"]["ok"],
          f"serve_bench: {sv['failed_reads']} failed reads, delta {sv['delta']}")
    log(f"serve_bench [{smi}]: {sv['pulls_per_s']} pulls/s, p50 "
        f"{sv['p50_ms']} ms, p99 {sv['p99_ms']} ms, {sv['pushes_per_s']} "
        f"pushes/s, {sv['clients']} clients over {sv['keys']} keys of "
        f"{sv['numel']}; delta pull {sv['delta']['delta_pull_bytes']} of "
        f"{sv['delta']['model_bytes']} bytes; {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    out, _ = _launch_child("async_bench", [
        "-m", "byteps_tpu_torch.tools.async_bench", "--device",
        LAUNCH_DEVICE])
    (a,) = _json_lines("async_bench", out, want=1)
    check("error" not in a and a["loss_sync"] < a["loss_init"],
          f"async_bench: {a}")
    log(f"async_bench [{smi}]: loss {a['loss_init']} -> sync "
        f"{a['loss_sync']} ({a['wall_sync_s']} s), async {a['loss_async']}"
        f" ({a['wall_async_s']} s), {a['delta_pushes_per_key']} delta "
        f"pushes a key; {time.perf_counter() - t:.1f} s")

    # (b) a restart on the card: exit 17 once, then train; beside
    # fsdp_memory, whose figures are this process's memory alone
    t = time.perf_counter()
    mark = os.path.join(tempfile.mkdtemp(prefix="bps_restart_"), "once")
    restart = _launch_start(launch + [
        "--restart", "1", sys.executable, "-c", LAUNCH_RESTART_WRAPPER,
        mark, "--steps", str(LAUNCH_MNIST_STEPS), "--device",
        LAUNCH_DEVICE], env={"BYTEPS_RETRY_BASE_DELAY": "0.01",
                             "BYTEPS_RETRY_MAX_DELAY": "0.01"})
    try:
        out, _ = _launch_child("fsdp_memory", [
        "-m", "byteps_tpu_torch.tools.fsdp_memory", "--device",
        LAUNCH_DEVICE, "--spawn", "2", "--backend", "gloo"])
        r_out, r_err = _launch_wait("launcher restart", restart)
    finally:
        if restart.poll() is None:
            restart.kill()
            restart.wait()
        shutil.rmtree(os.path.dirname(mark), ignore_errors=True)
    check(r_err.count("(restartable); restart 1/1") == 1,
          f"launcher restart: expected exactly one restart:\n"
          f"{r_err[-3000:]}")
    losses = [float(v) for _, v in LOSS_LINE.findall(r_out)]
    check(len(losses) >= 2 and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0],
          f"launcher restart: losses {losses} not finite and falling")
    log(f"launcher restart [{smi}]: exit 17, one restart, then "
        f"{LAUNCH_MNIST_STEPS} MNIST steps on the card, loss {losses[0]:.4f}"
        f" -> {losses[-1]:.4f}")
    fs = _json_lines("fsdp_memory", out, want=2, prefix="FSDP_RESULT ")
    for f in sorted(fs, key=lambda f: f["rank"]):
        check(all(f[d]["temp_bytes"] is not None
                  for d in ("flat_fsdp", "gspmd_fsdp")),
              f"fsdp_memory: no peak on the card: {f}")
        log(f"fsdp_memory rank {f['rank']} [{smi}]: {f['n_params']} "
            f"parameters; flat FSDP {f['flat_fsdp']['arg_bytes'] / 2**20:.1f}"
            f" MiB kept, peak {f['flat_fsdp']['temp_bytes'] / 2**20:.1f} MiB"
            f" above it; per-block FSDP "
            f"{f['gspmd_fsdp']['arg_bytes'] / 2**20:.1f} MiB kept, peak "
            f"{f['gspmd_fsdp']['temp_bytes'] / 2**20:.1f} MiB above it; "
            f"ratio {f['temp_ratio_flat_over_gspmd']}")
    log(f"fsdp_memory and the restart beside it: "
        f"{time.perf_counter() - t:.1f} s")
    log(f"launcher, examples and bench tools phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------- phase 18: frontends, bench smoke

MX_DEVICE = "cuda"
MX_STEPS = 2                     # timed steps, after 1 warm-up
MX_LR = 0.1
MX_ONEBIT_BYTES = 64 << 10       # a gradient this large goes onebit


class NDArray:
    """An mx.nd.NDArray stand-in on a host array: ``asnumpy``, slice
    assignment (the MXNet adapter is duck-typed to this protocol)."""

    def __init__(self, arr):
        self._a = arr

    def asnumpy(self):
        return self._a

    def __setitem__(self, key, value):
        self._a[key] = value


class _HostSGD:
    """The inner MXNet optimizer: numpy SGD on the host arrays, its time
    kept apart from the engine's."""

    def __init__(self):
        self.seconds = 0.0

    def update(self, index, weight, grad, state):
        t0 = time.perf_counter()
        for w, g in zip(weight, grad):
            w[:] = w.asnumpy() - MX_LR * g.asnumpy()
        self.seconds += time.perf_counter() - t0


def frontends_phase(torch, ok, registry, resnet, smi):
    """Phase 18: (a) the MXNet frontend's DistributedOptimizer over
    ResNet-50's gradients on the card; (b) the engine and compressed
    lanes of the port's bench_smoke on the card.  Returns the onebit
    launches of both main paths."""
    t_phase = time.perf_counter()
    launches = mxnet_arm(torch, ok, registry, resnet, smi)
    torch.cuda.empty_cache()
    for k, v in bench_smoke_arm(torch, ok, smi).items():
        launches[k] += v
    log(f"frontends and bench smoke phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def mxnet_arm(torch, ok, registry, resnet, smi):
    """Phase 18 (a): ResNet-50's 161 gradients a step, copied to host
    arrays, through ``byteps_tpu_torch.mxnet.DistributedOptimizer`` over
    numpy SGD; the host weights back to the card."""
    import numpy as np

    import byteps_tpu_torch.mxnet as mx
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.mxnet.ops import compression_kwargs

    torch.backends.cudnn.allow_tf32 = False
    mx.init(device=MX_DEVICE)
    try:
        dev = api.device()
        gen = torch.Generator().manual_seed(18)
        model = resnet.resnet50(num_classes=CLASSES, generator=gen).to(dev)
        batch = resnet.synthetic_images(gen, BATCH, IMAGE, CLASSES, dev)
        params = list(model.parameters())
        onebit = [p.numel() * 4 >= MX_ONEBIT_BYTES for p in params]
        for i, big in enumerate(onebit):
            if big:
                mx.byteps_declare_tensor(f"gradient_{i}",
                                         byteps_compressor_type="onebit")
        sgd = _HostSGD()
        opt = mx.DistributedOptimizer(sgd)
        weights = [NDArray(p.detach().cpu().numpy()) for p in params]
        idx = list(range(len(params)))

        def step(keep=None):
            t = {}
            t0 = time.perf_counter()
            model.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(
                model(batch["images"]), batch["labels"])
            loss.backward()
            torch.cuda.synchronize()
            t["fwd_bwd"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            grads = [NDArray(p.grad.detach().cpu().numpy()) for p in params]
            t["d2h"] = time.perf_counter() - t0
            if keep is not None:
                keep["raw"] = [g.asnumpy().copy() for g in grads]
                keep["w0"] = [w.asnumpy().copy() for w in weights]
            sgd.seconds = 0.0
            t0 = time.perf_counter()
            opt.update(idx, weights, grads, [None] * len(idx))
            t["update"] = time.perf_counter() - t0
            t["sgd"] = sgd.seconds
            t["engine"] = t["update"] - t["sgd"]
            if keep is not None:
                keep["reduced"] = [g.asnumpy() for g in grads]
            t0 = time.perf_counter()
            with torch.no_grad():
                for p, w in zip(params, weights):
                    p.copy_(torch.from_numpy(w.asnumpy()))
            torch.cuda.synchronize()
            t["h2d"] = time.perf_counter() - t0
            check(bool(torch.isfinite(loss)), f"mxnet: loss {loss.item()}")
            return loss, t

        t0 = time.perf_counter()
        loss, _ = step()                                 # warm-up
        log(f"mxnet [{smi}]: warm-up step {(time.perf_counter() - t0):.2f} "
            f"s, loss {loss.item():.4f}")
        eng = api.engine()
        comp = [eng.registry.get(f"gradient_{i}") for i in idx if onebit[i]]
        n_chunks = sum(len(c.chunk_bounds) for c in comp)
        check(all(c.compressor for c in comp) and n_chunks > 0,
              "mxnet: a onebit-declared gradient carries no compressor")
        keep, times = {}, []
        ok.reset_launches()                              # the main path
        for s in range(MX_STEPS):
            loss, t = step(keep if s == MX_STEPS - 1 else None)
            times.append(t)
        launches = dict(ok.launches)
        want = {"onebit_pack": 2 * n_chunks * MX_STEPS,
                "onebit_unpack": n_chunks * MX_STEPS,
                "onebit_unpack_sum": n_chunks * MX_STEPS}
        check(launches == want, f"mxnet: onebit launches {launches} over "
              f"{MX_STEPS} steps, expected {want} ({n_chunks} chunks)")

        def ms(k):
            return [round(t[k] * 1e3, 2) for t in times]

        step_ms = [round(sum(t[k] for k in ("fwd_bwd", "d2h", "update",
                                            "h2d")) * 1e3, 2)
                   for t in times]
        log(f"mxnet [{smi}]: ResNet-50 batch {BATCH}x{IMAGE}^2, "
            f"{len(params)} gradients ({sum(onebit)} onebit in {n_chunks} "
            f"chunks, {len(params) - sum(onebit)} raw); step ms {step_ms}: "
            f"forward+backward {ms('fwd_bwd')}, host staging d2h "
            f"{ms('d2h')} and h2d {ms('h2d')}, engine {ms('engine')}, "
            f"numpy SGD {ms('sgd')}; loss {loss.item():.4f}; launches "
            f"a step {({k: v // MX_STEPS for k, v in launches.items()})}")

        # the checked step: every reduced gradient is api.push_pull's of
        # the same device tensor with the same dict (fresh names); the
        # onebit ones the plain chain's; the weights numpy SGD's
        raw, reduced, w0 = keep["raw"], keep["reduced"], keep["w0"]
        for i in idx:
            kw = compression_kwargs(f"gradient_{i}")
            ref = api.push_pull(torch.from_numpy(raw[i]).to(dev),
                                f"mx.ref.{i}", compression=kw).cpu()
            check(same_bits(torch.from_numpy(reduced[i]), ref),
                  f"mxnet: gradient {i} ({kw}) differs from api.push_pull's")
            check(np.array_equal(weights[i].asnumpy(),
                                 w0[i] - MX_LR * reduced[i]),
                  f"mxnet: weight {i} is not numpy SGD of its gradient")
        for i, c in zip([i for i in idx if onebit[i]], comp):
            snap = [(s.wstate, s.sstate) for s in c.compressor]
            snap = [(_cpu(a), _cpu(b)) for a, b in snap]
            plain, _ = codec_reference(
                torch, registry, {"compressor": "onebit"}, c,
                torch.from_numpy(raw[i]), snap)
            # rtol: the scale's L1 sum is taken in another order on the
            # card (phase 4's bound)
            torch.testing.assert_close(
                torch.from_numpy(reduced[i]).reshape(plain.shape), plain,
                rtol=1e-5, atol=0)
        big = max((i for i in idx if onebit[i]), key=lambda i: raw[i].size)
        ctl = api.push_pull(torch.from_numpy(raw[big]).to(dev), "mx.ctl",
                            compression=None).cpu()
        check(not same_bits(torch.from_numpy(reduced[big]), ctl),
              "mxnet: the control (raw on a onebit gradient) passed the "
              "bit check")
        log(f"mxnet: all {len(idx)} reduced gradients equal api.push_pull's "
            f"bit for bit, the {sum(onebit)} onebit ones the plain pack -> "
            f"merge -> pack -> unpack chain (rtol 1e-5), the host weights "
            f"numpy SGD's; the control (gradient {big} raw) differs")

        # one more step under torch.profiler: the onebit kernels on the
        # card, a device kernel for each launch the counters read
        busy_ms, wall_ms, events, _ = profiled_step(torch, step,
                                                    by_thread=False)
        dev_ms = onebit_device_ms(events)
        per_step = {k: v // MX_STEPS for k, v in launches.items()}
        check(all(dev_ms[k][0] == per_step[k] for k in KERNELS),
              f"mxnet: the profiled step's onebit device kernels {dev_ms} "
              f"are not the {per_step} a step the counters read")
        log(f"mxnet [{smi}]: a profiled step took {wall_ms:.2f} ms, the "
            f"device busy {busy_ms:.2f} ms of it ({busy_ms / wall_ms:.1%}); "
            + ", ".join(f"{k} {n} device kernels, {ms:.4f} ms"
                        for k, (n, ms) in dev_ms.items()))
    finally:
        mx.shutdown()
    return launches


def bench_smoke_arm(torch, ok, smi):
    """Phase 18 (b): the engine and compressed lanes of the port's
    bench_smoke on the card.  The engine's result must be the bare
    collective's bit for bit, and the compressed lanes' wire ratio and
    golden error within the floor's ceilings; the timing verdict against
    the floor is printed, not checked."""
    from byteps_tpu_torch.tools import bench_smoke as bs

    with open(bs.FLOOR_PATH) as f:
        floor = json.load(f)
    comm = bs._comm(MX_DEVICE)
    try:
        out = bs._measure(comm)
        ok.reset_launches()                              # the main path
        out["compressed"] = bs._measure_compressed(comm)
        launches = dict(ok.launches)
    finally:
        comm.close()
    check(out["engine_equals_fused"],
          "bench smoke: the engine's push_pull differs from the bare "
          "collective's")
    lanes = out["compressed"]
    check(lanes["onebit"]["wire_ratio"] <= floor["compressed_wire_ratio_max"]
          and all(v["golden_error"] <= floor["compressed_quality_ceiling"]
                  for v in lanes.values()),
          f"bench smoke: compressed lanes outside the floor's ceilings: "
          f"{lanes}")
    check(all(launches[k] > 0 for k in KERNELS),
          f"bench smoke: the onebit lane launched {launches}")
    verdict, bad = bs.evaluate(out, floor, 0.30)
    log(f"bench smoke [{smi}]: engine {out['engine_8MB_gbps']} GB/s, bare "
        f"collective {out['fused_8MB_gbps']} GB/s, ratio "
        f"{out['engine_vs_fused_ratio']} (same bits); compressed "
        + ", ".join(f"{k} wire {v['wire_ratio']} golden {v['golden_error']}"
                    f" {v['gbps']} GB/s ratio {v['throughput_ratio']}"
                    for k, v in lanes.items())
        + f"; onebit launches {launches}")
    log(f"bench smoke timing verdict against the port's floor (printed, "
        f"not a pass condition): {'pass' if verdict else 'FAIL'} {bad}")
    return launches


# --------------------------- 19. repairs and entry points

REPAIR_DEVICE = "cuda"
DCN_DELAY_MS = 20                # the delay spec's ms at site=dcn, p = 1
DCN_NUMEL = 1 << 20              # one small push (4 MiB of f32)
DCN_PLAIN_RUNS = 5               # undelayed runs of each entry (the min)
METRIC_KW = {"partition_bytes": 16384, "partition_pinned": False,
             "credit_pinned": False, "compress_autotune": True,
             "min_compress_bytes": 4096}
METRIC_NUMEL = 40_000            # the ladder's bare tensor
METRIC_MAX_PUSHES = 200          # until its partition and codec lock
SLOT_STEPS = 5                   # sharded-update slot steps
MLP_STEPS = 20                   # examples.train_mnist_mlp --steps


def repairs_phase(torch, ok, smi):
    """Phase 19: (a) the ``dcn`` chaos site at the five collective
    entries, (b) the four metrics held to what drove them, (c)
    ``examples.train_mnist_mlp`` on the card.  Returns the onebit
    launches of (a) and (b)."""
    t_phase = time.perf_counter()
    launches = dcn_arm(torch, ok, smi)
    for k, v in metrics_arm(torch, ok, smi).items():
        launches[k] += v
    mlp_arm(smi)
    log(f"repairs and entry points phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def dcn_arm(torch, ok, smi):
    """Phase 19 (a): one small push through each collective entry at one
    rank over NCCL: a warm-up, DCN_PLAIN_RUNS runs undelayed, then one
    under ``delay:site=dcn:p=1:ms=DCN_DELAY_MS`` and one under a control
    spec naming another site.  Each delayed push fires once and its wall
    holds DCN_DELAY_MS a fire, while the control's fires nothing and
    stays under DCN_DELAY_MS (the growth over the quickest undelayed run
    is printed); every result under delay (onebit's too) is the
    undelayed one bit for bit.  The onebit counters are zeroed before the
    delayed pass and read after it."""
    from byteps_tpu_torch.comm import collectives as coll
    from byteps_tpu_torch.comm import compressed
    from byteps_tpu_torch.comm.mesh import bootstrap, resolve_device
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.compression import registry
    from byteps_tpu_torch.fault import injector

    comm = bootstrap(Config(), resolve_device(REPAIR_DEVICE))
    try:
        dev, n = comm.device, DCN_NUMEL
        x = torch.randn(n, generator=torch.Generator().manual_seed(19)).to(dev)
        onebit = {"compressor": "onebit"}
        wc = registry.create(onebit, n)
        sc = registry.create(onebit, n, for_server=True)
        entries = {
            "push_pull_array": lambda: coll.push_pull_array(
                comm, x, op="sum"),
            "push_pull_array(scale=0.5)": lambda: coll.push_pull_array(
                comm, x, op="sum", scale=0.5),
            "push_pull_arrays_batched": lambda: coll.push_pull_arrays_batched(
                comm, [x[:n // 2], x[n // 2:]]),
            "push_pull_chunk_scatter": lambda: coll.push_pull_chunk_scatter(
                comm, x, None, 0, n, 1, n),
            "fused_compressed_push_pull":
                lambda: compressed.fused_compressed_push_pull(
                    comm, x, wc, sc, wc.init_state(dev),
                    sc.init_state(dev))[0],
        }

        def timed(call):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            before = counters.get("fault.delay")
            t0 = time.perf_counter()
            out = _outputs(call())
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return (out, (time.perf_counter() - t0) * 1e3,
                    counters.get("fault.delay") - before)

        for f in entries.values():
            timed(f)                                     # warm-up
        plain = {k: [timed(f) for _ in range(DCN_PLAIN_RUNS)]
                 for k, f in entries.items()}
        runs = {}
        for arm, site in (("dcn", "dcn"), ("control", "sync")):
            injector.arm(f"delay:site={site}:p=1:ms={DCN_DELAY_MS}", seed=0)
            try:
                if arm == "dcn":
                    ok.reset_launches()                  # the main path
                runs[arm] = {k: timed(f) for k, f in entries.items()}
                if arm == "dcn":
                    launches = dict(ok.launches)
            finally:
                injector.disarm()
    finally:
        comm.close()
    fires = sum(r[2] for r in runs["dcn"].values())
    check(fires == len(entries) and all(r[2] == 1
                                        for r in runs["dcn"].values()),
          f"dcn: {fires} fires over {len(entries)} entries: "
          f"{ {k: r[2] for k, r in runs['dcn'].items()} }")
    check(all(r[2] == 0 for r in runs["control"].values()),
          "dcn: the control spec (site=sync) fired at a collective entry")
    for k, (out, ms, nfire) in runs["dcn"].items():
        quickest = min(r[1] for r in plain[k])
        ctl_ms = runs["control"][k][1]
        # the delayed wall holds the delay; the control's, armed at
        # another site, holds none
        check(ms >= DCN_DELAY_MS * nfire and ctl_ms < DCN_DELAY_MS,
              f"dcn {k}: delayed wall {ms:.3f} ms (at least {DCN_DELAY_MS} "
              f"ms a fire), control {ctl_ms:.3f} ms (under {DCN_DELAY_MS})")
        check(all(same_bits(a, b) for a, b in zip(out, plain[k][0][0])),
              f"dcn {k}: the result under delay is not the undelayed one")
        log(f"dcn [{smi}]: {k} fired {nfire}, {ms:.3f} ms delayed against "
            f"{quickest:.3f} undelayed (+{ms - quickest:.3f}); control "
            f"{runs['control'][k][2]} fires, {runs['control'][k][1]:.3f} "
            f"ms; bit for bit the undelayed result")
    if comm.device.type == "cuda":
        check(launches["onebit_pack"] >= 1
              and launches["onebit_unpack_sum"] >= 1,
              f"dcn: the onebit entry launched {launches}")
    log(f"dcn: {fires} fires at {len(entries)} entries, the control none; "
        f"onebit launches under delay {launches}")
    return launches


def metrics_arm(torch, ok, smi):
    """Phase 19 (b): a small engine on the card under METRIC_KW pushes a
    bare METRIC_NUMEL-float tensor until its partition bucket and its
    codec have locked, then a sharded slot steps SLOT_STEPS times beside
    an unsharded push.  ``compression.planner_locked`` must grow by the
    buckets the planner locked, with a ``compression.codec_locked`` gauge
    of 1.0 and flight event for each (bucket, codec);
    ``engine.credit_bytes`` must equal the scheduler's installed window;
    ``engine.sharded_updates`` must grow by the slot steps only."""
    from byteps_tpu_torch.common import flight_recorder
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.common.telemetry import counters, gauges
    from byteps_tpu_torch.core import api

    locked0 = counters.get("compression.planner_locked")
    t0 = time.monotonic()
    nb = METRIC_NUMEL * 4
    launches = {k: 0 for k in KERNELS}
    api.init(Config(**METRIC_KW), device=REPAIR_DEVICE)
    try:
        eng = api.engine()
        dev = eng.comm.device
        x = torch.randn(METRIC_NUMEL,
                        generator=torch.Generator().manual_seed(19)).to(dev)
        ok.reset_launches()                              # the main path
        pushes = 0
        while pushes < METRIC_MAX_PUSHES and not (
                eng.planner.locked(nb) and eng.planner.compress_locked(nb)):
            api.push_pull(x, "metrics.bare")
            pushes += 1
        api.push_pull(x, "metrics.bare")        # retires under the lock
        launches = dict(ok.launches)
        buckets = {int(b): v["locked_codec"] for b, v in
                   eng.planner.snapshot()["compression"]["buckets"].items()
                   if v["locked_codec"] is not None}
        window = eng.scheduler.credit_bytes
        planned = eng.planner.credit_bytes()
        credit = gauges.get("engine.credit_bytes")
    finally:
        api.shutdown()
    n_locked = counters.get("compression.planner_locked") - locked0
    events = sorted((e["bucket"], e["codec"])
                    for e in flight_recorder.recorder.snapshot()
                    if e["kind"] == "compression.codec_locked"
                    and e["mono"] >= t0)
    check(eng.planner.locked(nb) and buckets,
          f"metrics: nothing locked after {pushes} pushes")
    check(n_locked == len(buckets) and events == sorted(buckets.items()),
          f"metrics: planner_locked +{n_locked}, codec_locked events "
          f"{events}, the planner's locked buckets {buckets}")
    check(all(gauges.get("compression.codec_locked", bucket=b, codec=c)
              == 1.0 for b, c in buckets.items()),
          f"metrics: a codec_locked gauge is not 1.0 for {buckets}")
    check(credit == window == planned > 0,
          f"metrics: engine.credit_bytes {credit}, the installed window "
          f"{window}, the planner's {planned}")
    log(f"metrics [{smi}]: after {pushes} pushes planner_locked "
        f"+{n_locked} = the {len(buckets)} locked bucket(s) {buckets}, a "
        f"codec_locked gauge 1.0 and event each; engine.credit_bytes "
        f"{credit:.0f} = the installed window; onebit launches {launches}")

    before = counters.get("engine.sharded_updates")
    api.init(Config(sharded_update=True), device=REPAIR_DEVICE)
    try:
        dev = api.engine().comm.device
        gen = torch.Generator().manual_seed(20)
        p = torch.randn(METRIC_NUMEL, generator=gen).to(dev)
        api.declare_update("metrics.slot", p.shape, torch.float32,
                           optimizer=(torch.optim.SGD, {"lr": 0.1}),
                           init_value=p)
        for _ in range(SLOT_STEPS):
            p.copy_(api.push_pull_update(
                torch.randn(METRIC_NUMEL, generator=gen).to(dev),
                "metrics.slot"))
        api.push_pull(p, "metrics.unsharded")            # the control
        applied = api.engine().update_slots["metrics.slot"].applied
    finally:
        api.shutdown()
    steps = counters.get("engine.sharded_updates") - before
    check(steps == SLOT_STEPS == applied,
          f"metrics: engine.sharded_updates +{steps}, the slot applied "
          f"{applied} of {SLOT_STEPS} steps")
    log(f"metrics [{smi}]: engine.sharded_updates +{steps} = the "
        f"{SLOT_STEPS} slot steps (an unsharded push beside them counts "
        f"none)")
    return launches


def mlp_arm(smi):
    """Phase 19 (c): ``examples.train_mnist_mlp --steps MLP_STEPS`` on the
    card, in process; its printed losses finite and falling."""
    import contextlib
    import io

    from byteps_tpu_torch.examples import train_mnist_mlp

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_mnist_mlp.main(["--steps", str(MLP_STEPS), "--device",
                              REPAIR_DEVICE])
    out = buf.getvalue()
    losses = [float(v) for v in re.findall(r"step +\d+ +loss (\S+)", out)]
    check(len(losses) == 3 and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0],
          f"train_mnist_mlp: losses {losses} do not fall\n{out}")
    for line in out.strip().splitlines():
        log(f"train_mnist_mlp [{smi}]: {line}")


# ------------------------------------------------------ 20. buffer mode

BUFFER_NUMEL = 25_557_032          # ResNet-50's parameters, one flat gradient
BUFFER_CONTROL_NUMEL = 1000        # one chunk under buffer_min_bytes
BUFFER_DEVICE = "cuda"
BUFFER_COLLECTIVES = ("all_reduce", "reduce_scatter_tensor",
                      "all_gather_into_tensor", "all_gather", "broadcast")


def _buffer_push(torch, api, eng, x, name, smi):
    """One push of ``x`` (after a warm-up) under torch.profiler, with
    the engine's units, its collective entries and ``torch.distributed``'s
    calls counted; returns the result and the counts."""
    import torch.distributed as dist
    from byteps_tpu_torch.core import engine as engine_mod

    entries = ("push_pull_chunk_scatter", "assemble_scatter",
               "push_pull_array", "push_pull_arrays_batched")
    api.push_pull(x, name)
    if x.is_cuda:
        torch.cuda.synchronize()
    units, calls = [], collections.Counter()
    real_unit = eng._dispatch_unit
    real = {("dist", k): getattr(dist, k) for k in BUFFER_COLLECTIVES}
    real.update({("engine", k): getattr(engine_mod, k) for k in entries})

    def counted(key):
        fn = real[key]

        def wrapper(*a, **kw):
            calls[key[1]] += 1
            return fn(*a, **kw)
        return wrapper

    def recording(kind, unit):
        units.append((kind, len(unit), unit[0].pending.scatter is not None))
        real_unit(kind, unit)

    eng._dispatch_unit = recording
    for (mod, k) in real:
        setattr(dist if mod == "dist" else engine_mod, k, counted((mod, k)))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if x.is_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = api.push_pull(x, name)
            if x.is_cuda:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        eng._dispatch_unit = real_unit
        for (mod, k), fn in real.items():
            setattr(dist if mod == "dist" else engine_mod, k, fn)
    kernels = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels["all"] += 1
            for k in ("AllReduce", "ReduceScatter", "AllGather"):
                kernels[k] += k in e.name
    chunks = len(eng.registry.get(name).chunk_bounds)
    return out, {"units": units, "calls": dict(calls), "chunks": chunks,
                 "kernels": dict(kernels), "ms": ms}


def buffer_phase(torch, smi):
    """Phase 20: a ResNet-50-sized gradient on the scatter accumulator
    against a control on the parts path, at a world of one."""
    import numpy as np

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core import api

    t_phase = time.perf_counter()
    # the default chunk size, pinned: a world of one's planner would try
    # the whole tensor as one chunk at the next push
    bps.init(Config(partition_pinned=True), device=BUFFER_DEVICE)
    try:
        eng = api.engine()
        dev = api.device()
        rng = np.random.RandomState(20)
        g = torch.from_numpy(rng.randn(BUFFER_NUMEL).astype(np.float32)
                             ).to(dev)
        c = torch.from_numpy(rng.randn(BUFFER_CONTROL_NUMEL).astype(
            np.float32)).to(dev)
        out_g, rg = _buffer_push(torch, api, eng, g, "buffer.gradient", smi)
        out_c, rc = _buffer_push(torch, api, eng, c, "buffer.control", smi)
        check(rg["chunks"] > 1 and all(kind == "run" and on_acc
                                       for kind, _, on_acc in rg["units"])
              and sum(w for _, w, _ in rg["units"]) == rg["chunks"],
              f"buffer: the gradient's units {rg['units']} are not runs on "
              f"the accumulator covering its {rg['chunks']} chunks")
        calls = rg["calls"]
        check(calls.get("push_pull_chunk_scatter") == len(rg["units"])
              and calls.get("assemble_scatter") == 1
              and not calls.get("push_pull_array")
              and not calls.get("push_pull_arrays_batched"),
              f"buffer: the gradient's collective entries {calls}")
        check(not any(calls.get(k) for k in BUFFER_COLLECTIVES)
              and not rg["kernels"].get("AllReduce"),
              f"buffer: the gradient issued collectives {calls}, NCCL "
              f"kernels {rg['kernels']} at a world of one")
        check(rc["units"] and not any(on_acc for *_, on_acc in rc["units"])
              and rc["calls"].get("push_pull_array") == 1
              and rc["calls"].get("all_reduce") == 1
              and not rc["calls"].get("push_pull_chunk_scatter"),
              f"buffer: the control's units {rc['units']}, entries "
              f"{rc['calls']}")
        for name, r in (("gradient", rg), ("control", rc)):
            log(f"buffer {name} [{smi}]: {r['chunks']} chunk(s) in units "
                f"{[(k, w) for k, w, _ in r['units']]} "
                f"(on the accumulator: {[a for *_, a in r['units']]}); "
                f"entries and torch.distributed calls {r['calls']}; device "
                f"kernels {r['kernels']}; {r['ms']:.2f} ms")
        # the parts path: debug sampling keeps every tensor off the
        # accumulator (a pattern that names no tensor logs nothing)
        eng.cfg.debug_sample_tensor = "buffer.no-such-tensor"
        try:
            out_p, rp = _buffer_push(torch, api, eng, g, "buffer.gradient",
                                     smi)
        finally:
            eng.cfg.debug_sample_tensor = ""
        check(not any(on_acc for *_, on_acc in rp["units"])
              and rp["calls"].get("push_pull_array", 0)
              + rp["calls"].get("push_pull_arrays_batched", 0) >= 1,
              f"buffer: the parts-path push's units {rp['units']}")
        check(same_bits(out_g, out_p) and same_bits(out_g, g)
              and same_bits(out_c, c),
              "buffer: the accumulator's result differs from the parts "
              "path's (or from the input, at a world of one)")
        log(f"buffer [{smi}]: the accumulator's {BUFFER_NUMEL} floats equal "
            f"the parts path's bit for bit ({rp['ms']:.2f} ms there, "
            f"units {[(k, w) for k, w, _ in rp['units']]})")
    finally:
        bps.shutdown()
    log(f"buffer mode phase: {time.perf_counter() - t_phase:.1f} s")


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
    async_ms = async_phase(torch, bps, ok, registry, resnet,
                           smi)["clean"]["step_ms"]
    log(f"async parameter-server phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    observed = observed_phase(torch, bps, api, Config, ok, fa, registry,
                              llama, resnet, smi)
    log(f"observed sharded update phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fault_launches = fault_phase(torch, bps, api, Config, registry, smi,
                                 async_ms)
    log(f"fault plane and TCP transport phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    elastic_launches = elastic_phase(torch, smi)
    log(f"elastic membership phase: {time.perf_counter() - t_phase:.1f} s")
    serve_launches = serving_phase(torch, smi)
    fused_launches, fused_flash = fused_step_phase(torch, ok, fa, smi)
    seqpar_flash = seqpar_phase(torch, smi)
    modelpar_flash = modelpar_phase(torch, smi)
    launcher_launches = launcher_phase(torch, smi)
    frontend_launches = frontends_phase(torch, ok, registry, resnet, smi)
    repair_launches = repairs_phase(torch, ok, smi)
    buffer_phase(torch, smi)
    # the main paths' launches: phase 4's and the LM slices', phase 10's,
    # those phase 11's, 12's, 13's, 15's, 16's and 17's processes
    # counted, and phase 14's, 18's and 19's
    for k in KERNELS:
        launches[k] += (fault_launches.get(k, 0)
                        + elastic_launches.get(k, 0)
                        + serve_launches.get(k, 0)
                        + fused_launches.get(k, 0)
                        + launcher_launches[k]
                        + frontend_launches[k]
                        + repair_launches[k])
    for k in FLASH_KERNELS:
        flash_launches[k] += (fused_flash[k] + seqpar_flash[k]
                              + modelpar_flash[k])
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
