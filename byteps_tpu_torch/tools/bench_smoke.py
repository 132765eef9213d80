"""Bench-smoke gate of the port; port of ``tools/bench_smoke.py``.

The same eleven lanes and the same pure gate functions as the JAX tool,
each driven through the port's own modules on the card (``--device cpu``
for a rehearsal), and gated against the port's own floor file,
``bench_smoke_floor.json`` beside this module:

- **engine** (:func:`_measure`): the engine's host-staged push_pull
  (``push_pull_local``: a numpy array staged onto the card, reduced,
  read back) against the bare collective of ``comm/collectives.py`` on
  the same input already on the card, at 8 MB, in interleaved pairs; the
  ratio gates (either it or the engine's GB/s must clear its floor), and
  ``engine_equals_fused`` records whether the two results are the same
  bits;
- **serve**, **straggler**: the serving plane's pulls/s and p99 under
  training pushes, and the hedged p99 under one injected slow replica;
- **compressed** (:func:`_measure_compressed`): onebit and randomk
  through the engine at 2 MiB (onebit through the card's onebit
  kernels), against the uncompressed push: wire ratio, GB/s, throughput
  ratio and the codec's golden error;
- **sharded_update**: the MLP's leaves through push_pull plus the
  caller's Adam and through ``declare_update`` / ``push_pull_update``,
  bit for bit, with each arm's wire bytes a step;
- **trace**, **ts_sampler**: the cost of 1-in-4 sampled tracing and of
  a time-series sample a push;
- **transport**: TCP against loopback KV deltas, and a live shard's p99
  beside a partitioned one;
- **serve_dist**, **fleet**: three serving-host processes, and a fleet
  that grows to four and drains back to two;
- **durability**: the journal's cost on the push path and a cold
  replay's MB/s.

Why the ratios gate and not raw rates: a rate on a shared host measures
the host.  Each ratio pairs two paths in the same run, adjacent in time,
so the host's speed cancels.  The timing gates are for a host of the
card's machine: ``--update-floor`` rewrites the floor from a run there
(its note names the card and its power limit).

    python -m byteps_tpu_torch.tools.bench_smoke [--update-floor]
    python -m byteps_tpu_torch.tools.bench_smoke --device cpu

Prints one JSON object; exits 1 when a gate fails.  :func:`evaluate` is
the gate of a whole result, pure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ._bench_util import card_line, metrics_diag, quantile_stats_raw

FLOOR_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "bench_smoke_floor.json")
MB = 1024 * 1024


def _med(xs):
    return quantile_stats_raw(xs)[0]


def _comm(device):
    """This process's group (a world of one unless the BYTEPS_*/DMLC_*
    environment names more) on ``device``."""
    from ..comm.mesh import bootstrap, resolve_device
    from ..common.config import Config
    cfg = Config.from_env()
    return bootstrap(cfg, resolve_device(device, cfg.local_rank))


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _measure(comm, nbytes=8 * MB, reps=9):
    """The engine's host-staged push_pull against the bare collective at
    ``nbytes``, interleaved: each rep times the collective on the card's
    copy of the input, then the engine on the host array (staging, the
    engine, the read-back), and takes their ratio; the median of the
    ratios over ``reps``.  The engine is first pushed until its planner
    has locked the size (at most 24 pushes)."""
    import numpy as np
    import torch

    from ..comm.collectives import push_pull_array
    from ..common.config import Config
    from ..core.engine import PushPullEngine

    dev = comm.device
    x = np.random.RandomState(0).randn(nbytes // 4).astype(np.float32)
    x_dev = torch.from_numpy(x).to(dev)
    fused_out = push_pull_array(comm, x_dev, op="average")
    _sync(dev)
    eng = PushPullEngine(comm, Config(telemetry_on=False, trace_on=False))
    try:
        eng.declare_tensor("smoke.pp", x.shape, torch.float32)
        for _ in range(24):
            out = eng.push_pull_local(x, "smoke.pp")
            if eng.planner.locked(nbytes):
                break
        same = np.array_equal(out.view(np.int32),
                              fused_out.cpu().numpy().view(np.int32))
        fused_t, eng_t, ratios = [], [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            push_pull_array(comm, x_dev, op="average")
            _sync(dev)
            tf = time.perf_counter() - t0
            t0 = time.perf_counter()
            eng.push_pull_local(x, "smoke.pp")
            te = time.perf_counter() - t0
            fused_t.append(tf)
            eng_t.append(te)
            ratios.append(tf / te)   # engine/fused throughput ratio
        snap = eng.planner.snapshot()
    finally:
        eng.shutdown(wait=False)
    return {"fused_8MB_gbps": round(nbytes / _med(fused_t) / 1e9, 3),
            "engine_8MB_gbps": round(nbytes / _med(eng_t) / 1e9, 3),
            "engine_vs_fused_ratio": round(_med(ratios), 3),
            "ratio_per_rep": [round(r, 3) for r in sorted(ratios)],
            "engine_equals_fused": bool(same),
            "autotune": snap,
            "metrics": metrics_diag()}


COMPRESSED_CODECS = (
    ("onebit", {"compressor": "onebit", "ef": "vanilla"}),
    ("randomk", {"compressor": "randomk", "k": "0.25", "ef": "vanilla"}))


def _measure_compressed(comm, nbytes=2 * MB, reps=5):
    """Onebit and randomk through the engine at ``nbytes`` against the
    uncompressed push of the same tensor, interleaved a rep at a time:
    each lane's wire ratio (its chunks' payload bytes over the raw
    bytes), GB/s, throughput ratio against the uncompressed push, the
    codec's golden error, and ``zero_compile`` (no program built during
    the timed reps; the port builds its kernels once a process, at their
    first launch, in the warm-up)."""
    import numpy as np
    import torch

    from ..common.config import Config
    from ..common.telemetry import counters
    from ..compression import registry as creg
    from ..core.engine import PushPullEngine

    dev = comm.device
    eng = PushPullEngine(comm, Config(telemetry_on=False, trace_on=False,
                                      min_compress_bytes=4096))
    lanes = {}
    try:
        n = nbytes // 4
        x = torch.from_numpy(
            np.random.RandomState(3).randn(n).astype(np.float32)).to(dev)

        def push(name, **kw):
            eng.push_pull_async(x, name, op="sum", **kw).wait()
            _sync(dev)

        eng.declare_tensor("cmp.base", (n,), torch.float32)
        push("cmp.base")
        for codec, kwargs in COMPRESSED_CODECS:
            name = f"cmp.{codec}"
            eng.declare_tensor(name, (n,), torch.float32,
                               compression=kwargs)
            push(name, compression=kwargs)      # warm (states, kernels)
            ctx = eng.registry.get(name)
            payload = sum(s.worker.payload_nbytes()
                          for s in (ctx.compressor or ()))
            m0 = counters.get("engine.compile_cache_miss")
            base_t, lane_t, ratios = [], [], []
            for _ in range(reps):
                t0 = time.perf_counter()
                push("cmp.base")
                tb = time.perf_counter() - t0
                t0 = time.perf_counter()
                push(name, compression=kwargs)
                tc = time.perf_counter() - t0
                base_t.append(tb)
                lane_t.append(tc)
                ratios.append(tb / tc)   # compressed/uncompressed tput
            lanes[codec] = {
                "wire_ratio": round(payload / nbytes, 4),
                "gbps": round(nbytes / _med(lane_t) / 1e9, 3),
                "uncompressed_gbps": round(nbytes / _med(base_t) / 1e9, 3),
                "throughput_ratio": round(_med(ratios), 3),
                "golden_error": round(creg.golden_error(kwargs), 4),
                "zero_compile": counters.get("engine.compile_cache_miss")
                == m0,
            }
    finally:
        eng.shutdown(wait=False)
    return lanes


def _measure_sharded_update(comm, reps=7):
    """The MLP's leaves (64 -> 256 -> 128 -> 10, seeded) through two
    engines: unsharded (push_pull, then the caller's Adam on the whole
    parameters, the DistributedOptimizer's data path) and sharded
    (``declare_update`` / ``push_pull_update``: the owner's Adam and the
    parameter leg).  Wire bytes a step per arm from the per-leg
    ``wire_bytes`` counters (telemetry on in both arms), their ratio, the
    interleaved step-time ratio, and ``exact``: the two arms' parameters
    after the timed steps are the same bits.  ``ranks`` is the world R,
    which the wire contract depends on (push N, pull N/R)."""
    import numpy as np
    import torch

    from ..common.config import Config
    from ..common.telemetry import counters
    from ..core.engine import PushPullEngine
    from ..models.mlp import MLP

    dev = comm.device
    model = MLP(64, features=(256, 128, 10))
    leaves = [p.detach().clone() for p in model.parameters()]
    names = [f"su.{i}" for i in range(len(leaves))]
    rng = np.random.RandomState(7)
    grads = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32)).to(dev)
             for p in leaves]
    adam = (torch.optim.Adam, {"lr": 1e-2})
    cfg_kw = dict(telemetry_on=True, trace_on=False, partition_bytes=16384)
    eng_u = PushPullEngine(comm, Config(**cfg_kw))
    eng_s = PushPullEngine(comm, Config(sharded_update=True, **cfg_kw))
    try:
        p_u = [p.to(dev) for p in leaves]
        opt_u = adam[0](p_u, **adam[1])
        p_s = [p.to(dev) for p in leaves]
        for name, p in zip(names, leaves):
            eng_u.declare_tensor(name, p.shape, torch.float32)
            eng_s.declare_update(name, p.shape, torch.float32,
                                 optimizer=adam, init_value=p.to(dev))

        def step_u():
            hs = [eng_u.push_pull_async(g, n) for n, g in zip(names, grads)]
            for p, h in zip(p_u, hs):
                p.grad = h.wait()
            opt_u.step()
            _sync(dev)

        def step_s():
            hs = [eng_s.push_pull_update_async(g, n)
                  for n, g in zip(names, grads)]
            out = [h.wait() for h in hs]
            _sync(dev)
            return out

        step_u()                                  # warm both arms
        p_s = step_s()

        def wire():
            return (counters.get("wire_bytes", leg="push")
                    + counters.get("wire_bytes", leg="pull"))

        w0 = wire()
        step_u()
        w1 = wire()
        p_s = step_s()
        w2 = wire()
        wire_u, wire_s = w1 - w0, w2 - w1
        u_t, s_t, ratios = [], [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            step_u()
            tu = time.perf_counter() - t0
            t0 = time.perf_counter()
            p_s = step_s()
            ts = time.perf_counter() - t0
            u_t.append(tu)
            s_t.append(ts)
            ratios.append(tu / ts)   # sharded/unsharded step throughput
        exact = all(torch.equal(a, b) for a, b in zip(p_u, p_s))
    finally:
        eng_u.shutdown(wait=False)
        eng_s.shutdown(wait=False)
    return {"wire_bytes_per_step_unsharded": wire_u,
            "wire_bytes_per_step_sharded": wire_s,
            "wire_ratio": round(wire_s / wire_u, 4),
            "step_ms_unsharded": round(_med(u_t) * 1e3, 3),
            "step_ms_sharded": round(_med(s_t) * 1e3, 3),
            "step_time_ratio": round(_med(ratios), 3),
            "ratio_per_rep": [round(r, 3) for r in sorted(ratios)],
            "exact": exact, "ranks": comm.size}


def _warm_locked(eng, x, name, nbytes):
    for _ in range(24):
        eng.push_pull_local(x, name)
        if eng.planner.locked(nbytes):
            break


def _measure_trace(comm, nbytes=4 * MB, reps=9, sample_n=4):
    """Sampled tracing's cost: on one engine, each rep times a push with
    the process tracer's 1-in-``sample_n`` stream off, then on; the
    median of off/on."""
    import tempfile

    import numpy as np

    import torch

    from ..common import tracing as _tracing
    from ..common.config import Config
    from ..core.engine import PushPullEngine

    tmp = tempfile.mkdtemp(prefix="bps_trace_bench_")
    tr = _tracing.set_tracer(_tracing.Tracer(
        enabled=False, sample_n=0, out_dir=tmp, capacity=1 << 16))
    eng = PushPullEngine(comm, Config(telemetry_on=True, trace_on=False))
    try:
        x = np.random.RandomState(1).randn(nbytes // 4).astype(np.float32)
        eng.declare_tensor("trace.pp", x.shape, torch.float32)
        _warm_locked(eng, x, "trace.pp", nbytes)
        tr.sample_n = sample_n       # warm the sampled path's branches
        eng.push_pull_local(x, "trace.pp")
        ratios = []
        for _ in range(reps):
            tr.sample_n = 0
            t0 = time.perf_counter()
            eng.push_pull_local(x, "trace.pp")
            t_off = time.perf_counter() - t0
            tr.sample_n = sample_n
            t0 = time.perf_counter()
            eng.push_pull_local(x, "trace.pp")
            t_on = time.perf_counter() - t0
            ratios.append(t_off / t_on)   # sampled/unsampled throughput
        return {"sample_n": sample_n,
                "overhead_ratio": round(_med(ratios), 3),
                "ratio_per_rep": [round(r, 3) for r in sorted(ratios)],
                "events_buffered": tr.debug_state()["events_buffered"],
                "events_dropped": tr.dropped}
    finally:
        eng.shutdown(wait=False)
        _tracing.set_tracer(None)


def _measure_ts_sampler(comm, nbytes=4 * MB, reps=9):
    """The time-series sampler's cost: on one engine, each rep times a
    push, then a push followed by a forced ``sample_once()``; the median
    of the two walls' ratio."""
    import numpy as np
    import torch

    from ..common.config import Config
    from ..common.timeseries import TimeSeriesStore
    from ..core.engine import PushPullEngine

    store = TimeSeriesStore(interval_s=2.0, window=64)
    eng = PushPullEngine(comm, Config(telemetry_on=True, trace_on=False))
    try:
        x = np.random.RandomState(2).randn(nbytes // 4).astype(np.float32)
        eng.declare_tensor("ts.pp", x.shape, torch.float32)
        _warm_locked(eng, x, "ts.pp", nbytes)
        store.sample_once()          # warm the sampler's branches
        ratios = []
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.push_pull_local(x, "ts.pp")
            t_off = time.perf_counter() - t0
            t0 = time.perf_counter()
            eng.push_pull_local(x, "ts.pp")
            store.sample_once()
            t_on = time.perf_counter() - t0
            ratios.append(t_off / t_on)   # sampled/unsampled throughput
        return {"samples": len(store.points()),
                "overhead_ratio": round(_med(ratios), 3),
                "ratio_per_rep": [round(r, 3) for r in sorted(ratios)]}
    finally:
        eng.shutdown(wait=False)


def _measure_transport(device, nbytes=256 * 1024, reps=30):
    """TCP against loopback for seq-tokened KV deltas (interleaved
    pairs), and the p99 push latency to a live shard while the other
    shard's peer is partitioned (a dead endpoint whose supervisor keeps
    dialling)."""
    import math
    import socket as _socket
    import threading as _threading

    import numpy as np

    from ..comm import transport as btp
    from ..common import integrity as _bint
    from ..common.telemetry import counters as _counters
    from ..server.kv_store import KVStore

    n = nbytes // 4
    kv_lb, kv_tcp = KVStore(device), KVStore(device)
    for kv in (kv_lb, kv_tcp):
        kv.init_key("bench", np.zeros(n, np.float32))
    srv = btp.TransportServer(rank=0, kv=kv_tcp)
    lb = btp.LoopbackEndpoint(kv=kv_lb)
    ep = btp.TcpEndpoint(srv.addr, peer=0)
    delta = np.random.RandomState(0).randn(n).astype(np.float32)
    lb.push_delta("bench", delta, seq=1)
    ep.push_delta("bench", delta, seq=1)          # warm (conn, buffers)
    lb_t, tcp_t, ratios = [], [], []
    for i in range(reps):
        t0 = time.perf_counter()
        lb.push_delta("bench", delta, seq=i + 2)
        tl = time.perf_counter() - t0
        t0 = time.perf_counter()
        ep.push_delta("bench", delta, seq=i + 2)
        tt = time.perf_counter() - t0
        lb_t.append(tl)
        tcp_t.append(tt)
        ratios.append(tl / tt)    # tcp/loopback throughput ratio

    # one partitioned peer in a 2-shard world: a dead endpoint whose
    # supervisor dials a black hole forever, beside the live one
    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    dead = btp.TcpEndpoint(("127.0.0.1", dead_port), peer=1,
                           send_deadline_s=0.2, keepalive_s=0.0)
    client = btp.ShardedClient([ep, dead])
    live_key = next(k for k in (f"k{j}" for j in range(64))
                    if client.assigner.write_target(k) == 0)
    dead_key = next(k for k in (f"k{j}" for j in range(64))
                    if client.assigner.write_target(k) == 1)
    kv_tcp.init_key(live_key, np.zeros(256, np.float32))
    stop = _threading.Event()

    def hammer():
        seq = 1
        while not stop.is_set():
            try:
                client.push_delta(dead_key, np.zeros(256, np.float32),
                                  seq=seq)
            except (_bint.AckLost, btp.TransportError):
                pass
            seq += 1

    t = _threading.Thread(target=hammer, daemon=True)
    t.start()
    lats = []
    small = np.ones(256, np.float32)
    for i in range(150):
        t0 = time.perf_counter()
        client.push_delta(live_key, small, seq=i + 1)
        lats.append(time.perf_counter() - t0)
    stop.set()
    t.join(timeout=5)
    lats.sort()
    p99 = lats[min(len(lats) - 1, math.ceil(0.99 * len(lats)) - 1)]
    dead.close(drain=False)
    ep.close()
    srv.close()
    return {"nbytes": nbytes,
            "loopback_gbps": round(nbytes / _med(lb_t) / 1e9, 3),
            "tcp_gbps": round(nbytes / _med(tcp_t) / 1e9, 3),
            "tcp_vs_loopback_ratio": round(_med(ratios), 3),
            "partitioned_peer_p99_ms": round(p99 * 1e3, 3),
            "deadline_trips": _counters.get("transport.send_deadline_trips"),
            "reconnect_attempts": dead.connection.dial_attempts}


def _serve_bench(device):
    from . import serve_bench
    serve_bench.DEVICE = str(device)
    return serve_bench


def _measure_serve(device):
    """Pulls/s and p99 under concurrent training pushes (not gated; the
    delta check's ``ok`` is the correctness proxy)."""
    sb = _serve_bench(device)
    out = sb.measure(seconds=1.0, clients=2, keys=4, numel=32768,
                     replicas=3, staleness=0.0)
    out["delta"] = sb.delta_check()
    return {k: out[k] for k in ("pulls_per_s", "p50_ms", "p99_ms",
                                "pushes_per_s", "failed_reads", "delta")}


def _measure_straggler(device, slow_s=0.03, reps=150):
    """The p99 pull latency with one serving replica slowed by
    ``slow_s``, hedged and unhedged, against the no-fault p99 (taken on
    the hedged path)."""
    import math

    import numpy as np

    from ..common.telemetry import counters
    from ..server.kv_store import KVStore
    from ..server.serve_client import PullClient
    from ..server.serving import ServingPlane

    store = KVStore(device)
    dev = store.device
    for k in ("st.a", "st.b"):
        store.init_key(k, np.zeros(4096, np.float32))
        store.push_delta(k, np.ones(4096, np.float32))
    plane = ServingPlane(store, replicas=3, retention=8, hot_keys=8,
                         device=dev)
    plane.cut()
    PullClient(plane, max_staleness_s=0.0, device=dev).pull()   # hotness
    plane.cut()                                     # mirror the hot keys

    def p99_ms(hedge, n=reps):
        client = PullClient(plane, max_staleness_s=0.0, hedge=hedge,
                            device=dev)
        lats = []
        for _ in range(n):
            t0 = time.perf_counter()
            client.pull()
            lats.append(time.perf_counter() - t0)
        lats.sort()
        # ceil-based p99 index: one scheduler outlier cannot fail the gate
        return round(lats[min(n - 1, math.ceil(0.99 * n) - 1)] * 1e3, 3)

    nofault = p99_ms(hedge=True)
    plane.replicas[0].delay_s = slow_s
    unhedged = p99_ms(hedge=False)
    hedged = p99_ms(hedge=True)
    plane.close()
    return {"p99_nofault_ms": nofault,
            "p99_unhedged_ms": unhedged,
            "p99_hedged_ms": hedged,
            "slow_endpoint_ms": slow_s * 1e3,
            "hedged_pulls": counters.get("serve.hedged_pulls"),
            "hedge_wins": counters.get("serve.hedge_wins")}


def _measure_serve_dist(device):
    """Pulls/s and p99 against three serving-host processes behind the
    TCP transport (snapshot deltas shipped by the ring, the bus's
    directory, admission control armed)."""
    out = _serve_bench(device).measure_distributed(
        hosts=3, seconds=1.5, clients=3, keys=6, numel=16384,
        replicas=2, staleness=0.05)
    keep = ("hosts", "pulls_per_s", "p50_ms", "p99_ms", "pushes_per_s",
            "failed_reads", "per_host", "ships", "ship_failures",
            "failovers", "shed")
    return {k: out[k] for k in keep}


def _measure_fleet(device):
    """Pulls/s and p99 while the fleet reconciler spawns serving hosts
    up to the peak target and drains back to base."""
    out = _serve_bench(device).measure_fleet(
        seconds=4.0, clients=3, keys=6, numel=16384, replicas=2,
        staleness=0.05, base_hosts=2, peak_hosts=4)
    keep = ("base_hosts", "peak_hosts", "pulls_per_s", "p50_ms",
            "p99_ms", "pushes_per_s", "failed_reads", "spawned",
            "drain_started", "drained", "drain_escalated", "banned",
            "final_hosts", "still_draining")
    return {k: out[k] for k in keep}


def _measure_durability(device, numel=16 * 1024, reps=9, batch=24,
                        replay_pushes=400):
    """The journal's cost on the push path (interleaved batches of
    ``push_delta`` against a plain and a journaled store, ``fsync=off``
    so the ratio is the journaling's own) and a cold replay of
    ``replay_pushes`` records through ``wal.recover`` (MB/s of journal
    read back; the read is warm, from the page cache)."""
    import shutil
    import tempfile

    import numpy as np

    from ..common.config import Config
    from ..server import wal
    from ..server.kv_store import KVStore

    tmp = tempfile.mkdtemp(prefix="bps_bench_durable_")
    cfg = Config(telemetry_on=False, trace_on=False,
                 durable_dir=tmp, wal_fsync="off")
    try:
        plain, durable = KVStore(device), KVStore(device)
        dur = wal.attach(durable, os.path.join(tmp, "push"), cfg)
        zeros = np.zeros(numel, np.float32)
        plain.init_key("b", zeros)
        durable.init_key("b", zeros)
        delta = np.random.RandomState(3).randn(numel).astype(np.float32)

        def burst(store, start):
            for seq in range(start, start + batch):
                store.push_delta("b", delta, worker_id=0, seq=seq)

        burst(plain, 1)          # warm both paths past first-touch
        burst(durable, 1)
        ratios = []
        for rep in range(reps):
            base = (rep + 1) * batch + 1
            t0 = time.perf_counter()
            burst(plain, base)
            t_plain = time.perf_counter() - t0
            t0 = time.perf_counter()
            burst(durable, base)
            t_dur = time.perf_counter() - t0
            ratios.append(t_plain / t_dur)
        dur.close()

        replay_dir = os.path.join(tmp, "replay")
        src = KVStore(device)
        src_dur = wal.attach(src, replay_dir, cfg)
        src.init_key("b", zeros)
        for seq in range(1, replay_pushes + 1):
            src.push_delta("b", delta, worker_id=0, seq=seq)
        src_dur.close()
        t0 = time.perf_counter()
        _, stats = wal.recover(replay_dir, cfg=cfg, device=device)
        replay_s = time.perf_counter() - t0
        return {"push_ratio": round(_med(ratios), 3),
                "ratio_per_rep": [round(r, 3) for r in sorted(ratios)],
                "replay_records": stats["records"],
                "replay_mb": round(stats["bytes"] / MB, 2),
                "replay_mbps": round(stats["bytes"] / MB / replay_s, 1),
                "truncated_tails": stats["truncated_tails"],
                "corrupt_records": stats["corrupt_records"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ gates
# the JAX tool's gate functions, pure, one a lane

def _compressed_ok(lanes: dict, floor: dict, tol: float) -> bool:
    """The compressed gate (pure; pinned by a unit test like the
    straggler gate): onebit's wire ratio and every lane's golden error
    are deterministic contracts — no tolerance; the throughput ratio is
    a host measurement and takes the lane tolerance."""
    ratio_max = floor.get("compressed_wire_ratio_max", 0.35)
    quality_max = floor.get("compressed_quality_ceiling", 0.55)
    tput_floor = floor.get("compressed_throughput_floor", 0.0)
    ok = True
    for codec, lane in lanes.items():
        lane_ok = lane["golden_error"] <= quality_max
        if codec == "onebit":
            lane_ok = lane_ok and lane["wire_ratio"] <= ratio_max
        lane_ok = lane_ok and (lane["throughput_ratio"]
                               >= tput_floor * (1.0 - tol))
        lane["ok"] = lane_ok
        ok = ok and lane_ok
    return ok


def _sharded_update_ok(su: dict, floor: dict, tol: float) -> bool:
    """The sharded_update gate (pure; pinned by a unit test): the wire
    ratio and the replay exactness are deterministic contracts — no
    tolerance; the step-time ratio is a host measurement and takes the
    lane tolerance."""
    ratio_max = floor.get("sharded_wire_ratio_max", 0.62)
    step_floor = floor.get("sharded_step_ratio_floor", 0.0)
    gate = step_floor * (1.0 - tol)
    su["gate_step_ratio"] = round(gate, 3)
    return (su["exact"]
            and su["wire_ratio"] <= ratio_max
            and su["step_time_ratio"] >= gate)


def _trace_ok(trc: dict, floor: dict, tol: float) -> bool:
    """Sampled tracing must not cost more than the floor allows AND the
    sampled stream must actually have recorded something (a 1.0 ratio
    with zero events would mean the lane silently stopped tracing)."""
    gate = floor.get("trace_sample_overhead_floor", 0.7) * (1.0 - tol)
    trc["gate_ratio"] = round(gate, 3)
    return (trc["overhead_ratio"] >= gate
            and trc["events_buffered"] > 0)


def _ts_ok(ts: dict, floor: dict, tol: float) -> bool:
    """The sampler must not cost more than the floor allows AND must
    actually have filled the ring (a 1.0 ratio with an empty ring would
    mean the lane silently stopped sampling)."""
    gate = floor.get("ts_sampler_overhead_floor", 0.95) * (1.0 - tol)
    ts["gate_ratio"] = round(gate, 3)
    return ts["overhead_ratio"] >= gate and ts["samples"] > 0


def _transport_ok(trp: dict, floor: dict, tol: float) -> bool:
    """The transport gate (pure; pinned by a unit test): the TCP/loopback
    ratio is a host measurement and takes the lane tolerance; the
    partitioned-peer p99 is an absolute isolation ceiling (the fault is
    injected, so the bound holds on any host)."""
    gate_ratio = floor.get("transport_tcp_ratio_floor", 0.0) * (1.0 - tol)
    gate_p99 = floor.get("transport_partitioned_p99_ms", 50.0)
    trp["gate_ratio"] = round(gate_ratio, 4)
    trp["gate_p99_ms"] = gate_p99
    return (trp["tcp_vs_loopback_ratio"] >= gate_ratio
            and trp["partitioned_peer_p99_ms"] <= gate_p99)


def _straggler_ok(st, floor) -> bool:
    gate = max(floor.get("straggler_hedge_p99_factor", 2.0)
               * st["p99_nofault_ms"],
               floor.get("straggler_hedge_p99_abs_ms", 10.0))
    st["gate_ms"] = round(gate, 3)
    return st["p99_hedged_ms"] <= gate


def _serve_dist_ok(sd: dict, floor: dict, tol: float) -> bool:
    """The serve_dist gate (pure; pinned by a unit test): zero failed
    reads is ABSOLUTE (the tier's whole promise), every spawned host
    must actually have answered pulls (a silently dead host that never
    failed a read would otherwise pass), and aggregate pulls/s must
    clear the floor with the lane tolerance."""
    gate = floor.get("serve_dist_pulls_per_s_floor", 0.0) * (1.0 - tol)
    sd["gate_pulls_per_s"] = round(gate, 1)
    every_host_served = all(v.get("pulls", 0) > 0
                            for v in sd.get("per_host", {}).values())
    return (sd["failed_reads"] == 0
            and every_host_served
            and sd["pulls_per_s"] >= gate)


def _durability_ok(du: dict, floor: dict, tol: float) -> bool:
    """The durability gate (pure; pinned by a unit test): the journal
    must not tax the push path below the floor ratio, a cold start
    must replay above the MB/s floor, the replay must actually have
    read the records back (a 0-record replay would gate nothing), and
    a CLEAN journal must replay with zero damage detected — a torn
    tail or corrupt record on a fault-free bench run means the write
    path itself is producing garbage."""
    gate_r = floor.get("durability_push_ratio_floor", 0.0) * (1.0 - tol)
    gate_m = floor.get("durability_replay_mbps_floor", 0.0) * (1.0 - tol)
    du["gate_push_ratio"] = round(gate_r, 3)
    du["gate_replay_mbps"] = round(gate_m, 1)
    return (du["push_ratio"] >= gate_r
            and du["replay_mbps"] >= gate_m
            and du["replay_records"] > 0
            and du["truncated_tails"] == 0
            and du["corrupt_records"] == 0)


def _fleet_ok(fl: dict, floor: dict, tol: float) -> bool:
    """The fleet gate (pure; pinned by a unit test): zero failed reads
    through the churn is ABSOLUTE, the churn must actually have
    happened (spawns up to the peak AND at least one graceful drain
    back — a bench that never grew the fleet would gate nothing), the
    drains must have completed clean (none escalated to kill, none
    still draining), and pulls/s under churn must clear the floor with
    the lane tolerance."""
    gate = floor.get("fleet_pulls_per_s_floor", 0.0) * (1.0 - tol)
    fl["gate_pulls_per_s"] = round(gate, 1)
    churned = (fl.get("spawned", 0) >= fl.get("peak_hosts", 0)
               and fl.get("drained", 0) >= 1)
    drains_clean = (fl.get("drain_escalated", 0) == 0
                    and not fl.get("still_draining"))
    return (fl["failed_reads"] == 0
            and churned
            and drains_clean
            and fl["pulls_per_s"] >= gate)


# ----------------------------------------------------------- whole result

def measure_all(device) -> dict:
    """Every lane, in the JAX tool's order, in this process's group."""
    comm = _comm(device)
    try:
        out = _measure(comm)
        out["serve"] = _measure_serve(device)
        out["straggler"] = _measure_straggler(device)
        out["compressed"] = _measure_compressed(comm)
        out["sharded_update"] = _measure_sharded_update(comm)
        out["trace"] = _measure_trace(comm)
        out["ts_sampler"] = _measure_ts_sampler(comm)
        out["transport"] = _measure_transport(device)
        out["serve_dist"] = _measure_serve_dist(device)
        out["fleet"] = _measure_fleet(device)
        out["durability"] = _measure_durability(device)
    finally:
        comm.close()
    return out


def sharded_wire_contract(ranks: int) -> float:
    """The sharded update's wire-ratio ceiling at R ranks: push N + pull
    N/R over push N + pull N, (1 + 1/R) / 2, plus the JAX floor's margin
    for the small leaves that take the parts fallback at 1.0x (0.62 at
    R = 8, the JAX constant; 1.0575 at one rank, where the pull leg
    saves nothing)."""
    return round((1 + 1 / ranks) / 2 + 0.0575, 4)


def new_floor(out: dict, note: str) -> dict:
    """The floor file a measured ``out`` gives (``--update-floor``), by
    the JAX tool's rules: the engine's ratio and GB/s as measured; half
    the worst compressed throughput ratio, half the sharded step ratio,
    half the TCP/loopback ratio and half the durability push ratio; a
    tenth of serve_dist's and the fleet's pulls/s and of the replay
    MB/s; the contracts (wire ratios, quality ceiling, p99 ceilings,
    tracing and sampler floors) as constants, the sharded wire ceiling
    at the measured world (:func:`sharded_wire_contract`)."""
    worst_tput = min(lane["throughput_ratio"]
                     for lane in out["compressed"].values())
    return {"engine_vs_fused_ratio": out["engine_vs_fused_ratio"],
            "engine_8MB_gbps": out["engine_8MB_gbps"],
            "straggler_hedge_p99_factor": 2.0,
            "straggler_hedge_p99_abs_ms": 5.0,
            "compressed_wire_ratio_max": 0.35,
            "compressed_quality_ceiling": 0.55,
            "compressed_throughput_floor": round(worst_tput / 2, 3),
            "sharded_wire_ratio_max": sharded_wire_contract(
                out["sharded_update"]["ranks"]),
            "sharded_step_ratio_floor": round(
                out["sharded_update"]["step_time_ratio"] / 2, 3),
            "trace_sample_overhead_floor": 0.7,
            "ts_sampler_overhead_floor": 0.95,
            "transport_tcp_ratio_floor": round(
                out["transport"]["tcp_vs_loopback_ratio"] / 2, 3),
            "transport_partitioned_p99_ms": 50.0,
            "serve_dist_pulls_per_s_floor": round(
                out["serve_dist"]["pulls_per_s"] / 10, 1),
            "fleet_pulls_per_s_floor": round(
                out["fleet"]["pulls_per_s"] / 10, 1),
            "durability_push_ratio_floor": round(
                out["durability"]["push_ratio"] / 2, 3),
            "durability_replay_mbps_floor": round(
                out["durability"]["replay_mbps"] / 10, 1),
            "note": note}


def evaluate(out: dict, floor: dict, tol: float):
    """Gate a whole result against ``floor`` with tolerance ``tol``:
    ``(ok, failures)``, each failure a line naming the lane.  Marks each
    lane's ``ok`` (and its gates) in ``out``, as the JAX tool does.  The
    engine lane passes on either its ratio or its GB/s: when the host
    runs slow the bare collective's time swells and the ratio is honest,
    when it runs fast the engine is held to its fixed per-push host cost
    and the GB/s is.  A lane missing from ``out`` is not gated."""
    bad = []
    gate_r = floor["engine_vs_fused_ratio"] * (1.0 - tol)
    gate_a = floor["engine_8MB_gbps"] * (1.0 - tol)
    out["floor"] = {k: floor[k] for k in ("engine_vs_fused_ratio",
                                          "engine_8MB_gbps")}
    out["gate_ratio"] = round(gate_r, 3)
    out["gate_gbps"] = round(gate_a, 3)
    if not (out["engine_vs_fused_ratio"] >= gate_r
            or out["engine_8MB_gbps"] >= gate_a):
        bad.append(f"engine: engine_vs_fused_ratio "
                   f"{out['engine_vs_fused_ratio']} < gate {gate_r:.3f} "
                   f"AND engine_8MB_gbps {out['engine_8MB_gbps']} < gate "
                   f"{gate_a:.3f} (tolerance {tol:.0%})")
    if "straggler" in out:
        st = out["straggler"]
        st["ok"] = _straggler_ok(st, floor)
        if not st["ok"]:
            bad.append(f"straggler: hedged p99 {st['p99_hedged_ms']} ms > "
                       f"gate {st['gate_ms']} ms (no-fault "
                       f"{st['p99_nofault_ms']} ms)")
    if "compressed" in out and not _compressed_ok(out["compressed"], floor,
                                                  tol):
        bad.append("compressed: " + ", ".join(
            f"{k} {v}" for k, v in out["compressed"].items()
            if not v.get("ok")))
    for lane, fn in (("sharded_update", _sharded_update_ok),
                     ("trace", _trace_ok), ("ts_sampler", _ts_ok),
                     ("transport", _transport_ok),
                     ("serve_dist", _serve_dist_ok), ("fleet", _fleet_ok),
                     ("durability", _durability_ok)):
        if lane in out:
            out[lane]["ok"] = fn(out[lane], floor, tol)
            if not out[lane]["ok"]:
                bad.append(f"{lane}: {out[lane]}")
    out["ok"] = not bad
    return out["ok"], bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--update-floor", action="store_true",
                    help="measure, then rewrite the floor file from it")
    args = ap.parse_args(argv)
    tol = float(os.environ.get("BENCH_SMOKE_TOLERANCE", "0.30"))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_smoke: torch.cuda is not available (--device cpu "
              "runs it on the host)", file=sys.stderr)
        return 1
    out = measure_all(args.device)
    card = card_line(torch.device(args.device))
    out["card"] = card
    if args.update_floor:
        floor = new_floor(out, note=(
            f"measured floor on {card or args.device}; the lane fails "
            f"below ratio * (1 - tolerance)"))
        with open(FLOOR_PATH, "w") as f:
            json.dump(floor, f, indent=1)
            f.write("\n")
        out["floor_updated"] = floor
        print(json.dumps(out))
        return 0
    with open(FLOOR_PATH) as f:
        floor = json.load(f)
    ok, bad = evaluate(out, floor, tol)
    print(json.dumps(out))
    for line in bad:
        print(f"bench-smoke FAIL: {line}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
