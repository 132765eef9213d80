"""Serve bench of the port: pulls/sec and p99 pull latency under
concurrent pushes; port of ``tools/serve_bench.py``.

It stands up the port's parameter-serving plane (``server/serving.py``)
over a live ``KVStore`` on ``--device``, keeps a training pusher thread
summing deltas and cutting snapshots, and drives N concurrent pull
clients, reporting:

- ``pulls_per_s``: the clients' aggregate pull throughput;
- ``p50_ms`` / ``p99_ms``: per-pull latency quantiles as the clients see
  them (cache hits included when ``--staleness`` > 0);
- ``pushes_per_s``: the write load sustained while serving;
- ``delta``: a byte accounting check that a delta pull ships only the
  changed keys' bytes (the wire is byte-equal to the JAX package's).

``--hosts N`` is the distributed mode (``server/serving_tier.py``): N
``serve_host`` processes of the port behind the TCP transport, a
membership bus with the host directory, a ``ServingTier`` shipping
snapshot deltas along the ring, ring-routed clients; it reports per-host
pulls and latency too.  ``--fleet`` lets the fleet reconciler
(``launcher/reconciler.py``) spawn the hosts while the bench moves the
target up and down mid-storm.

    python -m byteps_tpu_torch.tools.serve_bench [--seconds S]
        [--clients N] [--keys K] [--numel E] [--replicas R]
        [--staleness SEC] [--hosts N | --fleet] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEVICE = "cuda"   # the planes' and the hosts' device (main's --device)


def delta_check(numel: int = 4096, keys: int = 4) -> dict:
    """Deterministic byte accounting: a full hydration costs the whole
    model; a delta pull after ONE changed key costs exactly that key's
    encoded bytes.  Returns the measured figures plus ``ok``."""
    import torch

    from ..server.kv_store import KVStore
    from ..server.serve_client import PullClient
    from ..server.serving import ServingPlane

    store = KVStore(DEVICE)
    dev = store.device
    names = [f"serve.delta.{i}" for i in range(keys)]
    for n in names:
        store.init_key(n, torch.zeros(numel, device=dev))
        store.push_delta(n, torch.ones(numel, device=dev))
    plane = ServingPlane(store, replicas=1, retention=8, device=dev)
    plane.cut()
    client = PullClient(plane, max_staleness_s=0.0, device=dev)
    client.pull()
    full_bytes = client.bytes_received
    store.push_delta(names[0], torch.ones(numel, device=dev))
    plane.cut()
    client.pull()
    delta_bytes = client.bytes_received - full_bytes
    key_bytes = numel * 4
    return {"model_bytes": keys * key_bytes,
            "full_pull_bytes": full_bytes,
            "delta_pull_bytes": delta_bytes,
            "changed_key_bytes": key_bytes,
            "ok": (full_bytes == keys * key_bytes
                   and delta_bytes == key_bytes)}


def measure(*, seconds: float = 2.0, clients: int = 4, keys: int = 8,
            numel: int = 65536, replicas: int = 3,
            staleness: float = 0.0) -> dict:
    """The concurrent-read/write measurement.  One pusher thread keeps
    training pushes landing (one cut per full key sweep, the per-step
    publication pattern); ``clients`` threads pull as fast as they can
    under the given staleness bound."""
    import numpy as np
    import torch

    from ..common.telemetry import counters
    from ..server.kv_store import KVStore
    from ..server.serve_client import PullClient
    from ..server.serving import ServingPlane

    store = KVStore(DEVICE)
    dev = store.device
    names = [f"serve.bench.{i}" for i in range(keys)]
    rng = np.random.RandomState(0)
    for n in names:
        store.init_key(n, torch.from_numpy(
            rng.randn(numel).astype(np.float32)).to(dev))
    plane = ServingPlane(store, replicas=replicas, retention=16, device=dev)
    plane.cut()
    # warm the hot-key histogram so replicas participate from the start
    warm = PullClient(plane, max_staleness_s=0.0, device=dev)
    warm.pull()
    plane.cut()

    stop = threading.Event()
    pushes = [0]

    def pusher():
        delta = torch.full((numel,), 1e-3, device=dev)
        i = 0
        while not stop.is_set():
            store.push_delta(names[i % keys], delta)
            pushes[0] += 1
            i += 1
            if i % keys == 0:
                plane.cut()

    lat_lock = threading.Lock()
    latencies: list = []
    pull_counts = [0] * clients
    errors = [0]

    def puller(idx: int):
        client = PullClient(plane, max_staleness_s=staleness, device=dev)
        mine = []
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                client.pull()
            except Exception:  # noqa: BLE001 — an erroring read is the
                # one thing the plane promises not to produce
                errors[0] += 1
                continue
            mine.append((time.perf_counter() - t0) * 1e3)
            pull_counts[idx] += 1
        with lat_lock:
            latencies.extend(mine)

    push_thread = threading.Thread(target=pusher, daemon=True)
    threads = [threading.Thread(target=puller, args=(i,), daemon=True)
               for i in range(clients)]
    c0 = counters.get("serve.cache_hits")
    t0 = time.perf_counter()
    push_thread.start()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    push_thread.join(timeout=10)
    wall = time.perf_counter() - t0

    total_pulls = sum(pull_counts)
    lat = np.asarray(latencies) if latencies else np.asarray([0.0])
    return {
        "seconds": round(wall, 3),
        "clients": clients,
        "keys": keys,
        "numel": numel,
        "replicas": replicas,
        "staleness_s": staleness,
        "pulls": total_pulls,
        "pulls_per_s": round(total_pulls / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)), 3),
        "p99_ms": round(float(np.percentile(lat, 99)), 3),
        "pushes": pushes[0],
        "pushes_per_s": round(pushes[0] / wall, 1),
        "failed_reads": errors[0],
        "cache_hits": counters.get("serve.cache_hits") - c0,
        "replica_reads": counters.get("serve.replica_reads"),
        "primary_reads": counters.get("serve.primary_reads"),
        "snapshot_cuts": counters.get("serve.snapshot_cuts"),
    }


def _await_host_up(p, timeout_s: float = 90.0) -> str:
    """First stdout line with a deadline: a host wedged before HOST-UP
    (import deadlock, bad env) must FAIL the bench, not hang it."""
    out: list = []
    t = threading.Thread(target=lambda: out.append(p.stdout.readline()),
                         daemon=True, name="serve-host-up")
    t.start()
    t.join(timeout_s)
    if not out:
        raise RuntimeError(
            f"serve host (pid {p.pid}) printed nothing within "
            f"{timeout_s}s — wedged before HOST-UP")
    return out[0]


def kill_serve_hosts(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except Exception:  # noqa: BLE001 — escalate, never leak
            p.kill()


def spawn_serve_hosts(n: int, bus_port: int, *, ttl_s: float = 5.0,
                      extra_env=None):
    """Spawn ``n`` real serving-host processes registered against the
    bus at ``bus_port``; returns the Popen list once every host printed
    HOST-UP (shared by the distributed bench and the chaos tests).  On
    any startup failure every already-spawned host is killed — no
    orphan processes left registered against a bus nobody will close."""
    import subprocess
    procs = []
    try:
        for i in range(n):
            env = dict(os.environ,
                       BYTEPS_SERVE_TIER_BUS=f"127.0.0.1:{bus_port}",
                       BYTEPS_SERVE_HOST_ID=str(i),
                       BYTEPS_SERVE_TIER_TTL=str(ttl_s),
                       BYTEPS_LOG_LEVEL="ERROR",
                       PYTHONPATH=REPO + os.pathsep + os.environ.get(
                           "PYTHONPATH", ""))
            env.update(extra_env(i) if callable(extra_env)
                       else (extra_env or {}))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.server.serve_host",
                 "--device", DEVICE],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for p in procs:
            line = _await_host_up(p)
            if "HOST-UP" not in line:
                raise RuntimeError(f"serve host failed to start: {line!r}")
            # keep draining after HOST-UP: a host that logs under chaos
            # (fault-injector warnings, transport errors) would
            # otherwise fill the 64 KiB pipe and BLOCK mid-log
            threading.Thread(target=lambda f=p.stdout: f.read(),
                             daemon=True, name="serve-host-drain").start()
    except BaseException:
        kill_serve_hosts(procs)
        raise
    return procs


def measure_distributed(*, hosts: int = 3, seconds: float = 3.0,
                        clients: int = 4, keys: int = 8,
                        numel: int = 16384, replicas: int = 2,
                        staleness: float = 0.0) -> dict:
    """The distributed measurement: real host processes, a live bus, a
    shipping publisher, ring-routed clients."""
    import socket as _socket

    import numpy as np

    import torch

    from ..common.telemetry import counters
    from ..fault.membership import MembershipView, _BusServer
    from ..server.kv_store import KVStore
    from ..server.serving_tier import ServingTier

    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    bus_port = s.getsockname()[1]
    s.close()
    bus = _BusServer(("127.0.0.1", bus_port), MembershipView(0, (0,)),
                     5.0, 5.0)
    procs = []
    tier = None
    try:
        procs = spawn_serve_hosts(hosts, bus_port)
        store = KVStore(DEVICE)
        dev = store.device
        names = [f"serve.dist.{i}" for i in range(keys)]
        rng = np.random.RandomState(0)
        for n in names:
            store.init_key(n, torch.from_numpy(
                rng.randn(numel).astype(np.float32)).to(dev))
        tier = ServingTier(store, bus=f"127.0.0.1:{bus_port}",
                           replicas=replicas, cut_interval_s=None,
                           ship_deadline_s=3.0)
        tier.cut()

        stop = threading.Event()
        pushes = [0]

        def pusher():
            delta = torch.full((numel,), 1e-3, device=dev)
            i = 0
            while not stop.is_set():
                store.push_delta(names[i % keys], delta)
                pushes[0] += 1
                i += 1
                if i % keys == 0:
                    tier.cut()

        lat_lock = threading.Lock()
        latencies: list = []
        per_host: dict = {}
        pull_counts = [0] * clients
        errors = [0]

        def puller(idx: int):
            client = tier.client(max_staleness_s=staleness, device=dev)
            router = client._plane
            mine = []
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    client.pull()
                except Exception:  # noqa: BLE001 — the tier's one promise
                    errors[0] += 1
                    continue
                mine.append((time.perf_counter() - t0) * 1e3)
                pull_counts[idx] += 1
            with lat_lock:
                latencies.extend(mine)
                for h, c in router.host_pulls.items():
                    per_host[h] = per_host.get(h, 0) + c

        push_thread = threading.Thread(target=pusher, daemon=True)
        threads = [threading.Thread(target=puller, args=(i,), daemon=True)
                   for i in range(clients)]
        t0 = time.perf_counter()
        push_thread.start()
        for t in threads:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in threads:
            t.join(timeout=15)
        push_thread.join(timeout=15)
        wall = time.perf_counter() - t0

        import numpy as _np
        total = sum(pull_counts)
        lat = _np.asarray(latencies) if latencies else _np.asarray([0.0])
        # per-host latency quantiles from the slowness tracker's windows
        from ..utils import slowness as _slowness
        snap = _slowness.tracker().snapshot().get("serve_pull", {})
        host_stats = {
            int(h): {"pulls": per_host.get(h, 0),
                     "p50_ms": (snap.get(h) or {}).get("median_ms", 0.0)}
            for h in sorted(tier.ring.hosts() | set(per_host))}
        # shed happens IN the host processes: their cumulative figures
        # ride the directory heartbeats (reading this process's
        # serve.shed counter would always print 0)
        dir_meta = tier.directory.info()["meta"]
        shed_total = sum(int(m.get("sheds", 0))
                         for m in dir_meta.values())
        return {
            "mode": "distributed",
            "hosts": hosts,
            "seconds": round(wall, 3),
            "clients": clients,
            "keys": keys,
            "numel": numel,
            "replicas": replicas,
            "staleness_s": staleness,
            "pulls": total,
            "pulls_per_s": round(total / wall, 1),
            "p50_ms": round(float(_np.percentile(lat, 50)), 3),
            "p99_ms": round(float(_np.percentile(lat, 99)), 3),
            "pushes_per_s": round(pushes[0] / wall, 1),
            "failed_reads": errors[0],
            "per_host": host_stats,
            "ring_gen": tier.debug_state()["gen"],
            "ships": counters.get("serve.tier_ships"),
            "ship_failures": counters.get("serve.tier_ship_failures"),
            "failovers": counters.get("serve.tier_failover"),
            "shed": shed_total,
        }
    finally:
        if tier is not None:
            tier.close()
        kill_serve_hosts(procs)
        bus.close()


def measure_fleet(*, seconds: float = 4.0, clients: int = 3,
                  keys: int = 6, numel: int = 16384, replicas: int = 2,
                  staleness: float = 0.1, base_hosts: int = 2,
                  peak_hosts: int = 4) -> dict:
    """Pulls/s and p99 DURING fleet churn: the fleet
    reconciler spawns the hosts (none are pre-spawned here), the bench
    drives the autoscaler's actuation channel — ``serve_scale`` target
    bumps on the bus — up to ``peak_hosts`` mid-storm and back down to
    ``base_hosts``, so the measurement window contains real spawns AND
    real graceful drains while the pull storm runs.  The gate: zero
    failed reads through all of it, and throughput above the floor."""
    import socket as _socket

    import numpy as np

    import torch

    from ..fault.membership import MembershipView, _BusServer
    from ..launcher.reconciler import FleetReconciler
    from ..server.kv_store import KVStore
    from ..server.serving_tier import ServingTier, TierDirectory

    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    bus_port = s.getsockname()[1]
    s.close()
    bus = _BusServer(("127.0.0.1", bus_port), MembershipView(0, (0,)),
                     5.0, 5.0)
    tier = None
    rec = None
    try:
        directory = TierDirectory(bus=f"127.0.0.1:{bus_port}", ttl_s=3.0)
        rec = FleetReconciler(
            directory=directory, interval_s=0.2, drain_deadline_s=8.0,
            spawn_env={"BYTEPS_LOG_LEVEL": "ERROR"}, device=DEVICE)
        rec_stop = threading.Event()
        rec_thread = threading.Thread(target=rec.run, args=(rec_stop,),
                                      daemon=True, name="fleet-bench-rec")
        directory.set_target(base_hosts)
        rec_thread.start()
        deadline = time.monotonic() + 90.0
        while len(directory.hosts(force=True)[1]) < base_hosts:
            if time.monotonic() > deadline:
                raise RuntimeError("reconciler never converged to the "
                                   "base fleet")
            time.sleep(0.1)

        store = KVStore(DEVICE)
        dev = store.device
        names = [f"serve.fleet.{i}" for i in range(keys)]
        rng = np.random.RandomState(0)
        for n in names:
            store.init_key(n, torch.from_numpy(
                rng.randn(numel).astype(np.float32)).to(dev))
        tier = ServingTier(store, bus=f"127.0.0.1:{bus_port}",
                           replicas=replicas, cut_interval_s=None,
                           ship_deadline_s=3.0)
        tier.cut()

        stop = threading.Event()
        pushes = [0]

        def pusher():
            delta = torch.full((numel,), 1e-3, device=dev)
            i = 0
            while not stop.is_set():
                store.push_delta(names[i % keys], delta)
                pushes[0] += 1
                i += 1
                if i % keys == 0:
                    tier.cut()

        lat_lock = threading.Lock()
        latencies: list = []
        pull_counts = [0] * clients
        errors = [0]

        def puller(idx: int):
            client = tier.client(max_staleness_s=staleness, device=dev)
            mine = []
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    client.pull()
                except Exception:  # noqa: BLE001 — zero failed reads
                    # through the churn is THE fleet promise
                    errors[0] += 1
                    continue
                mine.append((time.perf_counter() - t0) * 1e3)
                pull_counts[idx] += 1
            with lat_lock:
                latencies.extend(mine)

        churn_done = threading.Event()

        def _await_fleet(n: int, deadline_s: float) -> bool:
            end = time.monotonic() + deadline_s
            while time.monotonic() < end and not stop.is_set():
                if len(directory.hosts(force=True)[1]) == n \
                        and not rec.debug_state()["draining"]:
                    return True
                time.sleep(0.1)
            return False

        def churner():
            """The autoscaler's actuation channel, STATE-driven: bump
            the target to the peak and wait for the spawned hosts to
            actually register (a serve_host cold-starts in seconds —
            a fixed schedule would end the storm before the fleet ever
            grew), then drop back to base and wait for the drains to
            complete.  Both transitions land inside the measurement
            window because the window ends only after this does."""
            if stop.wait(max(seconds / 4.0, 0.5)):
                return
            directory.set_target(peak_hosts)
            _await_fleet(peak_hosts, 60.0)
            directory.set_target(base_hosts)
            _await_fleet(base_hosts, 60.0)
            churn_done.set()

        push_thread = threading.Thread(target=pusher, daemon=True)
        churn_thread = threading.Thread(target=churner, daemon=True)
        threads = [threading.Thread(target=puller, args=(i,), daemon=True)
                   for i in range(clients)]
        t0 = time.perf_counter()
        push_thread.start()
        churn_thread.start()
        for t in threads:
            t.start()
        # the storm runs until the churn completes (spawns registered,
        # drains landed), with `seconds` as the minimum and a hard cap
        # as the wedge guard
        churn_done.wait(timeout=150.0)
        remaining = seconds - (time.perf_counter() - t0)
        if remaining > 0:
            time.sleep(remaining)
        stop.set()
        for t in threads:
            t.join(timeout=15)
        push_thread.join(timeout=15)
        churn_thread.join(timeout=15)
        wall = time.perf_counter() - t0

        import numpy as _np
        from ..common.telemetry import counters
        total = sum(pull_counts)
        lat = _np.asarray(latencies) if latencies else _np.asarray([0.0])
        state = rec.debug_state()
        return {
            "mode": "fleet",
            "seconds": round(wall, 3),
            "clients": clients,
            "base_hosts": base_hosts,
            "peak_hosts": peak_hosts,
            "pulls": total,
            "pulls_per_s": round(total / wall, 1),
            "p50_ms": round(float(_np.percentile(lat, 50)), 3),
            "p99_ms": round(float(_np.percentile(lat, 99)), 3),
            "pushes_per_s": round(pushes[0] / wall, 1),
            "failed_reads": errors[0],
            "spawned": counters.get("reconcile.spawned"),
            "drain_started": counters.get("reconcile.drain_started"),
            "drained": counters.get("reconcile.drained"),
            "drain_escalated": counters.get("reconcile.drain_escalated"),
            "banned": counters.get("reconcile.banned"),
            "final_hosts": len(directory.hosts(force=True)[1]),
            "still_draining": state["draining"],
        }
    finally:
        if tier is not None:
            tier.close()
        if rec is not None:
            rec.close(kill_hosts=True)
        bus.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--keys", type=int, default=8)
    p.add_argument("--numel", type=int, default=65536)
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--staleness", type=float, default=0.0)
    p.add_argument("--hosts", type=int, default=0,
                   help="N > 0: distributed mode with N real "
                        "serving-host processes")
    p.add_argument("--fleet", action="store_true",
                   help="fleet mode: the reconciler spawns the hosts "
                        "and the bench churns the target mid-storm")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    global DEVICE
    DEVICE = args.device
    if args.fleet:
        out = measure_fleet(
            seconds=args.seconds, clients=args.clients, keys=args.keys,
            numel=args.numel, replicas=args.replicas,
            staleness=args.staleness or 0.1)
        print(json.dumps(out))
        return 0 if out["failed_reads"] == 0 else 1
    if args.hosts > 0:
        out = measure_distributed(
            hosts=args.hosts, seconds=args.seconds, clients=args.clients,
            keys=args.keys, numel=args.numel,
            replicas=min(args.replicas, args.hosts),
            staleness=args.staleness)
        print(json.dumps(out))
        return 0 if out["failed_reads"] == 0 else 1
    out = measure(seconds=args.seconds, clients=args.clients,
                  keys=args.keys, numel=args.numel,
                  replicas=args.replicas, staleness=args.staleness)
    out["delta"] = delta_check()
    from ._bench_util import conditions_block
    out["conditions"] = conditions_block(device=DEVICE)
    print(json.dumps(out))
    return 0 if (out["failed_reads"] == 0 and out["delta"]["ok"]) else 1


if __name__ == "__main__":
    sys.exit(main())
