"""Standalone serving-host process:
``python -m byteps_tpu_torch.server.serve_host [--device cuda|cpu]``;
port of ``byteps_tpu/server/serve_host.py``.

The first runtime role beside trainer and coordinator: a process whose
whole job is answering serving pulls.  It binds a
:class:`~byteps_tpu_torch.comm.transport.TransportServer`, attaches a
:class:`~byteps_tpu_torch.server.serving_tier.ServingHostCore` (stage/commit
publication, shed-aware pulls), registers with the membership bus's
serving-host directory, and keeps re-registering inside the TTL — the
directory heartbeat doubling as the tier's liveness signal.  Each
re-registration carries the host's cumulative pull/shed counts and hot
keys, the signals the autoscaler reads; a metrics snapshot is also
pushed to the bus (``metrics_put`` at ``SERVE_RANK_BASE + host_id``) so
``bps_top`` renders the host as a first-class row.

``--device`` (default ``cuda``) is where the host decodes shipped codec
keys (onebit's unpack kernel on a card); without CUDA ``--device cuda``
fails at start, never falling back to the CPU.

Environment:

- ``BYTEPS_SERVE_TIER_BUS``    — membership-bus ``host:port`` (optional;
  without it the host only prints its address for a static directory)
- ``BYTEPS_SERVE_HOST_ID``     — fixed host id (default: bus-allocated)
- ``BYTEPS_SERVE_HOST_BIND``   — ``host:port`` to listen on
  (default ``127.0.0.1:0`` = ephemeral)
- ``BYTEPS_FAULT_SPEC``        — chaos schedule, validated at start
  (``kill:site=serve_host:step=N`` dies at the Nth answered pull)
- ``BYTEPS_DURABLE_DIR``       — durable state plane root (server/wal.py);
  when set, the committed arc persists to
  ``<dir>/serve-<host_id>/arc.bin`` and a restart restores it from
  local disk BEFORE registering (``HOST-RESTORED <host_id> <commit>``)
  so the publisher re-ships nothing on the happy path

Prints ``HOST-UP <host_id> <host> <port>`` once serving (and, at a clean
exit, ``HOST-LAUNCHES <host_id> <json>``, the onebit kernels it
launched), then runs until
SIGTERM/SIGINT (clean: unregister, close), a graceful drain
(``serve_ctl drain``: mark the directory DRAINING, finish in-flight
pulls, final unregister handshake, print ``HOST-DRAINED <host_id>``,
exit 0), or the chaos injector kills it
(``kill:site=serve_host_start:step=1`` dies before HOST-UP — the
deterministic crash-looper the reconciler's flap ban is tested with).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time

__all__ = ["main"]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="serving-host process")
    ap.add_argument("--device", default="cuda",
                    help="where shipped codec keys are decoded "
                         "(cuda or cpu; default cuda)")
    args = ap.parse_args(argv)
    from ..common.config import get_config
    from ..common.logging import get_logger
    from ..comm import transport as tp
    from ..core.api import metrics_snapshot
    from ..fault import injector as inj
    from ..fault.membership import SERVE_RANK_BASE, bus_request
    from .serving_tier import ServingHostCore, TierDirectory

    cfg = get_config()
    # bpslint: ignore[env-knob] reason=per-process launch identity (like DMLC_WORKER_ID) consumed once at entrypoint start, before any Config is constructed or shared; documented in env.md
    bind = os.environ.get("BYTEPS_SERVE_HOST_BIND", "127.0.0.1:0")
    bind_host, bind_port = bind.rsplit(":", 1)
    # bpslint: ignore[env-knob] reason=per-process launch identity (like DMLC_WORKER_ID) consumed once at entrypoint start, before any Config is constructed or shared; documented in env.md
    want_id = os.environ.get("BYTEPS_SERVE_HOST_ID")
    want_id = int(want_id) if want_id not in (None, "") else None

    spec = cfg.fault_spec
    if spec:
        inj.arm(spec, seed=cfg.fault_seed,
                rank=want_id if want_id is not None else 0)

    core = ServingHostCore(host_id=want_id if want_id is not None else 0,
                           device=args.device)
    if core.restored_commit:
        # durable restart-in-place (server/wal.py): the committed arc
        # came back from local disk BEFORE registration, so the
        # publisher's next cut carries every unchanged key forward
        # instead of re-shipping the full arc over DCN
        print(f"HOST-RESTORED {core.host_id} {core.restored_commit}",
              flush=True)
    srv = tp.TransportServer(host=bind_host, port=int(bind_port),
                             rank=SERVE_RANK_BASE + core.host_id,
                             serving=core, tier=core)
    directory = TierDirectory()
    hid = core.host_id
    if directory.bus is not None:
        hid = directory.register(srv.addr, host_id=want_id,
                                 meta={"pulls": 0, "sheds": 0, "hot": []})
        if hid != core.host_id:
            # bus-allocated id: adopt it everywhere the identity matters
            core.host_id = hid
            core.server.server_id = hid
            if spec:
                inj.arm(spec, seed=cfg.fault_seed, rank=hid)
    if inj.ENABLED:
        # the startup kill site: a ``kill:site=serve_host_start`` rule
        # dies HERE — registered (the directory will see the flap) but
        # before HOST-UP, the launch-crash the reconciler's crash-loop
        # backoff and flap ban must absorb
        inj.on_serve_start()
    print(f"HOST-UP {hid} {srv.host} {srv.port}", flush=True)

    stop = threading.Event()

    def _sig(_s, _f):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)

    def heartbeat():
        """Directory TTL refresh + autoscaler signals + bps_top row.
        Drain-aware: once the drain latch is set, every beat re-asserts
        the DRAINING mark (a plain re-registration would clear it and
        flap the host back into the ring mid-drain)."""
        while not stop.wait(max(directory.ttl_s / 3.0, 0.5)):
            if directory.bus is None:
                continue
            try:
                directory.register(
                    srv.addr, host_id=hid,
                    draining=core.draining.is_set(),
                    meta={"pulls": core.pulls, "sheds": core.sheds,
                          "hot": core.hot_keys(8), "role": "serve"})
                snap = metrics_snapshot(light=True)
                snap["role"] = "serve"
                snap["host_id"] = hid
                bus_request(directory.bus,
                            {"op": "metrics_put",
                             "rank": SERVE_RANK_BASE + hid,
                             "metrics": snap}, timeout=5.0)
            except (ConnectionError, TimeoutError):
                # bus unreachable OR stalled (bus_request raises
                # MembershipTimeout, a TimeoutError, when an
                # established connection hangs — e.g. mid-coordinator-
                # failover): the TTL gives us a grace window; keep
                # serving and retry on the next beat.  The heartbeat
                # thread must never die — a healthy serving host
                # silently TTL-ing out of every client's ring is a
                # capacity loss nothing would ever report.
                get_logger().warning(
                    "serve host %d: bus unreachable or stalled", hid)

    threading.Thread(target=heartbeat, daemon=True,
                     name=f"bps-serve-host-hb-{hid}").start()
    drained = False
    try:
        while not stop.wait(0.25):
            if core.draining.is_set():
                break
        if core.draining.is_set() and not stop.is_set():
            # -- the graceful drain state machine --------------------
            # 1) mark the directory: the gen bump re-routes every
            #    consumer off this arc at its next sync
            if directory.bus is not None:
                try:
                    directory.register(
                        srv.addr, host_id=hid, draining=True,
                        meta={"pulls": core.pulls, "sheds": core.sheds,
                              "hot": core.hot_keys(8), "role": "serve"})
                except (ConnectionError, TimeoutError):
                    get_logger().warning(
                        "serve host %d: drain mark could not reach the "
                        "bus (heartbeat retries)", hid)
            # 2) in-flight pulls finish.  Quiet for a short settle
            #    window, not just a zero sample: stale routers (one
            #    sync interval behind the gen bump) may still land a
            #    last pull — answered normally, never refused.  The
            #    deadline bounds a wedged drain; the reconciler's own
            #    deadline escalates to kill beyond it.
            deadline = (time.monotonic()
                        + cfg.reconcile_drain_deadline_s)
            quiet_t = None
            while time.monotonic() < deadline and not stop.is_set():
                if core.admission.inflight > 0:
                    quiet_t = None
                elif quiet_t is None:
                    quiet_t = time.monotonic()
                elif time.monotonic() - quiet_t >= 0.3:
                    break
                time.sleep(0.05)
            drained = True
    finally:
        # 3) the final unregister handshake (clears the DRAINING mark
        #    on the bus), then clean exit
        if directory.bus is not None:
            try:
                directory.unregister(hid)
            except Exception:  # noqa: BLE001 — TTL finishes the job
                pass
        srv.close()
    if drained:
        print(f"HOST-DRAINED {hid} {core.pulls}", flush=True)
    ok = sys.modules.get("byteps_tpu_torch.ops.onebit_kernels")
    if ok is not None:
        # the kernels this host launched (its decodes at receipt)
        import json
        print(f"HOST-LAUNCHES {hid} {json.dumps(dict(ok.launches))}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
