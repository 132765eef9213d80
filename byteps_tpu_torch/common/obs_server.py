"""Per-process HTTP observability endpoint; port of
``byteps_tpu/common/obs_server.py``.

``BYTEPS_OBS_PORT`` arms a small threaded HTTP server (off by default;
``0`` = an OS-assigned port, read from :attr:`ObsServer.port`):

- ``/metrics``: the whole metrics registry in Prometheus text (names
  ``byteps_<name>``), with the engine's live gauges (scheduler depth,
  bytes in flight, push_pull MB/s) refreshed at scrape time;
- ``/healthz``: JSON liveness (membership epoch, engine run state, the
  age of the last heartbeat reply when ``init()`` or the membership
  armed the heartbeat, push_pull speed, current step, under elastic
  membership who hosts the control plane, and one line each for the
  serving planes and tier, the durable journals and the fleet
  reconciler of this process); HTTP 503 with
  ``degraded: true`` and
  the firing rules while any ``common/health.py`` alert is active;
- ``/debug/state``: JSON internals (scheduler, planner, last step, the
  server engines' quarantined rounds, the stores' dedup floors, the TCP
  transport's connections and servers, the serving planes, the serving
  tier (publisher or host), the durable journals, the fleet reconciler,
  the slowness scores, the flight recorder's fill, the tracer, the
  time-series window, the health alerts, the membership view and its
  failover replica);
- ``/timeseries``: the raw time-series ring.

Both documents carry an ``omitted`` list naming the sections of the JAX
package's documents that the port leaves out: none are left.

Started once per process by ``init()`` and not stopped by
``shutdown()``: an elastic suspend/resume keeps the endpoint and its
port, and handlers read the current engine through ``core.api`` on
every request.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import metrics as _metrics
from .logging import get_logger

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _refresh_live_gauges() -> None:
    """Stamp point-in-time gauges from the live components at scrape
    time (the dispatch loop only samples them once per iteration, which
    can be long ago on an idle engine)."""
    from ..core import api
    gauges = _metrics.gauges
    eng = api._engine
    if eng is not None:
        try:
            gauges.set("engine.sched_pending", eng.scheduler.pending)
            gauges.set("engine.bytes_in_flight",
                       eng.scheduler.bytes_in_flight)
            gauges.set("engine.pushpull_mbps", eng.speed.speed()[1])
            gauges.set("engine.running", 1 if eng._running else 0)
        except Exception:  # noqa: BLE001 — a mid-shutdown engine is fine
            pass
    else:
        gauges.set("engine.running", 0)
    # wire_bytes/wire_bytes_wasted need no refresh here: KVStore's
    # _account_wire maintains the process-wide counters on the same
    # mutations that move the per-store attributes — one series, one
    # writer (a scrape-time gauge beside the counter would be a second,
    # divergence-prone copy of the same figure)


# sections of the JAX package's documents that the port leaves out
OMITTED: tuple = ()


def _plane_health() -> dict:
    """The serving, durable and reconciler lines of ``/healthz``: a few
    fields of each registered component's debug state."""
    serving = []
    for kind in ("serving_plane", "serving_tier"):
        for c in _metrics.components(kind):
            st = c.debug_state()
            serving.append({"kind": st["kind"],
                            "snapshot_id": st.get("snapshot_id")})
    wal = []
    for c in _metrics.components("wal"):
        st = c.debug_state()
        wal.append({"lsn": st["lsn"], "fsync": st["fsync"],
                    "checkpoint_lsn": st.get("checkpoint_lsn"),
                    "lag_bytes": st["lag_bytes"]})
    reconciler = []
    for c in _metrics.components("reconciler"):
        st = c.debug_state()
        reconciler.append({k: st[k] for k in ("supervised", "draining",
                                              "banned")})
    return {"serving": serving, "wal": wal, "reconciler": reconciler}


def healthz() -> dict:
    """The /healthz document (also unit-testable without HTTP).  The
    ``ok``/``degraded`` pair mirrors the HTTP status the handler sends:
    503 while any health rule fires, 200 otherwise."""
    import time

    from . import health as _health
    from ..core import api
    from ..fault import membership as _membership
    eng = api._engine
    hb = api._heartbeat
    m = _membership.active_membership()
    if m is not None and m.heartbeat is not None:
        # the membership-managed monitor (re-hosted per world change)
        # supersedes the static auto-armed one
        hb = m.heartbeat
    alerts = _health.active_alerts()
    doc = {
        "ok": not alerts,
        "degraded": bool(alerts),
        "alerts": sorted(alerts),
        "alert_details": alerts,
        "ts": time.time(),
        "membership_epoch": _membership.current_epoch(),
        "engine_running": bool(eng is not None and eng._running),
        "last_heartbeat_age_s": (round(hb.last_beat_age(), 3)
                                 if hb is not None else None),
        "omitted": list(OMITTED),
    }
    doc.update(_plane_health())
    if m is not None:
        # who hosts the control plane right now (coordinator failover
        # visibility: bps_top and operators read this)
        v = m.view()
        doc["membership"] = {
            "rank": m.rank,
            "world": list(v.world),
            "coordinator": v.coordinator,
            "standby": m.standby_rank,
            "is_coordinator": m.is_coordinator,
            "hosting_bus": m.hosting_bus,
            "bus_addr": "%s:%d" % tuple(m.bus_addr),
            "heartbeat_server_rank": (hb.server_rank
                                      if hb is not None else None),
        }
    if eng is not None:
        ts, mbps = eng.speed.speed()
        doc["pushpull_mbps"] = round(mbps, 3)
        doc["pushpull_speed_ts"] = ts
        doc["step"] = eng.step_stats.current_step
    return doc


def debug_state() -> dict:
    """The /debug/state document: engine scheduler + planner internals,
    per-component quarantine/dedup state, flight-recorder fill, the
    tracer, the time-series window and the health alerts."""
    from . import flight_recorder as _flight
    from . import health as _health
    from . import timeseries as _ts
    from . import tracing as _tracing
    from ..core import api
    from ..fault import membership as _membership
    eng = api._engine
    doc: dict = {
        "engine": None,
        "server_engines": [c.debug_state()
                           for c in _metrics.components("server_engine")],
        "kv_stores": [c.debug_state()
                      for c in _metrics.components("kv_store")],
        "serving_planes": [c.debug_state()
                           for c in _metrics.components("serving_plane")],
        # the serving tier (server/serving_tier.py): the publisher's ring
        # and ship state on a trainer, the host core's staged, committed
        # and shed state on a serving host
        "serving_tier": [c.debug_state()
                         for c in _metrics.components("serving_tier")],
        # the fleet reconciler (launcher/reconciler.py): supervised
        # hosts, pending crash-loop restarts, draining set, ban list
        "reconciler": [c.debug_state()
                       for c in _metrics.components("reconciler")],
        # the durable state plane (server/wal.py): journal position,
        # fsync policy, live segments, cold-start replay lag
        "wal": [c.debug_state()
                for c in _metrics.components("wal")],
        # the TCP transport (comm/transport.py): per-connection state
        # machines and per-server attachment and peer views
        "transport": {
            "servers": [c.debug_state()
                        for c in _metrics.components("transport_server")],
            "connections": [c.debug_state()
                            for c in _metrics.components("transport_conn")],
        },
        "flight_recorder": {
            "enabled": _flight.recorder.enabled,
            "events": len(_flight.recorder),
            "capacity": _flight.recorder._ring.maxlen,
        },
        "trace": _tracing.tracer().debug_state(),
        "membership_epoch": _membership.current_epoch(),
        "omitted": list(OMITTED),
    }
    store = _ts.get_store()
    doc["timeseries"] = (None if store is None else
                         {"len": len(store.points()),
                          "window": store.window,
                          "interval_s": store.interval_s})
    doc["health"] = {"active_alerts": _health.active_alerts()}
    m = _membership.active_membership()
    if m is not None:
        v = m.view()
        doc["membership"] = {
            "epoch": v.epoch,
            "world": list(v.world),
            "coordinator": v.coordinator,
            "standby": m.standby_rank,
            "hosting_bus": m.hosting_bus,
            "bus_addr": "%s:%d" % tuple(m.bus_addr),
            # failover readiness: does this rank hold a replica to seed
            # a successor bus from, and how fresh is it?
            "replica": {"held": m._replica is not None,
                        "epoch": (m._replica or {}).get("epoch")},
        }
    # per-(site, peer) latency medians and phi scores, the labeled gauges
    # re-stamped so a /metrics scrape after this sees the same figures
    from ..utils import slowness as _slowness
    doc["slowness"] = _slowness.tracker().publish_gauges()
    if eng is not None:
        try:
            doc["engine"] = {
                "running": bool(eng._running),
                "sched_pending": eng.scheduler.pending,
                "bytes_in_flight": eng.scheduler.bytes_in_flight,
                "credit_bytes": eng.scheduler.credit_bytes,
                "dispatches": eng.stats["dispatches"],
                "chunks": eng.stats["chunks"],
                "planner": eng.planner.snapshot(),
                "step": (eng.step_stats.last().as_dict()
                         if eng.step_stats.last() else None),
            }
        except Exception as e:  # noqa: BLE001 — mid-teardown races
            doc["engine"] = {"error": str(e)}
    return doc


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server API
        status = 200
        try:
            if self.path == "/metrics":
                _refresh_live_gauges()
                body = _metrics.registry.render_prometheus().encode()
                ctype = PROMETHEUS_CONTENT_TYPE
            elif self.path == "/healthz":
                doc = healthz()
                # a degraded rank answers 503 so external probes (load
                # balancers, supervisors) see sickness without parsing
                status = 200 if doc["ok"] else 503
                body = json.dumps(doc, default=str).encode()
                ctype = "application/json"
            elif self.path == "/debug/state":
                body = json.dumps(debug_state(), default=str).encode()
                ctype = "application/json"
            elif self.path == "/timeseries":
                from . import timeseries as _ts
                store = _ts.get_store()
                doc = store.dump() if store is not None else {
                    "len": 0, "points": [],
                    "disabled": "BYTEPS_TS_ON=0 or init() not called"}
                body = json.dumps(doc, default=str).encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown route (try /metrics, "
                                     "/healthz, /debug/state, "
                                     "/timeseries)")
                return
        except Exception as e:  # noqa: BLE001 — a scrape must not 500 silently
            body = json.dumps({"error": str(e)}).encode()
            status = 500
            ctype = "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        get_logger().debug("obs: " + fmt, *args)


class ObsServer:
    """One process's observability endpoint."""

    def __init__(self, host: str, port: int):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]  # resolved (port 0)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.25},
            daemon=True, name="bps-obs-http")
        self._thread.start()
        get_logger().info("observability endpoint: http://%s:%d "
                          "(/metrics /healthz /debug/state /timeseries)",
                          host, self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=2)
        self._httpd.server_close()


_server: Optional[ObsServer] = None
_server_lock = threading.Lock()


def ensure_started(cfg) -> Optional[ObsServer]:
    """Start the process-wide endpoint if ``cfg.obs_port`` asks for one
    and none is running yet (idempotent across elastic suspend/resume —
    the endpoint and its port outlive any single engine).  A bind
    failure raises: the operator set the knob, silence would be a lie."""
    global _server
    with _server_lock:
        if _server is not None or cfg.obs_port is None:
            return _server
        _server = ObsServer(cfg.obs_host, cfg.obs_port)
        return _server


def get_server() -> Optional[ObsServer]:
    return _server


def stop_server() -> None:
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
