"""SLO/health engine: declarative rules over the time-series window;
port of ``byteps_tpu/common/health.py``.

Each rule of :data:`RULE_IDS` is evaluated once per sampling tick
against the local ring, with K-window hysteresis in both directions: a
rule fires after ``BYTEPS_HEALTH_WINDOWS`` consecutive breaching windows
and clears after as many clean ones.  On firing the engine records a
flight-recorder ``alert`` event, sets ``health.alerts_active{rule=}`` to
1, and ``/healthz`` answers 503 until every rule clears.

The cluster-history provider (the ``attrib_skew`` rule) is registered
by the membership bus on the rank that hosts it
(``fault/membership.py`` ``_BusServer``), and the quorum provider
(``quorum_loss``) by the gossip agent (``fault/gossip.py``) under
``BYTEPS_GOSSIP_ON``.  ``slow_peer`` reads the sampled ``slow_score`` (the
``slowness.max_score`` gauge, which ``utils/slowness.py`` publishes) against
``slowness_phi``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from . import flight_recorder
from .telemetry import ATTRIB_GAUGE_NAMES, counters, gauges

# Every rule the engine can fire — one literal per id (the bpslint
# health-rule table is checked against this tuple's spellings).
RULE_IDS = (
    "overlap_floor",
    "retransmit_burn",
    "shed_burn",
    "conn_reset_burn",
    "ef_growth",
    "attrib_skew",
    "slow_peer",
    "quorum_loss",
)

_BURN_RULES = {
    "retransmit_burn": "retransmit",
    "shed_burn": "shed",
    "conn_reset_burn": "conn_resets",
}

# a component mean below this is noise, never skew (ms)
_SKEW_FLOOR_MS = 5.0


def attrib_skew_findings(history: Dict[int, dict], ratio: float,
                         floor_ms: float = _SKEW_FLOOR_MS) -> List[dict]:
    """Cross-rank attribution skew, as a pure function over a cluster
    history map (``{rank: summary}`` — the bus's piggybacked windows).

    For each attribution component: a rank whose window-mean exceeds
    ``ratio`` times the cluster median (and the absolute floor) is
    skewed.  Shared by the engine (bus-hosting rank) and by
    ``tools/bps_doctor.py`` live mode, so both name the same culprit.
    """
    out: List[dict] = []
    if len(history) < 2:
        return out
    for comp in ATTRIB_GAUGE_NAMES:
        key = f"attrib_{comp}"
        means = {}
        for rank, summ in history.items():
            s = (summ or {}).get("series", {}).get(key)
            if s is not None:
                means[rank] = float(s.get("mean", 0.0))
        if len(means) < 2:
            continue
        vals = sorted(means.values())
        median = vals[len(vals) // 2] if len(vals) % 2 else (
            (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]) / 2.0)
        for rank, mean in means.items():
            if mean >= floor_ms and mean > ratio * max(median, 1e-9):
                out.append({"rank": rank, "component": comp,
                            "mean_ms": round(mean, 3),
                            "median_ms": round(median, 3)})
    out.sort(key=lambda f: -f["mean_ms"])
    return out


class _RuleState:
    __slots__ = ("breaches", "clears", "active", "detail")

    def __init__(self):
        self.breaches = 0
        self.clears = 0
        self.active = False
        self.detail: dict = {}


class HealthEngine:
    """Rule state machine: breach predicates + K-window hysteresis."""

    def __init__(self, cfg):
        self.k = int(cfg.health_windows)
        self.overlap_floor = float(cfg.health_overlap_floor)
        self.burn_rate = float(cfg.health_burn_rate)
        self.skew_ratio = float(cfg.health_skew_ratio)
        self.slow_phi = float(cfg.slowness_phi)
        self._states = {rid: _RuleState() for rid in RULE_IDS}
        self._lock = threading.Lock()

    # -- breach predicates (pure over the window) -----------------------

    def _breaches(self, store) -> Dict[str, Optional[dict]]:
        pts = store.points()
        out: Dict[str, Optional[dict]] = {rid: None for rid in RULE_IDS}
        if not pts:
            return out
        last = pts[-1]
        interval = max(store.interval_s, 1e-9)

        # overlap floor: only judged while steps actually complete —
        # an idle rank has no overlap to breach
        if last.get("steps", 0) > 0 and "overlap" in last \
                and last["overlap"] < self.overlap_floor:
            out["overlap_floor"] = {
                "overlap": round(last["overlap"], 4),
                "floor": self.overlap_floor}

        for rid, key in _BURN_RULES.items():
            rate = last.get(key, 0.0) / interval
            if rate > self.burn_rate:
                out[rid] = {"rate_per_s": round(rate, 3),
                            "burn_rate": self.burn_rate}

        # unbounded growth: the worst error-feedback norm rising
        # monotonically across at least K+1 samples, up >= 1.5x
        vals = [v for _, v in store.values("ef_norm")]
        tail = vals[-(2 * self.k + 2):]
        if (len(tail) >= self.k + 1 and tail[-1] > 0
                and all(b >= a - 1e-9 for a, b in zip(tail, tail[1:]))
                and tail[-1] >= max(tail[0], 1e-9) * 1.5):
            out["ef_growth"] = {"first": round(tail[0], 4),
                                "last": round(tail[-1], 4),
                                "samples": len(tail)}

        score = last.get("slow_score", 0.0)
        if score >= self.slow_phi:
            out["slow_peer"] = {"phi": round(score, 3),
                                "threshold": self.slow_phi}

        provider = _cluster_history_provider
        if provider is not None:
            try:
                skews = attrib_skew_findings(provider(), self.skew_ratio)
            except Exception:  # noqa: BLE001 — a bus hiccup must not
                skews = []     # wedge the sampler tick
            if skews:
                out["attrib_skew"] = {"worst": skews[0],
                                      "count": len(skews)}

        # quorum loss: the gossip plane says a strict majority of the
        # last agreed world is NOT reachable from here — this side of a
        # partition cannot commit epochs (fault/gossip.py quorum_ok)
        qprov = _quorum_provider
        if qprov is not None:
            try:
                q = qprov() or {}
                reach = int(q.get("reachable", 0))
                world = int(q.get("world", 0))
            except Exception:  # noqa: BLE001 — same tick-safety contract
                reach = world = 0
            if world >= 2 and 2 * reach <= world:
                out["quorum_loss"] = {"reachable": reach, "world": world}
        return out

    # -- the state machine ----------------------------------------------

    def evaluate(self, store) -> None:
        counters.inc("health.evals")
        breaches = self._breaches(store)
        with self._lock:
            for rid, detail in breaches.items():
                st = self._states[rid]
                if detail is not None:
                    st.breaches += 1
                    st.clears = 0
                    st.detail = detail
                    if not st.active and st.breaches >= self.k:
                        st.active = True
                        counters.inc("health.alerts_fired")
                        gauges.set("health.alerts_active", 1, rule=rid)
                        flight_recorder.record("alert", rule=rid,
                                               state="firing", **detail)
                else:
                    st.clears += 1
                    st.breaches = 0
                    if st.active and st.clears >= self.k:
                        st.active = False
                        gauges.set("health.alerts_active", 0, rule=rid)
                        flight_recorder.record("alert", rule=rid,
                                               state="cleared")

    def active_alerts(self) -> Dict[str, dict]:
        with self._lock:
            return {rid: dict(st.detail)
                    for rid, st in self._states.items() if st.active}


_engine_lock = threading.Lock()
_engine: Optional[HealthEngine] = None
_enabled = True
_cluster_history_provider: Optional[Callable[[], Dict[int, dict]]] = None
_quorum_provider: Optional[Callable[[], Dict[str, int]]] = None


def configure(cfg) -> None:
    """(Re)build the engine from a Config — ``bps.init()`` calls this
    so re-init after an elastic transition refreshes thresholds without
    losing the ring underneath."""
    global _engine, _enabled
    with _engine_lock:
        _enabled = bool(getattr(cfg, "health_on", True))
        if _enabled and _engine is None:
            _engine = HealthEngine(cfg)


def set_cluster_history_provider(
        fn: Optional[Callable[[], Dict[int, dict]]]) -> None:
    """Registered by the membership bus server on the rank that hosts
    it: a zero-copy view of the cluster's piggybacked window summaries,
    so the skew rule (and only that rank) judges cross-rank divergence."""
    global _cluster_history_provider
    _cluster_history_provider = fn


def clear_cluster_history_provider(fn) -> None:
    """Unregister ``fn`` if it is still the active provider (a dying
    bus must not clear the provider a failover successor installed)."""
    global _cluster_history_provider
    if _cluster_history_provider is fn:
        _cluster_history_provider = None


def set_quorum_provider(
        fn: Optional[Callable[[], Dict[str, int]]]) -> None:
    """Registered by the gossip agent: returns ``{"reachable": R,
    "world": W}`` against the last agreed world, feeding the
    ``quorum_loss`` rule."""
    global _quorum_provider
    _quorum_provider = fn


def clear_quorum_provider(fn) -> None:
    """Unregister ``fn`` if it is still the active provider (same
    contract as :func:`clear_cluster_history_provider`)."""
    global _quorum_provider
    if _quorum_provider is fn:
        _quorum_provider = None


def evaluate(store) -> None:
    """One tick: called by the time-series sampler after each sample."""
    eng = _engine
    if eng is not None and _enabled and store is not None:
        eng.evaluate(store)


def active_alerts() -> Dict[str, dict]:
    """``{rule_id: detail}`` of currently-firing rules (the
    ``/healthz`` degraded set)."""
    eng = _engine
    return eng.active_alerts() if eng is not None and _enabled else {}


def get_engine() -> Optional[HealthEngine]:
    return _engine


def _reset_for_tests() -> None:
    global _engine, _enabled, _cluster_history_provider, _quorum_provider
    with _engine_lock:
        _engine = None
        _enabled = True
        _cluster_history_provider = None
        _quorum_provider = None
