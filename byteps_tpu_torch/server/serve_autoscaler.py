"""Serving-tier autoscaler: signal-driven scale proposals over the bus;
port of ``byteps_tpu/server/serve_autoscaler.py``.

The tier's economics hinge on the consistent-hash ring
(``serve_ring.py``): a host joining or leaving moves ~1/N of the key
space, so scaling host-by-host is cheap — IF something decides when.
This module is that something, fed by the signals the repo already
maintains:

- the ``serve.*`` pull/shed figures serving hosts attach to their
  directory re-registrations (``serve_register`` meta rides the
  membership bus, ``fault/membership.py``),
- the hosts' ``hot_keys()`` histograms (same channel),
- and the **slowness tracker** (``utils/slowness.py``): per-host
  phi scores at site ``serve_pull`` (router-observed pull latency) and
  ``transport`` (publisher-observed ship RTT) — a gray-failing host is
  EXCLUDED from replica placement before it is dead.

:meth:`TierAutoscaler.decide` is a pure function of a signals dict (the
unit-testable core); :meth:`step` gathers signals, applies the cooldown,
and acts: scale-DOWN retires a victim through the tier (directory
unregister — every ring consumer heals at the next sync), scale-UP posts
the target through the bus (verb ``serve_scale``) for whoever launches
host processes (the fleet reconciler, an operator, a k8s controller)
to read — the autoscaler proposes, membership disposes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from ..common.logging import get_logger
from ..common.telemetry import counters, gauges

__all__ = ["ScaleDecision", "TierAutoscaler"]


@dataclasses.dataclass
class ScaleDecision:
    action: str                 # "up" | "down" | "hold"
    target: int                 # proposed host count
    victims: List[int]          # hosts to retire (action == "down")
    probation: List[int]        # gray-failing hosts excluded from placement
    placement: Dict[object, List[int]]   # hot key -> replica host set
    reason: str


class TierAutoscaler:
    """Proposes the serving-tier size and placement from live signals.

    Policy (deliberately boring — the interesting part is the signal
    plumbing and that proposals travel the BUS, not a config file):

    - **up** when the tier sheds (``shed_rate`` > 0) or the slowest
      healthy host's phi crosses the config threshold with no idle
      capacity, and the ceiling allows;
    - **down** when per-host pull rate sits under ``low_pulls_per_s``
      with zero shedding and the floor allows — victims are probationed
      hosts first (demote the gray one), else the smallest arc;
    - **hold** otherwise, and always inside the cooldown window.
    """

    def __init__(self, tier, *, min_hosts: Optional[int] = None,
                 max_hosts: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 low_pulls_per_s: float = 50.0,
                 hot_n: int = 8,
                 dispose: str = "retire"):
        from ..common.config import get_config
        cfg = get_config()
        if dispose not in ("retire", "drain"):
            raise ValueError("dispose must be 'retire' (unregister the "
                             "victim now) or 'drain' (propose it to the "
                             "fleet reconciler's graceful drain)")
        self.tier = tier
        self.dispose = dispose
        self.min_hosts = (cfg.serve_tier_min_hosts if min_hosts is None
                          else int(min_hosts))
        self.max_hosts = (cfg.serve_tier_max_hosts if max_hosts is None
                          else int(max_hosts))
        self.cooldown_s = (cfg.serve_tier_cooldown_s if cooldown_s is None
                           else float(cooldown_s))
        self.low_pulls_per_s = float(low_pulls_per_s)
        self.hot_n = int(hot_n)
        self._phi = cfg.slowness_phi
        self._last_decision = 0.0
        self._last_counts: Dict[int, Dict[str, float]] = {}
        self._last_poll = 0.0

    # -- signal gathering ----------------------------------------------------

    def signals(self) -> dict:
        """One consistent signals dict: per-host pull/shed RATES (deltas
        of the cumulative figures hosts attach to their directory
        re-registrations), per-host slowness phi (max over the
        ``serve_pull`` and ``transport`` sites), arc shares, hot keys,
        and the directory's current shape."""
        info = self.tier.directory.info()
        now = time.monotonic()
        dt = max(now - self._last_poll, 1e-6) if self._last_poll else None
        self._last_poll = now
        # first sample: no deltas exist yet, so every rate below is a
        # structural zero — "warm" lets decide() hold instead of
        # mistaking no-data-yet for an idle tier and retiring a host
        # that is in fact serving heavy traffic
        warm = dt is not None
        from ..fault.membership import SERVE_RANK_BASE
        from ..utils import slowness as _slowness
        tracker = _slowness.tracker()
        scores: Dict[int, float] = {}
        # serve_pull observations are keyed by bare host id (the
        # router's peer); transport observations by the endpoint peer =
        # SERVE_RANK_BASE + host_id — fold the latter back into host-id
        # space, and ignore transport peers below the base (those are
        # TRAINER ranks: rank 2 being slow must not probation host 2)
        for peer, phi in tracker.scores(site="serve_pull").items():
            scores[peer] = max(scores.get(peer, 0.0), phi)
        for peer, phi in tracker.scores(site="transport").items():
            if peer >= SERVE_RANK_BASE:
                h = peer - SERVE_RANK_BASE
                scores[h] = max(scores.get(h, 0.0), phi)
        hosts = sorted(info["hosts"])
        rates: Dict[int, dict] = {}
        hot: Dict[object, int] = {}
        for h in hosts:
            meta = info["meta"].get(h, {})
            cur = {"pulls": float(meta.get("pulls", 0)),
                   "sheds": float(meta.get("sheds", 0))}
            prev = self._last_counts.get(h)
            if prev is not None and dt is not None:
                rates[h] = {
                    "pulls_per_s": max(0.0, (cur["pulls"] - prev["pulls"])
                                       / dt),
                    "shed_per_s": max(0.0, (cur["sheds"] - prev["sheds"])
                                      / dt)}
            else:
                rates[h] = {"pulls_per_s": 0.0, "shed_per_s": 0.0}
            self._last_counts[h] = cur
            for k in meta.get("hot", ()):
                hot[k] = hot.get(k, 0) + 1
        return {
            "hosts": hosts,
            "warm": warm,
            "gen": info["gen"],
            "rates": rates,
            "pulls_per_s": sum(r["pulls_per_s"] for r in rates.values()),
            "shed_per_s": sum(r["shed_per_s"] for r in rates.values()),
            "slow": {h: scores.get(h, 0.0) for h in hosts},
            "phi_threshold": self._phi,
            "arc_share": self.tier.ring.arc_share(),
            "hot_keys": sorted(hot, key=lambda k: (-hot[k], str(k)))
            [:self.hot_n],
        }

    # -- the pure decision ---------------------------------------------------

    def decide(self, sig: dict) -> ScaleDecision:
        hosts: List[int] = list(sig["hosts"])
        n = len(hosts)
        phi_t = sig.get("phi_threshold", self._phi)
        probation = sorted(h for h in hosts
                           if sig["slow"].get(h, 0.0) >= phi_t)
        healthy = [h for h in hosts if h not in probation]
        placement = self._placement(sig, healthy or hosts)
        if n == 0:
            return ScaleDecision("up", max(self.min_hosts, 1), [],
                                 probation, placement, "no hosts")
        shed = sig.get("shed_per_s", 0.0)
        pulls = sig.get("pulls_per_s", 0.0)
        if (shed > 0.0 or len(healthy) < self.min_hosts) \
                and n < self.max_hosts:
            why = (f"shedding {shed:.1f}/s" if shed > 0.0
                   else f"only {len(healthy)} healthy host(s)")
            return ScaleDecision("up", n + 1, [], probation, placement, why)
        if not sig.get("warm", True):
            # zero observed rates on the FIRST sample mean "no deltas
            # yet", not "idle" — scaling down on them would retire (and
            # ban) a healthy host mid-traffic
            return ScaleDecision("hold", n, [], probation, placement,
                                 "warming up (first sample)")
        if (n > self.min_hosts and shed == 0.0
                and pulls / n < self.low_pulls_per_s):
            if probation:
                victim = probation[0]
                why = f"host {victim} on probation (phi >= {phi_t})"
            else:
                share = sig.get("arc_share", {})
                victim = min(hosts, key=lambda h: (share.get(h, 0.0), h))
                why = (f"idle tier ({pulls / n:.1f} pulls/s/host < "
                       f"{self.low_pulls_per_s})")
            return ScaleDecision("down", n - 1, [victim], probation,
                                 placement, why)
        return ScaleDecision("hold", n, [], probation, placement,
                             "within bounds")

    def _placement(self, sig: dict, hosts: List[int]
                   ) -> Dict[object, List[int]]:
        """Replica placement for the hot keys over the HEALTHY host set
        — probationed hosts carry no hot arcs (the gray-failure
        machinery governing placement, not just reporting it)."""
        if not hosts:
            return {}
        from .serve_ring import ServeRing
        ring = ServeRing(hosts, vnodes=self.tier.ring.vnodes)
        return {k: ring.replica_hosts(k, self.tier.replicas)
                for k in sig.get("hot_keys", ())}

    # -- the actuation loop --------------------------------------------------

    def step(self, force: bool = False) -> Optional[ScaleDecision]:
        """Gather → decide → act, inside the cooldown.  Returns the
        decision taken (None while cooling down)."""
        now = time.monotonic()
        if not force and now - self._last_decision < self.cooldown_s:
            return None
        sig = self.signals()
        decision = self.decide(sig)
        self._last_decision = now
        self.tier.set_probation(decision.probation)
        gauges.set("serve.tier_target", decision.target)
        if decision.action == "hold":
            return decision
        get_logger().warning("serve autoscaler: %s -> %d host(s): %s",
                             decision.action, decision.target,
                             decision.reason)
        # the proposal travels the BUS either way: launchers watch the
        # target, and a scale-down additionally retires its victims now
        try:
            self.tier.directory.set_target(decision.target)
        except (ConnectionError, TimeoutError):
            get_logger().warning("serve autoscaler: target proposal "
                                 "could not reach the bus")
        if decision.action == "up":
            counters.inc("serve.tier_scale_up")
        else:
            counters.inc("serve.tier_scale_down")
            if self.dispose == "drain":
                # the autoscaler PROPOSES, the reconciler DISPOSES:
                # victims ride the bus and are retired through the
                # graceful drain (in-flight pulls finish, final
                # unregister handshake, bounded by the drain deadline)
                try:
                    self.tier.directory.propose_victims(decision.victims)
                except (ConnectionError, TimeoutError):
                    get_logger().warning("serve autoscaler: victim "
                                         "proposal could not reach the "
                                         "bus")
            else:
                for v in decision.victims:
                    self.tier.retire_host(v, reason=decision.reason)
        return decision
