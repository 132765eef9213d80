"""bps_top: live terminal view of a running byteps_tpu cluster; the
port's copy of ``tools/bps_top.py`` (the bus's ``metrics`` reply is
shared, so it watches either package's cluster and renders the same
frame), the serving tier's hosts with their ring-arc share.

Polls the membership bus's ``metrics`` verb (one round-trip returns
every live rank's latest snapshot — ``core/api.py:cluster_metrics()``)
and renders a per-rank table: push_pull GB/s, scheduler queue depth,
sync-stall %, retransmits, and the membership epoch — the "what is the
cluster doing RIGHT NOW" companion to the flight recorder's "what was
it doing when it died".  Works against anything from a 3-process chaos
run to a single local engine (no bus → a local-only view).

Usage:
    python -m byteps_tpu_torch.tools.bps_top [--bus HOST:PORT]
        [--interval SEC] [--once] [--json]

    --bus       membership bus address (default: DMLC_PS_ROOT_URI +
                BYTEPS_MEMBERSHIP_PORT, the ElasticMembership default)
    --interval  refresh period, seconds (default 2)
    --once      print one frame and exit (scripting / tests)
    --json      print raw cluster_metrics() JSON instead of the table
"""

from __future__ import annotations

import argparse
import json
import sys
import time

_COLUMNS = ("RANK", "ROLE", "GB/s", "QDEPTH", "INFLIGHT", "STALL%",
            "ATTRIB", "RETX", "PULLS", "SHED%", "ARC", "CONN", "WAL",
            "CODEC", "TREND", "SLOW", "STATE", "EPOCH", "STEP", "AGE")


def _wal_cell(gauges: dict) -> str:
    """Durable-plane replay lag (server/wal.py): the on-disk journal
    bytes a cold start of this rank would replay, from the
    ``wal.lag_bytes`` gauge each checkpoint cycle refreshes.  '-' =
    durability off on this rank; a value climbing across refreshes
    means cuts have stopped landing (full disk, wedged cut thread) and
    the cold-start story is silently getting worse."""
    lag = gauges.get("wal.lag_bytes")
    if lag is None:
        return "-"
    if lag >= 1 << 20:
        return "%.1fM" % (lag / (1 << 20))
    if lag >= 1 << 10:
        return "%.1fK" % (lag / (1 << 10))
    return str(int(lag))


def _conn_cell(gauges: dict) -> str:
    """The rank's transport-connection health as ``ready/total`` from
    the ``transport.connections*`` gauges (comm/transport.py).  '-' =
    the rank runs no TCP transport (loopback-only world); a ready count
    below the total is the operator's cue that a peer is partitioned or
    mid-reconnect."""
    total = gauges.get("transport.connections")
    if not total:
        return "-"
    ready = int(gauges.get("transport.connections_ready") or 0)
    return f"{ready}/{int(total)}"


def _attrib_cell(step: dict) -> str:
    """The last step's DOMINANT attribution component as 'comp:NN%'
    (share of step wall time) — the one-glance answer to "what is this
    rank's step time going to".  '-' = no attribution yet (engine idle,
    telemetry off, or a pre-attribution snapshot); 'other' only shows
    when nothing measured dominates."""
    at = step.get("attrib") or {}
    wall = step.get("wall_ms") or 0.0
    if not at or not wall:
        return "-"
    comps = {k: v for k, v in at.items() if k != "other" and v > 0}
    if not comps:
        comps = {k: v for k, v in at.items() if v > 0}
    if not comps:
        return "-"
    k = max(comps, key=comps.get)
    return f"{k}:{min(999, round(100.0 * comps[k] / wall))}%"


def _codec_cell(gauges: dict) -> str:
    """The rank's active compression codecs, from the labeled
    ``compression.codec_locked{bucket=..,codec=..}`` (planner-ladder
    locks) and ``compression.active{tensor=..,codec=..}`` (explicitly
    configured tensors) gauges.  '-' = nothing compressed on this rank;
    multiple distinct codecs join with ','."""
    import re
    codecs = set()
    for series, value in gauges.items():
        if not value:
            continue       # a zeroed series is a RETIRED codec
        if series.startswith(("compression.codec_locked{",
                              "compression.active{")):
            m = re.search(r'codec="([^"]*)"', series)
            if m:
                codecs.add(m.group(1))
    return ",".join(sorted(codecs)) if codecs else "-"


def _shed_cell(counters: dict) -> str:
    """Shed share of this endpoint's pull traffic (``serve.shed`` /
    total answered), the admission-control health figure: 0% = nothing
    degraded, climbing = the host is trading freshness for survival
    under a storm (docs/serving.md)."""
    shed = counters.get("serve.shed", 0)
    pulls = counters.get("serve.pulls", 0) + shed
    if not pulls:
        return "-"
    return f"{100.0 * shed / pulls:.0f}%"


def _trend_cell(hist: dict) -> str:
    """The rank's throughput trend as a sparkline over its piggybacked
    time-series window (``common/timeseries.py`` summary ``spark``
    tail): mbps preferred, overlap fraction as the fallback on a rank
    that moves no wire bytes.  '-' = no history posted yet."""
    series = ((hist or {}).get("summary") or {}).get("series") or {}
    st = series.get("mbps") or series.get("overlap") or {}
    vals = st.get("spark") or []
    if not vals:
        return "-"
    from .bps_doctor import sparkline
    return sparkline(vals)


def _alert_rules(entry: dict) -> list:
    """Firing health-rule ids from a rank's snapshot gauges (the
    ``health.alerts_active{rule=}`` family; value 1 = firing)."""
    import re
    gauges = (entry.get("metrics") or {}).get("gauges") or {}
    out = []
    for series, v in gauges.items():
        m = re.match(r'^health\.alerts_active\{rule="([^"]+)"\}$', series)
        if m and v:
            out.append(m.group(1))
    return sorted(out)


def _rank_row(rank: int, entry: dict, slow=None, probation=(),
              role: str = "trainer", arc: float = None,
              label: str = None, hist: dict = None,
              gstate: str = None) -> tuple:
    """One table row from a rank's cached snapshot (missing fields render
    as '-': a rank mid-transition posts partial snapshots).  ``slow`` is
    the bus's per-rank step-barrier phi score, ``probation`` the demoted
    set — together they make a demotion watchable live: the score climbs,
    STATE flips to PROBATION, and the rank leaves the world until it
    recovers and rejoins (docs/gray_failures.md).  ``role`` / ``arc``
    render the serving tier's rows (ROLE=serve, ring-arc share)."""
    m = entry.get("metrics") or {}
    gauges = m.get("gauges") or {}
    counters = m.get("counters") or {}
    step = m.get("step") or {}

    def fmt(v, spec="{}"):
        return "-" if v is None else spec.format(v)

    mbps = m.get("speed_mbps")   # MiB/s (SpeedMonitor's 2**20 unit)
    stall = None
    if step.get("wall_ms"):
        stall = 100.0 * min(1.0, (step.get("sync_stall_ms") or 0.0)
                            / step["wall_ms"])
    return (
        label if label is not None else str(rank),
        role,
        # decimal GB/s, the same unit the bench tools' *_gbps report —
        # an operator comparing a row against the bench floor must not
        # eat a silent 7.4% MiB/GiB discrepancy
        fmt(None if mbps is None else mbps * 2**20 / 1e9, "{:.3f}"),
        fmt(m.get("sched_pending",
                  gauges.get("engine.sched_pending"))),
        fmt(m.get("bytes_in_flight")),
        fmt(stall, "{:.0f}"),
        # causal attribution: where the last step's wall time
        # went, from the step.attrib_* breakdown riding the snapshot
        _attrib_cell(step),
        fmt(counters.get("integrity.retransmit", 0)),
        # serving plane (server/serving.py): cumulative pulls served by
        # this rank — 0 everywhere means the rank runs no read plane
        fmt(counters.get("serve.pulls", 0)),
        # serving tier (server/serving_tier.py): shed share of answered
        # pulls, and this host's consistent-hash ring arc
        _shed_cell(counters),
        fmt(None if arc is None else 100.0 * arc, "{:.0f}%"),
        # transport (comm/transport.py): ready/total peer connections
        _conn_cell(gauges),
        # durable state plane (server/wal.py): cold-start replay lag
        _wal_cell(gauges),
        # compression: which codec(s) this rank's pushes ride
        _codec_cell(gauges),
        # history: throughput sparkline over the rank's
        # piggybacked time-series window
        _trend_cell(hist),
        # gray-failure columns: the coordinator's phi suspicion of this
        # rank's step-barrier lag, and whether it is demoted right now
        fmt(slow, "{:.1f}"),
        # STATE: probation wins; else the gossip membership verdict
        # (alive/suspect/dead/parked, fault/gossip.py) when the SWIM
        # plane is on; plain "ok" otherwise
        ("PROBATION" if rank in probation
         else (gstate if gstate and gstate != "alive" else "ok")),
        fmt(m.get("epoch")),
        fmt(step.get("step")),
        fmt(entry.get("age_s"), "{:.1f}s"),
    )


def render(cluster: dict) -> str:
    """The table for one cluster_metrics() reply (pure; unit-tested)."""
    slow = cluster.get("slow") or {}
    probation = set(cluster.get("probation") or ())
    history = cluster.get("history") or {}
    # gossip membership states: {rank: {"inc","state","hb"}}
    # from the local SWIM table — suspect/dead/parked rows stay visible
    # even when their metrics payloads have gone stale
    gstates = {int(r): (e or {}).get("state")
               for r, e in (cluster.get("states") or {}).items()}
    rows = [_COLUMNS]
    ranks = cluster.get("ranks", {})
    coordinator = cluster.get("coordinator")
    # demoted ranks leave the world (and the metrics cache) but stay
    # VISIBLE: a probation row with '-' metrics is the operator's cue
    # that the rank is parked, not vanished
    for rank in sorted(set(ranks) | probation | set(gstates)):
        rows.append(_rank_row(
            rank, ranks.get(rank, {}), slow=slow.get(rank),
            probation=probation,
            role="coordinator" if rank == coordinator else "trainer",
            hist=history.get(rank), gstate=gstates.get(rank)))
    # serving-tier rows (server/serving_tier.py): every host in the
    # bus's serving directory is a first-class row — id prefixed 's',
    # ROLE=serve, ring-arc share from the same ring math every client
    # routes by, shed rate from the host's published counters
    serve_hosts = cluster.get("serve_hosts") or {}
    serve_ranks = cluster.get("serve_ranks") or {}
    if serve_hosts:
        try:
            from ..server.serve_ring import ServeRing
            shares = ServeRing(serve_hosts).arc_share()
        except Exception:  # noqa: BLE001 — render must not die on a
            # directory/ring mismatch mid-transition
            shares = {}
        draining = {int(h) for h in cluster.get("serve_draining") or ()}
        for hid in sorted(serve_hosts):
            rows.append(_rank_row(
                hid, serve_ranks.get(hid, {}), role="serve",
                arc=shares.get(hid), label=f"s{hid}",
                # DRAINING rides the gossip-state slot: same STATE cell,
                # same "anything but alive wins over ok" rule
                gstate="DRAINING" if hid in draining else None))
    widths = [max(len(r[i]) for r in rows) for i in range(len(_COLUMNS))]
    head = "byteps_tpu cluster — epoch %s, world %s" % (
        cluster.get("epoch"), cluster.get("world"))
    if cluster.get("coordinator") is not None:
        # who hosts the control plane, and who takes over if it dies
        head += " — coordinator=%s standby=%s" % (
            cluster.get("coordinator"), cluster.get("standby"))
    if serve_hosts:
        head += " — serve tier: %d host(s), gen %s" % (
            len(serve_hosts), cluster.get("serve_gen"))
        # the fleet banner: target vs actual is THE
        # reconciler-health signal — actual counts only non-draining
        # hosts, so a lagging drain shows as actual > target
        draining = {int(h) for h in cluster.get("serve_draining") or ()}
        if cluster.get("serve_target") is not None or draining:
            target = cluster.get("serve_target")
            head += " — fleet: target=%s actual=%d" % (
                "-" if target is None else target,
                len(set(serve_hosts) - draining))
            if draining:
                head += " draining=%s" % sorted(draining)
    if probation:
        head += " — probation=%s" % sorted(probation)
    if cluster.get("gossip"):
        head += " — gossip view (no bus round-trip)"
    if cluster.get("failover_in_progress"):
        head += (" (COORDINATOR FAILOVER IN PROGRESS — bus not "
                 "answering, local-only view)")
    elif cluster.get("local_only"):
        head += " (local-only view: no membership bus)"
    lines = [head]
    # health banner: every firing SLO rule, named per rank,
    # from the health.alerts_active{rule=} gauges riding the snapshots —
    # the same source a --once --json consumer reads, so the banner and
    # the JSON never disagree
    firing = {rank: _alert_rules(entry)
              for rank, entry in sorted(ranks.items())}
    firing = {r: rules for r, rules in firing.items() if rules}
    if firing:
        lines.append("ALERTS: " + "; ".join(
            "rank %s: %s" % (r, ",".join(rules))
            for r, rules in firing.items()))
    lines.append("  ".join(c.rjust(w) for c, w in zip(rows[0], widths)))
    for row in rows[1:]:
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
    missing = sorted(set(cluster.get("world", []))
                     - set(cluster.get("ranks", {})))
    if missing:
        lines.append(f"(no snapshot yet from rank(s) {missing} — they "
                     "report on their next step_sync)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bus", default=None, help="membership bus host:port")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from byteps_tpu_torch.core.api import cluster_metrics

    while True:
        try:
            cluster = cluster_metrics(bus=args.bus)
        except Exception as e:  # noqa: BLE001 — a dead bus mid-watch
            print(f"bps_top: cluster_metrics failed: {e}", file=sys.stderr)
            if args.once:
                return 1
            time.sleep(args.interval)
            continue
        if args.json:
            print(json.dumps(cluster, default=str))
        else:
            if not args.once:
                # clear + home, like top (plain ANSI, no curses dep)
                sys.stdout.write("\x1b[2J\x1b[H")
            print(render(cluster), flush=True)
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
