"""bps_doctor: incident interrogation + postmortem for a byteps_tpu
cluster; the port's copy of ``tools/bps_doctor.py`` (the flight dumps,
time-series dumps and bus replies are shared, so it reads either
package's artifacts and either package's bus, and gives the same
diagnosis).

Two modes, one report shape (markdown by default, ``--json`` for
scripting):

**Live** (default): one ``cluster_metrics()`` round-trip over the
membership bus answers "is anything wrong RIGHT NOW, and who": the
firing health rules per rank (from each snapshot's
``health.alerts_active{rule=}`` gauges), the coordinator's slowness phi
scores and probation list, cross-rank attribution skew (the SAME pure
function the SLO engine runs — ``common/health.py:
attrib_skew_findings`` — so the doctor and the pager name the same
culprit), each rank's dominant attribution component, and trend
sparklines drawn from the piggybacked time-series window summaries
(``common/timeseries.py``).  The verdict names ONE culprit rank with
its evidence.

**Postmortem** (``--postmortem DIR``): correlates what a dead or sick
run left behind in one directory — flight-recorder dumps
(``bps_flight_*.json``: the ``alert`` events the health engine recorded
and the ``fault.*`` events the injector recorded), saved ``/timeseries``
windows (``bps_timeseries_*.json``), and a merged trace
(``bps_trace_merged.json``, from ``tools/bps_trace.py``) — into one
report that names WHAT degraded first (the earliest firing alert),
WHICH rank, and at WHICH injection/code site.

Usage:
    python -m byteps_tpu_torch.tools.bps_doctor [--bus HOST:PORT] [--json]
    python -m byteps_tpu_torch.tools.bps_doctor --postmortem DIR [--json]
        [--out PATH]

    --bus         membership bus address (default: DMLC_PS_ROOT_URI +
                  BYTEPS_MEMBERSHIP_PORT, the ElasticMembership default)
    --postmortem  directory of flight dumps / timeseries dumps / merged
                  trace to correlate instead of asking a live bus
    --skew-ratio  cross-rank attribution skew threshold (default 4.0,
                  the BYTEPS_HEALTH_SKEW_RATIO default)
    --json        machine-readable report on stdout
    --out         also write the JSON report to this path
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional

_SPARK_CHARS = "▁▂▃▄▅▆▇█"

_ALERT_GAUGE_RE = re.compile(r'^health\.alerts_active\{rule="([^"]+)"\}$')


def sparkline(values: List[float]) -> str:
    """A tiny unicode graph of ``values`` (empty input -> '-')."""
    vals = [float(v) for v in values]
    if not vals:
        return "-"
    lo, hi = min(vals), max(vals)
    if hi - lo < 1e-12:
        return _SPARK_CHARS[0] * len(vals)
    return "".join(
        _SPARK_CHARS[min(len(_SPARK_CHARS) - 1,
                         int((v - lo) / (hi - lo) * (len(_SPARK_CHARS) - 1)))]
        for v in vals)


def firing_rules(cluster: dict) -> Dict[int, List[str]]:
    """``{rank: [rule ids]}`` of alerts firing per the snapshots'
    ``health.alerts_active{rule=}`` gauges (value 1 = firing)."""
    out: Dict[int, List[str]] = {}
    for rank, entry in (cluster.get("ranks") or {}).items():
        gauges = (entry.get("metrics") or {}).get("gauges") or {}
        rules = sorted(m.group(1) for series, v in gauges.items()
                       if v and (m := _ALERT_GAUGE_RE.match(series)))
        if rules:
            out[int(rank)] = rules
    return out


def dominant_attrib(summary: dict) -> Optional[dict]:
    """The attribution component whose window-mean dominates a rank's
    history summary — "where is this rank's step time going"."""
    series = (summary or {}).get("series") or {}
    best = None
    for key, st in series.items():
        if not key.startswith("attrib_"):
            continue
        mean = float(st.get("mean", 0.0))
        if mean > 0 and (best is None or mean > best["mean_ms"]):
            best = {"component": key[len("attrib_"):],
                    "mean_ms": round(mean, 3)}
    return best


def _history_summaries(cluster: dict) -> Dict[int, dict]:
    return {int(r): (h or {}).get("summary") or {}
            for r, h in (cluster.get("history") or {}).items()}


def diagnose_live(cluster: dict, skew_ratio: float = 4.0) -> dict:
    """The live report document (pure over a cluster_metrics() reply;
    unit-tested without a bus)."""
    from byteps_tpu_torch.common.health import attrib_skew_findings
    alerts = firing_rules(cluster)
    slow = {int(r): float(v) for r, v in (cluster.get("slow") or {}).items()}
    probation = [int(r) for r in cluster.get("probation") or ()]
    history = _history_summaries(cluster)
    skews = attrib_skew_findings(history, skew_ratio)
    trends: Dict[int, dict] = {}
    attrib: Dict[int, dict] = {}
    for rank, summ in history.items():
        series = summ.get("series") or {}
        trends[rank] = {
            key: {"last": st.get("last"), "mean": st.get("mean"),
                  "min": st.get("min"), "max": st.get("max"),
                  "spark": sparkline(st.get("spark") or [])}
            for key, st in sorted(series.items())
            if key in ("overlap", "mbps", "slow_score", "step_wall_ms",
                       "retransmit", "shed", "ef_norm")}
        dom = dominant_attrib(summ)
        if dom:
            attrib[rank] = dom

    # the verdict: one culprit rank, by weight of evidence
    evidence: Dict[int, List[str]] = {}
    for rank, rules in alerts.items():
        evidence.setdefault(rank, []).extend(
            f"alert {rid} firing" for rid in rules)
    for rank in probation:
        evidence.setdefault(rank, []).append("on probation")
    if slow:
        worst = max(slow, key=lambda r: slow[r])
        if slow[worst] > 0:
            evidence.setdefault(worst, []).append(
                f"worst slowness phi {slow[worst]:.1f}")
    for f in skews:
        evidence.setdefault(int(f["rank"]), []).append(
            "attrib skew: %s %.1fms vs median %.1fms"
            % (f["component"], f["mean_ms"], f["median_ms"]))
    culprit = None
    if evidence:
        rank = max(evidence, key=lambda r: len(evidence[r]))
        culprit = {"rank": rank, "evidence": evidence[rank]}
    return {"mode": "live",
            "epoch": cluster.get("epoch"),
            "world": cluster.get("world"),
            "coordinator": cluster.get("coordinator"),
            "healthy": not alerts,
            "alerts": alerts,
            "slow": slow,
            "probation": probation,
            "attrib_skew": skews,
            "dominant_attrib": attrib,
            "trends": trends,
            "culprit": culprit}


# -- postmortem ------------------------------------------------------------


def load_flight_dumps(dir_: str) -> List[dict]:
    docs = []
    for path in sorted(glob.glob(os.path.join(dir_, "bps_flight_*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"bps_doctor: skipping unreadable {path}: {e}",
                  file=sys.stderr)
            continue
        doc["_path"] = path
        docs.append(doc)
    return docs


def _partition_incident(faults: List[dict],
                        parks: List[dict]) -> Optional[dict]:
    """Fold the partition-flavored flight events (``fault.partition`` /
    ``fault.partition_healed`` from the injector, ``membership.
    partition_minority`` / ``membership.quorum_refused`` from the
    quorum gate) into one incident: the two sides, which ranks parked
    as the minority, and how long the split lasted.  None when the
    incident directory shows no partition at all."""
    cuts = [f for f in faults if f.get("kind") == "partition"]
    heals = [f for f in faults if f.get("kind") == "partition_healed"]
    if not cuts and not parks:
        return None
    side_a: List[int] = []
    side_b: List[int] = []
    for f in cuts:
        d = f.get("detail") or {}
        if d.get("side_a"):
            side_a = sorted({int(r) for r in d["side_a"]} | set(side_a))
        if d.get("side_b"):
            side_b = sorted({int(r) for r in d["side_b"]} | set(side_b))
    parked = sorted({int(p["rank"]) for p in parks
                     if p.get("kind") == "partition_minority"
                     and p.get("rank") is not None})
    out: Dict = {"side_a": side_a, "side_b": side_b,
                 "parked_ranks": parked,
                 "cut_t": cuts[0].get("t") if cuts else None,
                 "healed": bool(heals)}
    if heals:
        h = heals[0]
        out["heal_t"] = h.get("t")
        after = (h.get("detail") or {}).get("after_ms")
        if after is not None:
            out["split_ms"] = float(after)
        elif out["cut_t"] is not None and h.get("t") is not None:
            out["split_ms"] = round(
                (float(h["t"]) - float(out["cut_t"])) * 1000.0, 1)
    return out


def diagnose_postmortem(dir_: str) -> dict:
    """Correlate one incident directory into the postmortem document
    (pure over files on disk; unit-tested from synthetic dumps)."""
    dumps = load_flight_dumps(dir_)
    alerts: List[dict] = []
    faults: List[dict] = []
    parks: List[dict] = []
    reconcile: List[dict] = []
    durability: List[dict] = []
    for doc in dumps:
        rank = doc.get("rank")
        for ev in doc.get("events") or ():
            kind = ev.get("kind", "")
            if kind.startswith("reconcile."):
                # fleet-reconciler incidents: spawns,
                # crash-loop restarts, bans, drains and their
                # escalations — the supervisor's side of the story
                reconcile.append({"t": ev.get("t"), "rank": rank,
                                  "kind": kind[len("reconcile."):],
                                  "host": ev.get("host"),
                                  "detail": {k: v for k, v in ev.items()
                                             if k not in ("t", "mono",
                                                          "kind", "host")}})
            elif kind == "alert":
                alerts.append({"t": ev.get("t"), "rank": rank,
                               "rule": ev.get("rule"),
                               "state": ev.get("state"),
                               "detail": {k: v for k, v in ev.items()
                                          if k not in ("t", "mono", "kind",
                                                       "rule", "state")}})
            elif kind.startswith("fault."):
                faults.append({"t": ev.get("t"), "rank": rank,
                               "kind": kind[len("fault."):],
                               "site": ev.get("site"),
                               "detail": {k: v for k, v in ev.items()
                                          if k not in ("t", "mono",
                                                       "kind", "site")}})
            elif kind.startswith("wal."):
                # durable-state-plane incidents: cold-start
                # replays, torn tails truncated, corrupt segments or
                # snapshots discarded, serving arcs restored from disk
                durability.append({"t": ev.get("t"), "rank": rank,
                                   "kind": kind[len("wal."):],
                                   "detail": {k: v for k, v in ev.items()
                                              if k not in ("t", "mono",
                                                           "kind")}})
            elif kind in ("membership.partition_minority",
                          "membership.quorum_refused"):
                parks.append({"t": ev.get("t"), "rank": rank,
                              "kind": kind.split(".", 1)[1],
                              "detail": {k: v for k, v in ev.items()
                                         if k not in ("t", "mono",
                                                      "kind")}})
    alerts.sort(key=lambda a: a.get("t") or 0.0)
    faults.sort(key=lambda f: f.get("t") or 0.0)
    parks.sort(key=lambda p: p.get("t") or 0.0)
    reconcile.sort(key=lambda r: r.get("t") or 0.0)
    durability.sort(key=lambda d: d.get("t") or 0.0)
    partition = _partition_incident(faults, parks)
    firing = [a for a in alerts if a.get("state") == "firing"]
    first = firing[0] if firing else None

    # the culprit: the rank the evidence converges on — injected faults
    # outrank alerts (the alert is the symptom, the fault the cause)
    evidence: Dict[int, List[str]] = {}
    site = None
    for f in faults:
        if f.get("rank") is None:
            continue
        r = int(f["rank"])
        evidence.setdefault(r, []).append(
            "fault %s at site %s" % (f["kind"], f.get("site")))
        if site is None and f.get("site"):
            site = f["site"]
    fault_ranks = set(evidence)
    for a in firing:
        if a.get("rank") is None:
            continue
        evidence.setdefault(int(a["rank"]), []).append(
            "alert %s fired" % a.get("rule"))
    culprit = None
    if evidence:
        # prefer a rank with an injected/recorded fault; break ties by
        # evidence weight
        rank = max(evidence,
                   key=lambda r: (r in fault_ranks, len(evidence[r])))
        culprit = {"rank": rank, "site": site,
                   "evidence": evidence[rank]}

    # saved /timeseries windows, one per rank that captured one
    ts: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(dir_,
                                              "bps_timeseries_*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        pts = doc.get("points") or []
        overlaps = [p["overlap"] for p in pts if "overlap" in p]
        ts[os.path.basename(path)] = {
            "len": len(pts),
            "span_s": (round(pts[-1]["t"] - pts[0]["t"], 3)
                       if len(pts) > 1 else 0.0),
            "overlap_min": round(min(overlaps), 4) if overlaps else None,
            "overlap_last": round(overlaps[-1], 4) if overlaps else None,
            "overlap_spark": sparkline(overlaps[-16:])}

    # merged trace (tools/bps_trace.py output), if the incident dir has
    # one: enough stats to say whether the timeline covers the window
    trace = None
    merged_path = os.path.join(dir_, "bps_trace_merged.json")
    if os.path.exists(merged_path):
        try:
            with open(merged_path) as f:
                merged = json.load(f)
            evs = [e for e in merged.get("traceEvents") or ()
                   if e.get("ph") != "M"]
            trace = {"path": merged_path, "events": len(evs),
                     "files": len(merged.get("mergedFrom") or ()),
                     "span_ms": round(max((e.get("ts", 0) for e in evs),
                                          default=0) / 1e3, 3)}
        except (OSError, ValueError):
            pass
    return {"mode": "postmortem",
            "dir": dir_,
            "dumps": [{"path": d["_path"], "rank": d.get("rank"),
                       "reason": d.get("reason"),
                       "events": len(d.get("events") or ())}
                      for d in dumps],
            "first_degradation": first,
            "alerts": alerts,
            "faults": faults,
            "partition": partition,
            "parks": parks,
            "reconciler": reconcile,
            "durability": durability,
            "timeseries": ts,
            "trace": trace,
            "culprit": culprit}


# -- rendering -------------------------------------------------------------


def render_markdown(report: dict) -> str:
    lines: List[str] = []
    if report["mode"] == "live":
        lines.append("# bps_doctor — live (epoch %s, world %s)"
                     % (report.get("epoch"), report.get("world")))
        if report.get("healthy"):
            lines.append("\n**Cluster healthy** — no health rule firing.")
        else:
            lines.append("\n**DEGRADED** — firing rules:")
            for rank, rules in sorted(report["alerts"].items()):
                lines.append("- rank %s: %s" % (rank, ", ".join(rules)))
        if report.get("culprit"):
            c = report["culprit"]
            lines.append("\n**Culprit: rank %s**" % c["rank"])
            for e in c["evidence"]:
                lines.append("  - %s" % e)
        if report.get("attrib_skew"):
            lines.append("\n## Cross-rank attribution skew")
            for f in report["attrib_skew"]:
                lines.append("- rank %(rank)s: %(component)s "
                             "%(mean_ms)sms vs median %(median_ms)sms" % f)
        if report.get("dominant_attrib"):
            lines.append("\n## Dominant attribution component")
            for rank, d in sorted(report["dominant_attrib"].items()):
                lines.append("- rank %s: %s (%.1fms mean)"
                             % (rank, d["component"], d["mean_ms"]))
        if report.get("trends"):
            lines.append("\n## Trends (window summaries)")
            for rank, series in sorted(report["trends"].items()):
                lines.append("- rank %s:" % rank)
                for key, st in series.items():
                    lines.append("    %-12s %s last=%s mean=%s"
                                 % (key, st["spark"], st["last"],
                                    st["mean"]))
    else:
        lines.append("# bps_doctor — postmortem of %s" % report["dir"])
        lines.append("\n%d flight dump(s), %d alert event(s), "
                     "%d fault event(s)"
                     % (len(report["dumps"]), len(report["alerts"]),
                        len(report["faults"])))
        first = report.get("first_degradation")
        if first:
            lines.append("\n**Degraded first: rule `%s` on rank %s** "
                         "(t=%s)" % (first.get("rule"), first.get("rank"),
                                     first.get("t")))
        if report.get("culprit"):
            c = report["culprit"]
            lines.append("\n**Culprit: rank %s%s**"
                         % (c["rank"],
                            (", site %s" % c["site"]) if c.get("site")
                            else ""))
            for e in c["evidence"]:
                lines.append("  - %s" % e)
        if report.get("partition"):
            p = report["partition"]
            lines.append("\n## Network partition")
            lines.append("- sides: %s | %s"
                         % (p.get("side_a"), p.get("side_b")))
            if p.get("parked_ranks"):
                lines.append("- minority parked: rank(s) %s (quorum "
                             "gate refused the epoch)"
                             % p["parked_ranks"])
            if p.get("healed"):
                lines.append("- healed after %sms"
                             % p.get("split_ms", "?"))
            else:
                lines.append("- NEVER healed within the recorded window")
        if report["alerts"]:
            lines.append("\n## Alert timeline")
            for a in report["alerts"]:
                lines.append("- t=%s rank %s: %s %s %s"
                             % (a.get("t"), a.get("rank"), a.get("rule"),
                                a.get("state"), a.get("detail") or ""))
        if report.get("reconciler"):
            lines.append("\n## Reconciler incidents")
            bans = [r for r in report["reconciler"]
                    if r["kind"] == "banned"]
            escalated = [r for r in report["reconciler"]
                         if r["kind"] == "drain_escalated"]
            if bans:
                lines.append("- BANNED (crash loop): host(s) %s"
                             % sorted({r.get("host") for r in bans}))
            if escalated:
                lines.append("- drain deadline ESCALATED to kill: "
                             "host(s) %s"
                             % sorted({r.get("host") for r in escalated}))
            for r in report["reconciler"]:
                lines.append("- t=%s host %s: %s %s"
                             % (r.get("t"), r.get("host"), r.get("kind"),
                                r.get("detail") or ""))
        if report.get("durability"):
            lines.append("\n## Durability / cold start")
            restores = [d for d in report["durability"]
                        if d["kind"] in ("recovered", "arc_restored")]
            losses = [d for d in report["durability"]
                      if d["kind"] in ("truncated_tail", "corrupt_record",
                                       "snapshot_corrupt", "arc_corrupt")]
            if restores:
                lines.append("- restored from local disk: rank(s) %s"
                             % sorted({d.get("rank") for d in restores}))
            if losses:
                lines.append("- journal damage detected and truncated to "
                             "the last durable point: %d event(s)"
                             % len(losses))
            for d in report["durability"]:
                lines.append("- t=%s rank %s: %s %s"
                             % (d.get("t"), d.get("rank"), d.get("kind"),
                                d.get("detail") or ""))
        if report["faults"]:
            lines.append("\n## Injected/recorded faults")
            for f in report["faults"]:
                lines.append("- t=%s rank %s: %s at site %s"
                             % (f.get("t"), f.get("rank"), f.get("kind"),
                                f.get("site")))
        if report.get("timeseries"):
            lines.append("\n## Saved time-series windows")
            for name, t in sorted(report["timeseries"].items()):
                lines.append("- %s: %d point(s) over %ss, overlap %s "
                             "(min %s, last %s)"
                             % (name, t["len"], t["span_s"],
                                t["overlap_spark"], t["overlap_min"],
                                t["overlap_last"]))
        if report.get("trace"):
            t = report["trace"]
            lines.append("\n## Merged trace")
            lines.append("- %s: %d event(s) from %d file(s), span %sms"
                         % (t["path"], t["events"], t["files"],
                            t["span_ms"]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bus", default=None, help="membership bus host:port")
    ap.add_argument("--postmortem", default=None, metavar="DIR")
    ap.add_argument("--skew-ratio", type=float, default=4.0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.postmortem:
        report = diagnose_postmortem(args.postmortem)
    else:
        from byteps_tpu_torch.core.api import cluster_metrics
        try:
            cluster = cluster_metrics(bus=args.bus)
        except Exception as e:  # noqa: BLE001 — a dead bus IS the finding
            print(f"bps_doctor: cluster_metrics failed: {e}",
                  file=sys.stderr)
            return 2
        report = diagnose_live(cluster, skew_ratio=args.skew_ratio)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, default=str)
    if args.json:
        print(json.dumps(report, default=str))
    else:
        print(render_markdown(report))
    # exit status mirrors /healthz: nonzero while something is wrong, so
    # the chaos lane (and operators' scripts) can gate on the verdict
    if report["mode"] == "live":
        return 0 if report.get("healthy") else 1
    return 0 if report.get("culprit") else 1


if __name__ == "__main__":
    sys.exit(main())
