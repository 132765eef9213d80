"""bps_trace: merge per-rank trace files into ONE aligned cluster timeline;
the port's copy of ``tools/bps_trace.py`` (the file layout is shared, so
it reads either package's traces).

Every process of a traced run (``BYTEPS_TRACE_ON`` window or
``BYTEPS_TRACE_SAMPLE`` stream) flushes
``bps_trace_rank{R}_{pid}.json`` into ``BYTEPS_TRACE_DIR``.  Each file's
event timestamps are that process's MONOTONIC clock — meaningless across
processes — but the file carries a ``monoAnchor`` (one simultaneous
``(wall, monotonic)`` pair) and a ``clockSync`` offset (this process's
wall clock minus the membership coordinator's, estimated NTP-style over
the bus ``ping`` verb).  This tool rebases every event onto the
coordinator's wall clock:

    aligned = (ts_mono - anchor.mono) + anchor.wall - clockSync.offset_s

and emits one chrome://tracing / Perfetto JSON whose flow events
(``ph: s/t/f``, bound by ``id``) now connect spans ACROSS ranks — a
push's enqueue → dispatch → wire → merge arc, and each rank's step
flowing into the coordinator's ``bus.step_barrier`` span.

Usage:
    python -m byteps_tpu_torch.tools.bps_trace [--dir DIR] [--out merged.json] [--validate]

    --dir       directory of per-rank trace files
                (default: $BYTEPS_TRACE_DIR, else the per-user tmp
                trace dir the engine writes to — byteps_tpu_torch.common
                .config.trace_dir_from_env, the one source of truth)
    --out       merged output path (default: <dir>/bps_trace_merged.json)
    --validate  check the merged timeline and exit nonzero on:
                  * any flow ``s`` without a matching ``f`` (same id)
                  * a flow whose aligned timestamps run backwards
                    (f before s beyond the clock-sync error budget)
                  * non-finite/negative aligned timestamps
                Orphan ``f`` flows (a member's reply lost after the
                coordinator closed the arc) are warned, not failed.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

# aligned-causality slack: two clock-sync estimates each carry half-RTT
# error; the validator only fails an arc that runs backwards by more
# than the files' combined declared error (floored at 1 ms)
MIN_SLACK_S = 0.001


def load_trace_files(dir_: str) -> List[dict]:
    """Every per-rank trace doc in ``dir_`` (merged outputs and spill
    side files excluded).  Files are keyed rank+pid, so one RUN yields
    one file per rank; a directory shared across runs merges them all —
    point --dir at a per-run directory (the workers' BYTEPS_TRACE_DIR)
    for a single-run timeline."""
    docs = []
    for path in sorted(glob.glob(os.path.join(dir_, "bps_trace_rank*.json"))):
        if path.endswith("_merged.json") or ".spill." in path:
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"bps_trace: skipping unreadable {path}: {e}",
                  file=sys.stderr)
            continue
        if "traceEvents" not in doc:
            continue
        doc["_path"] = path
        docs.append(doc)
    return docs


def _file_shift(doc: dict) -> Tuple[float, float]:
    """(shift_s, err_s): add ``shift_s`` to a file's monotonic seconds to
    land on the coordinator's wall clock.  Files without an anchor (old
    emitters) fall back to raw monotonic — flagged by err = inf."""
    anchor = doc.get("monoAnchor") or {}
    if "wall" not in anchor or "mono" not in anchor:
        return 0.0, math.inf
    shift = float(anchor["wall"]) - float(anchor["mono"])
    sync = doc.get("clockSync") or {}
    off = sync.get("offset_s")
    err = sync.get("err_s")
    if off is not None:
        shift -= float(off)
        return shift, float(err or 0.0)
    # no bus estimate (single process, or clock sync off): wall clocks
    # are assumed NTP-close; the validator allows generous slack
    return shift, 0.05


def merge(docs: List[dict]) -> dict:
    """One aligned chrome-trace doc from N per-rank docs.

    - every event's ``ts`` is rebased to coordinator wall time (then to
      a zero origin at the earliest event, so the viewer opens at t=0);
    - each file keeps its own ``pid`` namespace (tids are per-pid in the
      chrome model) but gets a ``process_name`` metadata row naming the
      rank, so the merged view reads "rank 0 / rank 1 / ...";
    - flow events pass through untouched — their ``id`` is
      cluster-unique by construction (rank and pid are folded into the
      high bits), which is exactly what makes the cross-rank arcs bind.
    """
    out_events: List[dict] = []
    meta_files = []
    t_min = math.inf
    for doc in docs:
        shift, err = _file_shift(doc)
        rank = doc.get("rank", "?")
        pid = doc.get("pid") or 0
        for ev in doc["traceEvents"]:
            if ev.get("ph") == "M":
                out_events.append(ev)
                continue
            ev = dict(ev)
            ev["ts"] = ev.get("ts", 0.0) + shift * 1e6
            t_min = min(t_min, ev["ts"])
            out_events.append(ev)
        out_events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"rank {rank} (pid {pid})"}})
        meta_files.append({"path": doc.get("_path"), "rank": rank,
                           "pid": pid, "shift_s": round(shift, 6),
                           "clock_err_s": (None if math.isinf(err)
                                           else err),
                           "events": len(doc["traceEvents"]),
                           "dropped": doc.get("droppedEvents", 0)})
    if math.isinf(t_min):
        t_min = 0.0
    for ev in out_events:
        if ev.get("ph") != "M":
            ev["ts"] = ev["ts"] - t_min
    out_events.sort(key=lambda e: (e.get("ph") == "M", e.get("ts", 0.0)))
    return {"traceEvents": out_events, "displayTimeUnit": "ms",
            "mergedFrom": meta_files,
            "originWall": t_min / 1e6}


def validate(merged: dict) -> List[str]:
    """Problems in a merged timeline (empty list = clean).  The two
    contracts the trace lane gates on: every flow ``s`` has its ``f``,
    and aligned timestamps respect causality within the declared
    clock-sync error."""
    errors: List[str] = []
    files = merged.get("mergedFrom") or [{}]
    # a file with no anchor declared an UNKNOWN (infinite) clock error
    # (merge stores it as None): its events sit on raw monotonic time,
    # so cross-file causality is meaningless — skip the backwards check
    # entirely instead of failing every arc against a 0-slack bound
    unalignable = any("clock_err_s" in f and f["clock_err_s"] is None
                      for f in files)
    if unalignable:
        print("bps_trace: warning: file(s) without a clock anchor — "
              "flow-direction validation skipped", file=sys.stderr)
    slack_s = max(MIN_SLACK_S,
                  2 * max((f.get("clock_err_s") or 0.0) for f in files))
    starts: Dict[int, dict] = {}
    finishes: Dict[int, dict] = {}
    n_flows = 0
    for ev in merged["traceEvents"]:
        ph = ev.get("ph")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if ts is None or not math.isfinite(ts) or ts < -1e-6:
            errors.append(f"non-monotonic/invalid aligned ts {ts!r} on "
                          f"{ev.get('name')!r} (pid {ev.get('pid')})")
            continue
        if ph in ("s", "t", "f"):
            n_flows += 1
            fid = ev.get("id")
            if fid is None:
                errors.append(f"flow event without id: {ev}")
                continue
            if ph == "s":
                if fid in starts:
                    errors.append(f"duplicate flow s for id {fid}")
                starts[fid] = ev
            elif ph == "f":
                if fid in finishes:
                    errors.append(f"duplicate flow f for id {fid}")
                finishes[fid] = ev
    for fid, ev in starts.items():
        fin = finishes.get(fid)
        if fin is None:
            errors.append(
                f"flow s id={fid} ({ev.get('name')}, pid {ev.get('pid')},"
                f" tid {ev.get('tid')}) has no matching f")
        elif not unalignable and fin["ts"] + slack_s * 1e6 < ev["ts"]:
            errors.append(
                f"flow id={fid} runs backwards after alignment: "
                f"s at {ev['ts']:.1f}us, f at {fin['ts']:.1f}us "
                f"(slack {slack_s * 1e3:.1f}ms)")
    for fid in set(finishes) - set(starts):
        # the coordinator closed an arc whose member never learned the
        # round completed (lost reply) — noisy, not wrong
        print(f"bps_trace: warning: flow f id={fid} has no s",
              file=sys.stderr)
    if n_flows == 0:
        print("bps_trace: warning: no flow events in the merged trace",
              file=sys.stderr)
    return errors


def summarize(merged: dict) -> dict:
    evs = [e for e in merged["traceEvents"] if e.get("ph") != "M"]
    flows = [e for e in evs if e.get("ph") in ("s", "t", "f")]
    pids_per_flow: Dict[int, set] = {}
    for e in flows:
        pids_per_flow.setdefault(e.get("id"), set()).add(e.get("pid"))
    cross = sum(1 for pids in pids_per_flow.values() if len(pids) > 1)
    return {"files": len(merged.get("mergedFrom", [])),
            "events": len(evs),
            "flow_events": len(flows),
            "flow_arcs": len(pids_per_flow),
            "cross_process_arcs": cross,
            "span_ms": round((max((e.get("ts", 0) for e in evs),
                                  default=0)) / 1e3, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--validate", action="store_true")
    args = ap.parse_args(argv)

    if args.dir is None:
        # same derivation the engine flushes to — the tool must look
        # where the tracer wrote, not at a second hardcoded default
        from byteps_tpu_torch.common.config import trace_dir_from_env
        args.dir = trace_dir_from_env()

    docs = load_trace_files(args.dir)
    if not docs:
        print(f"bps_trace: no bps_trace_rank*.json under {args.dir}",
              file=sys.stderr)
        return 2
    merged = merge(docs)
    out = args.out or os.path.join(args.dir, "bps_trace_merged.json")
    with open(out, "w") as f:
        json.dump(merged, f)
    summary = summarize(merged)
    summary["out"] = out
    if args.validate:
        errors = validate(merged)
        summary["validation_errors"] = len(errors)
        print(json.dumps(summary))
        for e in errors[:50]:
            print(f"bps_trace: INVALID: {e}", file=sys.stderr)
        return 1 if errors else 0
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
