"""Running the harness from a test: one rehearsal on the CPU, its last
line parsed."""

from __future__ import annotations

import json
import os
import subprocess
import sys

REHEARSAL_TIMEOUT_S = 300


def rehearse(root: str, workload: str, seed: int = 7, trace: int = 0,
             plant: str = "", seconds: float = 0.5, program_root=None):
    """``python3 -m perfbench.run --rehearse`` from ``root``: (exit code,
    the last line of standard output as JSON or None, standard error).
    ``program_root`` puts the port on the path (a copy of the benchmark
    alone does not hold it)."""
    env = dict(os.environ)
    if program_root:
        env["PYTHONPATH"] = os.pathsep.join(
            [program_root] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace), "--rehearse"]
    if plant:
        cmd += ["--plant", plant]
    p = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=REHEARSAL_TIMEOUT_S,
                       start_new_session=True)
    lines = p.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and p.returncode == 0 else None
    return p.returncode, last, p.stderr


def checkout_with(repo_root: str, dest, *candidates: str):
    """A copy of the benchmark in ``dest`` whose manifest also holds the
    entries of ``candidates/<name>.json``: a cell measured but not in
    ``BENCHMARK.json``."""
    import shutil
    from pathlib import Path
    dest = Path(dest)
    shutil.copytree(os.path.join(repo_root, "perfbench"), dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads(Path(repo_root, "BENCHMARK.json").read_text())
    for name in candidates:
        cand = json.loads((dest / "perfbench" / "candidates"
                           / f"{name}.json").read_text())
        for key in ("configs", "workloads", "per_layer"):
            m[key] += cand[key]
        cells = [w["name"] for w in cand["workloads"]]
        for p in m["per_layer"]:
            if p["name"] in cand["per_layer_workloads"]:
                p["workloads"] = p["workloads"] + cells
    (dest / "BENCHMARK.json").write_text(json.dumps(m))
    return str(dest)
