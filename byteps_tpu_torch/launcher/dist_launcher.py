"""bpslaunch-dist: multi-host ssh fan-out launcher of the port; port of
``byteps_tpu/launcher/dist_launcher.py`` (the reference's
``launcher/dist_launcher.py``, SURVEY.md §2.5): read a hostfile, ssh the
training command to every host with the bootstrap env injected, stream
logs to ``sshlog/``.

What differs from the JAX launcher: the remote command is wrapped in the
port's ``python3 -m byteps_tpu_torch.launcher.launch``, so each host
starts one worker per visible GPU (``BYTEPS_LOCAL_SIZE``, when passed
with ``--env``, overrides the count), at ``DMLC_NUM_WORKER`` hosts.
Worker 0's host is the coordinator (``DMLC_PS_ROOT_URI/PORT``), where
global rank 0 runs the rendezvous.  ``--server-hostfile`` is accepted
and ignored with a notice, commands are passed to ssh as argument
vectors (no shell string interpolation), and env is injected via
``env KEY=VALUE ...`` on the remote side.

Usage:
    bpslaunch-torch-dist -H hostfile [--port 9100] [--env K:V]...
                         [--restart N] CMD [ARGS...]

Supervision: ``--restart N`` (or ``BYTEPS_RESTART_LIMIT``) restarts a
host whose exit code equals the failure detector's restartable code
(``BYTEPS_FAILURE_EXIT_CODE``, default 17) with full-jitter backoff; a
per-host exit-code summary is printed at the end either way.

Elastic mode (``--elastic`` / ``BYTEPS_ELASTIC``): the survivors shrink
in place (fault/membership.py) instead of exiting, so supervision
restarts **only the dead rank, not the world** — any nonzero exit of a
single worker is restart-worthy (the crash IS the membership event),
and the restarted incarnation gets ``BYTEPS_ELASTIC_REJOIN=1`` so it
comes back through the membership rejoin barrier instead of the init
push barrier.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..common.config import _env_bool, _env_int
from ..common.retry import RetryPolicy

# env vars forwarded from the launcher's own environment when set
_FORWARD_KEYS = ("OMP_NUM_THREADS", "KMP_AFFINITY", "BYTEPS_LOG_LEVEL")


def parse_hostfile(path: str) -> List[Tuple[str, str]]:
    """Lines of ``host[:ssh_port]`` -> [(host, port)]; blanks/# skipped."""
    hosts: List[Tuple[str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            host, _, port = line.partition(":")
            hosts.append((host, port or "22"))
    if not hosts:
        raise ValueError(f"hostfile {path!r} contains no hosts")
    return hosts


def parse_envs(pairs: Sequence[str]) -> Dict[str, str]:
    """``KEY:VALUE`` pairs (reference --env syntax) -> dict."""
    out: Dict[str, str] = {}
    for item in pairs:
        key, sep, val = item.partition(":")
        if sep:
            out[key] = val
    return out


def build_env(hosts: List[Tuple[str, str]], worker_id: int,
              coordinator_port: int, extra: Dict[str, str]) -> Dict[str, str]:
    env = {
        "DMLC_ROLE": "worker",
        "DMLC_NUM_WORKER": str(len(hosts)),
        "DMLC_WORKER_ID": str(worker_id),
        "DMLC_PS_ROOT_URI": hosts[0][0],
        "DMLC_PS_ROOT_PORT": str(coordinator_port),
    }
    for k in _FORWARD_KEYS:
        v = os.environ.get(k)
        if v is not None:
            env[k] = v
    env.update(extra)
    return env


# the remote side: the port's per-host launcher, one worker per GPU
LAUNCH = ("python3", "-m", "byteps_tpu_torch.launcher.launch")


def ssh_argv(host: str, port: str, env: Dict[str, str], cmd: Sequence[str],
             username: Optional[str] = None) -> List[str]:
    """One ssh invocation as an argv list: env injected remotely via
    ``env K=V ... python3 -m byteps_tpu_torch.launcher.launch CMD``."""
    argv = ["ssh", "-o", "StrictHostKeyChecking=no", "-p", port]
    if username:
        argv += ["-l", username]
    remote = ["env"] + [f"{k}={v}" for k, v in sorted(env.items())] + \
        list(LAUNCH) + list(cmd)
    argv += [host, " ".join(shlex.quote(a) for a in remote)]
    return argv


class LaunchReport(List[int]):
    """Per-host final exit codes (list) plus supervision detail.

    ``restarts[i]``: restarts consumed by worker i; ``errors[i]``: the
    launcher-side exception (string traceback) that prevented a clean
    exit code, or None.  Being a list keeps every existing
    ``launch(...) == [0, 0, 3]`` caller working unchanged.
    """

    def __init__(self, codes, restarts, errors):
        super().__init__(codes)
        self.restarts: List[int] = restarts
        self.errors: List[Optional[str]] = errors


def format_exit_summary(hosts: List[Tuple[str, str]],
                        report: "LaunchReport", log_dir: str) -> str:
    """Human-grade per-host exit summary (what the reference never had:
    its dist launcher just joined the ssh threads and exited)."""
    lines = ["worker exit summary:"]
    for i, (host, _) in enumerate(hosts):
        code = report[i]
        if report.errors[i] is not None:
            status = "launcher error (ssh never completed)"
        elif code == 0:
            status = "ok"
        elif code < 0:
            status = f"killed by signal {-code}"
        else:
            status = f"exit {code}"
        line = f"  worker{i} [{host}]: {status}"
        if report.restarts[i]:
            line += f" after {report.restarts[i]} restart(s)"
        if report.errors[i] is not None:
            first = report.errors[i].strip().splitlines()[-1]
            line += f" — {first} (full traceback in {log_dir}/worker{i}.stderr)"
        elif code != 0:
            line += f" (see {log_dir}/worker{i}.stderr)"
        lines.append(line)
    return "\n".join(lines)


def launch(hosts: List[Tuple[str, str]], cmd: Sequence[str],
           coordinator_port: int = 9100,
           extra_env: Optional[Dict[str, str]] = None,
           username: Optional[str] = None,
           log_dir: str = "sshlog",
           ssh_runner=None,
           restart_limit: Optional[int] = None,
           restartable_codes: Optional[Set[int]] = None,
           backoff: Optional[RetryPolicy] = None,
           elastic: bool = False) -> "LaunchReport":
    """Fan the command out to every host; block until all exit.  Returns
    per-host exit codes (a :class:`LaunchReport`).
    ``ssh_runner(argv, stdout, stderr) -> int`` is injectable (tests use
    a local stub instead of real ssh).

    Supervision: a worker exiting with a code in ``restartable_codes``
    (default: the failure detector's ``BYTEPS_FAILURE_EXIT_CODE``, 17) is
    restarted up to ``restart_limit`` times (default
    ``BYTEPS_RESTART_LIMIT``) with per-worker full-jitter backoff —
    detector-triggered exits are *expected* under faults and worth
    retrying; a crash (exit 1) or signal death is not.  A raised
    ``ssh_runner`` (connection refused, DNS) is retried by the same
    policy before counting as a launcher error.

    ``elastic=True`` changes the supervision contract: survivors never
    exit on a peer failure (they shrink in place), so ANY nonzero exit
    is one dead rank worth restarting on its own — the restarted
    incarnation carries ``BYTEPS_ELASTIC_REJOIN=1`` (and every worker
    ``BYTEPS_ELASTIC=1``) so it rejoins the running world through the
    membership bus rather than re-running the cold bootstrap.
    """
    os.makedirs(log_dir, exist_ok=True)
    if ssh_runner is None:
        def ssh_runner(argv, stdout, stderr):
            return subprocess.call(argv, stdout=stdout, stderr=stderr)
    if restart_limit is None:
        restart_limit = _env_int("BYTEPS_RESTART_LIMIT", 0)
    if elastic and restart_limit == 0:
        restart_limit = 1   # elastic without restarts cannot re-grow
    if restartable_codes is None:
        restartable_codes = {_env_int("BYTEPS_FAILURE_EXIT_CODE", 17)}
    if backoff is None:
        from ..common.config import Config
        backoff = RetryPolicy.from_config(Config.from_env())

    codes: List[Optional[int]] = [None] * len(hosts)
    restarts: List[int] = [0] * len(hosts)
    errors: List[Optional[str]] = [None] * len(hosts)

    def run(i: int, host: str, port: str) -> None:
        env = build_env(hosts, i, coordinator_port, extra_env or {})
        if elastic:
            env.setdefault("BYTEPS_ELASTIC", "1")
        base = os.path.join(log_dir, f"worker{i}")
        try:
            attempt = 0
            while True:
                attempt_env = dict(env)
                if elastic and attempt > 0:
                    # only the dead rank restarts; it must come back as
                    # a rejoiner, not a cold bootstrap racing a world
                    # that kept running without it
                    # bpslint: ignore[env-knob] reason=launcher-to-worker marker WRITTEN into the restarted incarnation's env (the worker reads it before any Config exists); documented in env.md elastic table
                    attempt_env["BYTEPS_ELASTIC_REJOIN"] = "1"
                argv = ssh_argv(host, port, attempt_env, cmd, username)
                # restarts append — the first incarnation's logs are the
                # evidence of WHY the restart happened
                mode = "wb" if attempt == 0 else "ab"
                with open(base + ".stdout", mode) as out, \
                        open(base + ".stderr", mode) as err:
                    codes[i] = backoff.call(
                        ssh_runner, argv, out, err,
                        describe=f"ssh dispatch worker{i} [{host}]")
                restart_worthy = (codes[i] != 0 if elastic
                                  else codes[i] in restartable_codes)
                if restart_worthy and attempt < restart_limit:
                    attempt += 1
                    restarts[i] = attempt
                    delay = backoff.backoff(attempt)
                    print(f"worker{i} [{host}] exited {codes[i]} "
                          f"(restartable); restart {attempt}/"
                          f"{restart_limit} in {delay:.2f}s",
                          file=sys.stderr)
                    time.sleep(delay)
                    continue
                return
        except Exception:  # noqa: BLE001 — a dead thread must not map to
            # a silent exit-1: record the traceback where the operator
            # will look (the worker's .stderr log) and in the summary
            tb = traceback.format_exc()
            errors[i] = tb
            try:
                with open(base + ".stderr", "ab") as err:
                    err.write(b"\n[bpslaunch-dist] launcher-side error:\n")
                    err.write(tb.encode())
            except OSError:
                pass  # the log path itself may be what failed

    threads = [threading.Thread(target=run, args=(i, h, p), daemon=True)
               for i, (h, p) in enumerate(hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return LaunchReport([c if c is not None else 1 for c in codes],
                        restarts, errors)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Launch a distributed byteps_tpu_torch job over ssh")
    ap.add_argument("-H", "-WH", "--hostfile", "--worker-hostfile",
                    dest="hostfile", required=True,
                    help="file with one host[:ssh_port] per line")
    ap.add_argument("-SH", "--server-hostfile", dest="server_hostfile",
                    default=None,
                    help="accepted for reference compatibility; ignored "
                         "(no server processes)")
    ap.add_argument("--port", "--scheduler-port", dest="port", type=int,
                    default=9100, help="coordinator port on worker 0")
    ap.add_argument("--env", action="append", default=[],
                    help="KEY:VALUE exported on every host (repeatable)")
    ap.add_argument("--username", default=None, help="ssh username")
    ap.add_argument("--log-dir", default="sshlog")
    ap.add_argument("--restart", type=int, default=None, metavar="N",
                    help="restart a worker up to N times when it exits "
                         "with the restartable failure code "
                         "(BYTEPS_FAILURE_EXIT_CODE, default 17); "
                         "default from BYTEPS_RESTART_LIMIT")
    ap.add_argument("--elastic", action="store_true",
                    default=_env_bool("BYTEPS_ELASTIC", False),
                    help="elastic membership mode: survivors shrink in "
                         "place, ONLY the dead rank is restarted (on any "
                         "nonzero exit) and rejoins the running world "
                         "(BYTEPS_ELASTIC_REJOIN=1)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command to run on every host")
    args = ap.parse_args(argv)

    if args.server_hostfile:
        print("bpslaunch-dist: --server-hostfile ignored "
              "(torch.distributed collectives replace the parameter "
              "server)", file=sys.stderr)
    cmd = list(args.command)
    if cmd and cmd[0] == "--":   # strip only the leading separator: the
        cmd = cmd[1:]            # command's own "--" tokens must survive
    if not cmd:
        ap.error("no command given")

    hosts = parse_hostfile(args.hostfile)
    print(f"Launching {len(hosts)} workers "
          f"(coordinator {hosts[0][0]}:{args.port})")
    codes = launch(hosts, cmd, coordinator_port=args.port,
                   extra_env=parse_envs(args.env), username=args.username,
                   log_dir=args.log_dir, restart_limit=args.restart,
                   elastic=args.elastic)
    print(format_exit_summary(hosts, codes, args.log_dir), file=sys.stderr)
    # signal deaths are negative return codes; max() would mask them
    # behind any worker that exited 0
    return next((abs(c) for c in codes if c != 0), 0)


if __name__ == "__main__":
    sys.exit(main())
