"""bpslaunch: the port's process launcher, one worker per GPU; port of
``byteps_tpu/launcher/launch.py``.

The JAX launcher runs the command once per host, because JAX has one
controller per host.  The port's process model is the original
BytePS's (``launcher/launch.py:180-216`` of the reference): one process
per visible GPU.  The worker role starts ``L`` copies of the command
with ``BYTEPS_LOCAL_RANK=0..L-1`` and ``BYTEPS_LOCAL_SIZE=L``:

- ``L`` is ``BYTEPS_LOCAL_SIZE`` when it is set, else the number of
  visible cards.  With neither, the launcher exits non-zero and names
  the variable: it never falls back to the CPU unasked (set
  ``BYTEPS_LOCAL_SIZE`` and pass the command its own ``--device cpu``);
- at one host with ``L > 1`` and no ``DMLC_PS_ROOT_URI/PORT``, it sets
  ``127.0.0.1`` and a free port, a new one at each attempt (the
  membership bus, when one is used, takes ``DMLC_PS_ROOT_PORT + 2``, so
  that port must be free too);
- the first worker to exit non-zero stops its siblings, and the group's
  code is that worker's (a death by signal keeps its negative code);
  SIGINT and SIGTERM reach every worker.

Supervision, as in the JAX launcher: ``--restart N`` (or
``BYTEPS_RESTART_LIMIT``) restarts when the group exits with the failure
detector's restartable code (``BYTEPS_FAILURE_EXIT_CODE``, default 17),
with full-jitter backoff from ``RetryPolicy.from_config``.  All ``L``
workers restart together, because the process group must form again.
Any other code passes through unretried.

Roles ``server`` and ``scheduler`` exit 0 with a notice (the collectives
replace the parameter server), ``BYTEPS_ENABLE_GDB=1`` runs each worker
under gdb, and ``BYTEPS_TRACE_ON=1`` creates the trace directory first.

Fleet mode: a leading ``--fleet`` embeds the fleet reconciler
(``launcher/reconciler.py``) beside the workers; with no command it is
``python -m byteps_tpu_torch.launcher.reconciler``.

Usage:
    python -m byteps_tpu_torch.launcher.launch [--restart N] [--fleet] \\
        python -m byteps_tpu_torch.examples.train_mnist_byteps
    BYTEPS_LOCAL_SIZE=2 python -m byteps_tpu_torch.launcher.launch \\
        python -m byteps_tpu_torch.examples.train_mnist_byteps --device cpu
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

from ..common.config import _env_int

_STOP_GRACE_S = 10.0     # a sibling's SIGTERM, then SIGKILL
_USAGE = "usage: bpslaunch [--restart N] [--fleet] COMMAND [ARGS...]"


class _NoDevices(RuntimeError):
    pass


# the workers of the running attempt, which a forwarded signal reaches
_live: List[subprocess.Popen] = []


def _run_once(cmd: list, env: dict) -> int:
    """One worker, waited for (the launch at ``L = 1``)."""
    proc = subprocess.Popen(cmd, env=env)
    _live.append(proc)
    try:
        return proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        _live.remove(proc)


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    end = time.monotonic() + _STOP_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _wait_group(procs) -> int:
    """The first non-zero exit stops the others and is the group's
    code, else 0."""
    rc = 0
    live = list(procs)
    try:
        while live:
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code != 0 and rc == 0:
                    rc = code
                    _stop(live)
            time.sleep(0.05)
        return rc
    finally:
        _stop(procs)


def _run_group(cmd: list, envs: List[dict]) -> int:
    """Start one worker per env and wait for the group.  SIGINT and
    SIGTERM sent to the launcher reach every worker."""
    def forward(signum, _frame):
        for p in list(_live):
            if p.poll() is None:
                p.send_signal(signum)

    previous = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            previous[sig] = signal.signal(sig, forward)
    try:
        if len(envs) == 1:
            return _run_once(cmd, envs[0])
        procs = [subprocess.Popen(cmd, env=e) for e in envs]
        _live.extend(procs)
        try:
            return _wait_group(procs)
        finally:
            del _live[:]
    finally:
        for sig, h in previous.items():
            signal.signal(sig, h)


def _free_port_pair() -> int:
    """A loopback port ``p`` with ``p + 2`` free as well (the bus)."""
    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if p + 2 > 65535:
            continue
        try:
            with socket.socket() as a, socket.socket() as b:
                a.bind(("127.0.0.1", p))
                b.bind(("127.0.0.1", p + 2))
            return p
        except OSError:
            continue
    raise RuntimeError("bpslaunch: no free loopback port pair")


def local_size(env: Optional[dict] = None) -> int:
    """The number of workers to start: ``BYTEPS_LOCAL_SIZE``, else the
    visible cards; raises when there is neither."""
    env = os.environ if env is None else env
    if env.get("BYTEPS_LOCAL_SIZE"):
        n = int(env["BYTEPS_LOCAL_SIZE"])
        if n < 1:
            raise ValueError(f"BYTEPS_LOCAL_SIZE={n} must be >= 1")
        return n
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise _NoDevices(
            "bpslaunch: no visible CUDA device and BYTEPS_LOCAL_SIZE is "
            "not set; set BYTEPS_LOCAL_SIZE=N to start N workers (and "
            "pass the command --device cpu to run them on the CPU)")
    return n


def worker_envs(base: dict, n: int) -> List[dict]:
    """The environments of ``n`` local workers: ranks 0..n-1, and a
    fresh loopback rendezvous where one host runs several workers
    without one."""
    base = dict(base)
    base.setdefault("DMLC_ROLE", "worker")
    if (n > 1 and int(base.get("DMLC_NUM_WORKER", "1")) <= 1
            and not (base.get("DMLC_PS_ROOT_URI")
                     and base.get("DMLC_PS_ROOT_PORT"))):
        base["DMLC_PS_ROOT_URI"] = "127.0.0.1"
        base["DMLC_PS_ROOT_PORT"] = str(_free_port_pair())
    return [dict(base, BYTEPS_LOCAL_RANK=str(i), BYTEPS_LOCAL_SIZE=str(n))
            for i in range(n)]


def launch_worker(cmd: list, restart_limit: Optional[int] = None) -> int:
    env = dict(os.environ)
    try:
        n = local_size(env)
    except (_NoDevices, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2
    # bpslint: ignore[env-knob] reason=launcher-side wrapper knob applied to the worker argv before any Python/Config starts in the worker
    if env.get("BYTEPS_ENABLE_GDB", "0") == "1":
        # debug wrapping, reference launch.py:146-149: run each worker
        # under gdb so a crash drops a backtrace instead of dying silently
        cmd = ["gdb", "-ex", "run", "-ex", "bt", "--batch",
               "--args"] + list(cmd)
    if env.get("BYTEPS_TRACE_ON", "0") == "1":
        # reference launch.py:150-175: create the trace dir so the
        # engine's timeline writer never races on mkdir
        from ..common.config import trace_dir_from_env
        trace_dir = env.get("BYTEPS_TRACE_DIR") or trace_dir_from_env()
        os.makedirs(trace_dir, exist_ok=True)
    if restart_limit is None:
        restart_limit = _env_int("BYTEPS_RESTART_LIMIT", 0)
    restartable = _env_int("BYTEPS_FAILURE_EXIT_CODE", 17)
    from ..common.config import Config
    from ..common.retry import RetryPolicy
    backoff = RetryPolicy.from_config(Config.from_env())
    attempt = 0
    while True:
        # a new rendezvous port at each attempt: the last group's may
        # still be in TIME_WAIT
        rc = _run_group(cmd, worker_envs(env, n))
        if rc != restartable or attempt >= restart_limit:
            if attempt and rc != 0:
                print(f"bpslaunch: worker still failing (exit {rc}) after "
                      f"{attempt} restart(s); giving up", file=sys.stderr)
            return rc
        attempt += 1
        delay = backoff.backoff(attempt)
        print(f"bpslaunch: worker exited {rc} (restartable); restart "
              f"{attempt}/{restart_limit} in {delay:.2f}s", file=sys.stderr)
        time.sleep(delay)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    restart_limit = None
    fleet = False
    # only LEADING --restart N / --fleet belong to bpslaunch; anything
    # after the command is the command's own business
    while argv[:1] in (["--restart"], ["--fleet"]):
        if argv[0] == "--fleet":
            fleet = True
            argv = argv[1:]
            continue
        if len(argv) < 2 or not argv[1].isdigit():
            print(_USAGE, file=sys.stderr)
            return 2
        restart_limit = int(argv[1])
        argv = argv[2:]
    if fleet and not argv:
        from .reconciler import main as reconciler_main
        return reconciler_main([])
    role = os.environ.get("DMLC_ROLE", "worker").lower()
    if role in ("server", "scheduler"):
        print(f"bpslaunch: role '{role}' is not needed by "
              "byteps_tpu_torch (torch.distributed collectives replace "
              "the parameter server); exiting 0.", file=sys.stderr)
        return 0
    if not argv:
        print(_USAGE, file=sys.stderr)
        return 2
    rec = None
    if fleet:
        from .reconciler import FleetReconciler
        rec = FleetReconciler()
        if rec.directory.bus is None:
            print("bpslaunch: --fleet needs BYTEPS_SERVE_TIER_BUS; "
                  "running the worker without fleet supervision",
                  file=sys.stderr)
            rec = None
        else:
            threading.Thread(target=rec.run, daemon=True,
                             name="bps-fleet-reconciler").start()
    try:
        return launch_worker(argv, restart_limit=restart_limit)
    finally:
        if rec is not None:
            rec.close()


if __name__ == "__main__":
    sys.exit(main())
