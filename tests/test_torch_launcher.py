"""bpslaunch of the port (byteps_tpu_torch/launcher/launch.py) against
the JAX package's, and its one-worker-per-GPU behaviour on the CPU.

At one local worker both launchers' ``main`` run with ``_run_once``
replaced by a recorder that plays a scripted list of exit codes: they
must return the same code, run the same argv the same number of times,
and agree on every ``DMLC_*``, ``BYTEPS_LOCAL_RANK`` and
``BYTEPS_TRACE_DIR`` value, for a clean exit, a restartable code under
the limit, a limit that runs out, a custom failure code, the server and
scheduler roles, ``--fleet`` without a bus, gdb wrapping and the trace
directory.

With ``BYTEPS_LOCAL_SIZE=2`` the port's launcher starts two real
workers that push_pull over gloo; a failing worker stops its sibling;
code 17 restarts both, on a new rendezvous port; SIGTERM reaches both;
and with no card and no ``BYTEPS_LOCAL_SIZE`` it exits non-zero and
names the variable.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from byteps_tpu.launcher import launch as jax_launch
from byteps_tpu_torch.launcher import launch as port_launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMD = ["python", "train.py", "--lr", "0.1"]
ENV_KEYS = ("BYTEPS_LOCAL_RANK", "BYTEPS_TRACE_DIR")


def _seen_env(env):
    return {k: v for k, v in env.items()
            if k.startswith("DMLC_") or k in ENV_KEYS}


def _drive(mod, monkeypatch, argv, codes):
    calls = []
    script = list(codes)

    def recorder(cmd, env):
        calls.append((list(cmd), _seen_env(env)))
        return script.pop(0)

    monkeypatch.setattr(mod, "_run_once", recorder)
    rc = mod.main(list(argv))
    return rc, calls


SCENARIOS = {
    # name: (argv, scripted exit codes, extra env)
    "clean": (CMD, [0], {}),
    "restart_under_limit": (["--restart", "2"] + CMD, [17, 17, 0], {}),
    "limit_runs_out": (["--restart", "1"] + CMD, [17, 17], {}),
    "crash_not_restarted": (["--restart", "3"] + CMD, [3], {}),
    "signal_death": (CMD, [-9], {}),
    "custom_failure_code": (CMD, [23, 0], {"BYTEPS_FAILURE_EXIT_CODE": "23",
                                           "BYTEPS_RESTART_LIMIT": "1"}),
    "default_code_not_custom": (CMD, [17], {"BYTEPS_FAILURE_EXIT_CODE": "23",
                                            "BYTEPS_RESTART_LIMIT": "1"}),
    "server_role": (CMD, [], {"DMLC_ROLE": "server"}),
    "scheduler_role": (CMD, [], {"DMLC_ROLE": "scheduler"}),
    "fleet_without_bus": (["--fleet"] + CMD, [0], {}),
    "gdb": (CMD, [0], {"BYTEPS_ENABLE_GDB": "1"}),
    "dmlc_env": (CMD, [0], {"DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "1",
                            "DMLC_PS_ROOT_URI": "10.0.0.1",
                            "DMLC_PS_ROOT_PORT": "9100"}),
    "usage_missing_n": (["--restart"], [], {}),
    "usage_no_command": ([], [], {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_main_matches_jax_at_one_worker(monkeypatch, name):
    argv, codes, extra = SCENARIOS[name]
    for k in ("BYTEPS_RESTART_LIMIT", "BYTEPS_FAILURE_EXIT_CODE",
              "BYTEPS_ENABLE_GDB", "BYTEPS_TRACE_ON", "BYTEPS_SERVE_TIER_BUS",
              "DMLC_ROLE", "DMLC_NUM_WORKER", "DMLC_WORKER_ID",
              "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "BYTEPS_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BYTEPS_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("BYTEPS_RETRY_MAX_DELAY", "0.001")
    # one local worker; there is no card here
    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "1")
    for k, v in extra.items():
        monkeypatch.setenv(k, v)
    jrc, jcalls = _drive(jax_launch, monkeypatch, argv, codes)
    prc, pcalls = _drive(port_launch, monkeypatch, argv, codes)
    assert prc == jrc
    assert pcalls == jcalls
    assert len(pcalls) == len(codes)
    if name == "gdb":
        assert pcalls[0][0][:7] == ["gdb", "-ex", "run", "-ex", "bt",
                                    "--batch", "--args"]


def test_trace_dir_created_and_env_matches(monkeypatch, tmp_path):
    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "1")
    monkeypatch.setenv("BYTEPS_TRACE_ON", "1")
    out = {}
    for mod in (jax_launch, port_launch):
        d = tmp_path / mod.__name__.split(".")[0] / "trace"
        monkeypatch.setenv("BYTEPS_TRACE_DIR", str(d))
        rc, calls = _drive(mod, monkeypatch, CMD, [0])
        assert rc == 0 and d.is_dir()
        out[mod] = (calls[0][1]["BYTEPS_TRACE_DIR"], calls[0][0])
    assert out[jax_launch][1] == out[port_launch][1]
    assert {os.path.basename(v[0]) for v in out.values()} == {"trace"}


# --------------------------------------------------------- real workers

def _env(**kw):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
              "DMLC_WORKER_ID", "BYTEPS_LOCAL_RANK", "BYTEPS_LOCAL_SIZE",
              "BYTEPS_RESTART_LIMIT"):
        env.pop(k, None)
    env.update(BYTEPS_RETRY_BASE_DELAY="0.001", BYTEPS_RETRY_MAX_DELAY="0.001")
    env.update(kw)
    return env


def _launch(args, env, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


PUSH_PULL = (
    "import torch, byteps_tpu_torch as bps\n"
    "bps.init(device='cpu')\n"
    "x = torch.arange(4, dtype=torch.float32) * (bps.rank() + 1)\n"
    "y = bps.push_pull(x, name='x', average=False)\n"
    "print('RANK', bps.rank(), bps.size(), bps.local_rank(),\n"
    "      bps.local_size(), y.tolist(), flush=True)\n"
    "bps.shutdown()\n")


def test_two_workers_push_pull_over_gloo():
    r = _launch([sys.executable, "-c", PUSH_PULL],
                _env(BYTEPS_LOCAL_SIZE="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = sorted(ln.split(" ", 1)[1] for ln in r.stdout.splitlines()
                   if ln.startswith("RANK"))
    # 1*x + 2*x on both ranks
    assert lines == ["0 2 0 2 [0.0, 3.0, 6.0, 9.0]",
                     "1 2 1 2 [0.0, 3.0, 6.0, 9.0]"]


def test_failing_worker_stops_its_sibling():
    code = ("import os, sys, time\n"
            "if os.environ['BYTEPS_LOCAL_RANK'] == '1':\n"
            "    sys.exit(5)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    r = _launch([sys.executable, "-c", code], _env(BYTEPS_LOCAL_SIZE="2"))
    assert r.returncode == 5
    assert time.monotonic() - t0 < 30


def test_code_17_restarts_every_worker_on_a_new_port(tmp_path):
    log = tmp_path / "starts"
    code = ("import os, sys, time\n"
            f"p = {str(log)!r}\n"
            "r = os.environ['BYTEPS_LOCAL_RANK']\n"
            "prev = open(p).read().split() if os.path.exists(p) else []\n"
            "first = not any(x.startswith(r + ':') for x in prev)\n"
            "with open(p, 'a') as f:\n"
            "    f.write(r + ':' + os.environ['DMLC_PS_ROOT_PORT'] + ' ')\n"
            "if first and r == '0':\n"
            "    time.sleep(0.5); sys.exit(17)\n"
            "if first:\n"
            "    time.sleep(60)\n")
    r = _launch(["--restart", "1", sys.executable, "-c", code],
                _env(BYTEPS_LOCAL_SIZE="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    starts = log.read_text().split()
    assert sorted(s.split(":")[0] for s in starts) == ["0", "0", "1", "1"]
    ports = [s.split(":")[1] for s in starts]
    assert len(set(ports[:2])) == 1 and ports[2] == ports[3]
    assert ports[0] != ports[2]
    assert "restart 1/1" in r.stderr


def test_sigterm_reaches_every_worker(tmp_path):
    marks = tmp_path / "up"
    code = ("import os, time\n"
            f"open({str(marks)!r} + os.environ['BYTEPS_LOCAL_RANK'], 'w')"
            ".close()\n"
            "time.sleep(60)\n")
    p = subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
         sys.executable, "-c", code], cwd=ROOT, env=_env(BYTEPS_LOCAL_SIZE="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        end = time.monotonic() + 60
        while not all(os.path.exists(f"{marks}{i}") for i in range(2)):
            assert time.monotonic() < end and p.poll() is None
            time.sleep(0.05)
        t0 = time.monotonic()
        p.send_signal(signal.SIGTERM)
        p.wait(timeout=20)
        assert time.monotonic() - t0 < 15
        # the workers died by the forwarded signal: the group's code
        assert p.returncode == (-signal.SIGTERM) % 256
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_no_card_and_no_local_size_names_the_variable():
    r = _launch(["true"], _env())
    assert r.returncode != 0
    assert "BYTEPS_LOCAL_SIZE" in r.stderr
