"""bpslaunch-dist of the port (byteps_tpu_torch/launcher/dist_launcher.py)
against the JAX package's, on tests/test_dist_launcher.py's fake-ssh
scenarios.

Each scenario runs through both packages with ssh replaced by a local
stub: ``parse_hostfile``, ``parse_envs``, ``build_env``, the
``LaunchReport`` codes, restarts and errors, the exit summary and
``main``'s exit code must be equal.  By design the remote command
differs: the port wraps it in ``python3 -m
byteps_tpu_torch.launcher.launch`` (one worker per GPU on each host),
which is held to the JAX command with that prefix inserted after the
env assignments.
"""

import os
import shlex
import subprocess

import pytest

from byteps_tpu.common.retry import RetryPolicy as JaxRetry
from byteps_tpu.launcher import dist_launcher as jdl
from byteps_tpu_torch.common.retry import RetryPolicy as PortRetry
from byteps_tpu_torch.launcher import dist_launcher as pdl

MODS = {"jax": (jdl, JaxRetry), "port": (pdl, PortRetry)}
WRAP = ["python3", "-m", "byteps_tpu_torch.launcher.launch"]


def _host(argv):
    return argv[argv.index("-p") + 2]


def _unwrap(remote):
    """The port's remote command with the launcher prefix taken out."""
    toks = shlex.split(remote)
    i = next(i for i, t in enumerate(toks[1:], 1) if "=" not in t)
    assert toks[i:i + 3] == WRAP, remote
    return shlex.join(toks[:i] + toks[i + 3:])


def _fast(retry, attempts=2):
    return retry(max_attempts=attempts, base_delay_s=0.0, max_delay_s=0.0)


def _scenario(name, mod, retry, tmp):
    """Run one scenario; returns (comparable outcome, remote commands)."""
    remotes = []
    state = {}

    def record(argv):
        remotes.append(argv[-1])
        return _host(argv)

    if name == "fan_out":
        def ssh(argv, out, err):
            h = record(argv)
            out.write(f"hello from {h}\n".encode())
            return 0 if h != "h2" else 3
        rep = mod.launch([("h0", "22"), ("h1", "22"), ("h2", "22")],
                         ["python", "-c", "pass"], extra_env={"X": "y"},
                         log_dir=str(tmp / "l"), ssh_runner=ssh)
    elif name == "restart_restartable_only":
        def ssh(argv, out, err):
            h = record(argv)
            state[h] = state.get(h, 0) + 1
            if h == "h0":
                return 17 if state[h] == 1 else 0
            return 1
        rep = mod.launch([("h0", "22"), ("h1", "22")], ["x"],
                         log_dir=str(tmp / "l"), ssh_runner=ssh,
                         restart_limit=3, backoff=_fast(retry))
    elif name == "limit_exhausted":
        def ssh(argv, out, err):
            record(argv)
            err.write(b"detector fired\n")
            return 17
        rep = mod.launch([("h0", "22")], ["x"], log_dir=str(tmp / "l"),
                         ssh_runner=ssh, restart_limit=2,
                         backoff=_fast(retry))
        state["log"] = (tmp / "l" / "worker0.stderr").read_bytes().count(
            b"detector fired")
    elif name == "elastic":
        def ssh(argv, out, err):
            h = record(argv)
            state[h] = state.get(h, 0) + 1
            return 1 if h == "h1" and state[h] == 1 else 0
        rep = mod.launch([("h0", "22"), ("h1", "22"), ("h2", "22")], ["x"],
                         log_dir=str(tmp / "l"), ssh_runner=ssh,
                         restart_limit=2, backoff=_fast(retry), elastic=True)
    elif name == "ssh_retry":
        def ssh(argv, out, err):
            record(argv)
            if len(remotes) == 1:
                raise OSError("connect to host h0: Connection refused")
            return 0
        rep = mod.launch([("h0", "22")], ["x"], log_dir=str(tmp / "l"),
                         ssh_runner=ssh, backoff=_fast(retry))
    elif name == "thread_exception":
        def ssh(argv, out, err):
            if record(argv) == "h1":
                raise ValueError("hostfile entry resolved to garbage")
            return 0
        hosts = [("h0", "22"), ("h1", "22")]
        rep = mod.launch(hosts, ["x"], log_dir=str(tmp / "l"),
                         ssh_runner=ssh, backoff=_fast(retry, 1))
        state["summary"] = mod.format_exit_summary(hosts, rep, "L")
        rep.errors = [e and e.strip().splitlines()[-1] for e in rep.errors]
    else:
        raise KeyError(name)
    return (list(rep), rep.restarts, rep.errors, state), remotes


SCENARIOS = ("fan_out", "restart_restartable_only", "limit_exhausted",
             "elastic", "ssh_retry", "thread_exception")


@pytest.mark.parametrize("name", SCENARIOS)
def test_launch_matches_jax(tmp_path, name):
    out = {k: _scenario(name, mod, retry, tmp_path / k)
           for k, (mod, retry) in MODS.items()}
    assert out["port"][0] == out["jax"][0]
    jr, pr = sorted(out["jax"][1]), sorted(out["port"][1])
    assert len(jr) == len(pr) > 0
    assert sorted(_unwrap(r) for r in pr) == jr


def test_custom_failure_code_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BYTEPS_FAILURE_EXIT_CODE", "23")
    monkeypatch.setenv("BYTEPS_RESTART_LIMIT", "1")
    got = {}
    for k, (mod, retry) in MODS.items():
        seen = []

        def ssh(argv, out, err):
            seen.append(1)
            return 23 if len(seen) == 1 else 0

        rep = mod.launch([("h0", "22")], ["x"], log_dir=str(tmp_path / k),
                         ssh_runner=ssh, backoff=_fast(retry))
        got[k] = (list(rep), rep.restarts, len(seen))
    assert got["port"] == got["jax"] == ([0], [1], 2)


def test_parsers_and_env_match_jax(tmp_path, monkeypatch):
    hf = tmp_path / "hosts"
    hf.write_text("# comment\nhost-a\nhost-b:2222\n\nhost-c : ignored\n")
    assert pdl.parse_hostfile(str(hf)) == jdl.parse_hostfile(str(hf))
    empty = tmp_path / "empty"
    empty.write_text("\n# nothing\n")
    for mod in (jdl, pdl):
        with pytest.raises(ValueError):
            mod.parse_hostfile(str(empty))
    pairs = ["A:1", "B:x:y", "noval", "C:"]
    assert pdl.parse_envs(pairs) == jdl.parse_envs(pairs)
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    hosts = [("w0", "22"), ("w1", "22"), ("w2", "22")]
    for wid in range(3):
        assert (pdl.build_env(hosts, wid, 9100, {"FOO": "bar"})
                == jdl.build_env(hosts, wid, 9100, {"FOO": "bar"}))


def test_ssh_argv_wraps_the_port_launcher_without_shell_injection():
    cmd = ["python", "train.py", "--name", "a b; rm -rf /"]
    j = jdl.ssh_argv("host-a", "22", {"A": "1"}, cmd, "me")
    p = pdl.ssh_argv("host-a", "22", {"A": "1"}, cmd, "me")
    assert p[:-1] == j[:-1]
    assert "'a b; rm -rf /'" in p[-1]
    assert p[-1].startswith("env A=1 python3 -m "
                            "byteps_tpu_torch.launcher.launch python train.py")
    assert _unwrap(p[-1]) == j[-1]


def test_exit_summary_matches_jax():
    hosts = [("a", "22"), ("b", "22"), ("c", "22")]
    args = ([0, -9, 17], [0, 0, 2], [None, None, None])
    assert (pdl.format_exit_summary(hosts, pdl.LaunchReport(*args), "s")
            == jdl.format_exit_summary(hosts, jdl.LaunchReport(*args), "s"))


@pytest.mark.parametrize("codes,want", [((0, 5), 5), ((0, -9), 9),
                                        ((0, 0), 0)])
def test_main_exit_code_matches_jax(tmp_path, monkeypatch, codes, want):
    hf = tmp_path / "hosts"
    hf.write_text("h0\nh1\n")
    by_host = dict(zip(("h0", "h1"), codes))
    monkeypatch.setattr(subprocess, "call",
                        lambda argv, **kw: by_host[_host(argv)])
    rcs = [mod.main(["-H", str(hf), "--log-dir", str(tmp_path / "l"),
                     "--restart", "0", "--", "true"])
           for mod in (jdl, pdl)]
    assert rcs == [want, want]


def test_main_end_to_end_with_local_sh(tmp_path, monkeypatch):
    """The full CLI path with ssh replaced by a shim that runs the remote
    command here: the port's launcher starts the worker with the DMLC
    env and the --env value."""
    hf = tmp_path / "hosts"
    hf.write_text("localhost\n")
    shim = tmp_path / "ssh"
    shim.write_text('#!/bin/bash\neval "${@: -1}"\n')
    shim.chmod(0o755)
    monkeypatch.chdir(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH", root)
    real_call = subprocess.call

    def call_with_shim(argv, **kw):
        assert argv[0] == "ssh"
        return real_call(["bash", str(shim)] + argv[1:], **kw)

    monkeypatch.setattr(subprocess, "call", call_with_shim)
    rc = pdl.main(["-H", str(hf), "--env", "PROBE:42", "--env",
                   "BYTEPS_LOCAL_SIZE:1", "--",
                   "python3", "-c",
                   "import os; print(os.environ['DMLC_NUM_WORKER'], "
                   "os.environ['PROBE'], os.environ['BYTEPS_LOCAL_RANK'])"])
    assert rc == 0, (tmp_path / "sshlog" / "worker0.stderr").read_text()
    out = (tmp_path / "sshlog" / "worker0.stdout").read_text()
    assert out.strip() == "1 42 0"
