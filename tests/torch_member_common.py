"""Shared set-up of the port's membership and gossip tests
(``tests/test_torch_{membership,gossip,elastic,coordinator_failover,
partition,straggler,doctor}.py``): the fault plane's reset
(``torch_fault_common``), both observability planes' reset
(``torch_obs_common``), both packages' active membership and health
providers, all around every test; plus the helpers the files share: one
bus request, an elastic-worker spawner and the worker's line parsers."""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys

import pytest

from .torch_fault_common import REPO, _reset as _fault_reset, free_port
from .torch_obs_common import reset_all as _obs_reset

WORKER = os.path.join(REPO, "tests", "torch_elastic_worker.py")


def reset_membership_state():
    from byteps_tpu.common import health as jhealth
    from byteps_tpu.fault import membership as jmem
    from byteps_tpu_torch.fault import membership as pmem
    _fault_reset()
    _obs_reset()
    jhealth._reset_for_tests()
    for mod in (jmem, pmem):
        m = mod.active_membership()
        if m is not None:
            m.stop()
        mod._active_ref = None


@pytest.fixture(autouse=True)
def fresh_member_state():
    env = {k: os.environ.get(k) for k in ("DMLC_NUM_WORKER",
                                          "DMLC_WORKER_ID")}
    reset_membership_state()
    yield
    reset_membership_state()
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def req(port, msg, timeout=20.0, send=None, recv=None):
    """One request/reply round trip to a bus on 127.0.0.1:``port``, with
    the port's frame helpers unless others are given."""
    from byteps_tpu_torch.fault.membership import _recv_obj, _send_obj
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.settimeout(timeout)
    (send or _send_obj)(s, msg)
    reply = (recv or _recv_obj)(s)
    s.close()
    return reply


def spawn(rank, world, bus_port, hb_port, steps, extra=None):
    """One port elastic worker (``tests/torch_elastic_worker.py``) on the
    CPU, its output captured."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["BYTEPS_ELASTIC_RANK"] = str(rank)
    env["BYTEPS_ELASTIC_WORLD"] = ",".join(map(str, world))
    env["BYTEPS_ELASTIC_BUS"] = (f"127.0.0.1:{bus_port}"
                                 if bus_port is not None else "")
    env["BYTEPS_ELASTIC_HB_PORT"] = str(hb_port) if hb_port else ""
    env["BYTEPS_ELASTIC_STEPS"] = str(steps)
    env["BYTEPS_LOG_LEVEL"] = "ERROR"
    env["BYTEPS_MEMBERSHIP_RENDEZVOUS_TIMEOUT"] = "3"
    env["BYTEPS_MEMBERSHIP_SYNC_TIMEOUT"] = "15"
    for k in ("BYTEPS_FAULT_SPEC", "DMLC_NUM_WORKER", "DMLC_WORKER_ID",
              "BYTEPS_HEARTBEAT_ON"):
        env.pop(k, None)
    env.update(extra or {})
    return subprocess.Popen([sys.executable, WORKER], env=env, cwd=REPO,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def communicate(procs, timeout=120):
    outs = {}
    try:
        for name, p in procs.items():
            outs[name], _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs.values():
            p.kill()
        pytest.fail("elastic workers hung; partial output: "
                    + "".join(o[-1500:] for o in outs.values()))
    return outs


def final(out):
    """``(epoch, world, w)`` of a worker's FINAL line."""
    m = re.search(r"FINAL (\d+) (\S+) (\S+)", out)
    assert m, out[-3000:]
    return int(m.group(1)), m.group(2), float(m.group(3))


def simulate(phases, lr=0.1, dim=8):
    """The workers' arithmetic replayed piecewise: ``phases`` is a list
    of ``(world, steps)``; each step applies the world's mean of the
    rank-distinct gradients ``(r + 1) ** 2`` (``_simulate`` of the JAX
    package's ``tests/test_elastic.py``)."""
    import numpy as np
    w = np.zeros(dim, np.float32)
    for world, steps in phases:
        for _ in range(steps):
            grads = [np.full(dim, float((r + 1) ** 2), np.float32)
                     for r in world]
            w = w - np.float32(lr) * (np.sum(grads, axis=0,
                                             dtype=np.float32)
                                      / np.float32(len(grads)))
    return float(w[0])


__all__ = ["REPO", "WORKER", "communicate", "final", "free_port",
           "fresh_member_state", "req", "reset_membership_state",
           "simulate", "spawn"]
