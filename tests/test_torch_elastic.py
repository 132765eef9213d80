"""Elastic membership end to end on the port (``byteps_tpu_torch/fault/
membership.py`` + ``tests/torch_elastic_worker.py``): the JAX package's
cases of ``tests/test_elastic.py``, three real processes each with its
own CPU engine at a world of one (``DMLC_NUM_WORKER=1``,
``DMLC_WORKER_ID=<rank>``), one bus and one membership-managed heartbeat
server:

- a killed member's survivors shrink in place and match a clean run of
  the survivor world started from the state at the shrink;
- the killed member restarts and rejoins at a step boundary, with the
  survivors' parameters, and the stale-epoch probes drop their chunk and
  push;
- the sharded-update leg re-imports its stashed slot after the shrink
  and commits each step exactly once;
- a second member dying inside the shrink window leaves the last one to
  finish alone.

Every FINAL ``w`` is also held against the JAX worker's arithmetic
(``_simulate`` of ``tests/test_elastic.py``) at its tolerance of 1e-5.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from tests.test_elastic import _simulate as jax_simulate

from .torch_member_common import (communicate, final, free_port,  # noqa: F401
                                  fresh_member_state, simulate, spawn)

KILL = {"BYTEPS_FAULT_SEED": "7"}
# Headroom for a loaded host (the suite runs under ``-n 6``, this file's
# first test beside six interpreters importing JAX): a member whose
# heartbeat thread or bus handler is starved past the 0.7 s detection
# timeout, or that reaches the shrink rendezvous later than 3 s after its
# peer, is taken for dead beside the victim, and the survivors agree on
# {0} instead of {0, 2}.  The test's subject is the shrink's arithmetic,
# not its detection speed.
LOADED = {"BYTEPS_ELASTIC_HB_TIMEOUT": "3.0",
          "BYTEPS_MEMBERSHIP_RENDEZVOUS_TIMEOUT": "10"}


def test_shrink_to_survivors_matches_clean_run():
    """Kill member 1 at push 4 of 9: members 0 and 2 shrink in place
    (epoch 1, world {0, 2}, no exit) and end where a clean {0, 2} run
    from the state at the shrink ends."""
    n, kill_at = 9, 4
    bus, hb = free_port(), free_port()
    procs = {r: spawn(r, (0, 1, 2), bus, hb, n, extra={
        **LOADED, **({**KILL, "BYTEPS_FAULT_SPEC": f"kill:rank=1:step={kill_at}"}
                     if r == 1 else {})}) for r in (0, 1, 2)}
    outs = communicate(procs, timeout=240)
    assert procs[1].returncode == 1, outs[1][-3000:]
    assert "START 1" in outs[1] and "FINAL" not in outs[1]
    finals = {}
    for r in (0, 2):
        assert procs[r].returncode == 0, outs[r][-3000:]
        assert "WORLD 1 0,2" in outs[r], outs[r][-3000:]
        finals[r] = final(outs[r])
        assert finals[r][:2] == (1, "0,2"), finals[r]
    assert finals[0][2] == finals[2][2]
    w_shrink = simulate([((0, 1, 2), kill_at - 1)])
    bus2 = free_port()
    procs2 = {r: spawn(r, (0, 2), bus2, None, n, extra={
        **LOADED, "BYTEPS_ELASTIC_START_STEP": str(kill_at),
        "BYTEPS_ELASTIC_INIT_W": repr(w_shrink)}) for r in (0, 2)}
    outs2 = communicate(procs2, timeout=240)
    for r in (0, 2):
        assert procs2[r].returncode == 0, outs2[r][-3000:]
    clean = final(outs2[0])
    assert clean[:2] == (0, "0,2") and clean[2] == final(outs2[2])[2]
    assert finals[0][2] == clean[2]
    # the JAX worker's arithmetic, piecewise over the two worlds
    want = jax_simulate(jax_simulate(0.0, (0, 1, 2), kill_at - 1), (0, 2),
                        n - kill_at + 1)
    assert finals[0][2] == pytest.approx(want, abs=1e-5)


def test_rejoin_in_place_at_step_boundary():
    """The killed member restarts and is admitted at a step boundary
    (epoch 2, world {0,1,2}) with the survivors' epoch, keys and
    parameters; every member ends at the same ``w``; member 0's stale
    chunk and stale server push are dropped.  Member 0, which hosts the
    bus, holds its first step barrier after the shrink until the
    restarted member is parked there: on a loaded host a fresh
    interpreter can take longer to start than the survivors' 40 steps."""
    from byteps_tpu_torch.fault.membership import bus_request
    n, kill_at = 40, 4
    bus, hb = free_port(), free_port()
    # the held barrier waits for the restarted interpreter: its sync
    # deadline must outlast that start
    held = {"BYTEPS_MEMBERSHIP_SYNC_TIMEOUT": "120"}
    procs = {r: spawn(r, (0, 1, 2), bus, hb, n, extra={
        **held, "BYTEPS_ELASTIC_STEP_SLEEP": "0.3",
        **({**KILL, "BYTEPS_FAULT_SPEC": f"kill:rank=1:step={kill_at}"}
           if r == 1 else
           {"BYTEPS_ELASTIC_STALE_PROBE": "1",
            "BYTEPS_ELASTIC_HOLD_FOR_REJOIN": "1"} if r == 0 else {})})
        for r in (0, 1, 2)}
    out_victim, _ = procs[1].communicate(timeout=120)
    assert procs[1].returncode == 1, out_victim[-3000:]
    deadline = time.monotonic() + 90.0
    while True:
        try:
            pong = bus_request(("127.0.0.1", bus), {"op": "ping"},
                               timeout=3.0)
        except (ConnectionError, TimeoutError):
            pong = {}
        if (pong.get("ok") and int(pong.get("epoch", 0)) >= 1
                and sorted(pong.get("world") or ()) == [0, 2]):
            break
        assert time.monotonic() < deadline, pong
        time.sleep(0.1)
    rejoiner = spawn(1, (0, 1, 2), bus, None, n, extra={
        **held, "BYTEPS_ELASTIC_REJOIN": "1",
        "BYTEPS_ELASTIC_STEP_SLEEP": "0.3"})
    outs = communicate({0: procs[0], 2: procs[2], "rj": rejoiner})
    assert rejoiner.returncode == 0, outs["rj"][-3000:]
    line = next(ln for ln in outs["rj"].splitlines()
                if ln.startswith("REJOINED "))
    _, epoch, world, step0 = line.split()
    assert int(epoch) == 2 and world == "0,1,2", line
    assert kill_at - 1 <= int(step0) < n, line
    finals = {}
    for r in (0, 2):
        assert procs[r].returncode == 0, outs[r][-3000:]
        assert "WORLD 1 0,2" in outs[r] and "WORLD 2 0,1,2" in outs[r]
        finals[r] = final(outs[r])
        assert finals[r][:2] == (2, "0,1,2"), finals[r]
    fin_rj = final(outs["rj"])
    assert fin_rj[:2] == (2, "0,1,2")
    assert finals[0][2] == finals[2][2] == fin_rj[2]
    # the JAX arithmetic: {0,1,2} to the kill, {0,2} until the admission
    # boundary (the rejoiner's state step), then {0,1,2}
    s0 = int(step0)
    want = jax_simulate(jax_simulate(jax_simulate(
        0.0, (0, 1, 2), kill_at - 1), (0, 2), s0 - kill_at + 1),
        (0, 1, 2), n - s0)
    assert fin_rj[2] == pytest.approx(want, abs=1e-5)
    assert "STALE-CHUNK-DROPPED" in outs[0], outs[0][-3000:]
    assert "STALE-PUSH-DROPPED" in outs[0], outs[0][-3000:]


def _torch_sgd_replay(worlds):
    """The worker's sharded leg replayed with eager torch SGD (momentum
    0.9) on the whole 11-vector: a slot on a world of one steps the same
    optimizer on the same (unpadded) shard."""
    from tests.torch_elastic_worker import LR, SU_DIM
    basis = torch.arange(1, SU_DIM + 1, dtype=torch.float32)
    w = torch.zeros(SU_DIM)
    opt = torch.optim.SGD([w], lr=LR, momentum=0.9)
    for ranks in worlds:
        g0 = (np.sum([np.float32((r + 1) ** 2) for r in ranks],
                     dtype=np.float32) / np.float32(len(ranks)))
        w.grad = torch.from_numpy(np.float32(g0) * basis.numpy())
        opt.step()
    return w.numpy()


def test_shrink_resharding_sharded_update():
    """Kill member 1 mid-step while every member also trains an 11-vector
    through ``declare_update`` / ``push_pull_update`` (torch SGD with
    momentum): the survivors' re-declare restores the stash (``RESHARDED``
    with applied > 0), each step commits exactly once, and the final
    master is the eager replay bit for bit (and the JAX package's optax
    replay to rtol 1e-6).  The owner map of the JAX case does not apply: each
    member's engine is a world of one here."""
    from tests.test_elastic import _simulate_sharded
    n, kill_step = 9, 4
    kill_push = 2 * kill_step - 1
    bus, hb = free_port(), free_port()
    procs = {r: spawn(r, (0, 1, 2), bus, hb, n, extra={
        "BYTEPS_ELASTIC_SHARDED": "1", "BYTEPS_SHARDED_UPDATE": "1",
        **({**KILL, "BYTEPS_FAULT_SPEC": f"kill:rank=1:step={kill_push}"}
           if r == 1 else {})}) for r in (0, 1, 2)}
    outs = communicate(procs)
    assert procs[1].returncode == 1, outs[1][-3000:]
    assert "FINAL" not in outs[1]
    worlds = [(0, 1, 2)] * (kill_step - 1) + [(0, 2)] * (n - kill_step + 1)
    expected = _torch_sgd_replay(worlds)
    for r in (0, 2):
        assert procs[r].returncode == 0, outs[r][-3000:]
        assert "WORLD 1 0,2" in outs[r], outs[r][-3000:]
        resh = [ln for ln in outs[r].splitlines()
                if ln.startswith("RESHARDED ")]
        assert resh and all(int(ln.split()[1]) >= 1 for ln in resh), \
            outs[r][-3000:]
        fin = next(ln for ln in outs[r].splitlines()
                   if ln.startswith("FINAL-SHARDED "))
        _, applied, vals = fin.split(" ", 2)
        assert int(applied) == n, fin
        got = np.array([float(v) for v in vals.split(",")], np.float32)
        assert np.array_equal(got, expected), (r, got, expected)
        # torch's SGD rounds its momentum update once (a fused
        # multiply-add, add_(alpha=)), optax twice: ulps apart
        np.testing.assert_allclose(got, _simulate_sharded(worlds),
                                   rtol=1e-6, atol=0)


def test_double_failure_during_shrink():
    """Member 1 is killed; member 2 dies the moment its detector fires
    (inside the shrink window): member 0 finishes alone at world {0}."""
    n, kill_at = 9, 4
    bus, hb = free_port(), free_port()
    procs = {r: spawn(r, (0, 1, 2), bus, hb, n, extra=(
        {**KILL, "BYTEPS_FAULT_SPEC": f"kill:rank=1:step={kill_at}"}
        if r == 1 else
        {"BYTEPS_ELASTIC_DIE_ON_DETECT": "1"} if r == 2 else None))
        for r in (0, 1, 2)}
    outs = communicate(procs)
    assert procs[1].returncode == 1, outs[1][-3000:]
    assert procs[2].returncode == 1, outs[2][-3000:]
    assert "DIED-ON-DETECT" in outs[2], outs[2][-3000:]
    assert procs[0].returncode == 0, outs[0][-3000:]
    epoch, world, w0 = final(outs[0])
    assert epoch >= 1 and world == "0", (epoch, world)
    want = simulate([((0, 1, 2), kill_at - 1), ((0,), n - kill_at + 1)])
    assert w0 == want
    assert w0 == pytest.approx(jax_simulate(jax_simulate(
        0.0, (0, 1, 2), kill_at - 1), (0,), n - kill_at + 1), abs=1e-5)
