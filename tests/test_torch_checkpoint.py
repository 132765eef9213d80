"""The port's checkpoints (``byteps_tpu_torch/utils/checkpoint.py``) and
supervised recovery (``byteps_tpu_torch/fault/recovery.py``): the
manager's directory semantics and atomic writes, restores onto a
template, the broadcast from the root over two gloo processes,
``pack_state`` bytes equal to the JAX package's (sealed and unsealed,
each package's ``unpack_state`` reading the other's), the JAX package's
recovery cases (``tests/test_recovery.py``) on a gloo world of one, and
the 2-process kill-and-recover."""

from __future__ import annotations

import copy
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from byteps_tpu.utils import checkpoint as jck
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common import flight_recorder as pflight
from byteps_tpu_torch.common import integrity
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.core import api
from byteps_tpu_torch.fault import recovery as rec_mod
from byteps_tpu_torch.fault.recovery import RecoveryCoordinator
from byteps_tpu_torch.utils import checkpoint as ck
from byteps_tpu_torch.utils.checkpoint import CheckpointManager

from .torch_fault_common import (REPO, child_env, free_port,  # noqa: F401
                                 fresh_fault_state)

WORKER = os.path.join(REPO, "tests", "torch_fault_worker.py")


def _model_state(seed):
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.ReLU(),
                                torch.nn.Linear(4, 3))
    for p in model.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    x = torch.randn(5, 6, generator=gen)
    model(x).square().sum().backward()
    opt.step()
    return model, opt


# -- the manager ----------------------------------------------------------------


def test_manager_round_trip_onto_the_template(tmp_path):
    """Model and optimizer state dicts, numpy leaves and scalars restore
    onto the template's leaves bit for bit; the newest max_to_keep steps
    stay, one directory each."""
    model, opt = _model_state(0)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    tmpl = {"model": copy.deepcopy(model.state_dict()), "step": 0,
            "opt": copy.deepcopy(opt.state_dict()),
            "rng": np.zeros(4, np.uint32), "lr": 0.0}
    assert mgr.restore_latest(tmpl) == (None, tmpl)
    saved = {}
    for step in (2, 4, 6):
        state = {"model": model.state_dict(), "opt": opt.state_dict(),
                 "step": step, "rng": np.arange(4, dtype=np.uint32) * step,
                 "lr": 0.1 * step}
        assert mgr.save(step, state) is True
        saved[step] = copy.deepcopy(state)
        model[0].weight.data.add_(1.0)     # the trainer moves on
    assert sorted(os.listdir(tmp_path / "ck")) == ["4", "6"]
    step, got = mgr.restore_latest(tmpl)
    assert step == 6
    want = saved[6]
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v) and \
            got["model"][k].dtype == v.dtype
    mom = {k: v["momentum_buffer"] for k, v in got["opt"]["state"].items()}
    for k, v in want["opt"]["state"].items():
        assert torch.equal(mom[k], v["momentum_buffer"])
    assert got["opt"]["param_groups"] == want["opt"]["param_groups"]
    assert got["step"] == 6 and isinstance(got["step"], int)
    assert got["rng"].dtype == np.uint32
    np.testing.assert_array_equal(got["rng"], want["rng"])
    assert got["lr"] == want["lr"]
    # the loaded state goes back into a fresh model and optimizer
    model2, opt2 = _model_state(1)
    model2.load_state_dict(got["model"])
    opt2.load_state_dict(got["opt"])
    for a, b in zip(model2.parameters(), want["model"].values()):
        assert torch.equal(a, b)


def test_reload_rescans_another_managers_steps(tmp_path):
    writer = CheckpointManager(str(tmp_path), max_to_keep=3)
    reader = CheckpointManager(str(tmp_path), max_to_keep=3)
    writer.save(1, {"w": torch.ones(3)})
    writer.save(2, {"w": torch.ones(3) * 2})
    assert reader.latest_step() is None     # its view from construction
    reader.reload()
    step, got = reader.restore_latest({"w": torch.zeros(3)})
    assert step == 2 and torch.equal(got["w"], torch.full((3,), 2.0))


def test_a_failed_write_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, {"w": torch.ones(3)})

    def broken(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, {"w": torch.ones(3) * 2})
    monkeypatch.undo()
    fresh = CheckpointManager(str(tmp_path), max_to_keep=3)
    assert fresh.latest_step() == 1
    assert fresh.restore_latest({"w": torch.zeros(3)})[1]["w"].sum() == 3.0
    assert os.listdir(tmp_path) == ["1"]      # no temporary left behind


def test_async_save_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=True)
    w = torch.ones(1000)
    assert mgr.save(1, {"w": w})
    w.add_(41.0)                   # the trainer overwrites at once
    mgr.save(2, {"w": w})
    mgr.save(3, {"w": w * 2})
    mgr.wait_until_finished()
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    one = ck.restore_and_broadcast(str(tmp_path / "2"), {"w": w})
    assert torch.equal(one["w"], torch.full((1000,), 42.0))
    pending = ck.save_checkpoint(str(tmp_path / "single"), {"w": w},
                                 asynchronous=True)
    assert pending.wait() is True and bool(pending)
    with pytest.raises(FileExistsError):
        ck.save_checkpoint(str(tmp_path / "single"), {"w": w}, force=False)
    assert ck.save_checkpoint(str(tmp_path / "single"), {"w": w * 0}) is True
    assert ck.restore_and_broadcast(str(tmp_path / "single"),
                                    {"w": w})["w"].sum() == 0.0


def test_restore_rejects_a_template_it_does_not_fit(tmp_path):
    ck.save_checkpoint(str(tmp_path), {"w": torch.ones(3)})
    with pytest.raises(KeyError, match="lacks"):
        ck.restore_and_broadcast(str(tmp_path), {"v": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore_and_broadcast(str(tmp_path), {"w": torch.ones(4)})
    with pytest.raises(TypeError, match="cannot store"):
        ck.save_checkpoint(str(tmp_path / "x"), {"w": object()})


def test_restore_and_broadcast_over_two_gloo_ranks(tmp_path):
    """Only the root writes; both ranks meet at the barrier, restore, and
    receive the root's leaves by broadcast into the template's buffers:
    the same bytes on both."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER],
        env=child_env(BPS_FW_MODE="broadcast", BPS_FW_RANK=r,
                      BPS_FW_PORT=port, BPS_FW_CKPT=str(tmp_path)),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("broadcast workers hung")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    digests = [line.split()[2] for out in outs for line in out.splitlines()
               if line.startswith("DIGEST")]
    assert len(digests) == 2 and digests[0] == digests[1], outs
    assert os.listdir(tmp_path) == ["rank0"]


def test_sharded_optimizer_state_dict_carries_no_slot_state(tmp_path):
    """ROADMAP Queue C 11, pinned: in sharded-update mode the master and
    the moments live in the engine's slots, so the optimizer's
    ``state_dict()`` (what a checkpoint stores) holds no state, as the
    JAX adapter returns ``optax.EmptyState()``.  A checkpoint of it
    restarts the moments from zero."""
    import byteps_tpu_torch as bps
    api.init(pcfg.Config(sharded_update=True), device="cpu")
    try:
        model = torch.nn.Linear(4, 2)
        opt = bps.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(),
            sharded_update=True)
        for _ in range(2):
            opt.zero_grad()
            model(torch.ones(3, 4)).sum().backward()
            opt.step()
        sd = opt.state_dict()
        assert sd["state"] == {}
        slots = api.engine().update_slots
        assert slots and all(s.master is not None for s in slots.values())
        mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
        mgr.save(2, {"opt": sd})
        assert mgr.restore_latest({"opt": sd})[1]["opt"]["state"] == {}
    finally:
        api.shutdown()


# -- pack_state: the JAX package's bytes ------------------------------------------


def _states():
    rng = np.random.RandomState(11)
    return [
        {"w": rng.randn(16).astype(np.float32), "step": 7},
        {"z": np.arange(6, dtype=np.int64).reshape(2, 3), "b": 0.5,
         "a": [rng.randn(3).astype(np.float64), (True, np.float32(2.5))],
         "m": {"y": np.zeros((0, 4), np.float32), "x": None}},
        [np.uint8(3), {"k": rng.randint(0, 9, 5).astype(np.int32)}],
    ]


@pytest.mark.parametrize("idx", [0, 1, 2])
@pytest.mark.parametrize("seal", [True, False])
def test_pack_state_bytes_equal_the_jax_package(idx, seal):
    state = _states()[idx]
    mine, ref = ck.pack_state(state, seal=seal), jck.pack_state(state,
                                                                seal=seal)
    assert mine == ref
    assert integrity.is_frame(mine) == seal
    for blob in (mine, ref):
        a, b = ck.unpack_state(blob), jck.unpack_state(blob)
        assert pickle.dumps(a) == pickle.dumps(b)


def test_pack_state_turns_tensors_into_numpy():
    """Tensors on the port's side pack as the JAX side packs the same
    values as numpy: no torch object reaches the pickle."""
    rng = np.random.RandomState(3)
    w = rng.randn(2, 5).astype(np.float32)
    ints = np.arange(4, dtype=np.int64)
    mine = ck.pack_state({"w": torch.from_numpy(w.copy()),
                          "i": torch.from_numpy(ints.copy()), "step": 3})
    assert mine == jck.pack_state({"w": w, "i": ints, "step": 3})
    assert b"torch" not in mine
    with pytest.raises(TypeError, match="bfloat16"):
        ck.pack_state({"w": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="not an array"):
        ck.pack_state({"dtype": torch.float32})


def test_unpack_state_refuses_a_corrupt_blob():
    blob = bytearray(ck.pack_state({"w": np.arange(64, dtype=np.float32)}))
    blob[len(blob) // 2] ^= 0x10
    for unpack in (ck.unpack_state, jck.unpack_state):
        with pytest.raises(Exception, match="corrupt rejoin state"):
            unpack(bytes(blob))
    assert counters.get("integrity.crc_reject") == 1
    pcfg.set_config(pcfg.Config(integrity_on=False))
    raw = ck.pack_state({"w": np.ones(2)})
    assert not integrity.is_frame(raw) and raw == jck.pack_state(
        {"w": np.ones(2)}, seal=False)


# -- recovery on a gloo world of one ----------------------------------------------


def _template():
    return {"w": np.zeros(8, np.float32), "step": np.array(0)}


def test_recovery_coordinator_full_flow(tmp_path):
    """drain/suspend -> resume -> restore in one process: the engine is
    replaced, tensor keys survive in declaration order, the restored
    state is the last checkpoint, the resumed engine is live, and the
    counters, the flight event and the span record it."""
    api.init(pcfg.Config(), device="cpu")
    eng = api.engine()
    for name in ("a", "b", "c"):
        api.push_pull(torch.ones(16), name)
    keys_before = [(n, eng.registry.get(n).declared_key)
                   for n in eng.registry.names_in_declaration_order()]
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    w = np.arange(8, dtype=np.float32)
    mgr.save(4, {"w": w - 1, "step": np.array(4)})
    mgr.save(5, {"w": w, "step": np.array(5)})

    rc = RecoveryCoordinator(checkpoint_manager=CheckpointManager(
        str(tmp_path / "ck")), template=_template())
    res = rc.recover({1})

    assert res.failed_ranks == {1} and res.num_workers >= 1
    assert res.step == 5 and res.durable is None
    np.testing.assert_array_equal(res.state["w"], w)
    assert rc.done() and rc.wait(0) is res and rc.triggered
    eng2 = api.engine()
    assert eng2 is not eng
    keys_after = [(n, eng2.registry.get(n).declared_key)
                  for n in eng2.registry.names_in_declaration_order()]
    assert keys_after == keys_before
    out = api.push_pull(torch.ones(16), "a")
    torch.testing.assert_close(out, torch.ones(16))
    assert counters.get("recovery.attempt") == 1
    assert counters.get("recovery.completed") == 1
    events = [e for e in pflight.recorder.snapshot()
              if e.get("kind") == "recovery"]
    assert events and events[-1]["restored_step"] == 5


def test_recovery_is_idempotent_across_concurrent_detections():
    """Two detections at once (a heartbeat and a watchdog) run ONE
    recovery; every caller gets the first result."""
    api.init(pcfg.Config(), device="cpu")
    rc = RecoveryCoordinator(template=_template())
    results = []
    threads = [threading.Thread(target=lambda s=s: results.append(
        rc.recover({s}))) for s in (1, 2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 3 and all(r is results[0] for r in results)
    assert rc.recover({4}) is results[0]     # a late duplicate
    assert counters.get("recovery.attempt") == 1


def test_suspend_resume_shrink_preserves_key_order():
    api.init(pcfg.Config(), device="cpu")
    eng = api.engine()
    names = ["t.out", "t.mid", "t.in", "t.embed"]
    for n in names:
        api.push_pull(torch.ones(8), n)
    before = [(n, eng.registry.get(n).declared_key)
              for n in eng.registry.names_in_declaration_order()]
    assert [n for n, _ in before] == names  # declaration order, not sorted
    api.suspend()
    assert not api.initialized()
    api.resume(num_workers=1)
    eng2 = api.engine()
    after = [(n, eng2.registry.get(n).declared_key)
             for n in eng2.registry.names_in_declaration_order()]
    assert after == before
    api.push_pull(torch.ones(8), "t.new")
    assert eng2.registry.get("t.new").declared_key == len(names)


class _BrokenManager:
    def restore_latest(self, template):
        raise IOError("checkpoint store unreachable")


def test_failed_recovery_escalates_to_restartable_exit(monkeypatch):
    monkeypatch.setenv("BYTEPS_FAILURE_EXIT_CODE", "23")
    pcfg.reset_config()
    exits = []
    monkeypatch.setattr(rec_mod, "_exit", exits.append)
    api.init(pcfg.Config(), device="cpu")
    rc = RecoveryCoordinator(checkpoint_manager=_BrokenManager(),
                             template=_template())
    rc.on_failure({1})
    assert exits == [23]
    assert counters.get("recovery.failed") >= 1


def test_failed_recovery_releases_waiters_and_escalates():
    api.init(pcfg.Config(), device="cpu")
    rc = RecoveryCoordinator(checkpoint_manager=_BrokenManager(),
                             template=_template())
    with pytest.raises(IOError):
        rc.recover({1})
    with pytest.raises(RuntimeError, match="failed"):
        rc.recover({2})         # must raise, not block forever
    assert rc.done() and rc.wait(0) is None


def test_on_recovered_callback_error_does_not_kill_survivor(monkeypatch):
    exits = []
    monkeypatch.setattr(rec_mod, "_exit", exits.append)
    api.init(pcfg.Config(), device="cpu")

    def bad_callback(result):
        raise ValueError("user callback bug")

    rc = RecoveryCoordinator(template=_template(),
                             on_recovered=bad_callback)
    rc.on_failure({1})
    assert exits == []
    assert rc.wait(0) is not None and api.initialized()


def test_kill_and_recover_two_process(tmp_path):
    """Two real processes: the injector kills rank 1 at push step 3; rank
    0's heartbeat detects it and the RecoveryCoordinator completes
    suspend -> resume(1 worker) -> checkpoint restore with the step's
    value preserved, then trains on: no hang, no restartable exit."""
    port = free_port()
    procs = []
    for rank in range(2):
        extra = dict(BPS_FW_MODE="recover", BPS_FW_RANK=rank,
                     BPS_FW_HB_PORT=port, BPS_FW_CKPT=str(tmp_path / "ck"),
                     DMLC_NUM_WORKER=1, DMLC_WORKER_ID=0)
        if rank == 1:
            extra.update(BYTEPS_FAULT_SPEC="kill:rank=1:step=3",
                         BYTEPS_FAULT_SEED=7)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=child_env(**extra), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = ["", ""]
    try:
        outs[1], _ = procs[1].communicate(timeout=120)
        outs[0], _ = procs[0].communicate(timeout=120)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("chaos workers hung (recovery did not complete); "
                    "partial output: " + "".join(o[-1500:] for o in outs))
    assert procs[1].returncode == 1, outs[1][-3000:]   # a crash, not 17
    assert "START 1" in outs[1] and "RECOVERED" not in outs[1]
    assert procs[0].returncode == 0, outs[0][-3000:]
    assert "RECOVERED" in outs[0], outs[0][-3000:]
