"""Worker body of the port's elastic-membership tests
(``tests/test_torch_elastic.py``, ``test_torch_coordinator_failover.py``,
``test_torch_partition.py``, ``test_torch_straggler.py``,
``test_torch_doctor.py``, ``test_torch_failure_detector.py``); port of
the JAX package's ``tests/elastic_worker.py``, on the CPU.

Each process is one member with its own engine at a world of one
(``DMLC_NUM_WORKER=1``, ``DMLC_WORKER_ID=<rank>``: the injector is armed
at the member's rank), sharing one heartbeat endpoint and one membership
bus.  Each step: the rank-distinct gradient ``(rank + 1) ** 2`` rides
the engine's ``push_pull`` (enqueue and dispatch under every epoch),
``step_sync`` all-gathers the reduced gradients over the bus, and every
member applies their mean.  The scenarios and their env switches are the
JAX worker's:

- victim: ``BYTEPS_FAULT_SPEC=kill:rank=R:step=K`` (or
  ``kill:site=coordinator:step=K``) kills this process at its K-th push;
- survivor: the membership-managed heartbeat detects, ``on_failure``
  shrinks in place, the worker steps on to ``FINAL <epoch> <world>
  <w[0]>``;
- ``BYTEPS_ELASTIC_DIE_ON_DETECT=1``: exits the moment its detector
  fires (a double failure inside the shrink window);
- ``BYTEPS_ELASTIC_REJOIN=1``: comes up fresh, parks on the bus and
  resumes from the survivors' epoch, keys and parameters;
- ``BYTEPS_ELASTIC_STALE_PROBE=1``: after training, a stale-epoch chunk
  (pause dispatch, enqueue, advance the epoch, resume) and a stale-epoch
  server push must both be dropped;
- ``BYTEPS_ELASTIC_WEDGE_STEP=K`` (+ ``_WEDGE_S``): at step K the
  engine's next sync blocks; with ``BYTEPS_SYNC_DEADLINE_S`` armed the
  deadline trips and the installed action reconciles;
- ``BYTEPS_ELASTIC_PARTITION_SPEC`` + ``_PARTITION_STEP``: every rank
  arms the edge cut at step K; the minority parks
  (``PARKED <rank> <epoch>``) and rejoins after the heal;
- ``BYTEPS_ELASTIC_SHARDED=1``: a second model trained through
  ``declare_update`` / ``push_pull_update`` (torch SGD with momentum
  0.9), each step committed exactly once across a torn dispatch;
- ``BYTEPS_ELASTIC_SLOW_S`` (straggler runs): sleep this long before
  each ``step_sync``; a ``Demoted`` rank waits, then rejoins.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

LR = 0.1
DIM = 8
SU_NAME = "wsh"
SU_DIM = 11


def _grad(rank: int) -> np.ndarray:
    # rank-distinct so shrink/grow changes the mean: {1,4,9}/3 vs {1,9}/2
    return np.full(DIM, float((rank + 1) ** 2), np.float32)


def _su_slot(api, torch, m, mm):
    """A live sharded-update slot on the CURRENT engine; after a world
    change the declare consumes the suspend() stash and the worker prints
    ``RESHARDED <applied>``."""
    retries = 0
    while True:
        try:
            eng = api._require()
            slot = eng.update_slots.get(SU_NAME)
            if slot is None:
                api.declare_update(
                    SU_NAME, (SU_DIM,), torch.float32,
                    optimizer=(torch.optim.SGD, {"lr": LR,
                                                 "momentum": 0.9}),
                    init_value=torch.zeros(SU_DIM))
                slot = eng.update_slots[SU_NAME]
                if slot.applied:
                    print("RESHARDED", slot.applied, flush=True)
            return slot
        except RuntimeError:
            retries += 1
            if retries > 200:
                raise
            m.wait_ready(mm.current_epoch(), timeout=30)
            time.sleep(0.05)


def _su_step(api, torch, m, mm, g0, target):
    """One exactly-once sharded-update step: ``applied`` arbitrates a
    dispatch torn by a world change (already ``target``: it committed
    before the drain; ``target - 1``: it was dropped stale, redispatch)."""
    g = torch.from_numpy(np.float32(g0)
                         * np.arange(1, SU_DIM + 1, dtype=np.float32))
    retries = 0
    while True:
        slot = _su_slot(api, torch, m, mm)
        if slot.applied >= target:
            assert slot.applied == target, (slot.applied, target)
            return
        try:
            api.push_pull_update(g, SU_NAME)
        except (RuntimeError, ValueError):
            retries += 1
            if retries > 200:
                raise
            m.wait_ready(mm.current_epoch(), timeout=30)
            time.sleep(0.05)
            continue
        assert slot.applied == target, (slot.applied, target)
        return


def _stale_probes(api, torch, mm) -> int:
    """The deterministic stale-epoch drop checks (after training)."""
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.server.engine import ServerEngine

    eng = api._require()
    before = counters.get("membership.stale_chunks_dropped")
    eng.pause_dispatch()
    h = eng.push_pull_async(torch.ones(DIM), "stale_probe", op="sum")
    mm.advance_epoch()
    eng.resume_dispatch()
    try:
        h.wait(timeout=20)
        print("STALE-CHUNK-DELIVERED", flush=True)
        return 5
    except RuntimeError as e:
        if "stale membership epoch" not in str(e):
            print("STALE-CHUNK-WRONG-ERROR", e, flush=True)
            return 5
    if counters.get("membership.stale_chunks_dropped") <= before:
        print("STALE-CHUNK-NO-COUNTER", flush=True)
        return 5
    print("STALE-CHUNK-DROPPED", flush=True)

    srv = ServerEngine(num_threads=1, device="cpu")
    srv.set_membership_epoch(mm.current_epoch())
    srv.push("digest", np.ones(4, np.float32), 0, 1,
             mepoch=mm.current_epoch())
    v1 = srv.pull("digest", timeout=10)
    assert float(v1[0]) == 1.0, v1
    srv.push("digest", np.full(4, 100.0, np.float32), 0, 1,
             mepoch=mm.current_epoch() - 1)          # residue: dropped
    srv.push("digest", np.full(4, 2.0, np.float32), 0, 1,
             mepoch=mm.current_epoch())
    v2 = srv.pull("digest", timeout=10)
    srv.shutdown()
    if float(v2[0]) != 2.0:
        print("STALE-PUSH-SUMMED", float(v2[0]), flush=True)
        return 5
    if counters.get("membership.stale_pushes_dropped") < 1:
        print("STALE-PUSH-NO-COUNTER", flush=True)
        return 5
    print("STALE-PUSH-DROPPED", flush=True)
    return 0


def _parked_rejoin(mm, m, rank):
    """Minority park: dump the flight ring, stop the parked membership,
    retry rejoin until the partition heals; returns ``(membership, w,
    next_step)`` from the survivors' state."""
    from byteps_tpu_torch.common import flight_recorder as _flight
    from byteps_tpu_torch.fault.membership import ElasticMembership
    from byteps_tpu_torch.utils.failure_detector import install_failure_action

    print("PARKED", rank, mm.current_epoch(), flush=True)
    print("FLIGHT", _flight.dump("parked"), flush=True)
    m.stop()
    bus = os.environ["BYTEPS_ELASTIC_BUS"] or None
    deadline = time.monotonic() + 120.0
    while True:
        try:
            m2, step0, state = ElasticMembership.rejoin(
                rank, bus, device="cpu", timeout=5.0)
            break
        except Exception as e:  # noqa: BLE001 — severed until the heal
            if time.monotonic() > deadline:
                print("REJOIN-DEADLINE", repr(e), flush=True)
                raise
            time.sleep(0.5)
    install_failure_action(m2.on_failure)
    w = np.asarray(state["w"], np.float32)
    print("REJOINED", mm.current_epoch(),
          ",".join(map(str, m2.view().world)), step0, flush=True)
    return m2, w, int(step0) + 1


def main() -> int:
    rank = int(os.environ["BYTEPS_ELASTIC_RANK"])
    world = [int(r) for r in os.environ["BYTEPS_ELASTIC_WORLD"].split(",")]
    bus = os.environ["BYTEPS_ELASTIC_BUS"] or None
    hb_port = os.environ.get("BYTEPS_ELASTIC_HB_PORT", "")
    n_steps = int(os.environ["BYTEPS_ELASTIC_STEPS"])
    start_step = int(os.environ.get("BYTEPS_ELASTIC_START_STEP", "1"))
    init_w = float(os.environ.get("BYTEPS_ELASTIC_INIT_W", "0"))
    sleep_s = float(os.environ.get("BYTEPS_ELASTIC_STEP_SLEEP", "0.05"))
    slow_s = float(os.environ.get("BYTEPS_ELASTIC_SLOW_S", "0"))
    rejoining = os.environ.get("BYTEPS_ELASTIC_REJOIN", "") == "1"
    sharded = os.environ.get("BYTEPS_ELASTIC_SHARDED", "") == "1"
    die_on_detect = os.environ.get("BYTEPS_ELASTIC_DIE_ON_DETECT", "") == "1"
    wedge_step = int(os.environ.get("BYTEPS_ELASTIC_WEDGE_STEP", "0"))
    wedge_s = float(os.environ.get("BYTEPS_ELASTIC_WEDGE_S", "4"))
    partition_spec = os.environ.get("BYTEPS_ELASTIC_PARTITION_SPEC", "")
    partition_step = int(os.environ.get("BYTEPS_ELASTIC_PARTITION_STEP",
                                        "0"))
    # single-host engines; the world lives in the membership layer
    os.environ["DMLC_NUM_WORKER"] = "1"
    os.environ["DMLC_WORKER_ID"] = str(rank)

    import torch

    import byteps_tpu_torch.core.api as api
    from byteps_tpu_torch.fault import membership as mm
    from byteps_tpu_torch.fault.membership import (Demoted,
                                                   ElasticMembership,
                                                   MembershipTimeout,
                                                   PartitionMinority,
                                                   WorldChanged)
    from byteps_tpu_torch.utils.failure_detector import install_failure_action

    torch.set_num_threads(1)
    if rejoining:
        m, step0, state = ElasticMembership.rejoin(rank, bus, device="cpu")
        w = np.asarray(state["w"], np.float32)
        start_step = int(step0) + 1
        on_failure = m.on_failure
        print("REJOINED", mm.current_epoch(),
              ",".join(map(str, m.view().world)), step0, flush=True)
    else:
        api.init(device="cpu")   # arms the injector from BYTEPS_FAULT_SPEC
        m = ElasticMembership(rank, world, bus).start()
        w = np.full(DIM, init_w, np.float32)
        if die_on_detect:
            def on_failure(stale):
                print("DIED-ON-DETECT", sorted(stale), flush=True)
                os._exit(1)
        else:
            on_failure = m.on_failure
    install_failure_action(on_failure)
    if hb_port:
        m.host_heartbeat(interval=0.08, timeout=0.7, grace=60.0,
                         addr="127.0.0.1:" + hb_port,
                         on_failure=on_failure)
    from byteps_tpu_torch.common import obs_server as _obs
    if _obs.get_server() is not None:
        print("OBS", rank, _obs.get_server().port, flush=True)
    print("START", rank, flush=True)

    step = start_step
    retries = 0
    wedged = False
    partition_armed = False
    conn_errs = 0
    su_target = 0
    while step <= n_steps:
        if retries > 200:
            print("RETRY-BUDGET-EXHAUSTED at", step, flush=True)
            return 6
        if (partition_spec and partition_step and step == partition_step
                and not partition_armed):
            from byteps_tpu_torch.fault import injector as fault_injector
            partition_armed = True
            fault_injector.arm(partition_spec, rank=rank, persist=True)
            print("PARTITION-ARMED", rank, "at", step, flush=True)
        try:
            eng = api._require()
            if wedge_step and step == wedge_step and not wedged:
                wedged = True
                orig = eng._block

                def _wedge_once(x, _orig=orig, _eng=eng):
                    _eng._block = _orig
                    print("WEDGING", rank, flush=True)
                    time.sleep(wedge_s)
                    return _orig(x)
                eng._block = _wedge_once
            red = eng.push_pull(torch.from_numpy(_grad(rank)), "grad",
                                op="sum").numpy()
        except RuntimeError:
            retries += 1
            m.wait_ready(mm.current_epoch(), timeout=30)
            time.sleep(0.05)
            continue
        if slow_s:
            time.sleep(slow_s)
        try:
            _, payloads = m.step_sync(step, payload=red,
                                      state={"w": w, "step": step - 1})
        except WorldChanged as e:
            print("WORLD", e.view.epoch,
                  ",".join(map(str, e.view.world)), "at", step, flush=True)
            continue
        except MembershipTimeout:
            retries += 1
            continue
        except Demoted:
            print("DEMOTED", rank, "at", step, flush=True)
            slow_s = 0.0
            m, w, step = _parked_rejoin(mm, m, rank)
            continue
        except PartitionMinority:
            m, w, step = _parked_rejoin(mm, m, rank)
            retries = conn_errs = 0
            continue
        except ConnectionError:
            if not partition_armed:
                raise
            conn_errs += 1
            if conn_errs < 2:
                time.sleep(0.5)
                continue
            try:
                view = m.shrink({m.view().coordinator})
            except PartitionMinority:
                m, w, step = _parked_rejoin(mm, m, rank)
                retries = conn_errs = 0
                continue
            conn_errs = 0
            print("WORLD", view.epoch,
                  ",".join(map(str, view.world)), "at", step, flush=True)
            continue
        retries = 0
        conn_errs = 0
        grads = [np.asarray(p) for p in payloads.values()]
        g = (np.sum(grads, axis=0, dtype=np.float32)
             / np.float32(len(grads)))
        w = w - np.float32(LR) * g
        if sharded:
            su_target += 1
            _su_step(api, torch, m, mm, float(g[0]), su_target)
        step += 1
        time.sleep(sleep_s)

    assert np.all(w == w[0]), w
    rc = 0
    if os.environ.get("BYTEPS_ELASTIC_STALE_PROBE", "") == "1":
        rc = _stale_probes(api, torch, mm)
    if wedge_step:
        from byteps_tpu_torch.common.telemetry import counters as _counters
        print("DEADLINE-TRIPS", _counters.get("engine.sync_deadline_trips"),
              "RECONCILES", _counters.get("membership.reconcile_started"),
              flush=True)
    if sharded:
        slot = _su_slot(api, torch, m, mm)
        vals = ",".join(repr(float(v)) for v in slot.export()["master"])
        print("FINAL-SHARDED", slot.applied, vals, flush=True)
    view = m.view()
    print("FINAL", view.epoch, ",".join(map(str, view.world)),
          repr(float(w[0])), flush=True)
    if partition_armed:
        from byteps_tpu_torch.common import flight_recorder as _flight
        print("FLIGHT", _flight.dump("partition_done"), flush=True)
    install_failure_action(None)
    m.stop()
    api.shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(main())
