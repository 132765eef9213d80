"""Worker bodies of the port's multi-process fault-plane tests
(``tests/test_torch_checkpoint.py``, ``tests/test_torch_transport.py``),
on the CPU.  One mode per run, from ``BPS_FW_MODE``:

- **recover**: the 2 -> 1 kill-and-recover of the JAX package's
  ``tests/chaos_worker.py``.  Two processes, each its own engine at a
  world of one over gloo, share one heartbeat endpoint and one
  checkpoint directory.  The victim (``BPS_FW_RANK=1``) runs under
  ``BYTEPS_FAULT_SPEC=kill:rank=1:step=N``; each process's engine has
  host id 0 (a world of one), so the worker arms the injector with its
  heartbeat rank.  The survivor's monitor detects the silence and its
  ``RecoveryCoordinator`` runs suspend -> resume(num_workers=1) ->
  restore from the last step rank 0 saved; the loop checks the restored
  step against ``w == full(step)`` and trains 2 more steps on the
  resumed engine, then prints ``RECOVERED <step>``;
- **broadcast**: rank ``BPS_FW_RANK`` of a 2-process gloo world;
  rank 0 saves a checkpoint, both restore it with
  ``restore_and_broadcast`` from a directory only rank 0 wrote (rank 1
  reads nothing) and print the restored bytes' digest;
- **bitflip**: rank 0 hosts a ``ServerEngine`` behind a
  ``TransportServer``; ranks 1..2 push integer-valued gradients (exact
  in f32 under any arrival order) to a per-step key and pull the merged
  round back, under ``bitflip:site=server_push`` in the workers: every
  corrupted frame is NACKed and retransmitted from the sealed source
  copy, so the final parameters equal the fault-free replay bit for
  bit.  Workers print ``DIGEST``; the server ``REJECTS``/``RETRANS``;
- **kvreset**: rank 0 hosts a ``KVStore``; ranks 1..2 push ``STEPS``
  seq-tokened unit deltas each, retrying on ``AckLost``, rank 2 under
  ``conn_reset:site=transport``; each also re-sends its first (landed)
  token once.  The server polls the store to exactly ``2 * STEPS`` and
  prints ``SUM``/``DUP``; rank 2 prints ``RESETS``/``RECONNECTS``;
- **partition**: the JAX package's ``tests/transport_worker.py``
  partition mode.  A 4-rank elastic world (``ElasticMembership`` on
  ``BPS_FW_BUS``, membership-managed heartbeats on ``BPS_FW_HB_PORT``)
  whose data plane pushes seq-tokened unit deltas to rank 0's
  ``KVStore`` over the transport (rank 0 through the
  ``LoopbackEndpoint``).  ``partition:rank=2:site=transport`` blackholes
  rank 2's sockets: its pushes surface as ``AckLost`` at the send
  deadline, and after two in a row it prints ``PARTITIONED <deadline
  trips>`` and exits with the restartable code; the survivors' detector
  shrinks the world and they finish every step, each printing ``FINAL
  <epoch> <world> <w[0]>`` (and rank 0 the store's ``SUM``).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = 257
LR = np.float32(0.05)


def _grad(step: int, wid: int) -> np.ndarray:
    # integer-valued floats: their sums are EXACT in f32, so a merged
    # round does not depend on the arrival order
    return np.random.RandomState(7919 * step + wid) \
        .randint(-1024, 1025, N).astype(np.float32)


def main() -> int:
    mode = os.environ["BPS_FW_MODE"]
    rank = int(os.environ["BPS_FW_RANK"])
    port = int(os.environ.get("BPS_FW_PORT", "0"))
    steps = int(os.environ.get("BPS_FW_STEPS", "10"))
    if mode == "recover":
        return _run_recover(rank)
    if mode == "broadcast":
        return _run_broadcast(rank, port)
    from byteps_tpu_torch.comm import transport as tp
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.fault import injector as inj
    spec = os.environ.get("BYTEPS_FAULT_SPEC", "")
    if spec:
        inj.arm(spec, seed=int(os.environ.get("BYTEPS_FAULT_SEED",
                                              str(rank))), rank=rank)
    if mode == "bitflip":
        return _run_bitflip(tp, counters, rank, port, steps, nworkers=2)
    if mode == "kvreset":
        return _run_kvreset(tp, counters, rank, port, steps, nworkers=2)
    if mode == "partition":
        return _run_partition(tp, counters, rank, port, steps)
    raise SystemExit(f"unknown BPS_FW_MODE {mode!r}")


def _run_recover(rank: int) -> int:
    import torch

    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.fault import injector as inj
    from byteps_tpu_torch.fault.recovery import RecoveryCoordinator
    from byteps_tpu_torch.utils.checkpoint import CheckpointManager
    from byteps_tpu_torch.utils.failure_detector import HeartbeatMonitor

    hb_port = os.environ["BPS_FW_HB_PORT"]
    ckdir = os.environ["BPS_FW_CKPT"]
    template = {"w": np.zeros(8, np.float32), "step": np.array(0)}
    cfg = Config.from_env()
    api.init(cfg, device="cpu")
    if cfg.fault_spec:
        # a world of one has host id 0: arm with this worker's rank
        inj.arm(cfg.fault_spec, seed=cfg.fault_seed, rank=rank)
    eng = api.engine()
    # two managers over ONE directory: the loop saves through its own,
    # the coordinator restores through its own on the detector thread
    mgr = CheckpointManager(ckdir, max_to_keep=3) if rank == 0 else None
    coordinator = RecoveryCoordinator(
        checkpoint_manager=(CheckpointManager(ckdir, max_to_keep=3)
                            if rank == 0 else None),
        template=template)
    mon = HeartbeatMonitor(
        rank, 2, "127.0.0.1:" + hb_port, interval=0.08, timeout=0.7,
        grace=60.0,
        on_failure=(coordinator.on_failure if rank == 0 else
                    lambda stale: None)).start()
    # do not start killable work before the server has heard this rank
    if not mon.wait_server(60.0):
        print("NO-HEARTBEAT-SERVER", flush=True)
        return 7
    print("START", rank, flush=True)
    w = np.zeros(8, np.float32)
    for step in range(1, 400):
        if coordinator.triggered:
            break
        try:
            h = api.push_pull_async(torch.ones(8), "grad", op="sum")
            w = w + h.wait(timeout=10).numpy()
        except Exception:  # noqa: BLE001 — engine torn down mid-step
            if coordinator.triggered:
                break
            raise
        if rank == 0 and not coordinator.triggered:
            mgr.save(step, {"w": w, "step": np.array(step)})
        time.sleep(0.1)
    else:
        print("NO-FAILURE-DETECTED", flush=True)
        return 3
    res = coordinator.wait(timeout=60)
    if res is None:
        print("RECOVERY-TIMEOUT", flush=True)
        return 4
    assert res.failed_ranks == {1}, res.failed_ranks
    assert res.num_workers == 1, res.num_workers
    assert res.step is not None and res.step >= 1, res.step
    assert int(res.state["step"]) == res.step, (res.state["step"], res.step)
    np.testing.assert_array_equal(res.state["w"],
                                  np.full(8, float(res.step), np.float32))
    assert counters.get("recovery.completed") == 1
    eng2 = api.engine()
    assert eng2 is not eng
    w = np.asarray(res.state["w"])
    for _ in range(2):
        w = w + api.push_pull(torch.ones(8), "grad", op="sum").numpy()
    np.testing.assert_array_equal(w, np.full(8, float(res.step + 2),
                                             np.float32))
    mon.stop()
    api.shutdown()
    print("RECOVERED", res.step, flush=True)
    return 0


def _run_broadcast(rank: int, port: int) -> int:
    import torch
    import torch.distributed as dist

    from byteps_tpu_torch.utils import checkpoint as ck

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        state = {"w": torch.arange(6, dtype=torch.float32) + 1,
                 "n": np.arange(3, dtype=np.int64) * 7,
                 "step": 11, "lr": 0.25}
        # only the root writes; both meet at the barrier after the write
        # (the non-root then restores into the template's buffers)
        wrote = ck.save_checkpoint(os.path.join(os.environ["BPS_FW_CKPT"],
                                                "rank0"), state)
        assert wrote == (rank == 0), wrote
        template = {"w": torch.zeros(6), "n": np.zeros(3, np.int64),
                    "step": 0, "lr": 0.0}
        got = ck.restore_and_broadcast(
            os.path.join(os.environ["BPS_FW_CKPT"], "rank0"), template)
        digest = hashlib.sha256(
            got["w"].numpy().tobytes() + got["n"].tobytes()
            + repr((got["step"], got["lr"])).encode()).hexdigest()
        print("DIGEST", rank, digest, flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _run_bitflip(tp, counters, rank, port, steps, nworkers) -> int:
    if rank == 0:
        from byteps_tpu_torch.server.engine import ServerEngine
        eng = ServerEngine(num_threads=1, device="cpu")
        srv = tp.TransportServer(host="127.0.0.1", port=port, rank=0,
                                 engine=eng)
        print("SRV-UP", flush=True)
        try:
            # the workers push a sentinel round after their last pull
            eng.pull("done", timeout=120)
        finally:
            print("REJECTS", counters.get("integrity.crc_reject"),
                  flush=True)
            time.sleep(0.5)   # let the last ACKs drain
            srv.close()
            eng.shutdown()
        return 0
    wid = rank - 1
    ep = tp.TcpEndpoint(("127.0.0.1", port), peer=0, rank=rank)
    params = np.zeros(N, np.float32)
    for step in range(steps):
        key = f"g{step}"
        ep.push(key, _grad(step, wid), wid, nworkers)
        params -= LR * ep.pull(key, timeout=60)
    print("RETRANS", rank, counters.get("integrity.retransmit"),
          flush=True)
    print("DIGEST", rank, hashlib.sha256(params.tobytes()).hexdigest(),
          flush=True)
    ep.push("done", np.zeros(1, np.float32), wid, nworkers)
    ep.close()
    return 0


def _run_kvreset(tp, counters, rank, port, steps, nworkers) -> int:
    from byteps_tpu_torch.common import integrity
    if rank == 0:
        from byteps_tpu_torch.server.kv_store import KVStore
        kv = KVStore(device="cpu")
        kv.init_key("acc", np.zeros(1, np.float32))
        srv = tp.TransportServer(host="127.0.0.1", port=port, rank=0,
                                 kv=kv)
        print("SRV-UP", flush=True)
        want = float(steps * nworkers)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if float(kv.pull("acc")[0]) >= want:
                break
            time.sleep(0.05)
        time.sleep(0.5)  # a straggling duplicate would land here
        print("SUM", repr(float(kv.pull("acc")[0])), flush=True)
        print("DUP", counters.get("integrity.dup_dropped"), flush=True)
        srv.close()
        return 0
    ep = tp.TcpEndpoint(("127.0.0.1", port), peer=0, rank=rank,
                        send_deadline_s=5.0)

    def push_tok(seq):
        while True:
            try:
                ep.push_delta("acc", np.ones(1, np.float32),
                              worker_id=rank, seq=seq)
                return
            except integrity.AckLost:
                continue  # same token: the dedup absorbs the retry

    for step in range(steps):
        push_tok(step + 1)
        if step == 0:
            push_tok(1)   # a deliberate duplicate of a landed token
    print("RESETS", rank, counters.get("transport.conn_resets"), flush=True)
    print("RECONNECTS", rank, ep.connection.reconnects, flush=True)
    ep.close()
    return 0


def _elastic_grad(rank: int) -> np.ndarray:
    return np.full(4, float((rank + 1) ** 2), np.float32)


def _run_partition(tp, counters, rank, port, steps) -> int:
    world = [int(r) for r in os.environ["BPS_FW_WORLD"].split(",")]
    bus = os.environ["BPS_FW_BUS"]
    hb_port = os.environ.get("BPS_FW_HB_PORT", "")
    fail_code = int(os.environ.get("BYTEPS_FAILURE_EXIT_CODE", "17"))
    # single-host engines; the world lives in the membership layer
    os.environ["DMLC_NUM_WORKER"] = "1"
    os.environ["DMLC_WORKER_ID"] = str(rank)

    from byteps_tpu_torch.common import integrity
    from byteps_tpu_torch.fault.membership import (ElasticMembership,
                                                   MembershipTimeout,
                                                   WorldChanged)
    from byteps_tpu_torch.utils.failure_detector import install_failure_action

    kv = None
    if rank == 0:
        from byteps_tpu_torch.server.kv_store import KVStore
        kv = KVStore(device="cpu")
        kv.init_key("acc", np.zeros(1, np.float32))
        tp.serve(rank=0, host="127.0.0.1", port=port, kv=kv)
        ep = tp.LoopbackEndpoint(kv=kv)
    else:
        ep = tp.TcpEndpoint(("127.0.0.1", port), peer=0, rank=rank,
                            send_deadline_s=1.5, keepalive_s=0.0)
    # a shrink resumes an engine: on the host here
    m = ElasticMembership(rank, world, bus, device="cpu").start()
    install_failure_action(m.on_failure)
    if hb_port:
        m.host_heartbeat(interval=0.08, timeout=0.7, grace=60.0,
                         addr="127.0.0.1:" + hb_port,
                         on_failure=m.on_failure)
    print("START", rank, flush=True)
    w = np.zeros(4, np.float32)
    step, streak, retries = 1, 0, 0
    while step <= steps:
        if retries > 200:
            print("RETRY-BUDGET-EXHAUSTED at", step, flush=True)
            return 6
        try:
            ep.push_delta("acc", np.ones(1, np.float32), worker_id=rank,
                          seq=step)
            streak = 0
        except integrity.AckLost:
            # the partition evidence: per-send deadlines, never a hang
            streak += 1
            if streak >= 2:
                print("PARTITIONED",
                      counters.get("transport.send_deadline_trips"),
                      flush=True)
                m.stop()
                return fail_code
            continue
        try:
            _, payloads = m.step_sync(step, payload=_elastic_grad(rank))
        except WorldChanged as e:
            print("WORLD", e.view.epoch, ",".join(map(str, e.view.world)),
                  "at", step, flush=True)
            continue  # the re-push is same-token: the dedup absorbs it
        except MembershipTimeout:
            retries += 1
            continue
        retries = 0
        grads = [np.asarray(p) for p in payloads.values()]
        w = w - LR * (np.sum(grads, axis=0, dtype=np.float32)
                      / np.float32(len(grads)))
        step += 1
        time.sleep(0.03)
    view = m.view()
    if rank == 0:
        time.sleep(1.0)  # the other survivors' last deltas land
        print("SUM", repr(float(kv.pull("acc")[0])), flush=True)
    print("FINAL", view.epoch, ",".join(map(str, view.world)),
          repr(float(w[0])), flush=True)
    install_failure_action(None)
    m.stop()
    ep.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
