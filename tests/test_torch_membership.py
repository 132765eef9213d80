"""The port's elastic-membership units (``byteps_tpu_torch/fault/
membership.py``): the JAX package's cases of ``tests/test_membership.py``
(epoch, bus protocol, the engine's stale-epoch guard, the server engine's
and KV store's epoch gates, the assigner's reshard, the state wire
form), plus parity with the JAX module: ``_send_obj`` frames byte for
byte with integrity on and off, and each package's client against the
other package's ``_BusServer`` through ``sync``, ``hello``, ``rejoin``,
``ping`` and ``metrics``."""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest
import torch

from byteps_tpu.common import config as jcfg
from byteps_tpu.fault import membership as jmm
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.core import api
from byteps_tpu_torch.fault import membership as mm
from byteps_tpu_torch.fault.membership import (MembershipView, _BusServer,
                                               _recv_obj, _send_obj)
from byteps_tpu_torch.server.engine import ServerEngine
from byteps_tpu_torch.server.kv_store import KVStore
from byteps_tpu_torch.server.sharding import ServerAssigner
from byteps_tpu_torch.utils.checkpoint import pack_state, unpack_state

from .torch_member_common import (free_port, fresh_member_state,  # noqa: F401
                                  req)


# -- epoch ------------------------------------------------------------------


def test_epoch_is_monotonic():
    assert mm.current_epoch() == 0
    assert mm.advance_epoch() == 1
    assert mm.set_epoch(5) == 5
    assert mm.set_epoch(3) == 5          # never regresses
    assert mm.current_epoch() == 5


def test_view_basics():
    v = MembershipView(2, (0, 2, 5))
    assert v.num_workers == 3
    assert v.coordinator == 0


# -- bus: sync --------------------------------------------------------------


def test_bus_sync_quorum_delivers_all_payloads():
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=5.0)
    try:
        out = {}

        def member(r):
            out[r] = req(port, {"op": "sync", "rank": r, "epoch": 0,
                                "step": 1, "payload": r * 10})

        ts = [threading.Thread(target=member, args=(r,)) for r in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=20)
        for r in (0, 1):
            assert out[r]["ok"], out
            assert out[r]["payloads"] == {0: 0, 1: 10}
    finally:
        bus.close()


def test_bus_encodes_a_round_reply_once(monkeypatch):
    """The members of a completed round but the standby receive the same
    encoded frame: one encode for them, one for the standby's reply with
    its replica (the JAX bus encodes once per member; the bytes are the
    same)."""
    encodes = []
    real = mm._encode_obj

    def counting(obj):
        encodes.append(obj.get("op"))
        return real(obj)

    monkeypatch.setattr(mm, "_encode_obj", counting)
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1, 2)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=5.0)
    try:
        out = {}

        def member(r):
            out[r] = req(port, {"op": "sync", "rank": r, "epoch": 0,
                                "step": 1, "payload": np.full(3, r)})

        ts = [threading.Thread(target=member, args=(r,)) for r in (0, 1, 2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=20)
        server_side = [e for e in encodes if e is None]   # replies
        assert len(server_side) == 2, encodes
        assert "replica" in out[1] and "replica" not in out[0]
        for r in (0, 1, 2):
            assert out[r]["ok"] and sorted(out[r]["payloads"]) == [0, 1, 2]
        assert bus._round_frame[0] == (0, 1, False)
    finally:
        bus.close()


def test_bus_sync_wrong_epoch_is_stale():
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(3, (0,)),
                     rendezvous_timeout_s=1.0, sync_timeout_s=2.0)
    try:
        r = req(port, {"op": "sync", "rank": 0, "epoch": 1, "step": 7})
        assert r == {"ok": False, "stale": True, "epoch": 3, "world": [0],
                     "probation": []}
    finally:
        bus.close()


def test_bus_sync_timeout_names_the_missing():
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1, 2)),
                     rendezvous_timeout_s=1.0, sync_timeout_s=0.5)
    try:
        r = req(port, {"op": "sync", "rank": 0, "epoch": 0, "step": 1})
        assert r["timeout"] and r["missing"] == [1, 2], r
    finally:
        bus.close()


# -- bus: shrink rendezvous -------------------------------------------------


def test_bus_hello_agreement_and_stale_sync_release():
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1, 2)),
                     rendezvous_timeout_s=5.0, sync_timeout_s=30.0)
    try:
        parked = {}

        def sync_waiter():
            parked["r"] = req(port, {"op": "sync", "rank": 0, "epoch": 0,
                                     "step": 4}, timeout=40.0)

        t = threading.Thread(target=sync_waiter)
        t.start()
        out = {}

        def hello(r):
            out[r] = req(port, {"op": "hello", "rank": r, "epoch": 1,
                                "world": [0, 2]})

        hs = [threading.Thread(target=hello, args=(r,)) for r in (0, 2)]
        for h in hs:
            h.start()
        for h in hs:
            h.join(timeout=20)
        for r in (0, 2):
            assert out[r]["ok"], out
            assert out[r]["epoch"] == 1 and out[r]["world"] == [0, 2], out
        # rank 2 is the standby of {0, 2}: its reply carries the replica
        assert "replica" not in out[0]
        assert out[2]["replica"]["epoch"] == 1
        assert out[2]["replica"]["world"] == [0, 2]
        t.join(timeout=20)
        assert parked["r"].get("stale") or parked["r"].get("reconcile"), \
            parked
        assert bus.view() == MembershipView(1, (0, 2))
        late = req(port, {"op": "hello", "rank": 0, "epoch": 1,
                          "world": [0, 2]})
        assert late == {"ok": True, "epoch": 1, "world": [0, 2]}
        assert counters.get("membership.shrink_agreed") >= 1
    finally:
        bus.close()


def test_bus_hello_timeout_drops_nonresponders():
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1, 2)),
                     rendezvous_timeout_s=0.5, sync_timeout_s=5.0)
    try:
        r = req(port, {"op": "hello", "rank": 0, "epoch": 1,
                       "world": [0, 2]})
        assert r == {"ok": True, "epoch": 1, "world": [0]}
        assert bus.view() == MembershipView(1, (0,))
    finally:
        bus.close()


# -- bus: rejoin admission --------------------------------------------------


def _admission(port, bus, send=None, recv=None):
    """Park rank 1, then a step-7 quorum of ranks 0 and 2 carrying state:
    returns every reply."""
    state = pack_state({"w": np.arange(4, dtype=np.float32),
                        "step": np.array(6)})
    out = {}

    def rejoiner():
        out["join"] = req(port, {"op": "rejoin", "rank": 1}, timeout=30.0,
                          send=send, recv=recv)

    def member(r):
        out[r] = req(port, {"op": "sync", "rank": r, "epoch": 1, "step": 7,
                            "payload": None, "state": state,
                            "declared": ["a", "b"]}, timeout=30.0,
                     send=send, recv=recv)

    tj = threading.Thread(target=rejoiner)
    tj.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with bus._cv:
            if 1 in bus._join_wait:
                break
        time.sleep(0.005)
    ts = [threading.Thread(target=member, args=(r,)) for r in (0, 2)]
    for t in ts:
        t.start()
    for t in ts + [tj]:
        t.join(timeout=30)
    return out


def test_bus_rejoin_admitted_at_step_boundary_with_state():
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(1, (0, 2)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=10.0)
    try:
        out = _admission(port, bus)
        for r in (0, 2):
            assert out[r]["stale"], out[r]
            assert out[r]["epoch"] == 2 and out[r]["world"] == [0, 1, 2]
        join = out["join"]
        assert join["ok"] and join["epoch"] == 2
        assert join["world"] == [0, 1, 2]
        assert join["declared"] == ["a", "b"]
        assert join["step"] == 6
        got = unpack_state(join["state"])
        np.testing.assert_allclose(got["w"], np.arange(4, dtype=np.float32))
        assert counters.get("membership.rejoin_admitted") >= 1
        assert bus.parked_joiners() == []
    finally:
        bus.close()


def test_bus_rejoin_times_out_without_a_quorum():
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0,)),
                     rendezvous_timeout_s=0.5, sync_timeout_s=0.5)
    try:
        r = req(port, {"op": "rejoin", "rank": 9})
        assert r == {"ok": False, "timeout": True}
    finally:
        bus.close()


# -- the engine's epoch guard ------------------------------------------------


def test_stale_epoch_chunk_dropped_not_delivered():
    """A chunk enqueued before a world change is dropped at dispatch with
    an ABORTED status naming the stale epoch, and fresh pushes under the
    new epoch flow."""
    api.init(Config(), device="cpu")
    eng = api.engine()
    eng.pause_dispatch()
    h = eng.push_pull_async(torch.ones(8), "g", op="sum")
    mm.advance_epoch()
    eng.resume_dispatch()
    with pytest.raises(RuntimeError, match="ABORTED: stale membership "
                                           "epoch"):
        h.wait(timeout=20)
    assert counters.get("membership.stale_chunks_dropped") == 1
    out = eng.push_pull(torch.ones(8), "g", op="sum")
    assert torch.equal(out, torch.ones(8))


def test_stale_epoch_chunk_dropped_at_completion():
    """The syncer-side guard: a chunk already issued when the epoch moved
    is dropped at retirement (held inside the syncer's wait until the
    epoch has moved, so it is this guard and not the dispatch one)."""
    from byteps_tpu_torch.common import flight_recorder as flight
    api.init(Config(), device="cpu")
    eng = api.engine()
    inside, go = threading.Event(), threading.Event()
    real = eng._block

    def held(done):
        eng._block = real
        inside.set()
        go.wait(20)
        return real(done)

    eng._block = held
    h = eng.push_pull_async(torch.ones(8), "g", op="sum")
    assert inside.wait(20)
    mm.advance_epoch()
    go.set()
    with pytest.raises(RuntimeError, match="stale membership epoch"):
        h.wait(timeout=20)
    assert counters.get("membership.stale_chunks_dropped") == 1
    ev = [e for e in flight.recorder.snapshot()
          if e["kind"] == "engine.stale_chunk"]
    assert ev and ev[-1]["at"] == "retire" and ev[-1]["enq_epoch"] == 0


def test_stale_chunk_leaves_its_group():
    """Drain-mode grouping: a stale chunk popped in one batch with a
    fresh one leaves the batch (ABORTED), and the fresh one is still
    dispatched and delivered."""
    api.init(Config(group_size=-1), device="cpu")
    eng = api.engine()
    eng.pause_dispatch()
    stale = eng.push_pull_async(torch.ones(8), "a", op="sum")
    mm.advance_epoch()
    fresh = eng.push_pull_async(torch.full((8,), 2.0), "b", op="sum")
    eng.resume_dispatch()
    assert torch.equal(fresh.wait(timeout=20), torch.full((8,), 2.0))
    with pytest.raises(RuntimeError, match="stale membership epoch"):
        stale.wait(timeout=20)
    assert eng.stats["chunks"] == 1
    assert counters.get("membership.stale_chunks_dropped") == 1


def test_parked_process_refuses_enqueue():
    """A process parked on the minority side of a partition fails an
    enqueue loudly instead of queueing work no epoch will complete."""
    api.init(Config(), device="cpu")
    m = mm.ElasticMembership(0, [0], f"127.0.0.1:{free_port()}").start()
    try:
        m._parked = True
        assert mm.is_parked()
        with pytest.raises(RuntimeError, match="parked on the minority"):
            api.push_pull(torch.ones(4), "g")
        m._parked = False
        assert torch.equal(api.push_pull(torch.ones(4), "g", op="sum"),
                           torch.ones(4))
    finally:
        m.stop()


# -- the repairs: resume() without suspend(), host ids past num_hosts ---------


def test_resume_without_suspend_starts_an_engine():
    """``resume()`` with nothing suspended starts an engine with the names
    declared before it, as the JAX ``resume`` does (a rejoining process
    declares the survivors' names, then resumes); a second resume while
    it runs still raises."""
    api.declare("pre.a")
    api.declare("pre.b")
    api.resume(device="cpu")
    assert api.initialized() and api.device().type == "cpu"
    reg = api.engine().registry
    assert reg.names_in_declaration_order()[:2] == ["pre.a", "pre.b"]
    assert torch.equal(api.push_pull(torch.ones(3), "x", op="sum"),
                       torch.ones(3))
    with pytest.raises(RuntimeError, match="suspend"):
        api.resume(device="cpu")


def test_worker_id_past_num_worker_is_accepted_and_kill_reaches_it(
        monkeypatch):
    """The elastic topology's member config (``DMLC_NUM_WORKER=1``,
    ``DMLC_WORKER_ID=2``) is accepted as the JAX ``Config`` accepts it,
    the bootstrap forms a group of one, and ``kill:rank=2`` armed by
    ``init()`` fires in that process."""
    from byteps_tpu_torch.fault import injector as inj
    exits = []
    monkeypatch.setattr(inj, "_exit", exits.append)
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("DMLC_WORKER_ID", "2")
    monkeypatch.setenv("BYTEPS_FAULT_SPEC", "kill:rank=2:step=2")
    cfg = Config.from_env()
    assert (cfg.num_hosts, cfg.host_id) == (1, 2)
    assert jcfg.Config.from_env().host_id == cfg.host_id
    with pytest.raises(ValueError, match="host_id"):
        Config(host_id=-1)
    api.init(cfg, device="cpu")
    assert api.size() == 1 and api.rank() == 0
    api.push_pull(torch.ones(2), "g")
    assert exits == []
    api.push_pull_async(torch.ones(2), "g2")
    assert exits == [1]


# -- server engine / KV store epoch gates ------------------------------------


def test_server_engine_drops_stale_membership_push():
    srv = ServerEngine(num_threads=1, device="cpu")
    try:
        srv.push("k", np.ones(4, np.float32), 0, 1, mepoch=0)
        assert float(srv.pull("k", timeout=10)[0]) == 1.0
        srv.set_membership_epoch(2)
        assert srv.membership_epoch == 2
        srv.set_membership_epoch(1)
        assert srv.membership_epoch == 2
        srv.push("k", np.full(4, 100.0, np.float32), 0, 1, mepoch=0)
        srv.push("k", np.full(4, 2.0, np.float32), 0, 1, mepoch=2)
        assert float(srv.pull("k", timeout=10)[0]) == 2.0
        assert counters.get("membership.stale_pushes_dropped") == 1
        srv.push("k", np.full(4, 3.0, np.float32), 0, 1)
        assert float(srv.pull("k", timeout=10)[0]) == 3.0
    finally:
        srv.shutdown()


def test_kv_store_drops_stale_membership_delta():
    kv = KVStore(device="cpu")
    kv.init_key("w", np.zeros(4, np.float32))
    assert kv.push_delta("w", np.ones(4, np.float32), mepoch=0) == 1
    kv.set_membership_epoch(3)
    assert kv.push_delta("w", np.full(4, 50.0, np.float32), mepoch=0) == 1
    np.testing.assert_allclose(kv.pull("w"), 1.0)
    assert kv.push_delta("w", np.ones(4, np.float32), mepoch=3) == 2
    np.testing.assert_allclose(kv.pull("w"), 2.0)
    assert counters.get("membership.stale_pushes_dropped") == 1


# -- assigner resharding / mixed mode ----------------------------------------


def test_assigner_reshard_rehashes_and_resets_load():
    a = ServerAssigner(num_servers=4, fn="djb2")
    keys = list(range(64))
    before = {k: a.assign(k, 100) for k in keys}
    assert any(s >= 2 for s in before.values())
    a.reshard(2)
    assert a.load_bytes == [0, 0]
    after = {k: a.assign(k, 1) for k in keys}
    assert all(0 <= s < 2 for s in after.values())
    fresh = ServerAssigner(num_servers=2, fn="djb2")
    assert after == {k: fresh.assign(k) for k in keys}
    with pytest.raises(ValueError):
        a.reshard(0)


def test_assigner_mixed_mode_from_env(monkeypatch):
    monkeypatch.setenv("BYTEPS_ENABLE_MIXED_MODE", "1")
    monkeypatch.setenv("BYTEPS_MIXED_MODE_BOUND", "120")
    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    pcfg.reset_config()
    a = ServerAssigner(num_servers=5)
    assert a._mixed and a._bound == 120 and a._num_workers == 3
    monkeypatch.setenv("BYTEPS_MIXED_MODE_BOUND", "2")
    pcfg.reset_config()
    with pytest.raises(ValueError, match="MIXED_MODE_BOUND"):
        ServerAssigner(num_servers=5)


def test_assigner_mixed_reshard_violation_restores_shape():
    a = ServerAssigner(num_servers=5, fn="djb2", mixed_mode=True,
                       num_workers=3, bound=101)
    with pytest.raises(ValueError):
        a.reshard(1, num_workers=0)
    assert a.num_servers == 5 and a._num_workers == 3
    with pytest.raises(ValueError, match="explicit num_workers"):
        a.reshard(4)
    assert a.num_servers == 5 and a._num_workers == 3


# -- state wire form ----------------------------------------------------------


def test_pack_unpack_state_roundtrip():
    state = {"w": torch.arange(6.0).reshape(2, 3), "opt": {"m": np.ones(3)},
             "step": 17}
    got = unpack_state(pack_state(state))
    np.testing.assert_allclose(got["w"], np.arange(6.0).reshape(2, 3))
    np.testing.assert_allclose(got["opt"]["m"], 1.0)
    assert int(got["step"]) == 17
    assert isinstance(got["w"], np.ndarray)


# -- knobs and seams -------------------------------------------------------------

_KNOBS = ("elastic", "membership_port", "membership_hosts",
          "membership_rendezvous_timeout_s", "membership_sync_timeout_s",
          "bus_retries", "clock_sync_samples", "gossip_on",
          "gossip_interval_s", "gossip_fanout", "gossip_suspect_s",
          "gossip_dead_s", "straggler_policy", "straggler_demote_after",
          "straggler_min_lag_s")


@pytest.mark.parametrize("env", [
    {},
    {"BYTEPS_ELASTIC": "1", "BYTEPS_MEMBERSHIP_PORT": "7001",
     "BYTEPS_MEMBERSHIP_HOSTS": "10.0.0.1:7000,10.0.0.2",
     "BYTEPS_MEMBERSHIP_RENDEZVOUS_TIMEOUT": "3",
     "BYTEPS_MEMBERSHIP_SYNC_TIMEOUT": "15", "BYTEPS_BUS_RETRIES": "8",
     "BYTEPS_CLOCK_SYNC_SAMPLES": "0", "BYTEPS_GOSSIP_ON": "1",
     "BYTEPS_GOSSIP_INTERVAL_S": "0.1", "BYTEPS_GOSSIP_FANOUT": "2",
     "BYTEPS_GOSSIP_SUSPECT_S": "0.5", "BYTEPS_GOSSIP_DEAD_S": "2",
     "BYTEPS_STRAGGLER_POLICY": " Demote", "BYTEPS_STRAGGLER_DEMOTE_AFTER":
     "4", "BYTEPS_STRAGGLER_MIN_LAG": "0.5"},
], ids=["defaults", "set"])
def test_membership_knobs_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, p = jcfg.Config.from_env(), Config.from_env()
    for f in _KNOBS:
        assert getattr(p, f) == getattr(j, f), f


@pytest.mark.parametrize("kw,match", [
    ({"membership_sync_timeout_s": 0}, "membership timeouts"),
    ({"bus_retries": 0}, "bus_retries"),
    ({"gossip_interval_s": 0}, "gossip_interval_s"),
    ({"gossip_fanout": 0}, "gossip_fanout"),
    ({"gossip_suspect_s": 0}, "gossip_suspect_s"),
    ({"gossip_suspect_s": 2.0, "gossip_dead_s": 2.0}, "must exceed"),
    ({"membership_port": 70000}, "membership_port"),
    ({"clock_sync_samples": -1}, "clock_sync_samples"),
    ({"straggler_policy": "panic"}, "STRAGGLER_POLICY"),
])
def test_membership_knob_validation_matches_jax(kw, match):
    for cls in (Config, jcfg.Config):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_start_estimates_the_clock_offset_when_traced(tmp_path):
    """A traced member estimates its wall-clock offset against the bus
    host over ``ping`` at start and hands it to the tracer."""
    from byteps_tpu_torch.common import tracing
    pcfg.set_config(Config(trace_sample="1/1", trace_dir=str(tmp_path),
                           clock_sync_samples=3))
    tracing.set_tracer(None)
    m = mm.ElasticMembership(0, [0], f"127.0.0.1:{free_port()}").start()
    try:
        off = tracing.clock_offset()
        assert off["offset_s"] is not None and abs(off["offset_s"]) < 1.0
        assert off["source"].startswith("bus 127.0.0.1:")
    finally:
        m.stop()
        tracing.set_tracer(None)


def test_bus_registers_and_clears_the_cluster_history_provider():
    """The bus host registers the health engine's cluster-history view
    and unregisters it at close (the JAX bus leaves it registered:
    ROADMAP Queue C 22)."""
    from byteps_tpu_torch.common import health
    bus = _BusServer(("127.0.0.1", free_port()), MembershipView(0, (0, 1)),
                     1.0, 1.0)
    try:
        req(bus.addr[1], {"op": "metrics_put", "rank": 1, "metrics": {},
                          "history": {"n": 3}})
        assert health._cluster_history_provider() == {1: {"n": 3}}
    finally:
        bus.close()
    assert health._cluster_history_provider is None


# -- parity with the JAX module -------------------------------------------------


def _configure(**kw):
    jcfg.set_config(jcfg.Config(**kw))
    pcfg.set_config(pcfg.Config(**kw))


def _frame(send, obj) -> bytes:
    """The bytes ``send`` puts on a socket for ``obj``."""
    a, b = socket.socketpair()
    try:
        def writer():
            send(a, obj)
            a.shutdown(socket.SHUT_WR)

        t = threading.Thread(target=writer)
        t.start()
        b.settimeout(20)
        chunks = []
        while True:
            c = b.recv(1 << 20)
            if not c:
                break
            chunks.append(c)
        t.join(timeout=20)
        return b"".join(chunks)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("integrity", [True, False], ids=["sealed", "raw"])
@pytest.mark.parametrize("n", [16, 600_000], ids=["small", "large"])
def test_send_obj_frames_are_the_jax_bytes(integrity, n):
    """The same sync message framed by both packages: identical bytes on
    the wire (the large frame takes the port's two-write path), and each
    package's receiver reads the other's frame."""
    _configure(integrity_on=integrity)
    rng = np.random.default_rng(3)
    msg = {"op": "sync", "rank": 2, "epoch": 5, "step": 11,
           "payload": {"grad": rng.standard_normal(n).astype(np.float32),
                       "crc": 123},
           "metrics": None, "history": None}
    fp, fj = _frame(_send_obj, msg), _frame(jmm._send_obj, msg)
    assert fp == fj
    assert (fp[8:12] == b"BPSE") == integrity
    for recv, frame in ((_recv_obj, fj), (jmm._recv_obj, fp)):
        a, b = socket.socketpair()
        try:
            t = threading.Thread(target=a.sendall, args=(frame,))
            t.start()
            got = recv(b)
            t.join(timeout=20)
        finally:
            a.close()
            b.close()
        assert got["step"] == 11
        np.testing.assert_array_equal(got["payload"]["grad"],
                                      msg["payload"]["grad"])


def _bus_round(bus_cls, view_cls, send, recv):
    """One scenario against a bus: a 2-member sync, a rejoin admitted at
    a state-carrying boundary, a shrink hello, a ping, metrics.  Returns
    the replies with the wall-clock fields removed."""
    port = free_port()
    bus = bus_cls(("127.0.0.1", port), view_cls(1, (0, 2)),
                  rendezvous_timeout_s=2.0, sync_timeout_s=10.0,
                  host_rank=0)
    out = {}
    try:
        syncs = {}

        def member(r):
            syncs[r] = req(port, {"op": "sync", "rank": r, "epoch": 1,
                                  "step": 3, "payload": np.full(
                                      4, r, np.float32),
                                  "metrics": {"rank": r}}, send=send,
                           recv=recv)
        ts = [threading.Thread(target=member, args=(r,)) for r in (0, 2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=20)
        out["sync"] = {r: {k: v for k, v in rep.items() if k != "replica"}
                       for r, rep in syncs.items()}
        out["admission"] = _admission(port, bus, send=send, recv=recv)
        for r in (0, 2):
            out["admission"][r].pop("replica", None)
        out["hello"] = {}

        def hello(r):
            out["hello"][r] = req(port, {"op": "hello", "rank": r,
                                         "epoch": 3, "world": [0, 1]},
                                  send=send, recv=recv)
        hs = [threading.Thread(target=hello, args=(r,)) for r in (0, 1)]
        for h in hs:
            h.start()
        for h in hs:
            h.join(timeout=20)
        for r in (0, 1):
            out["hello"][r].pop("replica", None)
        ping = req(port, {"op": "ping"}, send=send, recv=recv)
        ping.pop("t_wall")
        out["ping"] = ping
        metrics = req(port, {"op": "metrics"}, send=send, recv=recv)
        for e in metrics["ranks"].values():
            e.pop("age_s")
        # the barrier lags' phi scores are timing: compare who is scored
        metrics["slow"] = sorted(metrics["slow"])
        out["metrics"] = metrics
    finally:
        bus.close()
    return out


def test_buses_serve_the_other_packages_client():
    """A port client against the JAX ``_BusServer`` and a JAX client
    against the port's give the same replies through sync, rejoin
    admission, hello, ping and metrics."""
    port_on_jax = _bus_round(jmm._BusServer, jmm.MembershipView,
                             _send_obj, _recv_obj)
    jax_on_port = _bus_round(_BusServer, MembershipView,
                             jmm._send_obj, jmm._recv_obj)
    for a, b in ((port_on_jax, jax_on_port),):
        ja, jb = a["admission"].pop("join"), b["admission"].pop("join")
        # the joiner is the standby of the admitted world: its replica
        # carries wall-clock stamps
        assert ja.pop("replica")["world"] == jb.pop("replica")["world"]
        assert unpack_state(ja.pop("state"))["w"].tolist() == \
            unpack_state(jb.pop("state"))["w"].tolist()
        assert ja == jb
        for k in ("sync",):
            for r in (0, 2):
                pa, pb = a[k][r].pop("payloads"), b[k][r].pop("payloads")
                assert sorted(pa) == sorted(pb) == [0, 2]
                for q in (0, 2):
                    np.testing.assert_array_equal(pa[q], pb[q])
        assert a == b
    assert port_on_jax["ping"]["epoch"] == 3
    assert port_on_jax["ping"]["world"] == [0, 1]
    assert port_on_jax["hello"][0] == {"ok": True, "epoch": 3,
                                       "world": [0, 1]}
