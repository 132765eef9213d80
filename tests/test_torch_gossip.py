"""The port's SWIM gossip plane (``byteps_tpu_torch/fault/gossip.py``):
the JAX package's cases of ``tests/test_gossip.py`` (merge precedence and
refutation, the suspicion state machine on a fake clock, quorum math,
64-rank convergence over ``InMemoryWire``, the ``quorum_loss`` rule, the
``partition:ranks=A|B`` site, the bus verb's frame clamp, and the
observability surfaces answering from the table), plus parity: the two
packages' tables merge the same digest sequences into the same tables,
and a digest of either package merges into a table of the other.

The multi-process split-brain proof is ``tests/test_torch_partition.py``.
"""

import socket
import time

import pytest

import numpy as np

from byteps_tpu.fault import gossip as jgossip
from byteps_tpu_torch.common import flight_recorder as _flight
from byteps_tpu_torch.common.config import get_config, reset_config
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.fault.gossip import (ALIVE, DEAD, PARKED, SUSPECT,
                                           GossipAgent, GossipTable,
                                           InMemoryWire, quorum_ok)

from .torch_member_common import free_port as _free_port
from .torch_member_common import fresh_member_state  # noqa: F401


def _wire_fn(wire, rank, clock=None):
    """Adapt InMemoryWire.exchange to the agent's (peer, digest) shape.
    ``clock`` (a {"now": t} cell) keeps the peer-side merges on the same
    fake clock the sweeps run on — mixing wall-clock progress stamps
    with fake-clock sweeps would mis-age every entry."""
    if clock is None:
        return lambda peer, digest: wire.exchange(rank, peer, digest)
    return lambda peer, digest: wire.exchange(rank, peer, digest,
                                              now=clock["now"])


# ---------------------------------------------------------------- quorum


def test_quorum_ok_strict_majority_truth_table():
    last = (0, 1, 2)
    assert quorum_ok((0, 1), last)          # 2 of 3
    assert quorum_ok((0, 1, 2), last)       # full world
    assert not quorum_ok((0,), last)        # 1 of 3
    assert not quorum_ok((), last)
    # the even-split proof: 2-of-4 is NOT a quorum, so neither half of
    # an even partition can commit an epoch — strictness is the point
    assert not quorum_ok((0, 1), (0, 1, 2, 3))
    assert quorum_ok((0, 1, 2), (0, 1, 2, 3))
    # a growing world is always a quorum of the smaller last world
    assert quorum_ok((0, 1, 2, 3), (0, 1))


# ----------------------------------------------------- merge precedence


def test_gossip_merge_precedence_incarnation_state_heartbeat():
    now = time.monotonic()
    t = GossipTable(0, (0, 1), now=now)
    # same incarnation: the more-damning state wins
    t.merge({"from": 9, "entries": {1: {"inc": 0, "state": SUSPECT,
                                        "hb": 0}}}, now=now)
    assert t.state_of(1) == SUSPECT
    # same incarnation, LESS damning: the stale happy claim loses
    t.merge({"from": 9, "entries": {1: {"inc": 0, "state": ALIVE,
                                        "hb": 5}}}, now=now)
    assert t.state_of(1) == SUSPECT
    # higher incarnation wins outright, even back to alive (refutation)
    t.merge({"from": 9, "entries": {1: {"inc": 1, "state": ALIVE,
                                        "hb": 1}}}, now=now)
    assert t.snapshot()[1] == {"inc": 1, "state": ALIVE, "hb": 1}
    # equal inc + equal state: higher heartbeat is the only progress
    t.merge({"from": 9, "entries": {1: {"inc": 1, "state": ALIVE,
                                        "hb": 7}}}, now=now)
    assert t.snapshot()[1]["hb"] == 7
    t.merge({"from": 9, "entries": {1: {"inc": 1, "state": ALIVE,
                                        "hb": 3}}}, now=now)
    assert t.snapshot()[1]["hb"] == 7
    # unknown rank in a digest = an observed join
    t.merge({"from": 9, "entries": {5: {"inc": 0, "state": ALIVE,
                                        "hb": 2}}}, now=now)
    assert t.state_of(5) == ALIVE
    # garbage states are ignored, not merged
    t.merge({"from": 9, "entries": {1: {"inc": 9, "state": "zombie",
                                        "hb": 0}}}, now=now)
    assert t.snapshot()[1]["inc"] == 1


def test_gossip_refutation_outbids_the_accusation():
    now = time.monotonic()
    t = GossipTable(2, (0, 1, 2), now=now)
    # someone claims WE are dead at our own incarnation: out-bid it
    t.merge({"from": 0, "entries": {2: {"inc": 0, "state": DEAD,
                                        "hb": 0}}}, now=now)
    me = t.snapshot()[2]
    assert me["state"] == ALIVE and me["inc"] == 1
    assert counters.get("gossip.refutations") == 1
    kinds = [e["kind"] for e in _flight.recorder.snapshot()]
    assert "gossip.refuted" in kinds
    # an accusation BELOW our incarnation is stale — no bump needed
    t.merge({"from": 0, "entries": {2: {"inc": 0, "state": SUSPECT,
                                        "hb": 0}}}, now=now)
    assert t.snapshot()[2] == me
    assert counters.get("gossip.refutations") == 1


def test_gossip_parked_rank_never_refutes():
    """A parked rank KNOWS it is out of the world (minority side of a
    partition) — it must not gossip itself back to alive."""
    now = time.monotonic()
    t = GossipTable(0, (0, 1), now=now)
    t.mark(0, PARKED, now=now)
    t.merge({"from": 1, "entries": {0: {"inc": 5, "state": SUSPECT,
                                        "hb": 0}}}, now=now)
    assert t.state_of(0) == PARKED
    assert counters.get("gossip.refutations") == 0


def test_gossip_beat_self_refutes_a_slept_through_accusation():
    now = time.monotonic()
    t = GossipTable(1, (0, 1), now=now)
    t.snapshot()  # sanity
    t._entries[1]["state"] = SUSPECT  # accusation merged while we slept
    t.beat(now=now)
    me = t.snapshot()[1]
    assert me["state"] == ALIVE and me["inc"] == 1 and me["hb"] == 1


# ------------------------------------------------- suspicion state machine


def test_gossip_sweep_suspect_then_dead_on_fake_clock():
    now = time.monotonic()
    t = GossipTable(0, (0, 1), suspect_s=1.0, dead_s=2.0, now=now)
    assert t.sweep(now=now + 0.5) == {}
    assert t.sweep(now=now + 1.0) == {1: SUSPECT}
    assert t.state_of(1) == SUSPECT
    assert counters.get("gossip.suspect") == 1
    # suspect holds through the refutation window...
    assert t.sweep(now=now + 2.5) == {}
    # ...then dies dead_s after suspicion onset
    assert t.sweep(now=now + 3.0) == {1: DEAD}
    assert counters.get("gossip.dead") == 1
    assert t.alive_ranks() == [0]
    assert t.reachable_ranks() == [0]
    kinds = [e["kind"] for e in _flight.recorder.snapshot()]
    assert kinds.count("gossip.state") == 2
    # the local rank never sweeps itself
    assert t.sweep(now=now + 99.0) == {}


def test_gossip_heartbeat_progress_defers_suspicion():
    now = time.monotonic()
    t = GossipTable(0, (0, 1), suspect_s=1.0, dead_s=2.0, now=now)
    t.merge({"from": 1, "entries": {1: {"inc": 0, "state": ALIVE,
                                        "hb": 3}}}, now=now + 0.9)
    assert t.sweep(now=now + 1.5) == {}  # progress reset the timer
    assert t.sweep(now=now + 1.9) == {1: SUSPECT}
    assert t.reachable_ranks() == [0, 1]  # suspect still counts


def test_gossip_mark_and_add_rank_revival_bump_incarnation():
    now = time.monotonic()
    t = GossipTable(0, (0, 1), now=now)
    t.mark(1, DEAD, now=now)
    assert t.snapshot()[1] == {"inc": 1, "state": DEAD, "hb": 0}
    # a rejoin admitted by the bus revives with a HIGHER incarnation so
    # the revival beats the stale death claim still circulating
    t.add_rank(1, now=now)
    assert t.snapshot()[1]["inc"] == 2
    assert t.state_of(1) == ALIVE
    # add_rank on a healthy entry is a no-op
    t.add_rank(1, now=now)
    assert t.snapshot()[1]["inc"] == 2
    with pytest.raises(ValueError, match="unknown gossip state"):
        t.mark(1, "zombie", now=now)


# ----------------------------------------------------------- payloads


def test_gossip_payload_versioning_highest_wins():
    now = time.monotonic()
    a = GossipTable(0, (0, 1), now=now)
    b = GossipTable(1, (0, 1), now=now)
    a.set_payload("metrics", {"t": 1.0, "v": {"step": 1}})
    a.set_payload("metrics", {"t": 2.0, "v": {"step": 2}})  # ver 2
    b.merge(a.digest(), now=now)
    assert b.payload(0, "metrics")["v"] == {"step": 2}
    # a stale lower-version replay does not roll the value back
    b.merge({"from": 0, "entries": {},
             "payloads": {"0/metrics": [1, {"t": 1.0,
                                            "v": {"step": 1}}]}}, now=now)
    assert b.payload(0, "metrics")["v"] == {"step": 2}
    b.set_payload("metrics", {"t": 3.0, "v": {"step": 9}})
    assert set(b.payloads_of_kind("metrics")) == {0, 1}


# -------------------------------------------------------- convergence


@pytest.mark.chaos
def test_gossip_convergence_64_ranks_join_and_death_subsecond():
    """64 tables on the in-memory wire: a join and a death both reach
    every table in well under a second of wall clock."""
    n = 64
    wire = InMemoryWire()
    now0 = time.monotonic()
    clock = {"now": now0}
    # ranks 0..62 start without rank 63 (it joins via dissemination)
    tables = {r: GossipTable(r, range(n - 1), suspect_s=1e9, dead_s=1e9,
                             now=now0) for r in range(n - 1)}
    tables[n - 1] = GossipTable(n - 1, range(n), suspect_s=1e9,
                                dead_s=1e9, now=now0)
    agents = {}
    for r, t in tables.items():
        wire.register(t)
        agents[r] = GossipAgent(t, _wire_fn(wire, r, clock), fanout=3,
                                seed=r)

    t_start = time.monotonic()
    for rnd in range(1, 40):
        clock["now"] = now0 + 0.01 * rnd
        for r in range(n):
            agents[r].step(now=clock["now"])
        if all(t.state_of(n - 1) == ALIVE for t in tables.values()):
            break
    assert all(t.state_of(n - 1) == ALIVE for t in tables.values()), \
        "join did not disseminate to every table"

    # rank 7 is killed; rank 0 observes it out-of-band (bus eviction)
    tables[0].mark(7, DEAD, now=now0 + 1.0)
    for rnd in range(1, 40):
        clock["now"] = now0 + 1.0 + 0.01 * rnd
        for r in range(n):
            if r == 7:
                continue  # dead ranks don't gossip (and can't refute)
            agents[r].step(now=clock["now"])
        if all(tables[r].state_of(7) == DEAD
               for r in range(n) if r != 7):
            break
    assert all(tables[r].state_of(7) == DEAD for r in range(n) if r != 7)
    elapsed = time.monotonic() - t_start
    assert elapsed < 1.0, f"convergence took {elapsed:.2f}s"


@pytest.mark.chaos
def test_gossip_gray_suspect_refutes_after_wire_heals():
    """A rank severed long enough to be suspected un-suspects itself by
    incarnation bump once the wire heals — it is gray, not dead."""
    now0 = time.monotonic()
    clock = {"now": now0}
    wire = InMemoryWire()
    tables = {r: GossipTable(r, (0, 1, 2), suspect_s=0.2, dead_s=10.0,
                             now=now0) for r in range(3)}
    agents = {r: GossipAgent(tables[r], _wire_fn(wire, r, clock),
                             fanout=2, seed=r) for r in range(3)}
    for t in tables.values():
        wire.register(t)

    wire.cut({2}, {0, 1})
    for k in range(1, 5):
        clock["now"] = now0 + 0.1 * k
        for r in range(3):
            agents[r].step(now=clock["now"])
    assert tables[0].state_of(2) == SUSPECT
    assert tables[1].state_of(2) == SUSPECT

    wire.heal()
    for k in range(5, 10):
        clock["now"] = now0 + 0.1 * k
        for r in range(3):
            agents[r].step(now=clock["now"])
    for t in tables.values():
        assert all(t.state_of(r) == ALIVE for r in range(3)), t.snapshot()
    # the un-suspect was a refutation (incarnation out-bid), not decay
    assert tables[0].snapshot()[2]["inc"] >= 1
    assert counters.get("gossip.refutations") >= 1


# ------------------------------------------------- quorum_loss health rule


class _StubStore:
    interval_s = 1.0

    def points(self):
        return [{"steps": 0}]

    def values(self, key):
        return []


def test_quorum_view_and_health_quorum_loss_rule():
    from byteps_tpu_torch.common import health
    from byteps_tpu_torch.common.health import HealthEngine
    now = time.monotonic()
    table = GossipTable(0, (0, 1, 2), now=now)
    agent = GossipAgent(table, lambda peer, digest: None,
                        world_fn=lambda: (0, 1, 2))
    agent.register_health_provider()
    try:
        engine = HealthEngine(get_config())
        store = _StubStore()
        # full world reachable: no breach
        assert engine._breaches(store)["quorum_loss"] is None
        # a suspect rank still counts toward quorum (gray, refutable)
        table.mark(1, SUSPECT, now=now)
        assert agent.quorum_view() == {"reachable": 3, "world": 3}
        assert engine._breaches(store)["quorum_loss"] is None
        # losing the strict majority of the last agreed world breaches
        table.mark(1, DEAD, now=now)
        table.mark(2, DEAD, now=now)
        assert agent.quorum_view() == {"reachable": 1, "world": 3}
        assert engine._breaches(store)["quorum_loss"] == {
            "reachable": 1, "world": 3}
        # K-window hysteresis before the alert fires
        for _ in range(engine.k):
            engine.evaluate(store)
        assert "quorum_loss" in engine.active_alerts()
        # heal: K clear windows retire it
        table.mark(1, ALIVE, now=now)
        table.mark(2, ALIVE, now=now)
        for _ in range(engine.k):
            engine.evaluate(store)
        assert "quorum_loss" not in engine.active_alerts()
    finally:
        agent.stop()
    assert health._quorum_provider is None  # stop() unregistered it


# --------------------------------------------- partition chaos site


def test_partition_spec_parse_validation():
    from byteps_tpu_torch.fault.injector import parse_spec
    rules = parse_spec("partition:ranks=0|1.2:ms=500")
    assert len(rules) == 1
    with pytest.raises(ValueError, match="non-empty"):
        parse_spec("partition:ranks=|1")
    with pytest.raises(ValueError, match="overlap"):
        parse_spec("partition:ranks=0.1|1.2")
    with pytest.raises(ValueError, match="ms"):
        parse_spec("partition:ranks=0|1:ms=-5")


def test_partition_edge_cut_is_per_edge_and_heals_once():
    from byteps_tpu_torch.fault import injector
    injector.arm("partition:ranks=0|1.2:ms=80", rank=0)
    try:
        assert injector.edge_cut(1)      # crosses the cut; starts clock
        assert injector.edge_cut(2)
        assert not injector.edge_cut(0)  # same side: edge stays open
        assert not injector.edge_cut(7)  # rank outside either side
        assert counters.get("fault.partition") == 1
        time.sleep(0.15)
        # heal is lazy (evaluated at the call site) and one-shot
        assert not injector.edge_cut(1)
        assert not injector.edge_cut(2)
        assert counters.get("fault.partition_healed") == 1
        kinds = [e["kind"] for e in _flight.recorder.snapshot()]
        assert "fault.partition" in kinds
        assert "fault.partition_healed" in kinds
    finally:
        injector.disarm()


# ------------------------------------------ bus verb: frame clamp (sat 4)


def test_gossip_verb_oversize_reply_names_frame_knob(monkeypatch):
    """A gossip digest reply inflated past BYTEPS_BUS_MAX_FRAME (huge
    piggybacked payload) must answer with a SMALL error naming the knob
    — not close silently and strand the anti-entropy loop retrying."""
    from byteps_tpu_torch.fault import membership as mem
    monkeypatch.setenv("BYTEPS_BUS_MAX_FRAME", "4096")
    reset_config()
    srv = mem._BusServer(("127.0.0.1", _free_port()),
                         mem.MembershipView(0, (0, 1)), 1.0, 1.0)
    try:
        table = GossipTable(0, (0, 1))
        table.set_payload("history", "h" * 1_000_000)
        srv.gossip_table = table
        conn = socket.create_connection(srv.addr, timeout=5)
        try:
            mem._send_obj(conn, {"op": "gossip", "rank": 1,
                                 "digest": GossipTable(1, (0, 1)).digest()})
            reply = mem._recv_obj(conn)
        finally:
            conn.close()
        assert reply["ok"] is False
        assert "BYTEPS_BUS_MAX_FRAME" in reply["error"]
    finally:
        srv.close()


# ------------------------------------------- observability surfaces


def test_partition_incident_from_synthetic_events():
    from byteps_tpu_torch.tools.bps_doctor import _partition_incident
    faults = [
        {"t": 100.0, "rank": 1, "kind": "partition",
         "detail": {"side_a": [0], "side_b": [1, 2]}},
        {"t": 110.5, "rank": 1, "kind": "partition_healed",
         "detail": {"side_a": [0], "side_b": [1, 2],
                    "after_ms": 10500.0}},
    ]
    parks = [{"t": 101.0, "rank": 0, "kind": "partition_minority",
              "detail": {"epoch": 0}}]
    inc = _partition_incident(faults, parks)
    assert inc["side_a"] == [0] and inc["side_b"] == [1, 2]
    assert inc["parked_ranks"] == [0]
    assert inc["healed"] is True
    assert inc["split_ms"] == 10500.0
    # an unhealed split still reports both sides and the parked minority
    inc = _partition_incident(faults[:1], parks)
    assert inc["healed"] is False and "split_ms" not in inc
    assert _partition_incident([], []) is None


def test_bps_top_renders_gossip_states_and_banner():
    from byteps_tpu_torch.tools.bps_top import render
    out = render({
        "epoch": 2, "world": [0, 1, 2], "coordinator": 0, "standby": 1,
        "gossip": True,
        "states": {0: {"inc": 0, "state": "alive", "hb": 9},
                   1: {"inc": 1, "state": "suspect", "hb": 4},
                   2: {"inc": 2, "state": "parked", "hb": 0}},
        "ranks": {}, "history": {},
    })
    assert "gossip view (no bus round-trip)" in out
    assert "suspect" in out
    assert "parked" in out


def test_cluster_metrics_answers_from_gossip_table(monkeypatch):
    """With BYTEPS_GOSSIP_ON, cluster_metrics() is answered from the
    local SWIM table — no bus round-trip, so it keeps working on either
    side of a partition."""
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.fault import membership as mem
    monkeypatch.setenv("BYTEPS_GOSSIP_ON", "1")
    monkeypatch.setenv("BYTEPS_GOSSIP_INTERVAL_S", "30")
    reset_config()
    mem._reset_epoch_for_tests()
    m = mem.ElasticMembership(0, [0],
                              f"127.0.0.1:{_free_port()}").start()
    try:
        assert m.gossip is not None
        m.gossip.set_payload("metrics",
                             {"t": time.time(), "v": {"step": 3}})
        out = api.cluster_metrics()
        assert out["gossip"] is True
        assert out["states"][0]["state"] == "alive"
        assert out["ranks"][0]["metrics"] == {"step": 3}
    finally:
        m.stop()
        mem._reset_epoch_for_tests()


# ------------------------------------------------ parity with the JAX module


def _digest_sequence(seed):
    """Seeded digests over ranks 0..5: entries with random incarnations,
    states and heartbeats (self-accusations among them) and versioned
    payloads."""
    rng = np.random.default_rng(seed)
    states = ["alive", "suspect", "dead", "parked", "zombie"]
    out = []
    for k in range(40):
        entries = {int(r): {"inc": int(rng.integers(0, 4)),
                            "state": states[int(rng.integers(0, 5))],
                            "hb": int(rng.integers(0, 20))}
                   for r in rng.choice(6, size=3, replace=False)}
        payloads = {f"{int(rng.integers(0, 6))}/metrics":
                    [int(rng.integers(1, 6)), {"t": float(k), "v": k}]}
        out.append({"from": int(rng.integers(0, 6)), "entries": entries,
                    "payloads": payloads})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tables_merge_like_the_jax_tables(seed):
    """The same digest sequence, merged and swept on one fake clock, into
    a table of each package: the same changed ranks at every merge, the
    same sweep transitions, the same final digest; and each package's
    digest merges into the other's table to the same result."""
    now = 1000.0
    p = GossipTable(2, range(4), suspect_s=1.0, dead_s=2.0, now=now)
    j = jgossip.GossipTable(2, range(4), suspect_s=1.0, dead_s=2.0,
                            now=now)
    for k, d in enumerate(_digest_sequence(seed)):
        t = now + 0.3 * k
        assert p.merge(d, now=t) == j.merge(d, now=t)
        assert p.sweep(now=t + 0.1) == j.sweep(now=t + 0.1)
        if k % 7 == 0:
            p.beat(now=t)
            j.beat(now=t)
    assert p.digest() == j.digest()
    cross_p = GossipTable(5, range(6), now=now)
    cross_j = jgossip.GossipTable(5, range(6), now=now)
    assert cross_p.merge(j.digest(), now=now) == \
        cross_j.merge(p.digest(), now=now)
    assert cross_p.digest() == cross_j.digest()
