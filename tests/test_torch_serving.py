"""The port's in-process serving plane (``byteps_tpu_torch/server/
serving.py``, ``serve_client.py``, ``serve_ring.py`` and the store's
serving hooks), held against the JAX package's
(``tests/test_serving.py``): snapshot ids and retention, the
copy-on-write freeze under every delta path of the port's store, cuts
only at consistent points, delta pulls that ship only changed keys with
replies (keys, versions, payload bytes, wire bytes) equal to the JAX
plane's for the same seeded cuts, raw and onebit, the staleness-bounded
client (cache hits, blocking refresh, ``block=False``, ``prefetch``,
``bytes_received``), hot-key replicas, ``notify_world_change`` on a
shrink, the consistent-hash ring routing as the JAX ring routes, pulls
over TCP between the packages, and the serving, tier, durable and
reconciler knobs of ``Config`` equal to the JAX ``Config``'s."""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from byteps_tpu.common import config as jcfg
from byteps_tpu.comm import transport as jtp
from byteps_tpu.server.kv_store import KVStore as JKVStore
from byteps_tpu.server.serve_client import PullClient as JPullClient
from byteps_tpu.server.serve_ring import ServeRing as JServeRing
from byteps_tpu.server.serving import ServingPlane as JServingPlane
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.comm import transport as tp
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.fault import injector as inj
from byteps_tpu_torch.fault import membership as mm
from byteps_tpu_torch.server import serving
from byteps_tpu_torch.server.kv_store import KVStore
from byteps_tpu_torch.server.serve_client import PullClient
from byteps_tpu_torch.server.serve_ring import ServeRing
from byteps_tpu_torch.server.serving import ServingPlane, SnapshotStore

from .torch_fault_common import fresh_fault_state, free_port  # noqa: F401

ONEBIT = {"compressor": "onebit"}
CPU = torch.device("cpu")


def _store(keys, numel=8):
    s = KVStore(device="cpu")
    for k in keys:
        s.init_key(k, np.zeros(numel, np.float32))
    return s


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_frame(a: bytes, b: bytes, numel: int, kwargs=ONEBIT):
    """Two codec frames of one value from the two packages: every
    integer leaf (onebit's sign words) equal bit for bit, every float
    leaf (onebit's L1 scale, a sum the packages take in another order:
    ROADMAP Queue C 2, 6) within rtol 1e-5."""
    from byteps_tpu_torch.compression import registry as preg
    comp = preg.create(dict(kwargs), numel, torch.float32, for_server=True)
    pa, pb = comp.wire_decode(bytes(a)), comp.wire_decode(bytes(b))
    assert sorted(pa) == sorted(pb) and len(a) == len(b)
    for k in pa:
        x, y = pa[k].numpy(), pb[k].numpy()
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=0)
        else:
            assert x.tobytes() == y.tobytes(), k


def _same_decoded(x, y):
    """Two decoded onebit values: the same sign everywhere, magnitudes
    within rtol 1e-5 (the scale, as in :func:`_same_frame`)."""
    x, y = _np(x), np.asarray(y)
    assert np.array_equal(np.signbit(x), np.signbit(y))
    np.testing.assert_allclose(x, y, rtol=1e-5, atol=0)


# -- snapshots ----------------------------------------------------------------


def test_snapshot_ids_monotonic_and_retention_bounded():
    s = _store(["a"])
    ss = SnapshotStore(s, retention=3)
    ids = []
    for _ in range(6):
        s.push_delta("a", np.ones(8, np.float32))
        ids.append(ss.cut().id)
    assert ids == list(range(1, 7)) and len(ss.ring) == 3
    assert ss.ring.get(ids[0]) is None
    assert ss.ring.get(ids[-1]).versions == {"a": 6}


@pytest.mark.parametrize("path", ["push_delta", "push_delta_wire",
                                  "apply_delta", "apply_delta_wire",
                                  "publish_key", "skip_screen"])
def test_cut_stays_frozen_under_every_delta_path(path, monkeypatch):
    """``snapshot_refs`` marks every key copy-on-write: whichever path
    then mutates the key (the store's own envelope hop, the transport's
    verified entries, a wire frame decoded on the store's device, a
    publish, or the non-finite screen's restore), the cut's read-only
    numpy views keep their bytes."""
    from byteps_tpu_torch.compression import registry as preg
    n = 4096
    s = _store(["a", "b"], numel=n)
    s.register_compression("a", ONEBIT, n)
    rng = np.random.default_rng(3)
    s.push_delta("a", rng.standard_normal(n).astype(np.float32),
                 worker_id=0, seq=1)
    ss = SnapshotStore(s, retention=4)
    snap = ss.cut()
    frozen = {k: np.array(v) for k, v in snap.refs.items()}
    comp = preg.create(ONEBIT, n, torch.float32)
    delta = rng.standard_normal(n).astype(np.float32)
    wire = comp.wire_encode(comp.compress(torch.from_numpy(delta),
                                          comp.init_state(CPU))[0])
    if path == "push_delta":
        s.push_delta("a", delta, worker_id=0, seq=2)
    elif path == "push_delta_wire":
        s.push_delta_wire("a", wire, worker_id=0, seq=2)
    elif path == "apply_delta":
        s.apply_delta("a", delta, worker_id=0, seq=2)
    elif path == "apply_delta_wire":
        s.apply_delta_wire("a", wire, worker_id=0, seq=2)
    elif path == "publish_key":
        s.publish_key("a", delta)
    else:
        monkeypatch.setenv("BYTEPS_NONFINITE_POLICY", "skip")
        pcfg.reset_config()
        # the second sum overflows to inf: the screen restores the value
        s.push_delta("a", np.full(n, 3e38, np.float32), worker_id=0, seq=2)
        s.push_delta("a", np.full(n, 3e38, np.float32), worker_id=1, seq=1)
        assert counters.get("integrity.nonfinite_skipped") == 1
    for k, v in snap.refs.items():
        assert v.tobytes() == frozen[k].tobytes(), k
        with pytest.raises(ValueError):
            v[0] = 9.0
    assert s.version("a") >= 1


def test_write_batch_defers_cuts_to_consistent_points():
    s = _store(["x", "y"])
    ss = SnapshotStore(s, retention=8, cut_interval_s=0.0)
    for _ in range(5):
        with s.write_batch():
            s.push_delta("x", np.ones(8, np.float32))
            s.push_delta("y", np.ones(8, np.float32))
    for snap in filter(None, (ss.ring.get(i) for i in range(1, 100))):
        assert snap.versions["x"] == snap.versions["y"], snap.versions
    assert ss.ring.latest().versions == {"x": 5, "y": 5}
    ss.detach()


def test_subscribers_notified_outside_the_lock_even_on_a_dropped_ack():
    """A landed delta notifies outside the store lock (the subscriber
    may pull), and a chaos-dropped ack still notifies: the sum applied."""
    from byteps_tpu_torch.common import integrity
    s = _store(["a"])
    got = []
    s.subscribe(lambda k, v: got.append((k, v, _np(s.pull(k))[0])))
    s.push_delta("a", np.ones(8, np.float32), worker_id=0, seq=1)
    inj.arm("drop:site=kv_push:p=1", seed=1, rank=0)
    with pytest.raises(integrity.AckLost):
        s.push_delta("a", np.ones(8, np.float32), worker_id=0, seq=2)
    inj.disarm()
    assert got == [("a", 1, 1.0), ("a", 2, 2.0)]


# -- delta pulls, against the JAX plane -----------------------------------------


def _both_planes(codec, numel=4096, keys=("a", "b", "c")):
    planes = {}
    for who, Store, Plane in (("port", KVStore, ServingPlane),
                              ("jax", JKVStore, JServingPlane)):
        st = Store(device="cpu") if who == "port" else Store()
        for k in keys:
            st.init_key(k, np.zeros(numel, np.float32))
            if codec is not None and k != "c":
                st.register_compression(k, codec, numel)
        kw = {"device": "cpu"} if who == "port" else {}
        planes[who] = (st, Plane(st, replicas=1, retention=4, **kw))
    return planes


@pytest.mark.parametrize("codec", [None, ONEBIT])
def test_delta_pulls_equal_the_jax_planes(codec):
    """The same seeded pushes and cuts through both planes: every reply
    (full or delta, its keys, versions, payload bytes and wire bytes)
    is the JAX plane's, and only changed keys travel."""
    numel = 4096
    planes = _both_planes(codec, numel)
    rng = np.random.default_rng(7)
    since = {"port": None, "jax": None}
    for rnd in range(6):
        changed = ["a", "b", "c"] if rnd == 0 else \
            list(rng.choice(["a", "b", "c"], size=rnd % 3 + 1,
                            replace=False))
        deltas = {k: rng.standard_normal(numel).astype(np.float32)
                  for k in sorted(changed)}
        replies = {}
        for who, (st, plane) in planes.items():
            for k, d in deltas.items():
                st.push_delta(k, d, worker_id=0, seq=rnd + 1)
            plane.cut()
            r = plane.pull(since_id=since[who])
            since[who] = r.snapshot_id
            replies[who] = r
        p, j = replies["port"], replies["jax"]
        assert (p.snapshot_id, p.full, p.wire_bytes) == \
            (j.snapshot_id, j.full, j.wire_bytes)
        assert sorted(p.items) == sorted(j.items) == \
            (["a", "b", "c"] if rnd == 0 else sorted(changed))
        for k in p.items:
            pi, ji = p.items[k], j.items[k]
            assert (pi.version, pi.wire_nbytes, pi.codec) == \
                (ji.version, ji.wire_nbytes, ji.codec)
            if isinstance(ji.payload, (bytes, bytearray)):
                _same_frame(pi.payload, ji.payload, numel)
            else:
                assert _np(pi.payload).tobytes() == \
                    np.asarray(ji.payload).tobytes()


@pytest.mark.parametrize("codec", [None, ONEBIT])
def test_pull_clients_receive_the_jax_clients_values_and_bytes(codec):
    """A port ``PullClient`` and a JAX one over the same cuts: equal
    decoded values (the onebit key decoded on the client's device) and
    equal ``bytes_received``; compressed keys cost less than raw."""
    numel = 8192
    planes = _both_planes(codec, numel)
    clients = {"port": PullClient(planes["port"][1], max_staleness_s=0.0,
                                  device="cpu"),
               "jax": JPullClient(planes["jax"][1], max_staleness_s=0.0)}
    rng = np.random.default_rng(9)
    for rnd in range(3):
        d = {k: rng.standard_normal(numel).astype(np.float32)
             for k in ("a", "b", "c")[:rnd + 1]}
        vals = {}
        for who, (st, plane) in planes.items():
            for k, v in d.items():
                st.push_delta(k, v)
            plane.cut()
            vals[who] = clients[who].pull()
        for k in ("a", "b", "c"):
            assert isinstance(vals["port"][k], torch.Tensor)
            if codec is not None and k != "c":
                _same_decoded(vals["port"][k], vals["jax"][k])
            else:
                np.testing.assert_array_equal(_np(vals["port"][k]),
                                              np.asarray(vals["jax"][k]))
        assert clients["port"].bytes_received == \
            clients["jax"].bytes_received
    if codec is not None:
        assert clients["port"].bytes_received < 3 * 3 * numel * 4


def test_full_fallback_after_retention_and_after_a_clear():
    s = _store(["a"], numel=16)
    plane = ServingPlane(s, replicas=1, retention=2, device="cpu")
    s.push_delta("a", np.ones(16, np.float32))
    plane.cut()
    client = PullClient(plane, max_staleness_s=0.0, device="cpu")
    client.pull()
    old = client.snapshot_id
    for _ in range(4):
        s.push_delta("a", np.ones(16, np.float32))
        plane.cut()
    assert plane.snapstore.ring.get(old) is None
    assert client.pull()["a"][0].item() == 5.0
    assert counters.get("serve.retention_miss") == 1
    # a clear bumps the generation: the next pull is full, not a delta
    gen = s._generation
    s.clear()
    s.init_key("a", np.full(16, 7.0, np.float32))
    plane.cut()
    r = plane.pull(since_id=client.snapshot_id)
    assert s._generation == gen + 1 and r.full
    assert client.pull()["a"][0].item() == 7.0


def test_torn_snapshot_never_observed_by_concurrent_pullers():
    numel = 64
    s = _store(["w.a", "w.b"], numel=numel)
    plane = ServingPlane(s, replicas=2, retention=8, cut_interval_s=0.0,
                         device="cpu")
    with s.write_batch():
        s.push_delta("w.a", np.ones(numel, np.float32))
        s.push_delta("w.b", np.ones(numel, np.float32))
    stop = threading.Event()
    torn = []

    def puller():
        client = PullClient(plane, max_staleness_s=0.0, device="cpu")
        while not stop.is_set():
            vals = client.pull()
            if vals and vals["w.a"][0] != vals["w.b"][0]:
                torn.append((float(vals["w.a"][0]), float(vals["w.b"][0])))

    threads = [threading.Thread(target=puller, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    for _ in range(50):
        with s.write_batch():
            s.push_delta("w.a", np.ones(numel, np.float32))
            s.push_delta("w.b", np.ones(numel, np.float32))
    stop.set()
    for t in threads:
        t.join(timeout=10)
    plane.close()
    assert torn == [] and s.pull("w.a")[0].item() == 51.0


@pytest.mark.integrity
def test_serve_pull_bitflip_nacked_and_retransmitted(monkeypatch):
    """A corrupted pull reply is NACKed and retransmitted from the
    sealed source: the client converges to exact values."""
    monkeypatch.setenv("BYTEPS_INTEGRITY_MAX_RETRANSMITS", "8")
    pcfg.reset_config()
    inj.arm("bitflip:site=serve_pull:p=0.3", seed=7, rank=0)
    s = _store(["k"], numel=128)
    plane = ServingPlane(s, replicas=1, device="cpu")
    plane.cut()
    client = PullClient(plane, max_staleness_s=0.0, device="cpu")
    for _ in range(12):
        s.push_delta("k", np.ones(128, np.float32))
        plane.cut()
        vals = client.pull()
    inj.disarm()
    np.testing.assert_array_equal(vals["k"].numpy(), np.full(128, 12.0))
    assert counters.get("integrity.crc_reject") > 0
    assert counters.get("integrity.retransmit") > 0
    assert counters.get("serve.pull_bytes_wasted") > 0


# -- the client's staleness bound ------------------------------------------------


def test_client_cache_hit_refresh_block_false_and_prefetch():
    s = _store(["a"])
    plane = ServingPlane(s, replicas=1, device="cpu")
    s.push_delta("a", np.ones(8, np.float32))
    plane.cut()
    c = PullClient(plane, max_staleness_s=60.0, device="cpu")
    assert c.pull()["a"][0].item() == 1.0
    b = c.bytes_received
    s.push_delta("a", np.ones(8, np.float32))
    plane.cut()
    # inside the bound: a cache hit, no wire bytes, the old value
    assert c.pull()["a"][0].item() == 1.0 and c.bytes_received == b
    assert counters.get("serve.cache_hits") == 1
    # past the bound, blocking: one delta pull brings it forward
    assert c.pull(max_staleness_s=0.0)["a"][0].item() == 2.0
    assert c.bytes_received == 2 * b
    # block=False serves the stale cache now and refreshes behind.  The
    # background refresh is held at the client's refresh lock until the
    # stale value is back: on a loaded host it would otherwise publish
    # the new cut before the foreground read the cache
    s.push_delta("a", np.ones(8, np.float32))
    plane.cut()
    with c._refresh_lock:
        assert c.pull(max_staleness_s=0.0,
                      block=False)["a"][0].item() == 2.0
    assert counters.get("serve.stale_served") == 1
    for _ in range(500):
        if c.version("a") == 3:
            break
        threading.Event().wait(0.01)
    assert c.pull()["a"][0].item() == 3.0
    pre = PullClient(plane, max_staleness_s=0.0, prefetch=True,
                     device="cpu")
    assert pre.pull()["a"][0].item() == 3.0   # the first pull blocks
    pre.pull()
    assert counters.get("serve.async_refresh") >= 2


# -- replicas and the world ------------------------------------------------------


def test_hot_key_replicas_and_a_dead_replica_degrades_to_primary():
    s = _store([f"k{i}" for i in range(4)])
    plane = ServingPlane(s, replicas=3, hot_keys=4, retention=8,
                         device="cpu")
    for i in range(4):
        s.push_delta(f"k{i}", np.full(8, float(i + 1), np.float32))
    plane.cut()
    client = PullClient(plane, keys=["k0", "k1"], max_staleness_s=0.0,
                        device="cpu")
    for _ in range(4):
        client.pull()
    plane.cut()
    assert plane.debug_state()["hot_keys_mirrored"] >= 1
    for r in plane.replicas:
        r.kill()
    vals = client.pull()
    assert vals["k0"][0].item() == 1.0 and vals["k1"][0].item() == 2.0
    assert counters.get("serve.primary_reads") >= 1


def test_notify_world_change_reshards_on_a_shrink():
    s = _store(["a"])
    plane = ServingPlane(s, replicas=3, device="cpu")
    s.push_delta("a", np.ones(8, np.float32))
    plane.cut()
    assert plane in serving.active_planes()
    serving.notify_world_change(mm.MembershipView(epoch=1, world=(0,)))
    st = plane.debug_state()
    assert st["alive_clamp"] == 1 and st["dead_replicas"] == [1, 2]
    assert PullClient(plane, max_staleness_s=0.0,
                      device="cpu").pull()["a"][0].item() == 1.0
    plane.close()
    assert plane not in serving.active_planes()


def test_membership_apply_notifies_the_serving_planes():
    """``ElasticMembership._maybe_apply`` of a shrink re-clamps every
    live plane, as the JAX membership does."""
    from byteps_tpu_torch.core import api
    s = _store(["a"])
    plane = ServingPlane(s, replicas=2, device="cpu")
    s.push_delta("a", np.ones(8, np.float32))
    plane.cut()
    api.init(pcfg.Config(), device="cpu")
    m = mm.ElasticMembership(0, [0, 1], f"127.0.0.1:{free_port()}",
                             device="cpu").start()
    try:
        m._maybe_apply(mm.MembershipView(epoch=1, world=(0,)))
        assert plane.debug_state()["alive_clamp"] == 1
        assert plane.debug_state()["dead_replicas"] == [1]
        assert counters.get("serve.reshards") >= 1
    finally:
        m.stop()
        plane.close()


def test_start_serving_defaults_to_write_driven_cuts():
    from byteps_tpu_torch.core import api
    s = _store(["a"])
    plane = api.start_serving(s, device="cpu")
    try:
        s.push_delta("a", np.ones(8, np.float32))
        assert plane.snapstore.ring.latest() is not None
    finally:
        plane.close()
    before = plane.snapstore.ring.latest().id
    s.push_delta("a", np.ones(8, np.float32))
    assert plane.snapstore.ring.latest().id == before


# -- the consistent-hash ring ----------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_serve_ring_routes_as_the_jax_ring(seed):
    rng = np.random.default_rng(seed)
    hosts = sorted(set(int(h) for h in rng.integers(0, 50,
                                                    size=rng.integers(1, 9))))
    vnodes = int(rng.integers(1, 80))
    keys = [f"layer{i}.w" for i in range(200)] + list(range(50))
    ring, jring = ServeRing(hosts, vnodes=vnodes), \
        JServeRing(hosts, vnodes=vnodes)
    for n in (1, 2, 3):
        assert [ring.replica_hosts(k, n) for k in keys] == \
            [jring.replica_hosts(k, n) for k in keys]
    assert ring.arc_share() == jring.arc_share()
    # the same churn moves the same keys
    extra = max(hosts) + 1
    ring2, jring2 = ServeRing(hosts + [extra], vnodes=vnodes), \
        JServeRing(hosts + [extra], vnodes=vnodes)
    assert ring.moved_keys(keys, ring2, 2) == \
        jring.moved_keys(keys, jring2, 2)


# -- over TCP, across the packages -----------------------------------------------


def test_pulls_over_tcp_across_the_packages():
    """A port client pulls from a port plane and from a JAX plane behind
    each package's transport server, and a JAX client pulls from the
    port's; every pair holds equal values and bytes (onebit included)."""
    numel = 4096
    planes = _both_planes(ONEBIT, numel)
    rng = np.random.default_rng(13)
    for k in ("a", "b", "c"):
        d = rng.standard_normal(numel).astype(np.float32)
        for st, plane in planes.values():
            st.push_delta(k, d)
    for _, plane in planes.values():
        plane.cut()
    psrv = tp.TransportServer(rank=0, serving=planes["port"][1])
    jsrv = jtp.TransportServer(rank=0, serving=planes["jax"][1])
    peps = []
    try:
        got = {}
        for name, addr in (("port<-port", psrv.addr),
                           ("port<-jax", jsrv.addr)):
            ep = tp.TcpEndpoint(addr, peer=0, rank=7)
            peps.append(ep)
            c = PullClient(tp.RemoteServing(ep), max_staleness_s=0.0,
                           device="cpu")
            got[name] = ({k: _np(v) for k, v in c.pull().items()},
                         c.bytes_received)
        jep = jtp.TcpEndpoint(psrv.addr, peer=0, rank=8)
        try:
            jc = JPullClient(jtp.RemoteServing(jep), max_staleness_s=0.0)
            got["jax<-port"] = ({k: np.asarray(v) for k, v
                                 in jc.pull().items()}, jc.bytes_received)
        finally:
            jep.close(drain=False)
        ref_vals, ref_bytes = got["jax<-port"]
        for name, (vals, nbytes) in got.items():
            assert nbytes == ref_bytes, name
            for k in ("a", "b"):
                _same_decoded(vals[k], ref_vals[k])
            np.testing.assert_array_equal(vals["c"], ref_vals["c"])
        # the port plane's frames decode to the same bits in both
        # packages' clients
        for k in ("a", "b", "c"):
            np.testing.assert_array_equal(got["port<-port"][0][k],
                                          ref_vals[k])
    finally:
        for ep in peps:
            ep.close(drain=False)
        psrv.close()
        jsrv.close()


# -- Config parity ----------------------------------------------------------------

_KNOBS = [
    ("serve_replicas", "BYTEPS_SERVE_REPLICAS", "3", "0"),
    ("serve_retention", "BYTEPS_SERVE_RETENTION", "5", "0"),
    ("serve_hot_keys", "BYTEPS_SERVE_HOT_KEYS", "2", "-1"),
    ("serve_max_staleness_s", "BYTEPS_SERVE_MAX_STALENESS", "1.5", "-1"),
    ("serve_cut_interval_s", "BYTEPS_SERVE_CUT_INTERVAL", "0.2", "-1"),
    ("serve_hedge_ms", "BYTEPS_SERVE_HEDGE_MS", "4", "-1"),
    ("serve_tier_vnodes", "BYTEPS_SERVE_TIER_VNODES", "16", "0"),
    ("serve_tier_replicas", "BYTEPS_SERVE_TIER_REPLICAS", "3", "0"),
    ("serve_tier_rate", "BYTEPS_SERVE_TIER_RATE", "100", "-1"),
    ("serve_tier_burst", "BYTEPS_SERVE_TIER_BURST", "10", "-1"),
    ("serve_tier_queue_high", "BYTEPS_SERVE_TIER_QUEUE_HIGH", "8", "0"),
    ("serve_tier_ttl_s", "BYTEPS_SERVE_TIER_TTL", "2.5", "0"),
    ("serve_tier_min_hosts", "BYTEPS_SERVE_TIER_MIN_HOSTS", "2", "0"),
    ("serve_tier_max_hosts", "BYTEPS_SERVE_TIER_MAX_HOSTS", "4", "0"),
    ("serve_tier_cooldown_s", "BYTEPS_SERVE_TIER_COOLDOWN", "1", "-1"),
    ("serve_tier_bus", "BYTEPS_SERVE_TIER_BUS", "127.0.0.1:9", None),
    ("reconcile_interval_s", "BYTEPS_RECONCILE_INTERVAL", "0.1", "0"),
    ("reconcile_flap_limit", "BYTEPS_RECONCILE_FLAP_LIMIT", "5", "0"),
    ("reconcile_flap_window_s", "BYTEPS_RECONCILE_FLAP_WINDOW", "9", "0"),
    ("reconcile_drain_deadline_s", "BYTEPS_RECONCILE_DRAIN_DEADLINE", "3",
     "0"),
    ("reconcile_ban_s", "BYTEPS_RECONCILE_BAN", "7", "-1"),
    ("durable_dir", "BYTEPS_DURABLE_DIR", "/some/dir", None),
    ("wal_fsync", "BYTEPS_WAL_FSYNC", " Interval ", "sometimes"),
    ("wal_fsync_interval_s", "BYTEPS_WAL_FSYNC_INTERVAL", "0.5", "0"),
    ("wal_segment_bytes", "BYTEPS_WAL_SEGMENT_BYTES", "8192", "100"),
    ("wal_retain_snapshots", "BYTEPS_WAL_RETAIN", "4", "0"),
]


@pytest.mark.parametrize("field,env,good,bad", _KNOBS,
                         ids=[k[0] for k in _KNOBS])
def test_config_knob_equals_the_jax_configs(field, env, good, bad,
                                            monkeypatch):
    """Each serving, tier, reconciler and durable knob: the same default,
    the same parse of its environment variable, and the same refusal
    (with the same message) of a bad value."""
    monkeypatch.delenv(env, raising=False)
    assert getattr(pcfg.Config(), field) == getattr(jcfg.Config(), field)
    assert getattr(pcfg.Config.from_env(), field) == \
        getattr(jcfg.Config.from_env(), field)
    monkeypatch.setenv(env, good)
    p, j = pcfg.Config.from_env(), jcfg.Config.from_env()
    assert getattr(p, field) == getattr(j, field) != \
        getattr(jcfg.Config(), field)
    if bad is None:
        return
    monkeypatch.setenv(env, bad)
    with pytest.raises(ValueError) as pe:
        pcfg.Config.from_env()
    with pytest.raises(ValueError) as je:
        jcfg.Config.from_env()
    assert str(pe.value) == str(je.value)


def test_config_knob_list_covers_the_jax_sections():
    """No knob of the JAX ``Config``'s serving, tier, reconciler and
    durable sections is missing from the port's (``serve_replicas`` and
    ``serve_hot_keys`` came earlier, with the sharding module)."""
    jaxf = {f.name for f in dataclasses.fields(jcfg.Config)
            if f.name.startswith(("serve_", "reconcile_", "wal_"))
            or f.name == "durable_dir"}
    assert jaxf == {k[0] for k in _KNOBS}
    portf = {f.name for f in dataclasses.fields(pcfg.Config)}
    assert jaxf <= portf
