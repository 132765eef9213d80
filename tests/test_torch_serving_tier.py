"""The port's distributed serving tier (``byteps_tpu_torch/server/
serving_tier.py``, ``serve_host.py``, ``serve_autoscaler.py``, the
transport's serving hops and the sharded-update slot's
``export_shards``), held against the JAX package's
(``tests/test_serving_tier.py``): admission control on the same clock,
the host's two-phase stage/commit and its shedding, the publisher's
ships (only owned, changed keys: the same hosts receive the same keys
and versions as under the JAX publisher), a onebit key shipped encoded
and decoded on the host's device, retirement after failed ships,
re-shipped holes, failover along the replica arc, the autoscaler's pure
``decide`` against the JAX one, mixed fleets (a port publisher and
client with a JAX ``serve_host`` process, a JAX publisher and client
with a port one), a port host restarted in place from its ``arc.bin``
with no re-ship, the shard-published cut, and the observability
sections."""

from __future__ import annotations

import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from byteps_tpu.common.telemetry import counters as jcounters
from byteps_tpu.server import serving_tier as jst
from byteps_tpu.server.kv_store import KVStore as JKVStore
from byteps_tpu.server.serve_autoscaler import TierAutoscaler as JAutoscaler
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.fault import injector as inj
from byteps_tpu_torch.server import serving_tier as pst
from byteps_tpu_torch.server.kv_store import KVStore
from byteps_tpu_torch.server.serve_autoscaler import TierAutoscaler
from byteps_tpu_torch.server.serving import ServeUnavailable
from byteps_tpu_torch.server.serving_tier import (AdmissionControl,
                                                  ServingHostCore,
                                                  ServingTier,
                                                  TierDirectory, inproc_host)

from .torch_fault_common import (REPO, child_env,  # noqa: F401
                                 fresh_fault_state)

KEYS = [f"t{i}" for i in range(12)]
ONEBIT = {"compressor": "onebit"}


def _store(keys, numel=8, jax=False):
    s = JKVStore() if jax else KVStore(device="cpu")
    for i, k in enumerate(keys):
        s.init_key(k, np.full(numel, float(i), np.float32))
    return s


def _core(host_id, **kw):
    return ServingHostCore(host_id=host_id, device="cpu", **kw)


def _inproc_tier(n_hosts=3, keys=(), replicas=2, **kw):
    d = TierDirectory(static_hosts={i: ("127.0.0.1", i + 1)
                                    for i in range(n_hosts)})
    cores = [inproc_host(_core(i)) for i in range(n_hosts)]
    store = _store(keys)
    tier = ServingTier(store, directory=d, replicas=replicas,
                       cut_interval_s=None, **kw)
    return store, tier, cores


def _stage(core, key, value, version):
    core.receive_key(key, np.asarray(value, np.float32),
                     {"version": version, "codec": None})


# -- admission control --------------------------------------------------------


def test_admission_equals_the_jax_admission_on_one_clock(monkeypatch):
    """The token bucket and the queue watermark decide as the JAX ones
    on the same sequence of calls and the same (faked) clock."""
    clock = [100.0]
    fake = types.SimpleNamespace(monotonic=lambda: clock[0])
    monkeypatch.setattr(pst, "time", fake)
    monkeypatch.setattr(jst, "time", fake)
    acs = (AdmissionControl(rate=10.0, burst=2.0, queue_high=3),
           jst.AdmissionControl(rate=10.0, burst=2.0, queue_high=3))
    trace = []
    for step in range(40):
        clock[0] += (0.03, 0.0, 0.11, 0.2)[step % 4]
        if step % 7 == 3:
            for ac in acs:
                ac.enter()
        if step % 11 == 5:
            for ac in acs:
                ac.exit()
        got = [ac.admit() for ac in acs]
        assert got[0] == got[1], step
        trace.append(got[0])
        assert acs[0].snapshot() == acs[1].snapshot()
    assert True in trace and False in trace


# -- the host core -------------------------------------------------------------


def test_host_stage_commit_publish_and_carry_forward():
    core = _core(5)
    _stage(core, "a", [1.0], 1)
    _stage(core, "b", [2.0], 1)
    out = core.commit({"snapshot_id": 1, "gen": 0,
                       "versions": {"a": 1, "b": 1}})
    assert out["keys"] == 2 and out["missing"] == 0
    r = core.pull()
    assert r.full and set(r.items) == {"a", "b"}
    _stage(core, "a", [9.0], 2)
    core.commit({"snapshot_id": 2, "gen": 0, "versions": {"a": 2, "b": 1}})
    r2 = core.pull(since_id=r.snapshot_id)
    assert not r2.full and set(r2.items) == {"a"}
    assert float(np.asarray(r2.items["a"].payload)[0]) == 9.0
    assert core.commit({"snapshot_id": 2, "gen": 0,
                        "versions": {"a": 2, "b": 1}}).get("dup") is True
    c0 = counters.get("serve.tier_missing_keys")
    out = core.commit({"snapshot_id": 3, "gen": 0,
                       "versions": {"a": 2, "ghost": 3}})
    assert out["missing"] == 1 and out["dropped"] == ["ghost"]
    assert counters.get("serve.tier_missing_keys") == c0 + 1


def test_host_sheds_only_inside_the_clients_bound():
    core = _core(0)
    _stage(core, "a", [1.0], 1)
    core.commit({"snapshot_id": 1, "gen": 0, "versions": {"a": 1}})
    base = core.pull().snapshot_id
    _stage(core, "a", [2.0], 2)
    core.commit({"snapshot_id": 2, "gen": 0, "versions": {"a": 2}})
    core.admission = AdmissionControl(rate=1e-9, burst=1e-9,
                                      queue_high=1000)
    r = core.pull(since_id=base, max_stale_s=60.0)
    assert r.shed and not r.items and r.snapshot_id == base
    r2 = core.pull(since_id=base, max_stale_s=0.0)
    assert not r2.shed and set(r2.items) == {"a"}
    assert counters.get("serve.shed") == 1
    assert counters.get("serve.shed_bypass") == 1
    assert not core.pull(max_stale_s=60.0).shed


def test_host_decodes_a_shipped_onebit_key_on_its_device():
    """A codec key ships as its frame; the host decodes it at receipt
    (on its device: the unpack kernel on a card) to the CPU chain's
    ``decompress(compress(value))``, keeps the frame, and serves the
    frame unchanged."""
    from byteps_tpu_torch.compression import registry as preg
    from byteps_tpu_torch.server.serving import encode_value
    n = 4096
    v = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    comp = preg.create(ONEBIT, n, torch.float32, for_server=True)
    wire = encode_value(comp, v, torch.device("cpu"))
    core = _core(1)
    core.receive_key("g", wire, {"version": 4,
                                 "codec": (ONEBIT, n, "<f4")})
    core.commit({"snapshot_id": 1, "gen": 0, "versions": {"g": 4}})
    snap = core.ring.latest()
    want = comp.decompress(comp.wire_decode(wire)).numpy()
    assert snap.refs["g"].tobytes() == want.tobytes()
    assert not snap.refs["g"].flags.writeable
    item = core.pull().items["g"]
    assert bytes(item.payload) == wire and item.codec == (ONEBIT, n, "<f4")


# -- the publisher -------------------------------------------------------------


def test_tier_ships_what_the_jax_tier_ships():
    """The same store, hosts and pushes through the port's publisher and
    the JAX one (in-process hosts): every host commits the same keys at
    the same versions, only owned keys, and a one-key change ships that
    key once per replica holder."""
    tiers = {}
    for who, mod, jax in (("port", pst, False), ("jax", jst, True)):
        d = mod.TierDirectory(static_hosts={i: ("127.0.0.1", i + 1)
                                            for i in range(3)})
        cores = [mod.inproc_host(_core(i) if who == "port" else
                                 mod.ServingHostCore(host_id=i))
                 for i in range(3)]
        store = _store(KEYS, jax=jax)
        tiers[who] = (store, mod.ServingTier(store, directory=d,
                                             replicas=2,
                                             cut_interval_s=None), cores)
    recv = {}
    for rnd in range(3):
        for who, (store, tier, cores) in tiers.items():
            if rnd:
                store.push_delta(KEYS[rnd], np.ones(8, np.float32))
            cnt = counters if who == "port" else jcounters
            r0 = cnt.get("serve.tier_recv_keys")
            tier.cut()
            recv[who] = cnt.get("serve.tier_recv_keys") - r0
        assert recv["port"] == recv["jax"] == (2 * len(KEYS) if rnd == 0
                                               else 2)
        for pc, jc in zip(tiers["port"][2], tiers["jax"][2]):
            assert pc.ring.latest().versions == jc.ring.latest().versions
            for k, a in pc.ring.latest().refs.items():
                assert a.tobytes() == \
                    np.asarray(jc.ring.latest().refs[k]).tobytes()
    for k in KEYS:
        owners = set(tiers["port"][1].ring.replica_hosts(k, 2))
        holders = {c.host_id for c in tiers["port"][2]
                   if k in c.ring.latest().versions}
        assert holders == owners
    for _, tier, _ in tiers.values():
        tier.close()


def test_tier_onebit_key_ships_encoded_and_the_client_decodes_it():
    n = 4096
    store = _store(["c0", "raw"], numel=n)
    store.register_compression("c0", ONEBIT, n)
    d = TierDirectory(static_hosts={0: ("127.0.0.1", 1)})
    inproc_host(_core(0))
    tier = ServingTier(store, directory=d, replicas=1, cut_interval_s=None)
    store.push_delta("c0", np.random.default_rng(4).standard_normal(n)
                     .astype(np.float32))
    b0 = counters.get("serve.tier_recv_bytes")
    snap = tier.cut()
    wire = counters.get("serve.tier_recv_bytes") - b0 - n * 4
    assert 0 < wire < n * 4
    client = tier.client(max_staleness_s=0.0, device="cpu")
    vals = client.pull(["c0"])
    from byteps_tpu_torch.compression import registry as preg
    comp = preg.create(ONEBIT, n, torch.float32, for_server=True)
    want = comp.decompress(comp.compress(
        torch.from_numpy(np.array(snap.refs["c0"])),
        comp.init_state(torch.device("cpu")))[0])
    assert torch.equal(vals["c0"], want)
    # the whole-model hydration: the onebit frame and the raw key
    assert client.bytes_received == wire + n * 4
    client.close()
    tier.close()


def test_a_cut_encodes_each_codec_key_once_for_every_host(monkeypatch):
    """The per-host ship threads share one encode of each codec key (the
    JAX publisher's threads may each encode it)."""
    n = 4096
    keys = [f"c{i}" for i in range(6)]
    store = _store(keys, numel=n)
    for k in keys:
        store.register_compression(k, ONEBIT, n)
    d = TierDirectory(static_hosts={i: ("127.0.0.1", i + 1)
                                    for i in range(3)})
    cores = [inproc_host(_core(i)) for i in range(3)]
    tier = ServingTier(store, directory=d, replicas=3, cut_interval_s=None)
    calls = []
    real = pst.encode_value
    monkeypatch.setattr(pst, "encode_value",
                        lambda *a: calls.append(1) or real(*a))
    snap = tier.cut()
    assert len(calls) == len(keys)
    for c in cores:
        for k in keys:
            assert c.ring.latest().enc_cache[k] == snap.enc_cache[k]
    tier.close()


class _FailingEndpoint:
    def serve_ctl(self, **kw):
        raise ServeUnavailable("dead host")

    def serve_cut(self, *a, **kw):
        raise ServeUnavailable("dead host")

    def serve_commit(self, *a, **kw):
        raise ServeUnavailable("dead host")

    def close(self, drain=True):
        pass


def test_tier_retires_a_host_after_failed_ships_and_reads_survive():
    store, tier, cores = _inproc_tier(3, KEYS[:6], replicas=2,
                                      fail_streak=2)
    tier.cut()
    with tier._lock:
        tier._eps[1] = _FailingEndpoint()
    store.push_delta(KEYS[0], np.ones(8, np.float32))
    tier.cut()
    assert 1 in tier.ring.hosts()
    store.push_delta(KEYS[1], np.ones(8, np.float32))
    tier.cut()
    assert 1 not in tier.ring.hosts()
    assert counters.get("serve.tier_retired") >= 1
    client = tier.client(max_staleness_s=0.0, device="cpu")
    assert set(client.pull()) == set(KEYS[:6])
    client.close()
    tier.close()


def test_restarted_host_gets_its_holes_reshipped_next_cut():
    store, tier, cores = _inproc_tier(2, KEYS[:6], replicas=1)
    tier.cut()
    fresh = inproc_host(_core(0))
    with tier._lock:
        tier._eps.pop(0, None)
    owned0 = [k for k in KEYS[:6] if tier.ring.owner(k) == 0]
    assert owned0
    store.push_delta(KEYS[0], np.ones(8, np.float32))
    m0 = counters.get("serve.tier_missing_keys")
    tier.cut()
    assert counters.get("serve.tier_missing_keys") > m0
    tier.cut()
    assert set(owned0) <= set(fresh.ring.latest().versions)
    client = tier.client(max_staleness_s=0.0, device="cpu")
    assert set(client.pull(owned0)) == set(owned0)
    client.close()
    tier.close()


def test_router_fails_over_along_the_replica_arc():
    store, tier, cores = _inproc_tier(3, KEYS[:8], replicas=2)
    tier.cut()
    client = tier.client(max_staleness_s=0.0, device="cpu")
    assert set(client.pull()) == set(KEYS[:8])
    cores[1].server.kill()
    f0 = counters.get("serve.tier_failover")
    vals = client.pull()
    assert set(vals) == set(KEYS[:8])
    assert counters.get("serve.tier_failover") > f0
    for i, k in enumerate(KEYS[:8]):
        assert vals[k][0].item() == float(i)
    client.close()
    tier.close()


# -- the autoscaler --------------------------------------------------------------


def _sig(hosts, *, shed=0.0, pulls=0.0, slow=(), share=None, warm=True):
    return {"hosts": list(hosts), "gen": 1, "warm": warm,
            "rates": {h: {"pulls_per_s": pulls / max(len(hosts), 1),
                          "shed_per_s": 0.0} for h in hosts},
            "pulls_per_s": pulls, "shed_per_s": shed,
            "slow": {h: (9.0 if h in slow else 0.0) for h in hosts},
            "phi_threshold": 8.0,
            "arc_share": share or {h: 1.0 / max(len(hosts), 1)
                                   for h in hosts},
            "hot_keys": ["hk0", "hk1", "hk2"]}


_SIGNALS = [
    _sig([0, 1, 2], shed=3.0, pulls=500.0),
    _sig([0, 1, 2], pulls=30.0, share={0: 0.5, 1: 0.2, 2: 0.3}),
    _sig([0, 1, 2], pulls=30.0, slow=(2,)),
    _sig([0, 1, 2], pulls=1000.0),
    _sig([0, 1, 2, 3], shed=5.0, pulls=500.0),
    _sig([], pulls=0.0),
    _sig([0, 4], pulls=10.0, warm=False),
    _sig([3], pulls=5.0, slow=(3,)),
]


@pytest.mark.parametrize("i", range(len(_SIGNALS)))
def test_autoscaler_decide_equals_the_jax_one(i):
    """``decide`` is a pure function of its signals, equal to the JAX
    autoscaler's: action, target, victims, probation, placement."""
    store, tier, _ = _inproc_tier(3, KEYS[:4], replicas=2)
    jd = jst.TierDirectory(static_hosts={h: ("127.0.0.1", h + 1)
                                         for h in range(3)})
    jtier = jst.ServingTier(_store(KEYS[:4], jax=True), directory=jd,
                            replicas=2, cut_interval_s=None)
    kw = dict(min_hosts=1, max_hosts=4, cooldown_s=0.0,
              low_pulls_per_s=50.0)
    got = TierAutoscaler(tier, **kw).decide(_SIGNALS[i])
    want = JAutoscaler(jtier, **kw).decide(_SIGNALS[i])
    assert vars(got) == vars(want)
    tier.close()
    jtier.close()


def test_autoscaler_step_holds_when_cold_then_retires():
    store, tier, cores = _inproc_tier(3, KEYS[:6], replicas=2)
    tier.cut()
    asc = TierAutoscaler(tier, min_hosts=1, max_hosts=4, cooldown_s=0.0,
                         low_pulls_per_s=50.0)
    first = asc.step(force=True)
    assert first.action == "hold" and "warming" in first.reason
    decision = asc.step(force=True)
    assert decision.action == "down"
    assert len(tier.ring.hosts()) == 2 and tier.directory.target() == 2
    tier.cut()
    client = tier.client(max_staleness_s=0.0, device="cpu")
    assert set(client.pull()) == set(KEYS[:6])
    client.close()
    tier.close()


# -- serving-host processes, across the packages ---------------------------------


def _spawn_host(pkg, host_id, durable_dir=None, spec=""):
    env = child_env(BYTEPS_SERVE_HOST_ID=host_id,
                    BYTEPS_SERVE_HOST_BIND="127.0.0.1:0")
    env.pop("BYTEPS_SERVE_TIER_BUS", None)
    env.pop("BYTEPS_DURABLE_DIR", None)
    if durable_dir:
        env["BYTEPS_DURABLE_DIR"] = str(durable_dir)
    if spec:
        env["BYTEPS_FAULT_SPEC"] = spec
    cmd = [sys.executable, "-m", f"{pkg}.server.serve_host"]
    if pkg == "byteps_tpu_torch":
        cmd += ["--device", "cpu"]
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _host_up(proc):
    """The host's ``HOST-UP <id> <host> <port>`` line (after any
    ``HOST-RESTORED``), and the lines before it."""
    seen = []
    while True:
        line = proc.stdout.readline()
        assert line, "".join(seen)
        seen.append(line)
        if line.startswith("HOST-UP"):
            _, hid, host, port = line.split()
            threading.Thread(target=proc.stdout.read, daemon=True).start()
            return int(hid), (host, int(port)), seen


def _stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("publisher,host", [("port", "byteps_tpu"),
                                            ("jax", "byteps_tpu_torch")])
def test_mixed_fleet_publisher_host_and_client(publisher, host):
    """A port publisher and port client with a JAX ``serve_host``
    process, and a JAX publisher and JAX client with a port one: cuts
    ship over TCP (raw and onebit keys), and each client reads what the
    other package's in-process decode gives."""
    n = 4096
    proc = _spawn_host(host, 0)
    try:
        hid, addr, _ = _host_up(proc)
        mod = pst if publisher == "port" else jst
        d = mod.TierDirectory(static_hosts={hid: addr})
        store = _store(["r", "g"], numel=n, jax=publisher == "jax")
        store.register_compression("g", ONEBIT, n)
        rng = np.random.default_rng(31)
        for k in ("r", "g"):
            store.push_delta(k, rng.standard_normal(n).astype(np.float32))
        # a JAX host compiles its decode at the first onebit ship: the
        # deadline leaves room for that on a loaded host
        tier = mod.ServingTier(store, directory=d, replicas=1,
                               cut_interval_s=None, ship_deadline_s=60.0)
        snap = tier.cut()
        kw = {"device": "cpu"} if publisher == "port" else {}
        client = tier.client(max_staleness_s=0.0, **kw)
        vals = {k: (v.numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in client.pull().items()}
        assert vals["r"].tobytes() == np.asarray(snap.refs["r"]).tobytes()
        comp = snap.codecs["g"][1]
        want = np.asarray(comp.decompress(comp.wire_decode(
            snap.enc_cache["g"])))
        assert vals["g"].tobytes() == np.asarray(want).reshape(-1).tobytes()
        # a delta: only the changed key travels
        b0 = client.bytes_received
        store.push_delta("r", np.ones(n, np.float32))
        tier.cut()
        client.pull()
        assert client.bytes_received - b0 == n * 4
        client.close()
        tier.close()
    finally:
        _stop(proc)


def test_port_host_restarts_in_place_from_its_arc(tmp_path):
    """A port ``serve_host`` with a durable dir persists each committed
    cut to ``serve-<id>/arc.bin`` (readable by the JAX host's loader);
    restarted, it prints ``HOST-RESTORED`` and the publisher's probe
    finds every key in place: nothing is re-shipped."""
    keys = [f"k{i}" for i in range(6)]
    proc = _spawn_host("byteps_tpu_torch", 0, durable_dir=tmp_path)
    proc2 = None
    try:
        hid, addr, _ = _host_up(proc)
        d = TierDirectory(static_hosts={hid: addr})
        store = _store(keys, numel=64)
        store.register_compression("k0", ONEBIT, 64)
        tier = ServingTier(store, directory=d, replicas=1,
                           cut_interval_s=None)
        store.push_delta("k1", np.ones(64, np.float32))
        tier.cut()
        arc = tmp_path / "serve-0" / "arc.bin"
        assert arc.exists()
        jcore = jst.ServingHostCore(host_id=0, durable_dir=str(tmp_path))
        assert jcore.restored_commit == 1
        _stop(proc)
        proc2 = _spawn_host("byteps_tpu_torch", 0, durable_dir=tmp_path)
        hid2, addr2, before = _host_up(proc2)
        assert any(ln.startswith("HOST-RESTORED 0 1") for ln in before), \
            before
        d.register(addr2, host_id=0)
        s0 = counters.get("serve.tier_ship_bytes")
        h0 = counters.get("wal.arc_probe_hits")
        tier.cut()
        assert counters.get("wal.arc_probe_hits") == h0 + 1
        assert counters.get("serve.tier_ship_bytes") == s0
        client = tier.client(max_staleness_s=0.0, device="cpu")
        vals = client.pull()
        assert vals["k1"][0].item() == 2.0 and set(vals) == set(keys)
        client.close()
        tier.close()
    finally:
        _stop(proc)
        if proc2 is not None:
            _stop(proc2)


@pytest.mark.chaos
def test_kill_site_serve_host_counts_answered_pulls():
    killed = []
    inj.arm("kill:step=2:site=serve_host", rank=0)
    orig = inj._exit
    inj._exit = lambda code: killed.append(code)
    try:
        core = _core(0)
        _stage(core, "a", [1.0], 1)
        core.commit({"snapshot_id": 1, "gen": 0, "versions": {"a": 1}})
        inj.on_step()
        core.pull()
        assert not killed
        core.pull()
        assert killed
    finally:
        inj._exit = orig
        inj.disarm()


# -- the shard-published cut and the observability sections -------------------


def test_shard_published_cut_reassembles_the_slot(monkeypatch):
    """Under the sharded update the tier publishes each slot's blocks
    from ``export_shards`` (``name@shard<i>`` and the manifest), and
    ``assemble_shard_keys`` rebuilds the slot's parameters exactly."""
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core import api
    api.init(Config(sharded_update=True), device="cpu")
    try:
        api.declare_update("w", (3, 5), torch.float32,
                           optimizer=(torch.optim.SGD, {"lr": 0.1}),
                           init_value=torch.arange(15.0).reshape(3, 5))
        api.push_pull_update(torch.ones(3, 5), "w")
        slot = api.engine().update_slots["w"]
        store = KVStore(device="cpu")
        d = TierDirectory(static_hosts={0: ("127.0.0.1", 1)})
        inproc_host(_core(0))
        tier = ServingTier(store, directory=d, replicas=1,
                           cut_interval_s=None)
        tier.cut()
        assert counters.get("serve.shard_publishes") == 1
        got = pst.assemble_shard_keys(lambda k: store.pull(k).numpy(), "w")
        np.testing.assert_array_equal(got, slot.params().numpy())
        tier.cut()
        assert counters.get("serve.shard_publishes") == 1   # unchanged
        tier.close()
    finally:
        api.shutdown()


def test_debug_state_and_healthz_serving_sections():
    from byteps_tpu_torch.common import obs_server
    store, tier, cores = _inproc_tier(2, KEYS[:4], replicas=1)
    tier.cut()
    client = tier.client(max_staleness_s=0.0, device="cpu")
    client.pull()
    dbg = obs_server.debug_state()
    hosts = [s for s in dbg["serving_tier"] if s["kind"] == "serving_host"
             and s["host_id"] in (0, 1) and s["snapshot_id"] == 1]
    assert len(hosts) >= 2
    pub = tier.debug_state()
    assert pub in dbg["serving_tier"]
    assert pub["hosts"] == [0, 1] and pub["snapshot_id"] == 1
    health = obs_server.healthz()
    assert {"kind": "serving_tier", "snapshot_id": 1} in health["serving"]
    client.close()
    tier.close()
