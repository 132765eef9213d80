"""The port's supervised TCP transport (``byteps_tpu_torch/comm/
transport.py``): the JAX package's cases (``tests/test_transport.py``
but the two serving pulls; ``tests/test_transport_chaos.py``'s bitflip
and conn_reset lanes at 3 processes), frames byte for byte the JAX
package's, a port endpoint against a JAX server and a JAX endpoint
against a port server (stored values, versions and dedup counters equal
to a run within one package), the serving ops answered as the JAX server
answers them with nothing attached, and onebit wire pushes into a store
that decodes them.  Every test that opens sockets checks that the
thread count comes back."""

from __future__ import annotations

import hashlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from byteps_tpu.comm import transport as jtp
from byteps_tpu.common import config as jcfg
from byteps_tpu.common.telemetry import counters as jcounters
from byteps_tpu.server.kv_store import KVStore as JKVStore
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common import integrity
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.common.telemetry import counters, gauges
from byteps_tpu_torch.comm import transport as tp
from byteps_tpu_torch.compression import registry
from byteps_tpu_torch.fault import injector as inj
from byteps_tpu_torch.server.engine import ServerEngine
from byteps_tpu_torch.server.kv_store import KVStore

from .torch_fault_common import (REPO, child_env, free_port,  # noqa: F401
                                 fresh_fault_state, thread_count)

WORKER = os.path.join(REPO, "tests", "torch_fault_worker.py")
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}


@pytest.fixture(autouse=True)
def _sockets_close(thread_count):
    """Every test here opens sockets: its threads must end with it."""
    yield


def _kv_server(**kw):
    kv = KVStore(device="cpu")
    kv.init_key("k", np.zeros(8, np.float32))
    srv = tp.TransportServer(rank=0, kv=kv, **kw)
    return kv, srv


def _engine():
    return ServerEngine(num_threads=1, device="cpu")


class _FakeSock:
    def __init__(self, data):
        self._b = io.BytesIO(data)

    def recv(self, n):
        return self._b.read(n)


# --- framing ----------------------------------------------------------------


def test_frame_roundtrip():
    raw = tp._pack_frame(tp.OP_PUSH, 7, {"hop": "kv"}, b"payload")
    op, rid, meta, payload = tp._read_frame(_FakeSock(raw))
    assert (op, rid, meta, payload) == (tp.OP_PUSH, 7, {"hop": "kv"},
                                        b"payload")


def test_frame_clamp_and_bad_magic():
    pcfg.set_config(Config(bus_max_frame=1024))
    big = tp._HEADER.pack(tp.MAGIC, tp.VERSION, tp.OP_PUSH, 1, 0, 1 << 40)
    with pytest.raises(tp.TransportError, match="BYTEPS_BUS_MAX_FRAME"):
        tp._read_frame(_FakeSock(big))
    # the sender clamps too
    with pytest.raises(tp.TransportError, match="BYTEPS_BUS_MAX_FRAME"):
        tp._pack_frame(tp.OP_PUSH, 1, {}, bytes(2048))
    pcfg.reset_config()
    bad = b"NOPE" + bytes(tp._HEADER.size - 4)
    with pytest.raises(tp.TransportError, match="BPST"):
        tp._read_frame(_FakeSock(bad))


def _frames():
    frame = integrity.seal_array(np.arange(5, dtype=np.float32), key="w",
                                 seq=3, worker=1)
    return [
        (tp.OP_HELLO, 0, {"rank": 1, "peer": 0}, b""),
        (tp.OP_PUSH, 9, {"hop": "kv", "mepoch": None}, frame),
        (tp.OP_PUSH, 2**40, {"hop": "server_push", "num_workers": 3,
                             "mepoch": 2}, frame),
        (tp.OP_KV_PULL, 5, {"key": "layer.0.weight"}, b""),
        (tp.OP_SERVER_PULL, 6, {"key": "g", "timeout": 10.0}, b""),
        (tp.OP_ACK, 9, {"version": 12, "dup": True}, b""),
        (tp.OP_NACK, 9, {"error": "CRC32C mismatch"}, b""),
        (tp.OP_ERR, 4, {"kind": "KeyError", "error": "'k'"}, b""),
        (tp.OP_REPLY, 5, {"version": 1}, frame),
        (tp.OP_KEEPALIVE, 8, {}, b""),
        (tp.OP_STATE, 1, None, b""),
    ]


@pytest.mark.parametrize("idx", range(11))
def test_frames_equal_the_jax_package(idx):
    op, rid, meta, payload = _frames()[idx]
    mine = tp._pack_frame(op, rid, meta, payload)
    assert mine == jtp._pack_frame(op, rid, meta, payload)
    # and each package reads the other's frame
    assert jtp._read_frame(_FakeSock(mine)) == tp._read_frame(
        _FakeSock(mine))


def test_op_codes_equal_the_jax_package():
    names = [n for n in dir(jtp) if n.startswith("OP_")]
    assert names and {n: getattr(tp, n) for n in names} == \
        {n: getattr(jtp, n) for n in names}
    assert (tp.MAGIC, tp.VERSION, tp._HEADER.format) == \
        (jtp.MAGIC, jtp.VERSION, jtp._HEADER.format)


# --- config / addressing ----------------------------------------------------


@pytest.mark.parametrize("kw,needle", [
    (dict(transport_port_base=70000), "transport_port_base"),
    (dict(transport_connect_timeout_s=0), "transport_connect_timeout_s"),
    (dict(transport_send_deadline_s=0), "transport_send_deadline_s"),
    (dict(transport_keepalive_s=-1), "transport_keepalive_s"),
    (dict(transport_max_inflight=0), "transport_max_inflight"),
    (dict(bus_max_frame=0), "bus_max_frame"),
])
def test_config_validation(kw, needle):
    with pytest.raises(ValueError, match=needle):
        Config(**kw)


def test_config_knobs_read_the_jax_names(monkeypatch):
    env = {"BYTEPS_TRANSPORT_HOSTS": "a,b:7", "BYTEPS_TRANSPORT_PORT_BASE":
           "9100", "BYTEPS_TRANSPORT_CONNECT_TIMEOUT": "2.5",
           "BYTEPS_TRANSPORT_SEND_DEADLINE": "3.5",
           "BYTEPS_TRANSPORT_KEEPALIVE": "0", "BYTEPS_TRANSPORT_MAX_INFLIGHT":
           "4096", "BYTEPS_BUS_MAX_FRAME": "65536"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, ref = Config.from_env(), jcfg.Config.from_env()
    for f in ("transport_hosts", "transport_port_base",
              "transport_connect_timeout_s", "transport_send_deadline_s",
              "transport_keepalive_s", "transport_max_inflight",
              "bus_max_frame"):
        assert getattr(mine, f) == getattr(ref, f), f
    defaults, jdefaults = Config(), jcfg.Config()
    for f in ("transport_connect_timeout_s", "transport_send_deadline_s",
              "transport_keepalive_s", "transport_max_inflight",
              "bus_max_frame", "heartbeat_interval_s", "heartbeat_timeout_s",
              "failure_exit_code", "sync_deadline_s", "slowness_phi",
              "slowness_window", "heartbeat_on"):
        assert getattr(defaults, f) == getattr(jdefaults, f), f


def test_transport_addr_resolution(monkeypatch):
    monkeypatch.setenv("BYTEPS_TRANSPORT_HOSTS",
                       "10.0.0.1:7000, 10.0.0.2, 10.0.0.3:7002")
    monkeypatch.setenv("BYTEPS_TRANSPORT_PORT_BASE", "9100")
    pcfg.reset_config()
    assert tp.transport_addr(0) == ("10.0.0.1", 7000)
    assert tp.transport_addr(1) == ("10.0.0.2", 9101)
    assert tp.transport_addr(2) == ("10.0.0.3", 7002)
    assert tp.transport_addr(5) == ("127.0.0.1", 9105)
    monkeypatch.delenv("BYTEPS_TRANSPORT_PORT_BASE")
    pcfg.reset_config()
    with pytest.raises(ValueError, match="BYTEPS_TRANSPORT_PORT_BASE"):
        tp.transport_addr(1)
    monkeypatch.delenv("BYTEPS_TRANSPORT_HOSTS")
    pcfg.reset_config()
    with pytest.raises(ValueError, match="BYTEPS_TRANSPORT_HOSTS"):
        tp.transport_addr(0)


# --- the data-plane hops over the wire --------------------------------------


def test_server_push_and_pull_over_tcp():
    eng = _engine()
    srv = tp.TransportServer(rank=0, engine=eng)
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    try:
        ep.push("g", np.full(16, 1.5, np.float32), 0, 2)
        ep.push("g", torch.full((16,), 2.0), 1, 2)   # a tensor, sealed too
        out, version = ep.pull_versioned("g", timeout=10)
        assert isinstance(out, np.ndarray)
        assert np.all(out == np.float32(3.5)) and version == 1
        assert counters.get("transport.connects") >= 1
    finally:
        ep.close()
        srv.close()
        eng.shutdown()


def _onebit_wire(values, numel=64):
    comp = registry.create(ONEBIT_EF, numel, torch.float32)
    payload, _ = comp.compress(torch.as_tensor(values),
                               comp.init_state("cpu"))
    return comp.wire_encode(payload)


def test_compressed_push_over_tcp():
    eng = _engine()
    eng.register_compression("c", ONEBIT_EF, 64)
    wire = _onebit_wire(np.linspace(-1, 1, 64, dtype=np.float32))
    srv = tp.TransportServer(rank=0, engine=eng)
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    local = _engine()
    local.register_compression("c", ONEBIT_EF, 64)
    try:
        ep.push_compressed("c", wire, 0, 1)
        out = ep.pull("c", timeout=10)
        local.push_compressed("c", wire, 0, 1)
        want = local.pull("c", timeout=10)
        assert out.shape == (64,) and np.isfinite(out).all()
        np.testing.assert_array_equal(out, want.numpy())
    finally:
        ep.close()
        srv.close()
        eng.shutdown()
        local.shutdown()


def test_onebit_push_delta_wire_decodes_like_a_local_push():
    """The store decodes a wire frame that crossed TCP on its own device
    (here the CPU; the card's case is in test_torch_cuda.py) to the bits
    a local ``push_delta_wire`` of the same frame lands."""
    kv, srv = _kv_server()
    local = KVStore(device="cpu")
    for store in (kv, local):
        store.init_key("c", np.zeros(64, np.float32))
        store.register_compression("c", ONEBIT_EF, 64)
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    rng = np.random.RandomState(5)
    try:
        for seq in (1, 2, 3):
            wire = _onebit_wire(rng.randn(64).astype(np.float32))
            v = ep.push_delta_wire("c", wire, worker_id=1, seq=seq)
            assert v == local.push_delta_wire("c", wire, worker_id=1,
                                              seq=seq) == seq
        assert ep.push_delta_wire("c", wire, worker_id=1, seq=3) == 3
        assert torch.equal(kv.pull("c"), local.pull("c"))
        assert kv.wire_bytes == local.wire_bytes
        assert kv.wire_bytes_wasted == len(wire)
    finally:
        ep.close()
        srv.close()


def test_loopback_endpoint_same_interface():
    eng = _engine()
    kv = KVStore(device="cpu")
    kv.init_key("k", np.zeros(4, np.float32))
    ep = tp.LoopbackEndpoint(engine=eng, kv=kv)
    ep.push("g", np.ones(4, np.float32), 0, 1)
    assert np.all(ep.pull("g", timeout=10).numpy() == 1.0)
    assert ep.push_delta("k", np.ones(4, np.float32), seq=1) == 1
    val, ver = ep.kv_pull("k")
    assert np.all(val.numpy() == 1.0) and ver == 1
    eng.shutdown()


def test_kv_delta_seq_dedup_over_wire():
    kv, srv = _kv_server()
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    try:
        before = counters.get("integrity.dup_dropped")
        assert ep.push_delta("k", np.ones(8, np.float32), seq=5) == 1
        assert ep.push_delta("k", np.ones(8, np.float32), seq=5) == 1
        assert counters.get("integrity.dup_dropped") == before + 1
        assert float(kv.pull("k")[0]) == 1.0
    finally:
        ep.close()
        srv.close()


def test_server_push_wire_level_dedup():
    eng = _engine()
    srv = tp.TransportServer(rank=0, engine=eng)
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    try:
        frame = integrity.seal_array(np.full(4, 2.0, np.float32), key="g",
                                     seq=1, worker=0)
        meta = {"hop": "server_push", "num_workers": 2, "mepoch": None}
        rop, rmeta, _ = ep.connection.request(tp.OP_PUSH, dict(meta), frame)
        assert rop == tp.OP_ACK and not rmeta.get("dup")
        rop, rmeta, _ = ep.connection.request(tp.OP_PUSH, dict(meta), frame)
        assert rop == tp.OP_ACK and rmeta.get("dup")
        ep.push("g", np.full(4, 3.0, np.float32), 1, 2)
        assert np.all(ep.pull("g", timeout=10) == np.float32(5.0))
    finally:
        ep.close()
        srv.close()
        eng.shutdown()


def test_mepoch_gate_over_wire():
    eng = _engine()
    eng.set_membership_epoch(3)
    srv = tp.TransportServer(rank=0, engine=eng)
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    try:
        before = counters.get("membership.stale_pushes_dropped")
        ep.push("g", np.ones(4, np.float32), 0, 1, mepoch=2)  # stale
        assert counters.get("membership.stale_pushes_dropped") == before + 1
        ep.push("g", np.full(4, 7.0, np.float32), 0, 1, mepoch=3)
        assert np.all(ep.pull("g", timeout=10) == 7.0)
    finally:
        ep.close()
        srv.close()
        eng.shutdown()


def test_rejoin_state_over_wire_and_corruption_refused():
    from byteps_tpu_torch.utils.checkpoint import pack_state
    state = {"w": np.arange(16, dtype=np.float32), "step": 7}
    blob = pack_state(state)
    corrupt = bytearray(blob)
    corrupt[len(corrupt) // 2] ^= 0x10
    provider = {"blob": blob}
    srv = tp.TransportServer(rank=0,
                             state_provider=lambda: provider["blob"])
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    try:
        got = ep.pull_state()
        assert np.all(got["w"] == state["w"]) and got["step"] == 7
        provider["blob"] = bytes(corrupt)
        with pytest.raises(integrity.IntegrityError):
            ep.pull_state()
    finally:
        ep.close()
        srv.close()


def test_serving_ops_answered_as_the_jax_server_with_none_attached():
    """OP_SERVE_PULL and the serving-tier hops keep their codes; with no
    serving endpoint or tier attached (the port has neither yet) the
    port server answers exactly as the JAX server does."""
    kv, srv = _kv_server()
    jsrv = jtp.TransportServer(rank=0, kv=JKVStore())
    answers = []
    try:
        for addr in (srv.addr, jsrv.addr):
            ep = tp.TcpEndpoint(addr, peer=0)
            got = [ep.connection.request(tp.OP_SERVE_PULL,
                                         {"since_id": None, "keys": None,
                                          "max_stale_s": None})[:2]]
            for hop in ("serve_cut", "serve_commit", "serve_ctl"):
                frame = (integrity.seal_array(np.ones(2, np.float32),
                                              key="s", seq=1)
                         if hop == "serve_cut" else
                         integrity.seal_bytes(b"", key="s", seq=1))
                got.append(ep.connection.request(
                    tp.OP_PUSH, {"hop": hop, "codec": None}, frame)[:2])
            answers.append(got)
            ep.close()
    finally:
        srv.close()
        jsrv.close()
    assert answers[0] == answers[1]
    assert answers[0][0] == (tp.OP_ERR, {
        "kind": "TransportRemoteError",
        "error": "TransportRemoteError('no serving endpoint attached')"})
    assert all("no serving tier attached" in a[1]["error"]
               for a in answers[0][1:])


# --- NACK / retransmit over the real wire -----------------------------------


def test_nack_retransmit_from_source_copy(monkeypatch):
    eng = _engine()
    srv = tp.TransportServer(rank=0, engine=eng)
    inj.arm("drop:site=heartbeat:p=0.001", rank=0)
    flips = {"n": 0}
    real = inj.corrupt_bytes

    def flip_once(site, data):
        if site == "server_push" and flips["n"] == 0:
            flips["n"] += 1
            b = bytearray(data)
            b[len(b) // 2] ^= 0x01
            return bytes(b)
        return real(site, data)

    monkeypatch.setattr(tp._fault, "corrupt_bytes", flip_once)
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    try:
        r0 = counters.get("integrity.crc_reject")
        t0 = counters.get("integrity.retransmit")
        ep.push("g", np.full(64, 3.25, np.float32), 0, 1)
        assert np.all(ep.pull("g", timeout=10) == np.float32(3.25))
        assert counters.get("integrity.crc_reject") == r0 + 1
        assert counters.get("integrity.retransmit") == t0 + 1
    finally:
        ep.close()
        srv.close()
        eng.shutdown()


def test_nack_budget_exhaustion_raises():
    eng = _engine()
    srv = tp.TransportServer(rank=0, engine=eng)
    inj.arm("bitflip:site=server_push:p=1", seed=3, rank=0)
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    try:
        with pytest.raises(integrity.IntegrityError, match="retransmis"):
            ep.push("g", np.ones(64, np.float32), 0, 1)
        assert counters.get("integrity.crc_reject") \
            == integrity.max_retransmits() + 1
    finally:
        inj.disarm()
        ep.close()
        srv.close()
        eng.shutdown()


# --- deadlines, partitions, resets ------------------------------------------


def test_send_deadline_surfaces_acklost_never_hangs():
    ep = tp.TcpEndpoint(("127.0.0.1", free_port()), peer=9,
                        send_deadline_s=0.5, keepalive_s=0.0)
    try:
        before = counters.get("transport.send_deadline_trips")
        t0 = time.monotonic()
        with pytest.raises(integrity.AckLost):
            ep.push_delta("k", np.ones(4, np.float32), seq=1)
        assert time.monotonic() - t0 < 5.0
        assert counters.get("transport.send_deadline_trips") > before
        assert ep.state == tp.CONNECTING
    finally:
        ep.close(drain=False)


def test_partition_blackholes_then_heals():
    kv, srv = _kv_server()
    ep = tp.TcpEndpoint(srv.addr, peer=0, send_deadline_s=0.6,
                        keepalive_s=0.0)
    try:
        ep.push_delta("k", np.ones(8, np.float32), seq=1)
        inj.arm("partition", seed=0, rank=0)
        with pytest.raises(integrity.AckLost):
            ep.push_delta("k", np.ones(8, np.float32), seq=2)
        assert counters.get("fault.partition") > 0
        inj.disarm()
        assert ep.push_delta("k", np.ones(8, np.float32), seq=2) == 2
        assert float(kv.pull("k")[0]) == 2.0
    finally:
        inj.disarm()
        ep.close()
        srv.close()


def test_partition_budget_heals_by_itself():
    kv, srv = _kv_server()
    ep = tp.TcpEndpoint(srv.addr, peer=0, send_deadline_s=0.6,
                        keepalive_s=0.0)
    try:
        ep.push_delta("k", np.ones(8, np.float32), seq=1)
        inj.arm("partition:n=2", seed=0, rank=0)  # heals after 2 ops
        for _ in range(20):
            try:
                ep.push_delta("k", np.ones(8, np.float32), seq=2)
                break
            except integrity.AckLost:
                continue
        assert float(kv.pull("k")[0]) == 2.0
        assert counters.get("fault.partition") == 2
    finally:
        inj.disarm()
        ep.close()
        srv.close()


def test_conn_reset_reconnect_exact_sum():
    kv, srv = _kv_server()
    inj.arm("conn_reset:p=0.2", seed=11, rank=0)
    ep = tp.TcpEndpoint(srv.addr, peer=0, send_deadline_s=3.0)
    n = 12
    try:
        for i in range(n):
            while True:
                try:
                    ep.push_delta("k", np.ones(8, np.float32),
                                  worker_id=0, seq=i + 1)
                    break
                except integrity.AckLost:
                    continue
        inj.disarm()
        assert float(kv.pull("k")[0]) == float(n)
        assert counters.get("transport.conn_resets") > 0
        assert counters.get("transport.reconnects") > 0
    finally:
        inj.disarm()
        ep.close()
        srv.close()


def test_partial_write_absorbed():
    kv, srv = _kv_server()
    inj.arm("partial_write:p=1:n=1", seed=2, rank=0)
    ep = tp.TcpEndpoint(srv.addr, peer=0, send_deadline_s=3.0)
    try:
        for _ in range(20):
            try:
                ep.push_delta("k", np.ones(8, np.float32), seq=1)
                break
            except integrity.AckLost:
                continue
        assert float(kv.pull("k")[0]) == 1.0
        assert counters.get("fault.partial_write") == 1
    finally:
        inj.disarm()
        ep.close()
        srv.close()


def test_slow_socket_throttles_and_feeds_slowness():
    kv, srv = _kv_server()
    inj.arm("slow_socket:ms=40", seed=0, rank=0)
    ep = tp.TcpEndpoint(srv.addr, peer=3, keepalive_s=0.0)
    try:
        t0 = time.monotonic()
        ep.push_delta("k", np.ones(8, np.float32), seq=1)
        assert time.monotonic() - t0 >= 0.04
        assert counters.get("fault.slow_socket") >= 1
        from byteps_tpu_torch.utils import slowness
        snap = slowness.tracker().snapshot()
        assert 3 in snap.get("transport", {})   # per-peer RTT observed
    finally:
        inj.disarm()
        ep.close()
        srv.close()


# --- backpressure / keepalive / state machine -------------------------------


def test_backpressure_bounds_inflight_bytes(monkeypatch):
    kv, srv = _kv_server()
    real = kv.apply_delta
    applying = threading.Event()

    def slow_apply(*a, **kw):
        applying.set()
        time.sleep(0.3)
        return real(*a, **kw)

    monkeypatch.setattr(kv, "apply_delta", slow_apply)
    ep = tp.TcpEndpoint(srv.addr, peer=0, max_inflight=16)
    try:
        before = counters.get("transport.backpressure_stalls")
        t = threading.Thread(target=lambda: ep.push_delta(
            "k", np.ones(8, np.float32), seq=1))
        t.start()
        assert applying.wait(10.0)    # t holds the in-flight budget
        ep.push_delta("k", np.ones(8, np.float32), seq=2)
        t.join(timeout=10)
        assert counters.get("transport.backpressure_stalls") > before
        assert float(kv.pull("k")[0]) == 2.0
    finally:
        ep.close()
        srv.close()


def test_keepalive_detects_dead_established_connection():
    kv, srv = _kv_server()
    ep = tp.TcpEndpoint(srv.addr, peer=0, keepalive_s=0.2,
                        send_deadline_s=1.0)
    try:
        ep.push_delta("k", np.ones(8, np.float32), seq=1)
        assert ep.state == tp.READY
        inj.arm("partition", seed=0, rank=0)   # silence, socket stays up
        deadline = time.monotonic() + 10
        while ep.state == tp.READY and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ep.state != tp.READY
    finally:
        inj.disarm()
        ep.close(drain=False)
        srv.close()


def test_keepalive_survives_parked_pull():
    eng = _engine()
    srv = tp.TransportServer(rank=0, engine=eng)
    ep = tp.TcpEndpoint(srv.addr, peer=0, keepalive_s=0.2,
                        send_deadline_s=15.0)
    try:
        ep.push("g", np.full(8, 1.0, np.float32), 0, 2)

        def late_second_contribution():
            time.sleep(1.2)   # far longer than the keepalive interval
            ep.push("g", np.full(8, 2.0, np.float32), 1, 2)

        t = threading.Thread(target=late_second_contribution)
        t.start()
        try:
            out = ep.pull("g", timeout=10)
        finally:
            t.join()
        assert np.all(out == np.float32(3.0))
        assert ep.connection.reconnects == 0
        assert ep.state == tp.READY
    finally:
        ep.close()
        srv.close()
        eng.shutdown()


def test_recreated_endpoint_tokens_advance_past_the_old_floor():
    kv, srv = _kv_server()
    ep1 = tp.TcpEndpoint(srv.addr, peer=0, rank=1)
    ep2 = None
    try:
        ep1.push_delta("k", np.ones(8, np.float32), worker_id=3)
        ep1.close()
        ep2 = tp.TcpEndpoint(srv.addr, peer=0, rank=1)
        d0 = counters.get("integrity.dup_dropped")
        ep2.push_delta("k", np.ones(8, np.float32), worker_id=3)
        assert counters.get("integrity.dup_dropped") == d0
        assert float(kv.pull("k")[0]) == 2.0
    finally:
        if ep2 is not None:
            ep2.close()
        srv.close()


def test_endpoint_to_caches_per_peer(monkeypatch):
    kv, srv = _kv_server()
    monkeypatch.setattr(tp, "transport_addr", lambda rank: srv.addr)
    a = tp.endpoint_to(5)
    try:
        assert isinstance(a, tp.TcpEndpoint)
        assert tp.endpoint_to(5) is a
        a.close()
        c = tp.endpoint_to(5)
        assert c is not a
        c.close()
    finally:
        srv.close()


def test_serve_registers_the_local_server_and_loops_back():
    kv = KVStore(device="cpu")
    kv.init_key("k", np.zeros(2, np.float32))
    srv = tp.serve(rank=0, host="127.0.0.1", port=0, kv=kv)
    assert tp.serve(rank=0) is srv and tp.local_server(0) is srv
    ep = tp.endpoint_to(0)          # this process's own rank
    assert isinstance(ep, tp.LoopbackEndpoint) and ep.kv is kv
    assert ep.push_delta("k", np.ones(2, np.float32), seq=1) == 1


def test_concurrent_same_token_push_merges_once(monkeypatch):
    eng = _engine()
    real = eng.receive_push
    merging = threading.Event()

    def slow_receive(*a, **kw):
        merging.set()
        time.sleep(0.5)
        return real(*a, **kw)

    monkeypatch.setattr(eng, "receive_push", slow_receive)
    srv = tp.TransportServer(rank=0, engine=eng)
    ep1 = tp.TcpEndpoint(srv.addr, peer=0)
    ep2 = tp.TcpEndpoint(srv.addr, peer=0, send_deadline_s=1.0)
    frame = integrity.seal_array(np.full(4, 2.0, np.float32), key="g",
                                 seq=5, worker=0)
    meta = {"hop": "server_push", "num_workers": 1, "mepoch": None}
    try:
        t = threading.Thread(target=ep1._transmit,
                             args=(dict(meta), frame, "server_push",
                                   "g", 0, 5))
        t.start()
        assert merging.wait(10.0)    # the original is mid-merge
        with pytest.raises(integrity.AckLost):
            ep2._transmit(dict(meta), frame, "server_push", "g", 0, 5)
        t.join()
        rmeta, _ = ep2._transmit(dict(meta), frame, "server_push",
                                 "g", 0, 5)
        assert rmeta.get("dup") is True
        assert np.all(ep1.pull("g", timeout=10) == np.float32(2.0))
    finally:
        ep1.close()
        ep2.close()
        srv.close()
        eng.shutdown()


def test_failed_merge_releases_the_dedup_claim():
    eng = _engine()
    srv = tp.TransportServer(rank=0, engine=eng)
    ep = tp.TcpEndpoint(srv.addr, peer=0)
    meta = {"hop": "server_push_wire", "num_workers": 1, "mepoch": None}
    try:
        bad = integrity.seal_bytes(b"\x00" * 8, key="uc", seq=9, worker=0)
        with pytest.raises(Exception):
            # no codec registered for "uc": the merge raises AFTER the
            # claim, which must roll back
            ep._transmit(dict(meta), bad, "server_push", "uc", 0, 9)
        good = integrity.seal_array(np.full(4, 4.0, np.float32),
                                    key="uc", seq=9, worker=0)
        d0 = counters.get("integrity.dup_dropped")
        ep._transmit({"hop": "server_push", "num_workers": 1,
                      "mepoch": None}, good, "server_push", "uc", 0, 9)
        assert counters.get("integrity.dup_dropped") == d0
        assert np.all(ep.pull("uc", timeout=10) == np.float32(4.0))
    finally:
        ep.close()
        srv.close()
        eng.shutdown()


def test_state_machine_full_cycle():
    port = free_port()
    ep = tp.TcpEndpoint(("127.0.0.1", port), peer=0, keepalive_s=0.0)
    srv = None
    try:
        assert ep.state == tp.CONNECTING   # nothing listening yet
        kv = KVStore(device="cpu")
        kv.init_key("k", np.zeros(8, np.float32))
        srv = tp.TransportServer(port=port, rank=0, kv=kv)
        deadline = time.monotonic() + 10
        while ep.state != tp.READY and time.monotonic() < deadline:
            time.sleep(0.02)
        assert ep.state == tp.READY
        ep.push_delta("k", np.ones(8, np.float32), seq=1)
        ep.close()
        assert ep.state == tp.DEAD
        with pytest.raises(tp.TransportClosed):
            ep.connection.request(tp.OP_KEEPALIVE, {})
    finally:
        ep.close(drain=False)
        if srv is not None:
            srv.close()


def test_debug_state_and_gauges():
    kv, srv = _kv_server()
    ep = tp.TcpEndpoint(srv.addr, peer=4)
    try:
        ep.push_delta("k", np.ones(8, np.float32), seq=1)
        ds = ep.connection.debug_state()
        assert ds["state"] == tp.READY and ds["peer"] == 4
        assert ds["connects"] == 1 and ds["last_rtt_ms"] is not None
        ss = srv.debug_state()
        assert ss["attached"]["kv"] and ss["connections"] == 1
        assert gauges.get("transport.connections") >= 1
        assert gauges.get("transport.connections_ready") >= 1
        from byteps_tpu_torch.common import metrics, obs_server
        doc = obs_server.debug_state()
        assert any(c["peer"] == 4 for c in doc["transport"]["connections"])
        assert any(s["rank"] == 0 for s in doc["transport"]["servers"])
        assert "transport" not in doc["omitted"]
        text = metrics.registry.render_prometheus()
        assert "byteps_transport_rtt_ms" in text
        assert "byteps_transport_connections_ready" in text
    finally:
        ep.close()
        srv.close()


# --- sharded routing --------------------------------------------------------


def test_sharded_client_routes_by_assigner():
    kvs, srvs, eps = [], [], []
    for i in range(2):
        kv = KVStore(device="cpu")
        srv = tp.TransportServer(rank=i, kv=kv)
        kvs.append(kv)
        srvs.append(srv)
        eps.append(tp.TcpEndpoint(srv.addr, peer=i))
    client = tp.ShardedClient(eps)
    try:
        keys = [f"param.{i}" for i in range(8)]
        for k in keys:
            shard = client.assigner.write_target(k)
            kvs[shard].init_key(k, np.zeros(4, np.float32))
            client.push_delta(k, np.ones(4, np.float32), seq=1)
        for k in keys:
            shard = client.assigner.write_target(k)
            assert k in kvs[shard].keys()
            assert k not in kvs[1 - shard].keys()
            val, ver = client.kv_pull(k)
            assert np.all(val == 1.0) and ver == 1
    finally:
        client.close()
        for srv in srvs:
            srv.close()
    with pytest.raises(ValueError, match="at least one"):
        tp.ShardedClient([])


def test_sharding_cross_process_determinism():
    """Two processes (different hash seeds) and this one route the same
    keys, ints and strings, to the same shards under every hash mode, and
    the JAX package's assigner agrees."""
    prog = r"""
import json
from byteps_tpu_torch.server.sharding import ServerAssigner, key_to_int
keys = [0, 1, 17, 2**31, 2**63 - 1] + [f"layer.{i}.weight" for i in range(8)]
out = {}
for fn in ("naive", "built_in", "djb2", "sdbm"):
    a = ServerAssigner(num_servers=5, fn=fn, mixed_mode=False, bound=101,
                       replicas=1, hot_keys=0)
    out[fn] = {str(k): a.assign(key_to_int(k)) for k in keys}
print(json.dumps(out, sort_keys=True))
"""
    results = []
    for seed in ("0", "31337"):
        env = child_env(PYTHONHASHSEED=seed)
        out = subprocess.run([sys.executable, "-c", prog], env=env,
                             cwd=REPO, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert results[0] == results[1]
    from byteps_tpu.server.sharding import ServerAssigner as JAssigner
    from byteps_tpu.server.sharding import key_to_int as jkey
    for fn, table in results[0].items():
        a = JAssigner(num_servers=5, fn=fn, mixed_mode=False, bound=101,
                      replicas=1, hot_keys=0)
        for k, shard in table.items():
            key = int(k) if k.isdigit() else k
            assert a.assign(jkey(key)) == shard, (fn, k)


# --- across the two packages ----------------------------------------------------


def _kv_scenario(ep):
    """Seq-tokened integer deltas from two workers, a deliberate duplicate,
    and an epoch-stamped push, then the pulled value and version."""
    versions = []
    for seq in range(1, 5):
        for w in (1, 2):
            delta = np.arange(8, dtype=np.float32) * seq + w
            versions.append(ep.push_delta("k", delta, mepoch=0, worker_id=w,
                                          seq=seq))
    versions.append(ep.push_delta("k", np.full(8, 99, np.float32),
                                  worker_id=1, seq=2))      # a duplicate
    value, version = ep.kv_pull("k")
    return versions, np.asarray(value), version


def _run_kv(ep_cls, srv_cls, kv):
    kv.init_key("k", np.zeros(8, np.float32))
    srv = srv_cls(rank=0, kv=kv)
    ep = ep_cls(srv.addr, peer=0, rank=1)
    try:
        return _kv_scenario(ep)
    finally:
        ep.close()
        srv.close()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_kv_pushes_across_the_packages(direction):
    """A port endpoint pushing to a JAX server with a JAX store (and a JAX
    endpoint to a port server with a port store) lands the same values,
    versions and dedup counts as a run within the server's package."""
    if direction == "port_to_jax":
        mixed = _run_kv(tp.TcpEndpoint, jtp.TransportServer, JKVStore())
        dup_mixed = jcounters.get("integrity.dup_dropped")
        jcounters.reset()
        within = _run_kv(jtp.TcpEndpoint, jtp.TransportServer, JKVStore())
        dup_within = jcounters.get("integrity.dup_dropped")
    else:
        mixed = _run_kv(jtp.TcpEndpoint, tp.TransportServer,
                        KVStore(device="cpu"))
        dup_mixed = counters.get("integrity.dup_dropped")
        counters.reset()
        within = _run_kv(tp.TcpEndpoint, tp.TransportServer,
                         KVStore(device="cpu"))
        dup_within = counters.get("integrity.dup_dropped")
    assert mixed[0] == within[0] == list(range(1, 9)) + [8]
    np.testing.assert_array_equal(mixed[1], within[1])
    assert mixed[1].dtype == np.float32 and mixed[2] == within[2] == 8
    assert dup_mixed == dup_within == 1


def test_server_engine_pushes_across_the_packages():
    """The sync merge hop too: a JAX endpoint's pushes merge in a port
    ServerEngine and a port endpoint pulls the round."""
    eng = _engine()
    srv = tp.TransportServer(rank=0, engine=eng)
    jep = jtp.TcpEndpoint(srv.addr, peer=0, rank=1)
    ep = tp.TcpEndpoint(srv.addr, peer=0, rank=2)
    try:
        jep.push("g", np.full(6, 1.25, np.float32), 0, 2)
        ep.push("g", np.full(6, 2.0, np.float32), 1, 2)
        out, version = jep.pull_versioned("g", timeout=10)
        assert np.all(out == np.float32(3.25)) and version == 1
    finally:
        jep.close()
        ep.close()
        srv.close()
        eng.shutdown()


# --- the 3-process chaos lanes ------------------------------------------------


def _spawn(mode, rank, port, steps, extra=None):
    env = child_env(BPS_FW_MODE=mode, BPS_FW_RANK=rank, BPS_FW_PORT=port,
                    BPS_FW_STEPS=steps, **(extra or {}))
    return subprocess.Popen([sys.executable, WORKER], env=env, cwd=REPO,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _communicate(procs, timeout=120):
    outs = {}
    try:
        for name, p in procs.items():
            outs[name], _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs.values():
            p.kill()
            p.communicate()
        pytest.fail("transport workers hung; partial output: "
                    + "".join(o[-1500:] for o in outs.values()))
    return outs


def _line_value(out, tag, idx=-1):
    for line in out.splitlines():
        if line.startswith(tag + " "):
            return line.split()[idx]
    raise AssertionError(f"no {tag!r} line in:\n" + out[-3000:])


def test_transport_bitflip_3proc_converges_bit_identical():
    from tests.torch_fault_worker import LR, _grad
    port = free_port()
    steps, nworkers = 8, 2
    procs = {0: _spawn("bitflip", 0, port, steps)}
    for rank in (1, 2):
        procs[rank] = _spawn(
            "bitflip", rank, port, steps,
            extra={"BYTEPS_FAULT_SPEC": "bitflip:site=server_push:p=0.15",
                   "BYTEPS_FAULT_SEED": str(100 + rank)})
    outs = _communicate(procs)
    for rank, p in procs.items():
        assert p.returncode == 0, f"rank {rank}:\n{outs[rank][-4000:]}"
    params = np.zeros_like(_grad(0, 0))
    for step in range(steps):
        merged = np.sum([_grad(step, w) for w in range(nworkers)], axis=0,
                        dtype=np.float32)
        params -= LR * merged
    want = hashlib.sha256(params.tobytes()).hexdigest()
    assert {_line_value(outs[r], "DIGEST") for r in (1, 2)} == {want}
    rejects = int(_line_value(outs[0], "REJECTS"))
    retrans = sum(int(_line_value(outs[r], "RETRANS", idx=2))
                  for r in (1, 2))
    assert rejects >= 1 and retrans >= 1, (rejects, retrans)


def test_transport_conn_reset_3proc_zero_double_sums():
    port = free_port()
    steps = 15
    procs = {0: _spawn("kvreset", 0, port, steps)}
    for rank in (1, 2):
        extra = {}
        if rank == 2:
            extra = {"BYTEPS_FAULT_SPEC":
                     "conn_reset:rank=2:site=transport:p=0.2",
                     "BYTEPS_FAULT_SEED": "9"}
        procs[rank] = _spawn("kvreset", rank, port, steps, extra=extra)
    outs = _communicate(procs)
    for rank, p in procs.items():
        assert p.returncode == 0, f"rank {rank}:\n{outs[rank][-4000:]}"
    assert float(_line_value(outs[0], "SUM")) == float(2 * steps)
    resets = int(_line_value(outs[2], "RESETS", idx=2))
    reconnects = int(_line_value(outs[2], "RECONNECTS", idx=2))
    assert resets >= 1 and reconnects >= 1, (resets, reconnects)
    assert int(_line_value(outs[0], "DUP")) >= 1


# --- the supervisor soak ------------------------------------------------------


def test_soak_32_endpoints_connect_storm_resets_no_thread_leak():
    base_threads = threading.active_count()
    n = 32
    kvs, srvs, eps = [], [], []
    try:
        for i in range(n):
            kv = KVStore(device="cpu")
            kv.init_key("k", np.zeros(4, np.float32))
            kvs.append(kv)
            srvs.append(tp.TransportServer(rank=i, kv=kv))
        for i in range(n):
            eps.append(tp.TcpEndpoint(srvs[i].addr, peer=i,
                                      keepalive_s=0.0,
                                      send_deadline_s=5.0))
        deadline = time.monotonic() + 20
        while (any(ep.state != tp.READY for ep in eps)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert all(ep.state == tp.READY for ep in eps)
        inj.arm("conn_reset:p=0.3:n=40", seed=7, rank=0)
        rounds = 3
        for r in range(rounds):
            for i, ep in enumerate(eps):
                while True:
                    try:
                        ep.push_delta("k", np.ones(4, np.float32),
                                      worker_id=i, seq=r + 1)
                        break
                    except integrity.AckLost:
                        continue
        inj.disarm()
        deadline = time.monotonic() + 20
        while (any(ep.state != tp.READY for ep in eps)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert all(ep.state == tp.READY for ep in eps)
        for kv in kvs:
            assert float(kv.pull("k")[0]) == float(rounds)
        assert gauges.get("transport.connections_ready") == n
    finally:
        inj.disarm()
        for ep in eps:
            ep.close()
        for srv in srvs:
            srv.close()
    deadline = time.monotonic() + 10
    while (threading.active_count() > base_threads + 2
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert threading.active_count() <= base_threads + 2, \
        [t.name for t in threading.enumerate()]
    assert gauges.get("transport.connections") == 0
