"""Parity of the port's ``KVStore`` with the JAX package's
(``server/kv_store.py``), on the CPU.

One scripted push sequence runs through both stores (``device="cpu"``
for the port): tokens and duplicates, stale membership epochs, a
token-less push, a non-finite delta and a merge that overflows, under
each ``BYTEPS_NONFINITE_POLICY``; compressed wire pushes of onebit,
topk, randomk and dithering, each with error feedback on the worker;
then ``bitflip`` and ``drop`` armed at ``kv_push`` with the same seed in
both, every AckLost retried with its token.  The results must match:
every value bit for bit, every version, every returned version or
error, every counter, ``wire_bytes`` and ``wire_bytes_wasted``.

The compressed pushes carry the JAX worker chain's frames to both
stores, so the comparison holds the stores' decode and sum; the port's
own worker chain must produce frames of the same length (and, but for
onebit's scale, an L1 sum taken in another order, the same bytes).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.common import integrity as ji
from byteps_tpu.common.telemetry import counters as jcounters
from byteps_tpu.compression import registry as jreg
from byteps_tpu.fault import injector as jinj
from byteps_tpu.fault import membership as jmem
from byteps_tpu.server.kv_store import KVStore as JStore
from byteps_tpu_torch.common import integrity as pi
from byteps_tpu_torch.common.telemetry import counters as pcounters
from byteps_tpu_torch.compression import registry as preg
from byteps_tpu_torch.fault import injector as pinj
from byteps_tpu_torch.fault import membership as pmem
from byteps_tpu_torch.server import kv_store as pkv
from byteps_tpu_torch.server.kv_store import KVStore as PStore

from .torch_ps_common import configure, counter_values
from .torch_ps_common import fresh_ps_state  # noqa: F401 — autouse

CODECS = {
    "onebit": {"compressor": "onebit", "ef": "vanilla"},
    "topk": {"compressor": "topk", "k": "0.1", "ef": "vanilla"},
    "randomk": {"compressor": "randomk", "k": "0.1", "seed": "3",
                "ef": "vanilla"},
    "dithering": {"compressor": "dithering", "k": "8", "ef": "vanilla"},
}
CNUMEL = 700
CHAOS = "bitflip:site=kv_push:p=0.3;drop:site=kv_push:p=0.3"


class _Side:
    """One package's store and the modules the script drives."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.store = JStore() if jax_side else PStore(device="cpu")
        self.integ = ji if jax_side else pi
        self.inj = jinj if jax_side else pinj
        self.mem = jmem if jax_side else pmem
        self.counters = jcounters if jax_side else pcounters
        self.out = []

    def value(self, key):
        v = self.store.pull(key)
        return np.asarray(v) if self.jax else v.numpy()

    def call(self, fn, *a, **kw):
        """Record the outcome: the returned version or the error."""
        try:
            self.out.append(("ok", fn(*a, **kw)))
        except Exception as e:  # noqa: BLE001 — the outcome is the datum
            self.out.append((type(e).__name__, str(e)))

    def push_retrying(self, push, *a, **kw):
        """Push, retrying a lost ack with the same token (as the async
        optimizer does); records every attempt's outcome."""
        for _ in range(8):
            try:
                self.out.append(("ok", push(*a, **kw)))
                return
            except self.integ.AckLost as e:
                self.out.append(("AckLost", str(e)))
            except Exception as e:  # noqa: BLE001
                self.out.append((type(e).__name__, str(e)))
                return


def _deltas(seed, n, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _jax_wires(kw, deltas):
    wc = jreg.create(dict(kw), CNUMEL, jnp.float32)
    st = wc.init_state()
    wires = []
    for d in deltas:
        payload, st = wc.compress(jnp.asarray(d), st)
        wires.append(wc.wire_encode(payload))
    return wires


def _port_wires(kw, deltas):
    wc = preg.create(dict(kw), CNUMEL, torch.float32)
    st = wc.init_state(torch.device("cpu"))
    wires = []
    for d in deltas:
        payload, st = wc.compress(torch.from_numpy(d), st)
        wires.append(wc.wire_encode(payload))
    return wires


def _script(side, wires):
    s = side.store
    rng = np.random.RandomState(0)
    s.init_key("w", rng.randn(4, 8).astype(np.float32))
    s.init_key("b", rng.randn(5).astype(np.float32))
    s.init_key("i", np.arange(6, dtype=np.int64))
    big = np.full(3, np.finfo(np.float32).max / 1.5, np.float32)
    s.init_key("big", big)
    s.init_key("w", np.zeros((4, 8), np.float32))     # idempotent
    d = _deltas(1, 8, (4, 8))
    side.call(s.push_delta, "w", d[0], worker_id=0, seq=1)
    side.call(s.push_delta, "w", d[1], worker_id=1, seq=1)
    side.call(s.push_delta, "w", d[2], worker_id=0, seq=1)    # duplicate
    side.call(s.push_delta, "w", d[3], worker_id=0, seq=2)
    side.call(s.push_delta, "w", d[4], worker_id=1, seq=1)    # duplicate
    side.call(s.push_delta, "w", d[5])                        # no token
    side.call(s.push_delta, "i", np.arange(6, dtype=np.int64) * 3,
              worker_id=0, seq=1)
    side.call(s.push_delta, "b", _deltas(2, 1, (5,))[0], worker_id=0,
              seq=1, mepoch=7)                                # stale
    side.call(s.push_delta, "nope", d[0], worker_id=0, seq=1)  # unknown
    # a world change: the floors reset, an old-epoch retry is stale
    side.mem.advance_epoch()
    s.set_membership_epoch(side.mem.current_epoch())
    side.call(s.push_delta, "w", d[6], worker_id=0, seq=2, mepoch=0)
    side.call(s.push_delta, "w", d[6], worker_id=0, seq=1, mepoch=1)
    # non-finite delta, then a merge that overflows
    nan = np.ones(5, np.float32)
    nan[[1, 3]] = [np.nan, np.inf]
    side.call(s.push_delta, "b", nan, worker_id=0, seq=2)
    side.call(s.push_delta, "b", np.ones(5, np.float32), worker_id=0,
              seq=3)
    side.call(s.push_delta, "big", big, worker_id=0, seq=1)
    side.call(s.push_delta, "big", -big, worker_id=0, seq=2)
    # compressed wire pushes
    for name, kw in CODECS.items():
        key = f"c_{name}"
        s.init_key(key, np.zeros(CNUMEL, np.float32))
        s.register_compression(key, kw, CNUMEL)
        s.register_compression(key, kw, CNUMEL)               # idempotent
        for i, wire in enumerate(wires[name]):
            side.call(s.push_delta_wire, key, wire, worker_id=0,
                      seq=i + 1)
        side.call(s.push_delta_wire, key, wires[name][0], worker_id=0,
                  seq=1)                                       # duplicate
    side.call(s.register_compression, "c_topk", CODECS["onebit"], CNUMEL)
    side.call(s.push_delta_wire, "b", wires["onebit"][0], worker_id=0,
              seq=9)                                           # no codec
    # chaos at kv_push: corrupt frames are NACKed and retransmitted,
    # lost acks retried with the same token
    side.inj.arm(CHAOS, seed=5)
    cd = _deltas(3, 12, (4, 8))
    for i, delta in enumerate(cd):
        side.push_retrying(s.push_delta, "w", delta, worker_id=2,
                           seq=i + 1, mepoch=1)
    for name in CODECS:
        for i, wire in enumerate(wires[name]):
            side.push_retrying(s.push_delta_wire, f"c_{name}", wire,
                               worker_id=3, seq=i + 1, mepoch=1)
    side.inj.disarm()
    return {
        "values": {k: side.value(k) for k in s.keys()},
        "versions": {k: s.version(k) for k in s.keys()},
        "outcomes": side.out,
        "counters": counter_values(side.counters),
        "wire": (s.wire_bytes, s.wire_bytes_wasted),
        "debug": {k: v for k, v in s.debug_state().items()},
    }


def _run_both(policy, integrity_on=True):
    configure(nonfinite_policy=policy, integrity_on=integrity_on)
    deltas = _deltas(4, 4, (CNUMEL,))
    wires = {name: _jax_wires(kw, deltas) for name, kw in CODECS.items()}
    want = _script(_Side(True), wires)
    got = _script(_Side(False), wires)
    return got, want, wires, deltas


def _assert_same(got, want):
    assert got["versions"] == want["versions"]
    assert sorted(got["values"]) == sorted(want["values"])
    for k, v in want["values"].items():
        assert got["values"][k].dtype == v.dtype, k
        assert got["values"][k].tobytes() == v.tobytes(), k
    assert got["outcomes"] == want["outcomes"]
    assert got["counters"] == want["counters"]
    assert got["wire"] == want["wire"]
    assert got["debug"] == want["debug"]


@pytest.mark.parametrize("policy", ["raise", "skip", "zero"])
def test_scripted_pushes_match_jax(policy):
    got, want, wires, deltas = _run_both(policy)
    _assert_same(got, want)
    c = got["counters"]
    assert c["integrity.crc_reject"] > 0 and c["integrity.retransmit"] > 0
    assert c["integrity.dup_dropped"] > 0 and c["fault.drop"] > 0
    assert c["membership.stale_pushes_dropped"] == 2
    assert got["wire"][0] > 0 and got["wire"][1] > 0
    # the port's own worker chains frame alike
    for name, kw in CODECS.items():
        mine = _port_wires(kw, deltas)
        assert [len(w) for w in mine] == [len(w) for w in wires[name]]
        if name != "onebit":
            assert mine == wires[name], name


def test_integrity_off_bitflip_lands_silently_alike():
    got, want, _, _ = _run_both("raise", integrity_on=False)
    _assert_same(got, want)
    assert got["counters"]["integrity.crc_reject"] == 0
    assert got["counters"]["fault.bitflip"] > 0


def test_bf16_delta_is_refused_with_integrity_on():
    s = PStore(device="cpu")
    s.init_key("h", torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        s.push_delta("h", torch.ones(4, dtype=torch.bfloat16), seq=1)
    assert s.version("h") == 0
    configure(integrity_on=False)
    assert s.push_delta("h", torch.ones(4, dtype=torch.bfloat16)) == 1
    assert torch.equal(s.pull("h"), torch.ones(4, dtype=torch.bfloat16))


def test_store_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        PStore()


def test_pull_copy_runs_outside_the_lock(monkeypatch):
    """A slow pull must not serialize pushes, and the copy-on-write mark
    keeps the reference it copies frozen."""
    s = PStore(device="cpu")
    s.init_key("w", np.zeros(4, np.float32))
    entered, release = threading.Event(), threading.Event()
    real = pkv._copy_outside_lock

    def slow_copy(ref):
        entered.set()
        release.wait(5)
        return real(ref)

    monkeypatch.setattr(pkv, "_copy_outside_lock", slow_copy)
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("v", s.pull("w")))
    t.start()
    assert entered.wait(5)
    assert s.push_delta("w", np.ones(4, np.float32), seq=1) == 1
    release.set()
    t.join(5)
    assert not t.is_alive()
    assert torch.equal(box["v"], torch.zeros(4))
    assert torch.equal(s.pull("w"), torch.ones(4))


def test_clear_resyncs_epoch_and_accounting():
    s = PStore(device="cpu")
    s.init_key("c", np.zeros(CNUMEL, np.float32))
    s.register_compression("c", CODECS["topk"], CNUMEL)
    wire = _port_wires(CODECS["topk"], _deltas(5, 1, (CNUMEL,)))[0]
    s.push_delta_wire("c", wire, seq=1)
    assert s.wire_bytes == len(wire) and s.nbytes() == 4 * CNUMEL
    pmem.advance_epoch()
    s.clear()
    assert s.keys() == [] and s.wire_bytes == 0
    assert s.debug_state()["membership_epoch"] == 1
    assert s.codec_info("c") is None
