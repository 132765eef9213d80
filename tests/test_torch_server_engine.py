"""Parity of the port's ``ServerEngine`` and ``server/sharding.py`` with
the JAX package's, on the CPU (``device="cpu"`` for the port).

Each scenario runs against both engines and records what a caller sees:
every pulled value (bit for bit), every error, and the counters.  The
scenarios: the barrier flow with parked pulls and sticky least-loaded
thread assignment; the scheduled queue's pop order; a merge failure that
poisons a key, and ``reset_key``; every quarantine case of the JAX
package's own integrity tests (non-finite contributions under skip /
zero / raise, late same-round pushes from contiguous and non-contiguous
ranks, a queued earlier round spared, a partial merge of the blamed
round discarded, a merged overflow, a pull after ``reset_key``);
compressed rounds, whose pulled wire bytes must equal the JAX engine's
(onebit: the same words, and the scale, an L1 sum that XLA's CPU takes
in another order, to rtol 1e-5 as in tests/test_torch_collectives.py,
ROADMAP Queue C item 2); and ``bitflip`` at ``server_push``, bit-identical to the
clean round.  The hash functions and ``ServerAssigner`` route 1000 keys
alike.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.common.telemetry import counters as jcounters
from byteps_tpu.compression import registry as jreg
from byteps_tpu.fault import injector as jinj
from byteps_tpu.server import engine as jeng
from byteps_tpu.server import sharding as jsh
from byteps_tpu_torch.common.telemetry import counters as pcounters
from byteps_tpu_torch.fault import injector as pinj
from byteps_tpu_torch.server import engine as peng
from byteps_tpu_torch.server import sharding as psh

from .torch_ps_common import configure, counter_values
from .torch_ps_common import fresh_ps_state  # noqa: F401 — autouse


class _Side:
    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.mod = jeng if jax_side else peng
        self.inj = jinj if jax_side else pinj
        self.counters = jcounters if jax_side else pcounters
        self.engines = []
        self.seen = []

    def engine(self, **kw):
        if not self.jax:
            kw["device"] = "cpu"
        eng = self.mod.ServerEngine(**kw)
        self.engines.append(eng)
        return eng

    def pull(self, eng, key, timeout=5):
        v = eng.pull(key, timeout=timeout)
        v = np.asarray(v) if self.jax else v.numpy()
        self.seen.append(("pull", v.dtype.str, v.shape, v.tobytes()))
        return v

    def call(self, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — the outcome is the datum
            self.seen.append((type(e).__name__, str(e)))

    def close(self):
        for eng in self.engines:
            eng.shutdown()


def _both(scenario, monkeypatch=None):
    """Run ``scenario(side)`` for each package; return (port, jax)
    observations with the counters."""
    outs = []
    for jax_side in (True, False):
        side = _Side(jax_side)
        try:
            extra = scenario(side)
        finally:
            side.close()
            if monkeypatch is not None:
                monkeypatch.undo()
        outs.append((side.seen, counter_values(side.counters), extra))
    return outs[1], outs[0]


def _f(v, n=4):
    return np.full(n, v, np.float32)


def _nan(n=4):
    a = np.ones(n, np.float32)
    a[1] = np.nan
    return a


# -- barrier flow, parked pulls, assignment, schedule ----------------------

def _barrier(side):
    eng = side.engine(num_threads=3)
    rng = np.random.RandomState(0)
    keys = [f"k{i}" for i in range(7)]
    sizes = [int(s) for s in rng.randint(1, 50, size=len(keys))]
    threads = [threading.Thread(target=side.pull, args=(eng, k))
               for k in keys]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10    # every pull parks before round 1
    while (not all(eng._state(k).parked for k in keys)
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert all(eng._state(k).parked for k in keys)
    for rnd in range(3):
        for key, n in zip(keys, sizes):
            for w in range(3):
                eng.push(key, rng.randn(n).astype(np.float32),
                         worker_id=w, num_workers=3)
        for key in keys:
            side.pull(eng, key)
    for t in threads:
        t.join(5)
        assert not t.is_alive()
    side.call(eng.push, "k0", np.ones(3, np.float64), worker_id=0,
              num_workers=3)           # geometry mismatch
    return ([eng.thread_id(k, 0) for k in keys], list(eng._acc_load),
            [eng.version(k) for k in keys])


def test_barrier_flow_parked_pulls_and_sticky_assignment():
    got, want = _both(_barrier)
    # the parked pulls' order between threads is a race: compare sorted
    assert sorted(got[0]) == sorted(want[0])
    assert got[1:] == want[1:]
    assert got[2][2] == [3] * 7


def _schedule_order(side):
    out = []
    for sched in (False, True):
        q = side.mod.PriorityQueue(sched)
        for i, key in enumerate("abacbcaab"):
            q.push(side.mod._Msg(key=key, worker_id=i))
        q.clear_counter("b")
        q.push(side.mod._Msg(key="", kind="stop"))
        out.append([(m.key, m.worker_id, m.kind) for m in
                    (q.wait_and_pop() for _ in range(10))])
    return out


def test_schedule_pop_order_matches():
    got, want = _both(_schedule_order)
    assert got == want
    assert got[2][1][0][0] == "b"      # cleared counter: b's lane first


def _poison(side, monkeypatch):
    real = side.mod.inplace_add

    def failing(dst, src, *a):
        if float(np.asarray(src).reshape(-1)[0]) == 13.0:
            raise MemoryError("merge failed")
        return real(dst, src, *a)

    monkeypatch.setattr(side.mod, "inplace_add", failing)
    eng = side.engine(num_threads=1)
    for w in range(2):
        eng.push("g", _f(1.0), worker_id=w, num_workers=2)
    side.pull(eng, "g")
    eng.push("g", _f(2.0), worker_id=0, num_workers=2)
    eng.push("g", _f(13.0), worker_id=1, num_workers=2)
    side.call(side.pull, eng, "g")
    side.call(eng.push, "g", _f(1.0), worker_id=0, num_workers=2)
    eng.reset_key("g")
    for w in range(2):
        eng.push("g", _f(5.0, 6), worker_id=w, num_workers=2)
    side.pull(eng, "g")
    return eng.version("g"), eng.debug_state()["keys"]["g"]


def test_poison_and_reset_key_match(monkeypatch):
    got, want = _both(lambda s: _poison(s, monkeypatch), monkeypatch)
    assert got == want
    assert got[2][0] == 2


# -- the quarantine cases of tests/test_integrity.py -----------------------

def _nonfinite_raise(side):
    eng = side.engine(num_threads=1)
    side.call(eng.push, "g", _nan(), worker_id=1, num_workers=2)


def _nonfinite_skip(side):
    eng = side.engine(num_threads=1)
    for r in range(2):
        eng.push("g", _f(1.0), worker_id=r, num_workers=2)
    side.pull(eng, "g")
    eng.push("g", _f(1.0), worker_id=0, num_workers=2)
    eng.push("g", _nan(), worker_id=1, num_workers=2)
    side.pull(eng, "g")
    for r in range(2):
        eng.push("g", _f(3.0), worker_id=r, num_workers=2)
    side.pull(eng, "g")


def _nonfinite_zero(side):
    eng = side.engine(num_threads=1)
    eng.push("g", _nan(), worker_id=0, num_workers=2)
    eng.push("g", _f(1.0), worker_id=1, num_workers=2)
    side.pull(eng, "g")


def _late_same_round(side):
    eng = side.engine(num_threads=1)
    for r in range(3):
        eng.push("g", _f(1.0), worker_id=r, num_workers=3)
    side.pull(eng, "g")
    eng.push("g", _f(1.0), worker_id=0, num_workers=3)
    eng.push("g", _nan(), worker_id=1, num_workers=3)
    eng.push("g", _f(1.0), worker_id=2, num_workers=3)
    side.pull(eng, "g")
    for r in range(3):
        eng.push("g", _f(2.0), worker_id=r, num_workers=3)
    side.pull(eng, "g")


def _late_noncontiguous(side):
    eng = side.engine(num_threads=1)
    for r in (0, 2):
        eng.push("g", _f(1.0), worker_id=r, num_workers=2)
    side.pull(eng, "g")
    eng.push("g", _nan(), worker_id=0, num_workers=2)
    eng.push("g", _f(1.0), worker_id=2, num_workers=2)
    side.pull(eng, "g")
    for r in (0, 2):
        eng.push("g", _f(2.0), worker_id=r, num_workers=2)
    side.pull(eng, "g")


def _spares_queued_round(side, monkeypatch):
    gate = threading.Event()
    orig = side.mod.PriorityQueue.wait_and_pop

    def gated(self):
        gate.wait()
        return orig(self)

    monkeypatch.setattr(side.mod.PriorityQueue, "wait_and_pop", gated)
    eng = side.engine(num_threads=1)
    try:
        for r in range(3):
            eng.push("g", _f(float(r + 1)), worker_id=r, num_workers=3)
        eng.push("g", _nan(), worker_id=0, num_workers=3)
        gate.set()
        side.pull(eng, "g")
        eng.push("g", _f(1.0), worker_id=1, num_workers=3)
        eng.push("g", _f(1.0), worker_id=2, num_workers=3)
        for r in range(3):
            eng.push("g", _f(3.0), worker_id=r, num_workers=3)
        side.pull(eng, "g")
    finally:
        gate.set()


def _discards_partial_merge(side, monkeypatch):
    sem = threading.Semaphore(0)
    orig = side.mod.PriorityQueue.wait_and_pop

    def gated(self):
        sem.acquire()
        return orig(self)

    monkeypatch.setattr(side.mod.PriorityQueue, "wait_and_pop", gated)
    eng = side.engine(num_threads=1)
    try:
        st = eng._state("g")
        eng.push("g", _f(1.0), worker_id=1, num_workers=3)
        eng.push("g", _f(1.0), worker_id=2, num_workers=3)
        sem.release(2)
        deadline = time.monotonic() + 5
        while st.count < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert st.count == 2
        eng.push("g", _nan(), worker_id=0, num_workers=3)
        for r in range(3):
            eng.push("g", _f(2.0), worker_id=r, num_workers=3)
        sem.release(10)
        side.pull(eng, "g")
    finally:
        sem.release(100)


def _merged_overflow(side):
    eng = side.engine(num_threads=1)
    big = np.full(2, np.finfo(np.float32).max, np.float32)
    for r in range(2):
        eng.push("g", _f(1.0, 2), worker_id=r, num_workers=2)
    side.pull(eng, "g")
    for r in range(2):
        eng.push("g", big, worker_id=r, num_workers=2)
    side.call(side.pull, eng, "g", timeout=1)


def _pull_after_reset(side):
    eng = side.engine(num_threads=1)
    for r in range(2):
        eng.push("g", _f(1.0), worker_id=r, num_workers=2)
    side.pull(eng, "g")
    eng.reset_key("g")
    side.call(side.pull, eng, "g", timeout=0.2)
    for r in range(2):
        eng.push("g", _f(3.0), worker_id=r, num_workers=2)
    side.pull(eng, "g")


CASES = {
    "nonfinite_raise": ("raise", _nonfinite_raise),
    "nonfinite_skip": ("skip", _nonfinite_skip),
    "nonfinite_zero": ("zero", _nonfinite_zero),
    "late_same_round": ("skip", _late_same_round),
    "late_noncontiguous_rank": ("skip", _late_noncontiguous),
    "spares_queued_round": ("skip", _spares_queued_round),
    "discards_partial_merge": ("skip", _discards_partial_merge),
    "merged_overflow_skip": ("skip", _merged_overflow),
    "merged_overflow_zero": ("zero", _merged_overflow),
    "merged_overflow_raise": ("raise", _merged_overflow),
    "pull_after_reset_key": ("raise", _pull_after_reset),
}


@pytest.mark.parametrize("case", list(CASES))
def test_quarantine_cases_match(case, monkeypatch):
    policy, fn = CASES[case]
    configure(nonfinite_policy=policy)
    if fn in (_spares_queued_round, _discards_partial_merge):
        got, want = _both(lambda s: fn(s, monkeypatch), monkeypatch)
    else:
        got, want = _both(fn)
    assert got == want
    assert got[0], "the scenario observed nothing"


# -- compressed rounds, chaos ----------------------------------------------

CODECS = {
    "onebit": {"compressor": "onebit"},
    "onebit_ef": {"compressor": "onebit", "ef": "vanilla"},
    "topk": {"compressor": "topk", "k": "0.1"},
    "randomk": {"compressor": "randomk", "k": "0.1", "seed": "3"},
    "dithering": {"compressor": "dithering", "k": "8"},
}
CNUMEL = 900


def _jax_wire(kw, x):
    wc = jreg.create(dict(kw), CNUMEL, jnp.float32)
    payload, _ = wc.compress(jnp.asarray(x), wc.init_state())
    return wc.wire_encode(payload)


def _compressed(side, kw, wires):
    eng = side.engine(num_threads=2)
    eng.register_compression("c", kw, CNUMEL)
    side.call(eng.pull_compressed, "d", timeout=0.1)     # not registered
    out = []
    for rnd in wires:
        for w, wire in enumerate(rnd):
            eng.push_compressed("c", wire, worker_id=w, num_workers=2)
        side.pull(eng, "c")
        out.append(eng.pull_compressed("c", timeout=5))
        assert eng.pull_compressed("c", timeout=5) is out[-1]   # cached
    return out


@pytest.mark.parametrize("codec", list(CODECS))
def test_compressed_pull_wire_matches(codec):
    rng = np.random.RandomState(1)
    wires = [[_jax_wire(CODECS[codec], rng.randn(CNUMEL).astype(np.float32))
              for _ in range(2)] for _ in range(3)]
    got, want = _both(lambda s: _compressed(s, CODECS[codec], wires))
    assert got[:2] == want[:2]
    for g, w in zip(got[2], want[2]):
        assert len(g) == len(w)
        if codec.startswith("onebit"):
            assert g[8:] == w[8:] and g[:4] == w[:4]    # count and words
            np.testing.assert_allclose(np.frombuffer(g[4:8], "<f4"),
                                       np.frombuffer(w[4:8], "<f4"),
                                       rtol=1e-5)
        else:
            assert g == w


def _chaos_round(side, spec):
    if spec:
        side.inj.arm(spec, seed=3)
    eng = side.engine(num_threads=2)
    eng.register_compression("c", CODECS["topk"], CNUMEL)
    rng = np.random.RandomState(2)
    for rnd in range(4):
        for w in range(2):
            eng.push(f"g{rnd % 2}", rng.randn(64).astype(np.float32),
                     worker_id=w, num_workers=2)
            eng.push_compressed("c", _jax_wire(
                CODECS["topk"], rng.randn(CNUMEL).astype(np.float32)),
                worker_id=w, num_workers=2)
        side.pull(eng, f"g{rnd % 2}")
        side.pull(eng, "c")
    side.inj.disarm()


def test_bitflip_at_server_push_is_bit_identical_to_clean():
    clean, clean_j = _both(lambda s: _chaos_round(s, ""))
    got, want = _both(lambda s: _chaos_round(
        s, "bitflip:site=server_push:p=0.3;delay:site=server_pull:p=0.5"))
    assert got == want
    assert got[0] == clean[0] == clean_j[0]
    assert got[1]["integrity.crc_reject"] > 0
    assert got[1]["integrity.retransmit"] > 0
    assert clean[1]["integrity.loopback_fast"] > 0


def test_engine_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        peng.ServerEngine(num_threads=1)


def test_stale_epoch_pushes_are_dropped():
    configure()
    for mod, counters, kw in ((jeng, jcounters, {}),
                              (peng, pcounters, {"device": "cpu"})):
        eng = mod.ServerEngine(num_threads=1, **kw)
        try:
            eng.set_membership_epoch(2)
            eng.push("g", _f(1.0), worker_id=0, num_workers=1, mepoch=1)
            eng.push("g", _f(4.0), worker_id=0, num_workers=1, mepoch=2)
            assert float(np.asarray(eng.pull("g", timeout=5))[0]) == 4.0
        finally:
            eng.shutdown()
        assert counters.get("membership.stale_pushes_dropped") == 1


# -- sharding ---------------------------------------------------------------

KEYS = list(range(0, 1000 * 7919, 7919))[:500] + [f"async.layer{i}.w"
                                                  for i in range(500)]


def test_hash_functions_match():
    for fn in ("hash_naive", "hash_built_in", "hash_djb2", "hash_sdbm"):
        for k in KEYS:
            ik = psh.key_to_int(k)
            assert ik == jsh.key_to_int(k)
            assert getattr(psh, fn)(ik) == getattr(jsh, fn)(ik), (fn, k)


@pytest.mark.parametrize("fn", ["naive", "built_in", "djb2", "sdbm"])
def test_server_assigner_matches(fn):
    kw = dict(fn=fn, mixed_mode=False, bound=101, replicas=3, hot_keys=5)
    p, j = psh.ServerAssigner(7, **kw), jsh.ServerAssigner(7, **kw)
    for i, k in enumerate(KEYS):
        ik = psh.key_to_int(k)
        assert p.assign(ik, i) == j.assign(ik, i)
    for k in KEYS[::37]:
        for _ in range(len(str(k)) % 5 + 1):
            p.record_pull(k, 8)
            j.record_pull(k, 8)
    assert p.hot_keys() == j.hot_keys()
    assert p.rebuild_replicas() == j.rebuild_replicas()
    assert [p.replica_set(k) for k in KEYS[:50]] == [
        j.replica_set(k) for k in KEYS[:50]]
    p.reshard(5)
    j.reshard(5)
    assert [p.write_target(k) for k in KEYS] == [
        j.write_target(k) for k in KEYS]
    assert p.load_bytes == j.load_bytes
    assert p.load_summary() == j.load_summary()


def test_mixed_mode_matches_and_validates():
    p = psh.ServerAssigner(6, fn="djb2", mixed_mode=True, num_workers=4,
                           bound=101, replicas=1, hot_keys=0)
    j = jsh.ServerAssigner(6, fn="djb2", mixed_mode=True, num_workers=4,
                           bound=101, replicas=1, hot_keys=0)
    assert [p.assign(psh.key_to_int(k)) for k in KEYS] == [
        j.assign(jsh.key_to_int(k)) for k in KEYS]
    p.reshard(5, num_workers=3)
    j.reshard(5, num_workers=3)
    assert [p.assign(psh.key_to_int(k)) for k in KEYS] == [
        j.assign(jsh.key_to_int(k)) for k in KEYS]
    for bad in (dict(num_servers=5), dict(num_servers=9, num_workers=3)):
        with pytest.raises(ValueError) as pe:
            p.reshard(**bad)
        with pytest.raises(ValueError) as je:
            j.reshard(**bad)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown hash fn"):
        psh.ServerAssigner(2, fn="md5", mixed_mode=False, bound=101,
                           replicas=1, hot_keys=0)
