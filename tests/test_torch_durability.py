"""The port's durable state plane (``byteps_tpu_torch/server/wal.py`` and
the ``KVStore`` journal hooks), held against the JAX package's
(``tests/test_durability.py``): the journal's record format and replay
state machine, torn tails, bit flips, mid-log corruption, the LSN
advance past a restored cut, the chaos sites (``disk_full`` as
``ENOSPC``, ``wal_write``, ``fsync``), atomic snapshot cuts, the
restricted unpickler (it refuses a pickled torch tensor), and the
interop the formats promise: a durable directory written by either
package's store, from the same seeded operations, recovers in the other
to equal values (bit for bit), versions, dedup floors, generation and
membership epoch.  A writer process SIGKILLed mid-stream recovers every
acknowledged push, and a replayed token is absorbed by the rebuilt dedup
floor."""

from __future__ import annotations

import dataclasses
import errno
import os
import pickle
import signal
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from byteps_tpu.common import config as jcfg
from byteps_tpu.server import wal as jwal
from byteps_tpu.server.kv_store import KVStore as JKVStore
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common import integrity
from byteps_tpu_torch.common.telemetry import counters, gauges
from byteps_tpu_torch.fault import injector as inj
from byteps_tpu_torch.server import wal
from byteps_tpu_torch.server.kv_store import KVStore
from byteps_tpu_torch.server.serving import SnapshotStore

from .torch_fault_common import REPO, child_env, fresh_fault_state  # noqa: F401

WORKER = os.path.join(REPO, "tests", "torch_durable_worker.py")


def _cfg(**over):
    return dataclasses.replace(pcfg.get_config(), **over)


def _mk_store(dirpath, n=8, **over):
    store = KVStore(device="cpu")
    dur = wal.attach(store, str(dirpath), cfg=_cfg(**over))
    store.init_key("w", np.zeros(n, np.float32))
    return store, dur


def _value(store, key):
    v = store.pull(key)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _state(store):
    """Everything a recovery must restore, comparable across packages."""
    keys = sorted(store.keys())
    return {"values": {k: _value(store, k).tobytes() for k in keys},
            "shapes": {k: _value(store, k).shape for k in keys},
            "versions": dict(store._versions),
            "seen": dict(store._seen),
            "generation": store._generation,
            "epoch": store._membership_epoch}


# -- the journal --------------------------------------------------------------


def test_wal_roundtrip_records_and_lsn_sequence(tmp_path):
    log = wal.WriteAheadLog(str(tmp_path))
    assert log.replay() == ([], {"records": 0, "bytes": 0,
                                 "truncated_tails": 0, "corrupt_records": 0,
                                 "dropped_segments": 0})
    a = np.arange(4, dtype=np.float32)
    assert log.append("init", ("k", a)) == 1
    assert log.append("delta", ("k", a, 0, 1)) == 2
    assert log.append("epoch", 3) == 3
    assert log.lsn == 3
    log.close()
    log2 = wal.WriteAheadLog(str(tmp_path))
    recs, stats = log2.replay()
    assert [(lsn, kind) for lsn, kind, _ in recs] == [
        (1, "init"), (2, "delta"), (3, "epoch")]
    np.testing.assert_array_equal(recs[0][2][1], a)
    assert stats["records"] == 3 and stats["truncated_tails"] == 0
    assert log2.append("epoch", 4) == 4
    log2.close()
    with pytest.raises(RuntimeError, match="before replay"):
        wal.WriteAheadLog(str(tmp_path / "fresh")).append("epoch", 1)


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_wal_segments_read_by_the_other_package(tmp_path, writer, reader):
    """The segment files are the JAX package's byte for byte: the same
    appends make the same files, and each package replays the other's
    records (multi-segment, with an ``advance_to`` marker)."""
    mods = {"port": wal, "jax": jwal}
    rng = np.random.default_rng(11)
    recs_in = [("init", ("k", rng.standard_normal(5).astype(np.float32))),
               ("delta", ("k", rng.standard_normal(5).astype(np.float32),
                          1, 7)),
               ("epoch", 2), ("clear", (1, 2)),
               ("publish", ("p", np.arange(6, dtype=np.int64)))]
    dirs = {}
    for who in ("port", "jax"):
        d = tmp_path / who
        log = mods[who].WriteAheadLog(str(d), segment_bytes=4096)
        log.replay()
        for i in range(12):
            for kind, data in recs_in:
                log.append(kind, data)
            if i == 6:
                log.advance_to(log.lsn + 5)
        log.close()
        dirs[who] = d
    for (_, p), (_, j) in zip(wal.WriteAheadLog(str(dirs["port"]))
                              .segments(),
                              jwal.WriteAheadLog(str(dirs["jax"]))
                              .segments()):
        assert open(p, "rb").read() == open(j, "rb").read()
    log = mods[reader].WriteAheadLog(str(dirs[writer]))
    recs, stats = log.replay()
    log.close()
    assert stats["corrupt_records"] == 0 and stats["truncated_tails"] == 0
    assert len(recs) == 12 * len(recs_in) + 1
    body = [r for r in recs if r[1] != "__advance__"]
    for i, (lsn, kind, data) in enumerate(body):
        want_kind, want = recs_in[i % len(recs_in)]
        assert kind == want_kind
        if kind in ("init", "publish"):
            assert data[0] == want[0]
            np.testing.assert_array_equal(data[1], want[1])
        elif kind == "delta":
            assert data[0] == want[0] and data[2:] == want[2:]
            np.testing.assert_array_equal(data[1], want[1])
        else:
            assert data == want


def test_wal_torn_tail_truncated_and_appends_resume(tmp_path):
    log = wal.WriteAheadLog(str(tmp_path))
    log.replay()
    for i in range(1, 6):
        log.append("epoch", i)
    log.close()
    seg = log.segments()[-1][1]
    good_size = os.path.getsize(seg)
    with open(seg, "ab") as fh:
        fh.write(b"\x00\x00\x01\x00" + b"\xde\xad")
    log2 = wal.WriteAheadLog(str(tmp_path))
    recs, stats = log2.replay()
    assert [r[0] for r in recs] == [1, 2, 3, 4, 5]
    assert stats["truncated_tails"] == 1 and stats["corrupt_records"] == 0
    assert os.path.getsize(seg) == good_size
    assert log2.append("epoch", 6) == 6
    log2.close()
    recs, stats = wal.WriteAheadLog(str(tmp_path)).replay()
    assert [r[0] for r in recs] == [1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("where", ["first", "last"])
def test_wal_bit_flip_truncates_at_the_flipped_record(tmp_path, where):
    """A flipped bit in the first segment is mid-log corruption (later
    segments are discarded); in the last it is a torn tail.  Either way
    replay stops at the record and trusts nothing after it."""
    log = wal.WriteAheadLog(str(tmp_path), segment_bytes=256)
    log.replay()
    for i in range(1, 30):
        log.append("epoch", i)
    log.close()
    segs = log.segments()
    assert len(segs) >= 3
    path = segs[0][1] if where == "first" else segs[-1][1]
    with open(path, "r+b") as fh:
        fh.seek(10)
        b = fh.read(1)
        fh.seek(10)
        fh.write(bytes([b[0] ^ 0x40]))
    before = counters.get("wal.dropped_segments")
    log2 = wal.WriteAheadLog(str(tmp_path))
    recs, stats = log2.replay()
    log2.close()
    if where == "first":
        assert recs == [] and stats["corrupt_records"] == 1
        assert stats["dropped_segments"] == len(segs) - 1
        assert counters.get("wal.dropped_segments") - before \
            == len(segs) - 1
        assert len(log2.segments()) <= 1
    else:
        assert stats["truncated_tails"] == 1
        assert [r[0] for r in recs] == list(range(1, segs[-1][0]))


def test_wal_segment_roll_and_truncate_upto(tmp_path):
    log = wal.WriteAheadLog(str(tmp_path), segment_bytes=256)
    log.replay()
    for i in range(1, 40):
        log.append("epoch", i)
    segs = log.segments()
    assert len(segs) >= 4
    assert log.truncate_upto(segs[2][0] - 1) == 2
    assert log.segments()[0][0] == segs[2][0]
    log.close()
    recs, stats = wal.WriteAheadLog(str(tmp_path)).replay()
    assert recs[0][0] == segs[2][0] and recs[-1][0] == 39
    assert stats["corrupt_records"] == 0


def test_wal_corruption_below_cut_advances_past_it(tmp_path):
    """A corrupt record below the snapshot cut truncates the journal to
    an LSN the cut covers: recovery advances past it (a sealed
    ``__advance__`` marker), so post-restart pushes survive the next
    restart, and the JAX package replays the advanced journal to the
    same state."""
    store, dur = _mk_store(tmp_path, wal_segment_bytes=4096)
    for seq in range(1, 25):
        store.push_delta("w", np.full(8, 0.5, np.float32), worker_id=0,
                         seq=seq)
    assert dur.checkpoint(force=True)
    snap_lsn = dur.wal.lsn
    want_cut = _state(store)
    dur.close()
    segs = dur.wal.segments()
    with open(segs[0][1], "r+b") as fh:
        fh.seek(8)
        b = fh.read(1)
        fh.seek(8)
        fh.write(bytes([b[0] ^ 0x20]))
    store2, stats = wal.recover(str(tmp_path), device="cpu")
    assert stats["had_snapshot"] == 1
    assert stats.get("advanced_to", 0) > snap_lsn
    assert _state(store2) == want_cut
    store2.push_delta("w", np.full(8, 2.0, np.float32), worker_id=0,
                      seq=25)
    store2.push_delta("w", np.full(8, 3.0, np.float32), worker_id=1,
                      seq=1)
    want = _state(store2)
    store2._durable.close()
    store3, _ = wal.recover(str(tmp_path), device="cpu")
    assert _state(store3) == want
    store3._durable.close()
    jstore, _ = jwal.recover(str(tmp_path))
    assert _state(jstore) == want
    jstore._durable.close()


# -- chaos sites --------------------------------------------------------------


@pytest.mark.integrity
def test_wal_disk_full_is_enospc_and_leaves_the_store_untouched(tmp_path):
    store, dur = _mk_store(tmp_path)
    store.push_delta("w", np.ones(8, np.float32), worker_id=0, seq=1)
    v = _value(store, "w").copy()
    inj.arm("drop:site=disk_full:p=1", seed=1, rank=0)
    before = counters.get("wal.disk_full_errors")
    with pytest.raises(OSError) as e:
        store.push_delta("w", np.ones(8, np.float32), worker_id=0, seq=2)
    inj.disarm()
    assert e.value.errno == errno.ENOSPC
    assert counters.get("wal.disk_full_errors") == before + 1
    np.testing.assert_array_equal(_value(store, "w"), v)
    assert store._seen[("w", 0)] == 1
    store.push_delta("w", np.ones(8, np.float32), worker_id=0, seq=2)
    np.testing.assert_array_equal(_value(store, "w"), v + 1.0)
    dur.close()


def test_wal_torn_write_and_bitflip_recover_to_last_durable_point(tmp_path):
    for spec, seed, raises in (("drop:site=wal_write:p=1", 2, True),
                               ("bitflip:site=wal_write:p=1", 3, False)):
        d = tmp_path / spec.split(":")[0]
        store, dur = _mk_store(d)
        store.push_delta("w", np.ones(8, np.float32), worker_id=0, seq=1)
        want = _state(store)
        inj.arm(spec, seed=seed, rank=0)
        if raises:
            with pytest.raises(OSError):
                store.push_delta("w", np.ones(8, np.float32), worker_id=0,
                                 seq=2)
        else:
            store.push_delta("w", np.ones(8, np.float32), worker_id=0,
                             seq=2)
        inj.disarm()
        dur.close()
        store2, stats = wal.recover(str(d), device="cpu")
        assert stats["truncated_tails"] == 1
        assert _state(store2) == want
        store2._durable.close()


FSYNC_INTERVAL_S = 3600.0


def _clock_past_interval(monkeypatch, module):
    """Give ``module`` (either package's ``wal``) a ``time`` whose
    monotonic clock reads two intervals past the real one.  A log starts
    with ``_last_sync = 0.0``, so its first ``interval`` fsync waits until
    the monotonic clock passes the interval: on a host up for less than
    ``FSYNC_INTERVAL_S`` the real clock would see no fsync at all
    (ROADMAP Queue C 30, the reference's rule)."""
    real = module.time

    class _Clock:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def monotonic():
            return real.monotonic() + 2 * FSYNC_INTERVAL_S

    monkeypatch.setattr(module, "time", _Clock())


def _count_fsyncs(module, counters_, dirpath, policy):
    """fsyncs of three appends through ``module.WriteAheadLog``."""
    before = counters_.get("wal.fsyncs")
    log = module.WriteAheadLog(str(dirpath), fsync=policy,
                               fsync_interval_s=FSYNC_INTERVAL_S)
    log.replay()
    for i in range(1, 4):
        log.append("epoch", i)
    synced = counters_.get("wal.fsyncs") - before
    log.close()
    return synced


def test_wal_interval_fsync_counts_match_jax(tmp_path, monkeypatch):
    """The same appends under the same patched clock fsync as often in
    both packages, for every policy."""
    from byteps_tpu.common.telemetry import counters as jcounters
    _clock_past_interval(monkeypatch, wal)
    _clock_past_interval(monkeypatch, jwal)
    for policy in ("always", "interval", "off"):
        got = _count_fsyncs(wal, counters, tmp_path / f"p_{policy}", policy)
        want = _count_fsyncs(jwal, jcounters, tmp_path / f"j_{policy}",
                             policy)
        assert got == want == {"always": 3, "interval": 1, "off": 0}[policy]


def test_wal_fsync_policies_and_dropped_fsync(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="wal_fsync"):
        pcfg.Config(wal_fsync="sometimes")
    _clock_past_interval(monkeypatch, wal)
    for policy in ("always", "interval", "off"):
        d = tmp_path / policy
        before = counters.get("wal.fsyncs")
        log = wal.WriteAheadLog(str(d), fsync=policy,
                                fsync_interval_s=FSYNC_INTERVAL_S)
        log.replay()
        for i in range(1, 4):
            log.append("epoch", i)
        synced = counters.get("wal.fsyncs") - before
        assert synced == {"always": 3, "interval": 1, "off": 0}[policy]
        log.close()
        recs, _ = wal.WriteAheadLog(str(d)).replay()
        assert [r[0] for r in recs] == [1, 2, 3]
    inj.arm("drop:site=fsync:p=1", seed=4, rank=0)
    store, dur = _mk_store(tmp_path / "dropped")
    before = counters.get("wal.fsync_dropped")
    store.push_delta("w", np.ones(8, np.float32), worker_id=0, seq=1)
    assert counters.get("wal.fsync_dropped") > before
    want = _state(store)
    inj.disarm()
    dur.close()
    store2, _ = wal.recover(str(tmp_path / "dropped"), device="cpu")
    assert _state(store2) == want


# -- snapshots and the restricted unpickler -----------------------------------


def test_snapshot_retention_manifest_and_corrupt_fallback(tmp_path):
    d = str(tmp_path)
    for lsn in (5, 9, 14):
        wal.save_snapshot(d, {"arrays": {}, "versions": {"w": lsn},
                              "generation": 1, "epoch": 0, "seen": {}},
                          lsn=lsn, generation=1, retain=2)
    state, lsn = wal.load_snapshot(d)
    assert lsn == 14 and state["versions"] == {"w": 14}
    assert sum(n.endswith(".bin") for n in os.listdir(d)) == 2
    # the JAX package loads the port's cut
    jstate, jlsn = jwal.load_snapshot(d)
    assert jlsn == 14 and jstate == state
    newest = os.path.join(d, f"kv-snap-{14:016d}.bin")
    blob = bytearray(open(newest, "rb").read())
    blob[len(blob) // 2] ^= 0x5A
    open(newest, "wb").write(bytes(blob))
    before = counters.get("wal.snapshot_corrupt")
    state, lsn = wal.load_snapshot(d)
    assert lsn == 9 and counters.get("wal.snapshot_corrupt") == before + 1


def test_restricted_unpickler_refuses_torch_tensors_and_foreign_globals(
        tmp_path):
    """The allowlist is numpy and builtins: a pickled torch tensor (what
    a journal must never hold) and an ``os.system`` gadget are both
    refused at the unpickle, and replay classes such a record as
    corruption, never resolving the global."""
    pwned = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {pwned}",))

    for obj in (torch.arange(3.0), Evil()):
        with pytest.raises(pickle.UnpicklingError, match="allowlist"):
            wal._loads(pickle.dumps(obj))
        with pytest.raises(pickle.UnpicklingError, match="allowlist"):
            jwal._loads(pickle.dumps(obj))
    state = {"arrays": {"w": np.arange(3, dtype=np.float32)},
             "seen": {("w", 0): 2}, "generation": 1}
    out = wal._loads(pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL))
    np.testing.assert_array_equal(out["arrays"]["w"], state["arrays"]["w"])
    assert out["seen"] == state["seen"]
    payload = pickle.dumps((1, "delta", ("w", torch.ones(2), 0, 1)),
                           protocol=pickle.HIGHEST_PROTOCOL)
    frame = integrity.seal_bytes(payload, key="wal", seq=1)
    with open(tmp_path / f"kv-{1:016d}.wal", "wb") as fh:
        fh.write(wal._LEN.pack(len(frame)) + frame)
    recs, stats = wal.WriteAheadLog(str(tmp_path)).replay()
    assert recs == [] and stats["truncated_tails"] == 1
    assert not pwned.exists()


def test_journal_records_hold_numpy_never_torch(tmp_path):
    """What the store journals is numpy and builtins: every record the
    port's store writes (init, delta, publish, epoch, clear) passes the
    restricted unpickler, and a delta pushed as a torch tensor is
    journaled as its numpy bytes."""
    store, dur = _mk_store(tmp_path)
    store.push_delta("w", torch.full((8,), 0.5), worker_id=3, seq=9)
    store.publish_key("p", torch.arange(4, dtype=torch.int32))
    store.set_membership_epoch(2)
    store.clear()
    dur.close()
    recs, stats = wal.WriteAheadLog(str(tmp_path)).replay()
    assert stats["corrupt_records"] == stats["truncated_tails"] == 0
    assert [k for _, k, _ in recs] == ["init", "delta", "publish",
                                       "epoch", "clear"]
    delta = recs[1][2]
    assert isinstance(delta[1], np.ndarray) and delta[2:] == (3, 9)
    np.testing.assert_array_equal(delta[1], np.full(8, 0.5, np.float32))


# -- the KVStore coupling, across packages ------------------------------------


def _seeded_ops(store, dur, seed):
    """The same mutations through either package's store: a clear, two
    workers' token-stamped deltas, an epoch, a cut mid-way, a publish,
    and deltas after the cut (replayed from the journal)."""
    rng = np.random.default_rng(seed)
    store.init_key("a", rng.standard_normal(16).astype(np.float32))
    store.push_delta("a", rng.standard_normal(16).astype(np.float32),
                     worker_id=0, seq=1)
    store.clear()
    store.init_key("a", rng.standard_normal(16).astype(np.float32))
    store.init_key("b", rng.standard_normal((3, 7)).astype(np.float32))
    store.set_membership_epoch(2)
    for seq in range(1, 6):
        for w in (0, 1):
            for k, shape in (("a", (16,)), ("b", (3, 7))):
                store.push_delta(k, rng.standard_normal(shape)
                                 .astype(np.float32),
                                 mepoch=2, worker_id=w, seq=seq)
        if seq == 3:
            assert dur.checkpoint() is True
    store.publish_key("c", rng.standard_normal(5).astype(np.float32))
    store.push_delta("a", rng.standard_normal(16).astype(np.float32),
                     mepoch=2, worker_id=0, seq=6)


@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port"),
                                           ("jax", "jax")])
def test_durable_dir_recovers_in_either_package(tmp_path, writer, reader):
    """A durable directory written by either package's store recovers in
    the other to equal state: values bit for bit, versions, dedup
    floors, generation and membership epoch; the rebuilt floor absorbs
    a replayed token."""
    if writer == "port":
        store = KVStore(device="cpu")
        dur = wal.attach(store, str(tmp_path), cfg=_cfg())
    else:
        store = JKVStore()
        dur = jwal.attach(store, str(tmp_path), cfg=jcfg.get_config())
    _seeded_ops(store, dur, seed=23)
    want = _state(store)
    dur.close()
    if reader == "port":
        got, stats = wal.recover(str(tmp_path), device="cpu")
    else:
        got, stats = jwal.recover(str(tmp_path))
    assert stats["had_snapshot"] == 1 and stats["applied"] >= 3
    assert _state(got) == want
    assert want["generation"] == 1 and want["epoch"] == 2
    before = _value(got, "a").copy()
    got.push_delta("a", np.full(16, 9.0, np.float32), mepoch=2,
                   worker_id=0, seq=6)
    np.testing.assert_array_equal(_value(got, "a"), before)
    got._durable.close()


def test_snapshotstore_cut_checkpoints_and_truncates(tmp_path):
    store, dur = _mk_store(tmp_path, wal_segment_bytes=4096)
    snapstore = SnapshotStore(store, retention=4)
    try:
        for seq in range(1, 40):
            store.push_delta("w", np.full(8, 0.5, np.float32),
                             worker_id=0, seq=seq)
        lag = dur.wal.lag_bytes()
        before = counters.get("wal.snapshot_saves")
        snapstore.cut()
        assert counters.get("wal.snapshot_saves") == before + 1
        assert dur.wal.lag_bytes() < lag
        assert gauges.get("wal.last_snapshot_lsn") == dur.wal.lsn
    finally:
        snapstore.detach()
        dur.close()
    store2, stats = wal.recover(str(tmp_path), device="cpu")
    assert stats["had_snapshot"] == 1 and _state(store2) == _state(store)
    store2._durable.close()


# -- a killed writer ----------------------------------------------------------


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_sigkilled_writer_recovers_every_acknowledged_push(tmp_path,
                                                           reader):
    """A writer process SIGKILLed mid-stream: every key recovers to its
    last acknowledged state, or to the one push in flight at the kill
    (journaled before the merge, so possibly durable), never older; the
    last acknowledged token is absorbed when replayed."""
    proc = subprocess.Popen([sys.executable, WORKER, str(tmp_path), "5"],
                            env=child_env(), cwd=REPO,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        acks = 0
        while acks < 40:
            line = proc.stdout.readline()
            assert line, "".join(lines[-20:])
            lines.append(line)
            acks += line.startswith("ACK ")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        lines += proc.stdout.readlines()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    acked, inflight, will = {}, {}, {}
    last_tok = {}
    for ln in lines:
        parts = ln.split()
        if len(parts) != {"WILL": 6, "ACK": 4}.get(parts[0] if parts
                                                   else "", -1):
            continue    # the line the kill cut short, or another
        if parts[:1] == ["WILL"]:
            key, w, seq, ver, crc = parts[1], int(parts[2]), \
                int(parts[3]), int(parts[4]), int(parts[5])
            will[(key, w, seq)] = (ver, crc)
            inflight[key] = (ver, crc)
        elif parts[:1] == ["ACK"]:
            key, w, seq = parts[1], int(parts[2]), int(parts[3])
            acked[key] = will[(key, w, seq)]
            last_tok[key] = (w, seq)
            inflight.pop(key, None)
    assert set(acked) == {"a", "b"}
    if reader == "port":
        store, stats = wal.recover(str(tmp_path), device="cpu")
    else:
        store, stats = jwal.recover(str(tmp_path))
    for key, (ver, crc) in acked.items():
        got = (store.version(key), zlib.crc32(np.ascontiguousarray(
            _value(store, key), np.float32).tobytes()))
        assert got == (ver, crc) or got == inflight.get(key), \
            (key, got, (ver, crc), inflight.get(key))
        w, seq = last_tok[key]
        assert store._seen[(key, w)] >= seq
        before = _value(store, key).copy()
        store.push_delta(key, np.ones(before.shape, np.float32),
                         worker_id=w, seq=seq)
        np.testing.assert_array_equal(_value(store, key), before)
    store._durable.close()


# -- init() and the recovery coordinator --------------------------------------


def test_init_opens_the_durable_process_store(tmp_path, monkeypatch):
    """``BYTEPS_DURABLE_DIR`` makes ``init()`` open the process-lifetime
    store under ``<dir>/trainer`` on the engine's device; a second
    incarnation after shutdown recovers what the first journaled, and
    ``/healthz`` carries the journal's line."""
    from byteps_tpu_torch.common import obs_server
    from byteps_tpu_torch.core import api
    monkeypatch.setenv("BYTEPS_DURABLE_DIR", str(tmp_path))
    api.init(device="cpu")
    try:
        store = api.durable_kv_store()
        assert store is not None and store.device.type == "cpu"
        store.init_key("w", np.zeros(4, np.float32))
        store.push_delta("w", np.ones(4, np.float32), worker_id=0, seq=1)
        doc = obs_server.healthz()
        mine = store._durable.debug_state()
        assert mine["lsn"] == 2
        assert {"lsn": 2, "fsync": mine["fsync"], "checkpoint_lsn": 0,
                "lag_bytes": mine["lag_bytes"]} in doc["wal"]
        assert doc["omitted"] == []
    finally:
        api.shutdown()
    wal._reset_for_tests()
    store2, dur2 = wal.ensure_process_store(pcfg.Config.from_env(),
                                            device="cpu")
    np.testing.assert_array_equal(_value(store2, "w"), np.ones(4))
    assert dur2.recover_stats["applied"] == 2


@pytest.mark.parametrize("survivor", [False, True])
def test_recovery_coordinator_durable_probe(tmp_path, monkeypatch,
                                            survivor):
    """The probe runs before suspend: a process whose durable store is
    not open (its incarnation is gone) rebuilds it from disk
    (``recovery.durable_restore``); a survivor keeps its live store and
    hardens the tail (``recovery.durable_kept``).
    ``RecoveryResult.durable`` carries the journal's statistics."""
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.fault.recovery import RecoveryCoordinator
    monkeypatch.setenv("BYTEPS_DURABLE_DIR", str(tmp_path))
    monkeypatch.setenv("BYTEPS_HEARTBEAT_ON", "0")
    api.init(device="cpu")          # opens the process store
    try:
        live = api.durable_kv_store()
        live.init_key("w", np.zeros(4, np.float32))
        live.push_delta("w", np.full(4, 2.0, np.float32), worker_id=0,
                        seq=1)
        if not survivor:
            wal._reset_for_tests()  # this incarnation's store is gone
        result = RecoveryCoordinator().recover({1})
        assert result.durable is not None
        # the survivor's stats are its open-time recovery (an empty dir)
        assert result.durable["applied"] == (0 if survivor else 2)
        name = "recovery.durable_kept" if survivor else \
            "recovery.durable_restore"
        assert counters.get(name) == 1
        got = api.durable_kv_store()
        assert (got is live) == survivor
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(_value(got, "w"), np.full(4, 2.0))
        got.push_delta("w", np.ones(4, np.float32), worker_id=0, seq=2)
        np.testing.assert_array_equal(_value(got, "w"), np.full(4, 3.0))
    finally:
        api.shutdown()
