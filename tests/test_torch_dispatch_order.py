"""Root-ordered dispatch at more than one rank (core/root_order.py),
against the JAX engine's priority order.

The JAX engine issues paused pushes in priority order (earlier-declared
first) on its CPU mesh.  The port's ranks, joined over gloo, must issue
the same order on every rank: the root decides it and announces it, the
followers take it.  A control run with the engine's former rule
(enqueue order) must fail that check.

Under skew (rank 1 sleeps between its pushes) nothing deadlocks, with
the Python and with the native scheduler on the root, and the results
are bit-equal to an unskewed run and equal to the numpy mean (inputs are
multiples of 1/64, so every mean over 2 or 4 ranks is exact).  The
onebit all-gather and the sharded update (reduce-scatter, slot step,
all-gather, and the parts fallback) are bit-equal under skew too.  The
membership-epoch verdict is the root's; suspend/resume reconnects; a
follower's shutdown while it waits for the root returns at once.

The queues themselves are also driven in process, over a store of the
test process.

Each rendezvous is bound by rank 0 on a port the system picks at the
bind (``torch_order_worker._rendezvous``); a failed check prints every
rank's output.
"""

import collections
import contextlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from torch.distributed import TCPStore

from byteps_tpu_torch.common.scheduler import ChunkScheduler
from byteps_tpu_torch.common.types import ChunkTask
from byteps_tpu_torch.core.root_order import (FollowerOrder, LeaderOrder,
                                              store_client)

from . import torch_order_worker as W

CASES_2 = ("order", "control", "skew_py", "skew_native", "even",
           "paths_skew", "paths_even", "epoch", "suspend", "shutdown_wait")
CASES_4 = ("order", "control", "skew_py", "skew_native", "even")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("order"))
    out = {}

    def go(world, cases):
        out[world] = W.spawn(world, cases, tmp)

    ts = [threading.Thread(target=go, args=a)
          for a in ((2, CASES_2), (4, CASES_4))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert set(out) == {2, 4}, "a world failed (see the log above)"
    return out


@pytest.fixture(scope="module")
def jax_order():
    """The order the JAX engine issues K paused pushes made in reverse
    declared order, on its CPU mesh."""
    import byteps_tpu as jbps
    from byteps_tpu.common.config import Config as JaxConfig
    from byteps_tpu.common.config import set_config as jax_set_config
    from byteps_tpu.core import api as jax_api

    jax_set_config(JaxConfig(group_size=1, telemetry_on=False))
    jbps.init()
    try:
        eng = jax_api._engine
        issued = []
        for attr in ("_dispatch_single", "_dispatch_parts_group",
                     "_dispatch_buffer_run"):
            real = getattr(eng, attr)

            def rec(arg, _real=real):
                unit = arg if isinstance(arg, list) else [arg]
                issued.extend(t.name for t in unit)
                return _real(arg)

            setattr(eng, attr, rec)
        names = [f"t{i}" for i in range(W.K)]
        for n in names:
            eng.declare_tensor(n, (W.ORDER_N,), np.float32)
        eng.pause_dispatch()
        rows = [W.rows(10 + i, 8, W.ORDER_N) for i in range(W.K)]
        hs = [eng.push_pull_async(rows[i], names[i])
              for i in reversed(range(W.K))]
        eng.resume_dispatch()
        for h in hs:
            h.wait()
    finally:
        jbps.shutdown()
    return issued


def _order_ok(issued, want):
    return list(issued) == list(want)


@contextlib.contextmanager
def _explained(ranks):
    """A failed check inside carries every rank's output."""
    try:
        yield
    except AssertionError as e:
        logs = "\n".join(f"--- rank {r}:\n{str(res['log'])[-3000:]}"
                         for r, res in enumerate(ranks))
        raise AssertionError(f"{e}\n{logs}") from None


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_issues_the_jax_priority_order(runs, jax_order, world):
    assert jax_order == [f"t{i}" for i in range(W.K)]
    with _explained(runs[world]):
        for res in runs[world]:
            assert _order_ok(res["order/issued"], jax_order), \
                res["order/issued"]
            # the root popped the six paused tasks at once: one
            # announcement
            assert int(res["order/order_msgs"]) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_enqueue_order_control_fails_the_check(runs, jax_order, world):
    with _explained(runs[world]):
        for res in runs[world]:
            issued = list(res["control/issued"])
            assert issued == [f"t{i}" for i in reversed(range(W.K))]
            assert not _order_ok(issued, jax_order)


@pytest.mark.parametrize("sched", ["skew_py", "skew_native"])
@pytest.mark.parametrize("world", [2, 4])
def test_skew_keeps_one_order_and_the_exact_mean(runs, world, sched):
    with _explained(runs[world]):
        _skew_checks(runs[world], world, sched)


def _skew_checks(ranks, world, sched):
    issued0 = list(ranks[0][f"{sched}/issued"])
    assert len(issued0) == W.STEPS * sum(
        -(-n * 4 // 4096) for n in W.SKEW_SIZES)
    for res in ranks:
        assert list(res[f"{sched}/issued"]) == issued0
        for s in range(W.STEPS):
            for i, n in enumerate(W.SKEW_SIZES):
                got = res[f"{sched}/{s}/{i}"]
                even = res[f"even/{s}/{i}"]
                assert np.array_equal(got.view(np.int32),
                                      even.view(np.int32)), (s, i)
                want = W.rows(100 * s + i, world, n).mean(0)
                np.testing.assert_array_equal(got, want)
    # the slow follower waited for chunks the root announced before it
    # had them; the order took fewer messages than chunks (the worker's
    # _announced_first makes both sure under any load)
    assert float(ranks[1][f"{sched}/order_wait_ms"]) > 0
    for res in ranks:
        assert 0 < int(res[f"{sched}/order_msgs"]) < len(issued0)


def test_onebit_and_sharded_update_bit_equal_under_skew(runs):
    with _explained(runs[2]):
        for res in runs[2]:
            keys = [k.split("/", 1)[1] for k in res
                    if k.startswith("paths_even/")]
            assert len(keys) == 2 * 5
            for k in keys:
                a, b = res[f"paths_skew/{k}"], res[f"paths_even/{k}"]
                assert np.array_equal(a.view(np.int32), b.view(np.int32)), k
        r0, r1 = runs[2]
        for k in r0:
            if k.startswith("paths_"):
                assert np.array_equal(r0[k], r1[k]), k


def test_epoch_verdict_is_the_roots(runs):
    with _explained(runs[2]):
        for res in runs[2]:
            assert "stale membership epoch" in str(res["epoch/stale_error"])
            np.testing.assert_array_equal(res["epoch/after"],
                                          W.rows(501, 2, 64).mean(0))
            # the dropped chunk was never issued; the next push was
            assert list(res["epoch/issued"]) == ["e"]


def test_suspend_resume_reconnects_the_order(runs):
    with _explained(runs[2]):
        for res in runs[2]:
            np.testing.assert_array_equal(res["suspend/0"],
                                          W.rows(600, 2, 2000).mean(0))
            np.testing.assert_array_equal(res["suspend/1"],
                                          W.rows(601, 2, 2000).mean(0))
            assert res["suspend/keys"][0] == res["suspend/keys"][1]


def test_follower_shutdown_while_waiting(runs):
    with _explained(runs[2]):
        res = runs[2][1]
        assert float(res["shutdown_wait/shutdown_s"]) < 5
        assert str(res["shutdown_wait/status"]) == "ABORTED"


def test_a_port_taken_before_the_bind_is_never_joined(tmp_path,
                                                      monkeypatch):
    """Another process's store listens on the port a harness would have
    picked ahead of the bind (the pick-then-bind gap of a loaded host):
    the world still comes up on a store of its own, gives the right
    order, and writes nothing into the other store."""
    foreign = TCPStore("127.0.0.1", 0, is_master=True,
                       wait_for_workers=False)
    foreign.set("foreign", "1")
    # The harness before the repair picked its ports with free_ports and
    # handed them to every rank: this patch gave them the taken port, and
    # the world then failed to come up.  The harness now picks no port
    # ahead, so nothing reads the patch; it stays so that the case runs
    # the old harness's failure as it stood.
    monkeypatch.setattr(W, "free_ports",
                        lambda n: [str(foreign.port)] * n, raising=False)
    ranks = W.spawn(2, ("order",), str(tmp_path))
    with _explained(ranks):
        for res in ranks:
            assert list(res["order/issued"]) == [f"t{i}"
                                                 for i in range(W.K)]
            assert f"port {foreign.port} " not in str(res["log"])
        assert foreign.num_keys() == 1


@pytest.mark.parametrize("world_of_store", ["this", "another"])
def test_a_follower_joins_only_its_own_worlds_store(tmp_path, monkeypatch,
                                                    world_of_store):
    """A follower reads rank 0's port from the world's file and joins
    only a store that carries the world's token: a store of another
    world's (a stale file, a port reused) is refused, never joined."""
    token = "w" + world_of_store
    store = TCPStore("127.0.0.1", 0, is_master=True,
                     wait_for_workers=False)
    store.set("order_world", "wthis")
    (tmp_path / f"{token}.case.port").write_text(str(store.port))
    monkeypatch.setenv("ORDER_WORLD", token)
    monkeypatch.setenv("ORDER_DIR", str(tmp_path))
    monkeypatch.setenv("BYTEPS_LOCAL_RANK", "1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "0")
    if world_of_store == "this":
        W._rendezvous("case", timeout=5.0)
        assert os.environ["DMLC_PS_ROOT_PORT"] == str(store.port)
    else:
        with pytest.raises(RuntimeError, match="another world's"):
            W._rendezvous("case", timeout=5.0)
        assert os.environ["DMLC_PS_ROOT_PORT"] == "0"


# ------------------------------------------------------------- in process

@pytest.fixture
def store_addr():
    """A store server of this process (the rendezvous's stands in)."""
    master = TCPStore("127.0.0.1", 0, is_master=True,
                      wait_for_workers=False)
    yield f"127.0.0.1:{master.port}"
    del master


def _task(name, part=0, prio=0, key=None, nbytes=4):
    return ChunkTask(name=name, key=part if key is None else key,
                     priority=prio, offset_elems=0, num_elems=1,
                     nbytes=nbytes, data=torch.zeros(1), t_enqueue=time.time())


def _stats():
    return {"order_msgs": 0, "order_send_ms": 0.0, "order_wait_ms": 0.0,
            "order_lag_ms": 0.0}


def _follower(addr, rank=1, prefix="t/", followers=1):
    stats = _stats()
    return FollowerOrder(store_client(addr, prefix), rank, followers, stats,
                         lambda: store_client(addr, prefix)), stats


def test_follower_waits_for_a_key_it_lacks(store_addr):
    f, stats = _follower(store_addr)
    try:
        f.announce([("b", 0, False), ("a", 0, False)])
        f.add_task(_task("a"))
        assert f.get_task(block=False) is None      # "b" heads the order
        got = []
        th = threading.Thread(target=lambda: got.append(
            f.get_task(block=True)))
        th.start()
        time.sleep(0.2)
        f.add_task(_task("b"))
        th.join(5)
        assert [t.name for t in got] == ["b"]
        assert f.get_task(block=True).name == "a"
        assert stats["order_wait_ms"] >= 100
    finally:
        f.close()


def test_follower_wakes_on_interrupt_and_shutdown(store_addr):
    f, _ = _follower(store_addr)
    try:
        f.announce([("x", 0, False)])
        f.interrupt()
        assert f.get_task(block=True) is None        # the pause handshake
        got = []
        th = threading.Thread(target=lambda: got.append(
            f.get_task(block=True)))
        th.start()
        time.sleep(0.1)
        f.wake()
        th.join(5)
        assert got == [None] and not th.is_alive()
        f.add_task(_task("y"))
        assert [t.name for t in f.drain()] == ["y"] and f.pending == 0
    finally:
        t0 = time.monotonic()
        f.close()
        # the receiver, blocked in the store's wait, is ended at once
        assert time.monotonic() - t0 < 5 and not f._rx.is_alive()


def test_follower_takes_two_pushes_of_one_name_in_enqueue_order(store_addr):
    f, _ = _follower(store_addr)
    try:
        first, second = _task("w", 1), _task("w", 1)
        f.add_task(first)
        f.add_task(second)
        f.announce([("w", 1, False), ("w", 1, True)])
        assert f.get_task() is first and first.order_stale is False
        assert f.get_task() is second and second.order_stale is True
    finally:
        f.close()


def test_leader_announces_each_popped_batch_in_one_message(store_addr):
    stats = _stats()
    lead = LeaderOrder(ChunkScheduler(), store_client(store_addr, "t/"),
                       stats, lambda t: False)
    follows = [_follower(store_addr, r, followers=2) for r in (1, 2)]
    try:
        for i in range(4):
            lead.add_task(_task(f"t{i}", prio=-i, key=i << 16))
            for f, _ in follows:
                f.add_task(_task(f"t{i}", key=i << 16))
        order = [lead.get_task(block=True).name for _ in range(4)]
        assert order == ["t0", "t1", "t2", "t3"] and stats["order_msgs"] == 1
        for f, fstats in follows:
            assert [f.get_task(block=True, timeout=5).name
                    for _ in range(4)] == order
            assert fstats["order_msgs"] == 1
        lead.close()
        for f, _ in follows:
            f._rx.join(5)
            assert not f._rx.is_alive()      # the root's end of the stream
    finally:
        for f, _ in follows:
            f.close()


def test_follower_counts_its_wait_for_an_announcement_as_lag(store_addr):
    f, stats = _follower(store_addr)
    try:
        # nothing held and nothing announced: idle, not counted
        assert f.get_task(block=True, timeout=0.15) is None
        assert stats["order_lag_ms"] == stats["order_wait_ms"] == 0
        f.add_task(_task("a"))
        got = []
        th = threading.Thread(target=lambda: got.append(
            f.get_task(block=True)))
        th.start()
        time.sleep(0.2)
        f.announce([("a", 0, False)])
        th.join(5)
        assert [t.name for t in got] == ["a"]
        assert stats["order_lag_ms"] >= 100 and stats["order_wait_ms"] == 0
    finally:
        f.close()


class _CountingStore:
    """A store that counts the calls made through it."""

    def __init__(self, store):
        self._store = store
        self.calls = collections.Counter()

    def __getattr__(self, name):
        self.calls[name] += 1
        return getattr(self._store, name)


def test_leader_writes_an_announcement_once_and_the_last_reader_drops_it(
        store_addr):
    stats = _stats()
    root = _CountingStore(store_client(store_addr, "t/"))
    lead = LeaderOrder(ChunkScheduler(), root, stats, lambda t: False)
    follows = [_follower(store_addr, r, followers=3) for r in (1, 2, 3)]
    try:
        for i in range(3):
            lead.add_task(_task(f"t{i}", prio=-i, key=i << 16))
            for f, _ in follows:
                f.add_task(_task(f"t{i}", key=i << 16))
        order = [lead.get_task(block=True).name for _ in range(3)]
        # one write for three followers
        assert root.calls == {"compare_set": 1} and stats["order_send_ms"] > 0
        for f, _ in follows:
            assert [f.get_task(block=True, timeout=5).name
                    for _ in range(3)] == order
        view = store_client(store_addr, "t/")
        end = time.monotonic() + 5
        while view.check(["0"]) and time.monotonic() < end:
            time.sleep(0.01)
        assert not view.check(["0"]) and not view.check(["ack/0"])
    finally:
        lead.close()
        for f, _ in follows:
            f.close()


def test_a_follower_that_shuts_down_first_leaves_the_others_the_order(
        store_addr):
    stats = _stats()
    lead = LeaderOrder(ChunkScheduler(), store_client(store_addr, "t/"),
                       stats, lambda t: False)
    (early, _), (late, lstats) = [_follower(store_addr, r, followers=2)
                                  for r in (1, 2)]
    try:
        early.close()                   # claims the next key with its end
        assert not early._rx.is_alive()
        for i in range(2):
            lead.add_task(_task(f"t{i}", prio=-i, key=i << 16))
            late.add_task(_task(f"t{i}", key=i << 16))
        order = [lead.get_task(block=True).name for _ in range(2)]
        assert [late.get_task(block=True, timeout=5).name
                for _ in range(2)] == order == ["t0", "t1"]
        assert lstats["order_msgs"] == 1
        lead.close()
        late._rx.join(5)
        assert not late._rx.is_alive()
    finally:
        late.close()


@pytest.mark.parametrize("world", [2, 4])
def test_the_workers_own_check_passes(runs, world):
    """The check the card run uses (``--spawn cuda ... --check``) finds
    nothing on gloo."""
    with _explained(runs[world]):
        assert W.check(runs[world], world) == []
