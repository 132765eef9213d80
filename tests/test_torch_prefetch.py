"""The port's host-to-device prefetch (``byteps_tpu_torch/utils/
prefetch.py``): the counterparts of ``tests/test_prefetch.py``'s eight
cases, on the CPU (the pinned copies on a side stream are checked on
the card in ``tests/test_torch_cuda.py``).  The loader's rank is a
``CommContext`` built by hand: it reads only the rank, the world size
and the device."""

import threading
import time

import numpy as np
import pytest
import torch

from byteps_tpu_torch.comm.mesh import CommContext
from byteps_tpu_torch.utils.prefetch import (ShardedBatchLoader,
                                             prefetch_to_device)

CPU = torch.device("cpu")


def _batches(n, shape=(8, 4), start=0):
    for i in range(start, start + n):
        yield {"x": np.full(shape, float(i), np.float32),
               "y": np.full((shape[0],), i, np.int32)}


def _comm(size=8, rank=0):
    return CommContext(rank=rank, size=size, local_rank=rank,
                       local_size=size, num_nodes=1, device=CPU,
                       backend="gloo")


def test_prefetch_yields_all_batches_in_order():
    got = list(prefetch_to_device(_batches(5), size=2, device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device == CPU
        np.testing.assert_array_equal(b["y"].numpy(), np.full((8,), i))


def test_prefetch_overlaps_source_latency():
    """With a slow source the consumer sees batches the producer staged
    ahead: the wall time is about max(source, consumer), not the sum."""
    delay = 0.15                # large against scheduler jitter

    def slow():
        for b in _batches(4):
            time.sleep(delay)
            yield b

    t0 = time.perf_counter()
    for _ in prefetch_to_device(slow(), size=2, device="cpu"):
        time.sleep(delay)       # consumer work of the same size
    wall = time.perf_counter() - t0
    # serial ~8 * delay; overlapped ~5 * delay; the bound sits between
    assert wall < 6.8 * delay, f"no overlap: wall={wall:.3f}s"


def test_prefetch_early_exit_releases_producer():
    """Leaving the consumer loop must unblock the producer (it would
    otherwise park in its put for ever, holding staged batches)."""
    produced = []

    def source():
        for b in _batches(100):
            produced.append(1)
            yield b

    it = prefetch_to_device(source(), size=2, device="cpu")
    next(it)
    it.close()                  # what a `break` does, via GeneratorExit
    time.sleep(0.5)
    n_after = len(produced)
    time.sleep(0.3)
    assert len(produced) == n_after, "producer still running after close"
    assert n_after < 100
    assert not any(t.name == "bps-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_loader_rejects_second_pass_over_exhausted_iterator():
    comm = _comm(size=8)
    loader = ShardedBatchLoader(comm, _batches(2, shape=(16, 4)))
    assert len(list(loader)) == 2
    with pytest.raises(ValueError, match="one-shot iterator"):
        list(loader)
    # a re-iterable source supports epoch loops
    data = [{"x": np.zeros((16, 4), np.float32)} for _ in range(2)]
    loader2 = ShardedBatchLoader(comm, data)
    assert len(list(loader2)) == 2
    assert len(list(loader2)) == 2


def test_prefetch_propagates_source_error():
    def bad():
        yield from _batches(2)
        raise RuntimeError("source exploded")

    it = prefetch_to_device(bad(), size=2, device="cpu")
    assert next(it) is not None
    assert next(it) is not None
    with pytest.raises(RuntimeError, match="source exploded"):
        next(it)


def test_sharded_batch_loader():
    """Rank r of 8 gets rows [2r, 2r + 2) of each 16-row batch."""
    for rank in (0, 3, 7):
        loader = ShardedBatchLoader(_comm(size=8, rank=rank),
                                    _batches(3, shape=(16, 4)))
        seen = 0
        for i, b in enumerate(loader):
            seen += 1
            assert b["x"].shape == (2, 4) and b["y"].shape == (2,)
            assert (b["x"] == float(i)).all()
        assert seen == 3
    rows = ShardedBatchLoader(
        _comm(size=4, rank=2),
        [{"x": np.arange(16, dtype=np.float32).reshape(8, 2)}])
    np.testing.assert_array_equal(next(iter(rows))["x"].numpy(),
                                  [[8, 9], [10, 11]])


def test_sharded_batch_loader_rejects_bad_shapes():
    comm = _comm(size=8)
    with pytest.raises(ValueError, match="not divisible"):
        for _ in ShardedBatchLoader(comm, _batches(1, shape=(6, 4))):
            pass

    def changing():
        yield {"x": np.zeros((16, 4), np.float32)}
        yield {"x": np.zeros((16, 8), np.float32)}

    with pytest.raises(ValueError, match="changed mid-stream"):
        for _ in ShardedBatchLoader(comm, changing()):
            pass


def test_loader_feeds_train_step():
    """End to end: loader batches drive the fused step (one gloo rank)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.models.mlp import MLP, softmax_cross_entropy
    from byteps_tpu_torch.parallel import make_dp_train_step, replicate

    bps.init(device="cpu")
    try:
        comm = api.engine().comm
        model = replicate(comm, MLP(4, features=(16, 10)))
        step = make_dp_train_step(
            comm, model, lambda m, b: softmax_cross_entropy(m(b["x"]),
                                                            b["y"]),
            torch.optim.SGD(model.parameters(), lr=0.1))
        n_steps = 0
        for b in ShardedBatchLoader(comm, _batches(4, shape=(16, 4))):
            loss = step(b)
            n_steps += 1
        assert n_steps == 4 and np.isfinite(loss.item())
    finally:
        bps.shutdown()
