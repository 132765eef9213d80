"""Parity of the port's integrity layer with the JAX package's
(``common/integrity.py``, ``common/retry.py``, ``native.crc32c``).

Frames are a wire format both packages must read, so they are compared
byte for byte: every dtype the envelope names, several shapes and the
0-d case, sealed by either package and opened by the other.  CRC32C is
the native core's, held against a plain bitwise table (the reference's
polynomial, written out here) and the JAX package's backend.  Every
single-bit flip of a small frame is rejected by both.  A bf16 tensor is
refused with a ValueError (numpy names no bf16 dtype; the JAX package
cannot seal one either).  ``screen_nonfinite`` and ``RetryPolicy``'s
backoff schedule agree exactly.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.common import integrity as ji
from byteps_tpu.common.retry import RetryPolicy as JRetry
from byteps_tpu.common.telemetry import counters as jcounters
from byteps_tpu_torch import native
from byteps_tpu_torch.common import integrity as pi
from byteps_tpu_torch.common.retry import RetryPolicy as PRetry
from byteps_tpu_torch.common.telemetry import counters as pcounters

from .torch_ps_common import configure, counter_values
from .torch_ps_common import fresh_ps_state  # noqa: F401 — autouse


def crc32c_plain(data: bytes, crc: int = 0) -> int:
    """Bitwise CRC32C, reflected Castagnoli polynomial 0x82F63B78."""
    c = ~crc & 0xFFFFFFFF
    for b in bytes(data):
        c ^= b
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
    return ~c & 0xFFFFFFFF


def test_crc32c_check_value_and_continuation():
    data = np.random.RandomState(0).bytes(1037)
    assert native.crc32c(b"123456789") == pi.CHECK == 0xE3069283
    assert crc32c_plain(b"123456789") == 0xE3069283
    want = crc32c_plain(data)
    assert pi.crc32c(data) == ji.crc32c(data) == want
    for cut in (0, 1, 7, 8, 513, 1036, 1037):
        part = pi.crc32c(data[:cut])
        assert pi.crc32c(data[cut:], part) == want
        assert ji.crc32c(data[cut:], ji.crc32c(data[:cut])) == want
    # unaligned start and a memoryview over array memory, without a copy
    arr = np.frombuffer(data, np.uint8)
    assert pi.crc32c(memoryview(arr[3:])) == crc32c_plain(data[3:])
    assert pi.crc32c(b"") == 0


SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4)]
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_frames_are_byte_equal(dtype, shape):
    rng = np.random.RandomState(10 * SHAPES.index(shape)
                                + DTYPES.index(dtype))
    a = np.asarray(rng.randn(*shape) * 100).astype(dtype)
    kw = dict(key="w.conv1", seq=17, worker=3)
    jf = ji.seal_array(a, **kw)
    assert pi.seal_array(a, **kw) == jf
    assert pi.seal_array(torch.from_numpy(np.array(a)), **kw) == jf
    got, meta = pi.open_array(jf)
    back, jmeta = ji.open_array(pi.seal_array(a, **kw))
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(back, a)
    assert (meta.key, meta.worker, meta.seq) == ("w.conv1", 3, 17)
    assert (meta.key, meta.worker, meta.seq, meta.shape) == (
        jmeta.key, jmeta.worker, jmeta.seq, jmeta.shape)


def test_byte_frames_are_byte_equal():
    data = np.random.RandomState(1).bytes(300)
    for kw in (dict(key="k", seq=0, worker=-1), dict(key="λ", seq=9,
                                                    worker=2)):
        assert pi.seal_bytes(data, **kw) == ji.seal_bytes(data, **kw)
        assert pi.open_bytes(ji.seal_bytes(data, **kw))[0] == data


def test_every_single_bit_flip_is_rejected_by_both():
    frame = pi.seal_array(np.arange(3, dtype=np.float32), key="k", seq=5,
                          worker=1)
    assert frame == ji.seal_array(np.arange(3, dtype=np.float32), key="k",
                                  seq=5, worker=1)
    buf = bytearray(frame)
    for bit in range(len(buf) * 8):
        buf[bit // 8] ^= 1 << (bit % 8)
        bad = bytes(buf)
        buf[bit // 8] ^= 1 << (bit % 8)
        with pytest.raises(pi.IntegrityError):
            pi.open_frame(bad)
        with pytest.raises(ji.IntegrityError):
            ji.open_frame(bad)


def test_truncated_and_kind_mismatched_frames_are_rejected():
    frame = pi.seal_bytes(b"abc", key="k")
    for bad in (frame[:10], frame[:-1], b"XXXX" + frame[4:]):
        with pytest.raises(pi.IntegrityError):
            pi.open_frame(bad)
    with pytest.raises(pi.IntegrityError, match="ndarray frame"):
        pi.open_array(frame)


def test_bf16_is_refused_by_both():
    with pytest.raises(ValueError, match="bfloat16"):
        pi.seal_array(torch.ones(4, dtype=torch.bfloat16), key="k")
    with pytest.raises(ValueError):
        ji.seal_array(np.asarray(jnp.ones(4, jnp.bfloat16)), key="k")


def _screen_inputs():
    a = np.array([1.0, np.nan, -np.inf, 4.0, np.inf], np.float32)
    return a, np.arange(4, dtype=np.int32), np.ones(3, np.float64)


@pytest.mark.parametrize("policy", ["raise", "skip", "zero"])
def test_screen_nonfinite_policies_agree(policy):
    configure(nonfinite_policy=policy)
    bad, ints, good = _screen_inputs()
    for arr in (ints, good):
        assert pi.screen_nonfinite(arr, what="delta", key="k",
                                   worker=1) is arr
        assert pi.screen_nonfinite(torch.from_numpy(arr), what="delta",
                                   key="k", worker=1) is not None
    if policy == "raise":
        with pytest.raises(ValueError, match="worker 2") as pe:
            pi.screen_nonfinite(bad, what="delta", key="k", worker=2)
        with pytest.raises(ValueError, match="worker 2") as je:
            ji.screen_nonfinite(bad, what="delta", key="k", worker=2)
        assert str(pe.value) == str(je.value)
    else:
        got_t = pi.screen_nonfinite(torch.from_numpy(bad.copy()),
                                    what="delta", key="k", worker=2)
        pcounters.reset()       # the parity below counts one call each
        got = pi.screen_nonfinite(bad, what="delta", key="k", worker=2)
        want = ji.screen_nonfinite(bad, what="delta", key="k", worker=2)
        if policy == "skip":
            assert got is None and got_t is None and want is None
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got_t.numpy(), want)
    assert counter_values(pcounters) == counter_values(jcounters)


@pytest.mark.parametrize("base,cap", [(0.1, 2.0), (0.05, 0.3), (1.0, 10.0)])
def test_retry_backoff_schedules_are_equal(base, cap):
    pr = PRetry(max_attempts=12, base_delay_s=base, max_delay_s=cap,
                rng=random.Random(7))
    jr = JRetry(max_attempts=12, base_delay_s=base, max_delay_s=cap,
                rng=random.Random(7))
    assert [pr.backoff(k) for k in range(1, 12)] == [
        jr.backoff(k) for k in range(1, 12)]

    def run(policy_cls, counters):
        slept = []
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 4:
                raise ConnectionError("transient")
            return calls["n"]

        policy = policy_cls(max_attempts=5, base_delay_s=base,
                            max_delay_s=cap, rng=random.Random(3),
                            sleep=slept.append)
        out = policy.call(flaky)
        with pytest.raises(ConnectionError):
            policy_cls(max_attempts=2, base_delay_s=base, max_delay_s=cap,
                       rng=random.Random(3), sleep=slept.append).call(
                lambda: (_ for _ in ()).throw(ConnectionError("down")))
        return out, slept, counter_values(counters)

    assert run(PRetry, pcounters) == run(JRetry, jcounters)


def test_retry_deadline_and_validation():
    with pytest.raises(ValueError):
        PRetry(max_attempts=0)
    slept = []
    policy = PRetry(max_attempts=50, base_delay_s=1.0, max_delay_s=1.0,
                    deadline_s=0.0, rng=random.Random(0), sleep=slept.append)
    with pytest.raises(KeyError):
        policy.call(lambda: {}["missing"])
    assert slept == []
