"""The port's codecs and decorators against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``byteps_tpu.compression`` and
``byteps_tpu_torch.compression``, three steps with the state threaded,
at a ragged size under 0xFFFF and one over it (dithering's sparse
``idx`` is uint16 below, uint32 above).  Tolerances:

- prng, topk, randomk, dithering with ``max`` normalization and
  Nesterov momentum over randomk: every payload leaf and state bit for
  bit (ties at the k-th place included, which torch.topk alone would
  break another way);
- dithering with ``l2``: the norm is a sum of squares taken in another
  order, so it agrees to rtol 1e-6, and a code may round the other way
  where ``u`` sits on a level: at most 1e-3 of the codes may differ;
  decompressing one payload is bit-exact in both packages;
- onebit under a decorator: words bit for bit, the scale (an L1 sum) to
  rtol 1e-6, as in tests/test_torch_onebit.py;
- PowerSGD: ``P``, ``Q'`` and ``P Q'^T`` to 1e-5 of their max-abs (the
  products and the QR are LAPACK/BLAS on one side and XLA on the other);
- ``golden_error`` of every ladder rung to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
from jax import lax
import pytest
import torch

from byteps_tpu.common import scheduler as jax_scheduler
from byteps_tpu.compression import create as jax_create
from byteps_tpu.compression import elias as jax_elias
from byteps_tpu.compression import prng as jax_prng
from byteps_tpu.compression import registry as jax_registry
from byteps_tpu_torch import native
from byteps_tpu_torch.common import scheduler as port_scheduler
from byteps_tpu_torch.compression import common, elias, prng
from byteps_tpu_torch.compression import registry as port_registry

from .test_golden_vectors import DITHERING_GOLDEN, ONEBIT_SCALE, \
    ONEBIT_WORDS_HEAD, X

NUMELS = [1001, 70000]
STEPS = 3
L2_CODE_SHARE = 1e-3
PSGD_TOL = 1e-5


def _x(numel, seed):
    """randn with exact zeros (ReLU), +-x pairs and a block of equal
    magnitudes, so that magnitudes tie."""
    rng = np.random.RandomState(seed)
    x = rng.randn(numel).astype(np.float32)
    x[rng.rand(numel) < 0.3] = 0.0
    x[:64] = 1.5
    x[64:128] = -1.5
    return x


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _port_leaf(j, p):
    """The port's leaf as the JAX dtype: int16-held uint16 and int32-held
    uint32 as unsigned, the int64 counter as uint32."""
    a = _np(p)
    jd = np.asarray(j).dtype
    if jd == np.uint16:
        return a.view(np.uint16)
    if jd == np.uint32:
        return a.view(np.uint32) if a.dtype == np.int32 else a.astype(
            np.uint32)
    return a


def _to_port(payload):
    """A JAX payload as the port holds it (unsigned leaves as the signed
    views of their bits)."""
    out = {}
    for k, v in payload.items():
        a = np.asarray(v)
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        elif a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a.copy())
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _run(kw, numel, seed=0):
    """Both chains over STEPS steps: [(jax payload, port payload, jax
    state, port state, jax decompress, port decompress)]."""
    j = jax_create(dict(kw), numel)
    p = port_registry.create(dict(kw), numel)
    js, ps = j.init_state(), p.init_state("cpu")
    out = []
    for s in range(STEPS):
        x = _x(numel, seed + s)
        jp, js = j.compress(jnp.asarray(x), js)
        pp, ps = p.compress(torch.from_numpy(x), ps)
        out.append((jp, pp, js, ps, np.asarray(j.decompress(jp)),
                    p.decompress(pp).numpy()))
    return out


def _assert_exact(jt, pt):
    jf, pf = _flat(jt), _flat(pt)
    assert jf.keys() == pf.keys()
    for k in jf:
        np.testing.assert_array_equal(_port_leaf(jf[k], pf[k]),
                                      np.asarray(jf[k]), err_msg=k)


# ------------------------------------------------------------------ prng

@pytest.mark.parametrize("seed,counter,n", [
    (0, 0, 5000), (3, 2**32 - 100, 300), (0xFFFFFFFF, 123456789, 4096),
    (2**31 + 7, 2**32 - 1, 64), (0x9E3779B9, 2**31, 1000)])
def test_prng_bit_exact(seed, counter, n):
    want = np.asarray(jax_prng.uniform(seed, counter, n)).view(np.uint32)
    np.testing.assert_array_equal(jax_prng.uniform_np(seed, counter, n)
                                  .view(np.uint32), want)
    np.testing.assert_array_equal(prng.uniform_np(seed, counter, n)
                                  .view(np.uint32), want)
    got = prng.uniform(seed, counter, n).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    # as a codec's state: a 0-d int64 counter
    got = prng.uniform(seed, torch.tensor(counter, dtype=torch.int64), n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_prng_rounds_to_one_near_the_top():
    """A hash above 2**32 - 2**7 converts to 2**32: the score reads 1.0
    in both packages (round to nearest)."""
    for seed in range(2000):
        a = jax_prng.uniform_np(seed, 0, 4096)
        if (a == 1.0).any():
            break
    else:
        pytest.skip("no hash rounds to 1.0 in the seeds tried")
    got = prng.uniform(seed, 0, 4096).numpy()
    assert (got == 1.0).sum() == (a == 1.0).sum() > 0


# ---------------------------------------------------- topk and randomk

def _lexsort_topk(scores, k, higher_index_first=False):
    idx = np.arange(len(scores))
    order = np.lexsort((-idx if higher_index_first else idx, -scores))
    return order[:k]


@pytest.mark.parametrize("k", [64, 100, 191])
def test_stable_topk_breaks_ties_by_lower_index(k):
    """k falls inside a block of 128 equal magnitudes (64, 100) or of
    zeros (191): the port's indices are lax.top_k's, and a tie-break by
    the higher index differs."""
    x = np.zeros(1000, np.float32)
    x[200:264] = 1.5
    x[500:564] = -1.5
    x[10:73] = 3.0
    idx = common.stable_topk(torch.from_numpy(np.abs(x)), k).numpy()
    _, want = lax.top_k(jnp.abs(jnp.asarray(x)), k)
    np.testing.assert_array_equal(idx, np.asarray(want))
    np.testing.assert_array_equal(idx, _lexsort_topk(np.abs(x), k))
    control = _lexsort_topk(np.abs(x), k, higher_index_first=True)
    assert not np.array_equal(idx, control)


@pytest.mark.parametrize("numel", NUMELS)
@pytest.mark.parametrize("kw", [
    {"compressor": "topk", "k": "0.1"},
    {"compressor": "topk", "k": "100", "ef": "vanilla"},
    {"compressor": "randomk", "k": "0.25", "seed": "5"},
    {"compressor": "randomk", "k": "0.01", "ef": "vanilla"},
], ids=["topk", "topk_ef", "randomk", "randomk_ef"])
def test_sparsifiers_bit_exact(kw, numel):
    for jp, pp, js, ps, jd, pd in _run(kw, numel):
        _assert_exact(jp, pp)
        _assert_exact(js, ps)
        np.testing.assert_array_equal(pd, jd)


def test_randomk_tie_at_the_kth_score():
    """Scores are float32(hash) / 2**32: distinct hashes collide.  With k
    chosen so that the k-th place splits a pair of equal scores, the port
    keeps the JAX index (the lower one)."""
    n = 70000
    scores = prng.uniform_np(0, 0, n)
    vals, counts = np.unique(scores, return_counts=True)
    v = vals[counts >= 2][len(vals[counts >= 2]) // 2]
    k = int((scores > v).sum()) + 1
    x = np.random.RandomState(1).randn(n).astype(np.float32)
    j = jax_create({"compressor": "randomk", "k": str(k)}, n)
    p = port_registry.create({"compressor": "randomk", "k": str(k)}, n)
    jp, _ = j.compress(jnp.asarray(x), j.init_state())
    pp, _ = p.compress(torch.from_numpy(x), p.init_state("cpu"))
    _assert_exact(jp, pp)
    tied = np.flatnonzero(scores == v)
    assert tied[0] in pp["indices"].numpy()
    assert tied[1] not in pp["indices"].numpy()
    control = _lexsort_topk(scores, k, higher_index_first=True)
    assert not np.array_equal(np.asarray(jp["indices"]), control)


# ------------------------------------------------------------- dithering

DITHER_CASES = [(part, norm, sparse) for part in ("linear", "natural")
                for norm in ("max", "l2") for sparse in ("0", "0.05")]


@pytest.mark.parametrize("numel", NUMELS)
@pytest.mark.parametrize("part,norm,sparse", DITHER_CASES,
                         ids=["-".join(c) for c in DITHER_CASES])
def test_dithering_matches_jax(part, norm, sparse, numel):
    kw = {"compressor": "dithering", "k": "16", "partition": part,
          "normalize": norm, "sparse_ratio": sparse, "seed": "2"}
    if sparse != "0":
        kw["ef"] = "vanilla"
    j = jax_create(dict(kw), numel)
    p = port_registry.create(dict(kw), numel)
    for jp, pp, js, ps, jd, pd in _run(kw, numel):
        assert pp.keys() == jp.keys()
        jc, pc = np.asarray(jp["codes"]), pp["codes"].numpy()
        if norm == "max":
            _assert_exact(jp, pp)
            _assert_exact(js, ps)
            np.testing.assert_array_equal(pd, jd)
        else:
            np.testing.assert_allclose(float(pp["norm"]), float(jp["norm"]),
                                       rtol=1e-6)
            assert (pc != jc).mean() <= L2_CODE_SHARE
            if "idx" in jp:
                assert (_port_leaf(jp["idx"], pp["idx"])
                        != np.asarray(jp["idx"])).mean() <= L2_CODE_SHARE
        # one payload decodes to the same bits in both packages
        np.testing.assert_array_equal(p.decompress(_to_port(jp)).numpy(),
                                      np.asarray(j.decompress(jp)))
        if "idx" in pp:
            assert pp["idx"].dtype == (torch.int16 if numel <= 0xFFFF
                                       else torch.int32)
        assert p.payload_nbytes() == j.payload_nbytes()


def test_dithering_sparse_ties_keep_the_lower_index():
    """Nearly every |code| ties in the sparse layout: the kept entries
    are lax.top_k's of the dense codes, which a tie-break by the higher
    index misses."""
    kw = {"compressor": "dithering", "k": "4", "sparse_ratio": "0.1"}
    x = torch.from_numpy(_x(5000, 9))
    j, p = jax_create(dict(kw), 5000), port_registry.create(dict(kw), 5000)
    jp, _ = j.compress(jnp.asarray(x.numpy()), j.init_state())
    pp, _ = p.compress(x, p.init_state("cpu"))
    _assert_exact(jp, pp)
    dense = port_registry.create({"compressor": "dithering", "k": "4"}, 5000)
    codes = dense.compress(x, dense.init_state("cpu"))[0]["codes"].numpy()
    mags = np.abs(codes.astype(np.int64))
    assert (mags > 0).sum() > p.sparse_k      # the k-th place ties
    want = np.asarray(jp["idx"]).astype(np.int64)
    np.testing.assert_array_equal(_lexsort_topk(mags, p.sparse_k), want)
    control = _lexsort_topk(mags, p.sparse_k, higher_index_first=True)
    assert not np.array_equal(control, want)


@pytest.mark.parametrize("case", list(DITHERING_GOLDEN))
def test_dithering_golden_vectors(case):
    """tests/test_golden_vectors.py's frozen dithering codes."""
    partition, normalize = case
    codes, norm = DITHERING_GOLDEN[case]
    p = port_registry.create(
        {"compressor": "dithering", "partition_num": "4",
         "partition": partition, "normalize": normalize, "seed": "3"},
        len(X))
    pp, _ = p.compress(torch.from_numpy(X), p.init_state("cpu"))
    np.testing.assert_array_equal(pp["codes"].numpy(),
                                  np.asarray(codes, np.int8))
    np.testing.assert_allclose(float(pp["norm"]), norm, rtol=1e-6)


def test_onebit_golden_vector():
    p = port_registry.create({"compressor": "onebit", "scaling": "true"},
                             len(X))
    pp, _ = p.compress(torch.from_numpy(X), {})
    words = pp["words"].numpy().view(np.uint32)
    np.testing.assert_array_equal(words[:32], ONEBIT_WORDS_HEAD)
    assert (words[32:] == 0xFFFFFFFF).all()
    np.testing.assert_allclose(float(pp["scale"]), ONEBIT_SCALE, rtol=1e-6)


# -------------------------------------------------------------- powersgd

def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


@pytest.mark.parametrize("numel", NUMELS + [300000])
@pytest.mark.parametrize("kw", [{"compressor": "powersgd", "rank": "4"},
                                {"compressor": "powersgd", "rank": "2",
                                 "iters": "2", "ef": "vanilla"}],
                         ids=["rank4", "rank2_iters2_ef"])
def test_powersgd_matches_jax(kw, numel):
    j = jax_create(dict(kw), numel)
    p = port_registry.create(dict(kw), numel)
    assert (p.inner if "ef" in kw else p).n == (j.inner if "ef" in kw
                                                else j).n
    assert not p.bidirectional and p.payload_nbytes() == j.payload_nbytes()
    np.testing.assert_array_equal(_flat(p.init_state("cpu"))[
        "inner/q" if "ef" in kw else "q"].numpy(), np.asarray(
            _flat(j.init_state())["inner/q" if "ef" in kw else "q"]))
    for jp, pp, js, ps, jd, pd in _run(kw, numel):
        for k in ("p", "q"):
            assert _rel(pp[k].numpy(), jp[k]) <= PSGD_TOL, k
        assert _rel(pd, jd) <= PSGD_TOL
        for k, v in _flat(js).items():
            assert _rel(_flat(ps)[k].numpy(), v) <= PSGD_TOL, k
        g = {k: torch.stack([pp[k], pp[k] * 0.5]) for k in pp}
        jg = {k: jnp.stack([jp[k], jp[k] * 0.5]) for k in jp}
        assert _rel(p.decompress_sum(g).numpy(),
                    j.decompress_sum(jg)) <= PSGD_TOL


# -------------------------------------------------------------- nesterov

@pytest.mark.parametrize("numel", NUMELS)
@pytest.mark.parametrize("inner", ["onebit", "randomk"])
def test_nesterov_matches_jax(inner, numel):
    kw = {"compressor": inner, "k": "0.1", "ef": "vanilla",
          "momentum": "nesterov", "momentum_mu": "0.8"}
    for jp, pp, js, ps, jd, pd in _run(kw, numel):
        if inner == "randomk":
            _assert_exact(jp, pp)
            _assert_exact(js, ps)
            np.testing.assert_array_equal(pd, jd)
            continue
        np.testing.assert_array_equal(_port_leaf(jp["words"], pp["words"]),
                                      np.asarray(jp["words"]))
        np.testing.assert_allclose(float(pp["scale"]), float(jp["scale"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(ps["momentum"].numpy(),
                                   np.asarray(js["momentum"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(pd, jd, rtol=1e-6)
    server = port_registry.create(dict(kw), 100, for_server=True)
    assert server.name == "error_feedback"      # momentum is worker-only


# ----------------------------------------------------------------- elias

def _codes(n, seed, density=0.1):
    rng = np.random.RandomState(seed)
    c = rng.randint(-127, 128, size=n) * (rng.rand(n) < density)
    return c.astype(np.int8)


@pytest.mark.parametrize("n,density", [(1, 1.0), (1000, 0.0), (5000, 0.1),
                                       (70000, 0.02), (300, 1.0)])
def test_elias_frames_byte_identical(n, density):
    codes = _codes(n, n, density)
    norm = 0.37 * n
    frame = elias.encode_wire(codes, norm)
    assert frame == jax_elias.encode_wire(codes, norm)
    words, nbits = elias.elias_encode(codes)
    twin = elias.elias_encode_np(codes)
    np.testing.assert_array_equal(words, twin[0])
    assert nbits == twin[1]
    for decode in (elias.decode_wire, jax_elias.decode_wire):
        got, got_norm = decode(frame, expected_numel=n)
        np.testing.assert_array_equal(got, codes)
        assert got_norm == np.float32(norm)
    np.testing.assert_array_equal(elias.elias_decode(words, nbits, n),
                                  elias.elias_decode_np(words, nbits, n))
    assert elias.wire_nbytes(codes) == len(frame)


def test_elias_rejects_forged_and_malformed_frames():
    codes = _codes(500, 3)
    frame = elias.encode_wire(codes, 1.0)
    with pytest.raises(ValueError, match="numel 500 != expected 499"):
        elias.decode_wire(frame, expected_numel=499)
    forged = (np.array([2**20], "<u4").tobytes() + frame[4:])
    with pytest.raises(ValueError, match="truncated"):
        elias.decode_wire(forged, expected_numel=500)
    with pytest.raises(ValueError, match="shorter than its header"):
        elias.decode_wire(frame[:8])
    # a level of 0 in the stream: the native decoder refuses it
    bad = np.zeros(1, np.uint32)
    bad[0] = 0b1 | (0b0 << 1) | (0b1 << 2)      # gap 1, sign 0, then junk
    with pytest.raises(ValueError, match="malformed"):
        elias.elias_decode(bad, 32, 10)


@pytest.mark.parametrize("kw", [
    {"compressor": "dithering", "k": "8"},
    {"compressor": "dithering", "k": "8", "sparse_ratio": "0.2",
     "ef": "vanilla"}], ids=["dense", "sparse"])
def test_dithering_wire_frames_cross_decode(kw):
    x = _x(3000, 4)
    j, p = jax_create(dict(kw), 3000), port_registry.create(dict(kw), 3000)
    jp, _ = j.compress(jnp.asarray(x), j.init_state())
    pp, _ = p.compress(torch.from_numpy(x), p.init_state("cpu"))
    frame = p.wire_encode(pp)
    assert frame == j.wire_encode(jp)
    assert p.wire_nbytes(pp) == j.wire_nbytes(jp) == len(frame)
    np.testing.assert_array_equal(
        p.decompress(p.wire_decode(frame)).numpy(),
        np.asarray(j.decompress(j.wire_decode(frame))))
    with pytest.raises(ValueError, match="expected 2999"):
        port_registry.create(dict(kw), 2999).wire_decode(frame)


def test_generic_wire_frame_round_trips():
    kw = {"compressor": "topk", "k": "10"}
    p = port_registry.create(kw, 500)
    pp, _ = p.compress(torch.from_numpy(_x(500, 1)), {})
    back = p.wire_decode(p.wire_encode(pp))
    for k in pp:
        assert torch.equal(back[k], pp[k])
    assert p.wire_nbytes(pp) == len(p.wire_encode(pp))


def test_native_coder_is_the_ports_own_library():
    lib = native.load()
    assert lib.bps_native_abi_version() == native.ABI_VERSION == 3
    assert native.library_path().parent == native.BUILD_DIR


# ------------------------------------------------------ golden and registry

@pytest.mark.parametrize("rung", [k for k, kw in
                                  port_scheduler.COMPRESS_LADDER if kw])
def test_golden_error_matches_jax(rung):
    kw = dict(port_scheduler.COMPRESS_LADDER)[rung]
    assert kw == dict(jax_scheduler.COMPRESS_LADDER)[rung]
    np.testing.assert_allclose(port_registry.golden_error(kw),
                               jax_registry.golden_error(kw), rtol=1e-5)
    assert port_registry.golden_error(None) == 0.0
    assert (port_registry.GOLDEN_NUMEL, port_registry.GOLDEN_STEPS) == (
        jax_registry.GOLDEN_NUMEL, jax_registry.GOLDEN_STEPS)


def test_registry_builds_the_jax_chains():
    for kw in [{"compressor": "topk", "ef": "vanilla",
                "momentum": "nesterov"},
               {"compressor": "dithering", "sparse_ratio": "0.1"},
               {"compressor": "powersgd", "ef": "1"},
               {"compressor": "randomk", "ef": "off"}]:
        for server in (False, True):
            j = jax_create(dict(kw), 1000, for_server=server)
            p = port_registry.create(dict(kw), 1000, for_server=server)
            chain = []
            while True:
                assert p.name == j.name
                chain.append(p.name)
                if not hasattr(j, "inner"):
                    break
                j, p = j.inner, p.inner
            assert p.bidirectional == j.bidirectional
    assert port_registry._EF_ON == jax_registry._EF_ON
    assert port_registry._EF_OFF == jax_registry._EF_OFF
    assert port_registry._MOMENTUM_ON == jax_registry._MOMENTUM_ON


def test_registry_error_messages():
    with pytest.raises(ValueError, match="unknown momentum 'heavy'"):
        port_registry.create({"compressor": "onebit", "momentum": "heavy"},
                             100)
    with pytest.raises(ValueError, match="unknown ef 'yes'"):
        port_registry.validate_kwargs({"compressor": "topk", "ef": "yes"})
    with pytest.raises(ValueError, match=r"invalid compression kwargs .*"
                       r"k=0 out of range"):
        port_registry.validate_kwargs({"compressor": "topk", "k": "0"})
    with pytest.raises(ValueError, match="invalid compression kwargs .*"
                       "rank"):
        port_registry.validate_kwargs({"compressor": "powersgd",
                                       "rank": "four"})
    with pytest.raises(ValueError, match="s must be in"):
        port_registry.validate_kwargs({"compressor": "dithering",
                                       "k": "200"})
    assert common.resolve_k(0.01, 1000) == 10
    assert common.resolve_k(7, 1000) == 7


def test_cache_key_names_the_configuration():
    """Equal configurations have equal keys, and each parameter that
    changes the codec's function changes its key, decorators included."""
    def key(kw, numel=1000):
        return port_registry.create(dict(kw), numel).cache_key()

    base = {"compressor": "dithering", "k": "8", "sparse_ratio": "0.1"}
    assert key(base) == key(dict(base))
    for change in ({"k": "4"}, {"partition": "natural"},
                   {"normalize": "l2"}, {"seed": "1"},
                   {"sparse_ratio": "0.2"}, {"ef": "vanilla"},
                   {"momentum": "nesterov"}):
        assert key(base) != key({**base, **change}), change
    assert key({"compressor": "topk", "k": "7"}) != key(
        {"compressor": "topk", "k": "8"})
    assert key({"compressor": "powersgd", "rank": "2"}) != key(
        {"compressor": "powersgd", "rank": "4"})
    assert key(base, 1000) != key(base, 1001)
