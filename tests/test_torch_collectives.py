"""The port's collectives, compressed push_pull and engine across gloo
processes, against numpy and the JAX package's codecs.

Three layouts: one node of two ranks (the hierarchical path's
reduce-scatter and all-gather, with ``n % local_size != 0`` padding),
two nodes of one (its cross-node all-reduce), and two nodes of two (both
levels, on separate process groups).  Rank r contributes row r of seeded
numpy arrays (tests/torch_collectives_worker.py).

Every codec of the registry (and Nesterov momentum) goes through the
compressed push_pull; its gathered payload leaves, which cross the wire
as bytes, are compared leaf by leaf with the JAX codec's.

Tolerances: all-reduces are exact (the inputs are chosen so that every
f32 sum is exact in any order, and the port accumulates f16/bf16 in f32
as the reference does); payload leaves are bit-exact except the sums
taken in another order: onebit's first-level scales and dithering's L2
norms to rtol 1e-6, PowerSGD's P and Q to 1e-5 of their max-abs; values
after the server's re-compression to rtol 1e-5, because XLA's CPU
reduction of the padded (32, L) merged chunk is itself off by up to
~3e-6 of an f64 sum at 5000 elements (the port's torch sum by ~1e-7),
and PowerSGD's merged sum to 1e-5 of its max-abs.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from byteps_tpu.common.partitioner import chunk_bounds
from byteps_tpu.compression import create as jax_create

from . import torch_collectives_worker as W

LAYOUTS = ("node_of_2", "2_nodes", "2x2")
NP_DTYPES = {"float32": np.float32, "float16": np.float16,
             "bfloat16": ml_dtypes.bfloat16}


def _world(layout):
    hosts, local = W.LAYOUTS[layout]
    return hosts * local


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every layout's ranks, layouts run at once: {layout: [npz by rank]}."""
    tmp = str(tmp_path_factory.mktemp("torch_collectives"))
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futures = {name: pool.submit(W.spawn, name, "cpu", tmp)
                   for name in LAYOUTS}
        outs = {name: f.result() for name, f in futures.items()}
    return {name: [dict(np.load(o)) for o in files]
            for name, files in outs.items()}


def _expected_all_reduce(R, i, dname, op):
    xs = W.rows(100 + i, R, W.N_ELEMS).astype(NP_DTYPES[dname])
    acc = xs.astype(np.float32).sum(0)
    if op == "average":
        acc = acc / np.float32(R)
    return acc.astype(NP_DTYPES[dname]).astype(np.float32)


@pytest.mark.parametrize("op", ["sum", "average"])
@pytest.mark.parametrize("dname", list(W.DTYPES))
@pytest.mark.parametrize("kind", ["flat", "hier"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_all_reduce(results, layout, kind, dname, op):
    R = _world(layout)
    i = list(W.DTYPES).index(dname)
    want = _expected_all_reduce(R, i, dname, op)
    for rank in range(R):
        got = results[layout][rank][f"{kind}/{dname}/{op}"]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_broadcast(results, layout):
    R = _world(layout)
    want = W.rows(200, R, 64)[R - 1]
    for rank in range(R):
        np.testing.assert_array_equal(results[layout][rank]["broadcast"],
                                      want)


def _jax_codec_run(R, kw, numel, steps_rows):
    """The JAX codec calls: compress each rank's row -> stack ->
    decompress_sum -> (a bidirectional codec) compress -> decompress,
    state threaded over steps.  Per step: the gathered payload leaves in
    the payload's key order, and the result."""
    workers = [jax_create(dict(kw), numel) for _ in range(R)]
    server = jax_create(dict(kw), numel, for_server=True)
    wst = [w.init_state() for w in workers]
    sst = server.init_state()
    outs = []
    for xs in steps_rows:
        payloads = []
        for r in range(R):
            p, wst[r] = workers[r].compress(jnp.asarray(xs[r]), wst[r])
            payloads.append(p)
        gathered = {k: jnp.stack([p[k] for p in payloads])
                    for k in payloads[0]}
        y = workers[0].decompress_sum(gathered).astype(jnp.float32)
        if server.bidirectional:
            p2, sst = server.compress(y, sst)
            y = server.decompress(p2)
        outs.append(([(k, np.asarray(v)) for k, v in gathered.items()],
                     np.asarray(y)))
    return outs


# leaves that are sums taken in another order: onebit's L1 scale and
# dithering's L2 norm to rtol 1e-6; every other leaf is bit-exact, but
# PowerSGD's P and Q (products and a QR of BLAS/LAPACK against XLA),
# held, like its result, to PSGD_TOL of their max-abs
LEAF_RTOL = {"scale": 1e-6, "norm": 1e-6}
PSGD_TOL = 1e-5


def _close_to_max(got, want, tol, what):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err} of the max-abs"


def _as_jax_dtype(got, want):
    if want.dtype in (np.uint16, np.uint32):
        return got.view(want.dtype)
    return got


@pytest.mark.parametrize("codec", list(W.CODECS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_compressed_push_pull_matches_jax_codec(results, layout, codec):
    R = _world(layout)
    steps = [W.rows(300 + s, R, W.CODEC_NUMEL)
             for s in range(W.CODEC_STEPS)]
    ref = _jax_codec_run(R, W.CODECS[codec], W.CODEC_NUMEL, steps)
    for rank in range(R):
        res = results[layout][rank]
        for s, (leaves, out) in enumerate(ref):
            assert f"codec/{codec}/{s}/g{len(leaves)}" not in res
            for i, (name, want) in enumerate(leaves):
                got = _as_jax_dtype(res[f"codec/{codec}/{s}/g{i}"], want)
                assert got.shape == want.shape, name
                if codec == "powersgd":
                    _close_to_max(got, want, PSGD_TOL, name)
                elif name in LEAF_RTOL:
                    np.testing.assert_allclose(got, want,
                                               rtol=LEAF_RTOL[name],
                                               err_msg=name)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=name)
            got = res[f"codec/{codec}/{s}/out"]
            if codec == "powersgd":
                _close_to_max(got, out, PSGD_TOL, "out")
            else:
                np.testing.assert_allclose(got, out, rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_engine_push_pull(results, layout):
    """Several multi-chunk tensors in flight: a compressed average, an
    uncompressed average and an int32 sum, two steps (error feedback
    carries across them)."""
    R = _world(layout)
    kw = W.CODECS["onebit_ef"]
    bounds = chunk_bounds(3000, 4, 4096)
    a_steps = [W.rows(400 + s, R, 3000) for s in range(2)]
    a_ref = []
    per_chunk = [_jax_codec_run(R, kw, ln, [x[:, off:off + ln]
                                         for x in a_steps])
                 for off, ln in bounds]
    for s in range(2):
        a_ref.append(np.concatenate([c[s][1] for c in per_chunk]) / R)
    for rank in range(R):
        res = results[layout][rank]
        np.testing.assert_array_equal(res["engine/chunks"], [3, 3, 1])
        for s in range(2):
            np.testing.assert_allclose(res[f"engine/a/{s}"].reshape(-1),
                                       a_ref[s], rtol=1e-5)
            b = W.rows(500 + s, R, 2500)
            np.testing.assert_array_equal(res[f"engine/b/{s}"],
                                          b.sum(0) * np.float32(1 / R))
            np.testing.assert_array_equal(
                res[f"engine/c/{s}"],
                np.arange(12, dtype=np.int32) * (R * (R + 1) // 2))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_engine_dispatches_one_chunk_per_collective(results, layout):
    """At more than one rank, under the default group size (4) and with
    autotune on, every collective carries one chunk (the engine's two
    steps of the three tensors above: 2 x (3 + 3 + 1) chunks) and the
    planner is inert."""
    for res in results[layout]:
        assert res["engine/stats"].tolist() == [14, 14]
        assert not res["engine/planner_active"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ranks_receive_identical_results(results, layout):
    r0, *others = results[layout]
    for r in others:
        assert r0.keys() == r.keys()
        for k in r0:
            np.testing.assert_array_equal(r0[k], r[k], err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_update_and_zero(results, layout):
    """The worker's sharded-update case (SGD with momentum and Adam on a
    ragged multi-chunk tensor, an even one and a small one) equals the
    replicated update and the optimizer on the exact averages, bit for
    bit; its ZeRO-1 and FSDP steps ("all", and "ici" across two nodes)
    equal replicated data parallelism with AdamW to rtol 1e-5 (the ranks'
    gradients of the MLP are summed in another order)."""
    from . import torch_sharded_worker as SW
    R = _world(layout)
    _, want_params = SW.replicated_mlp(
        R, SW.ZERO_STEPS, lambda ps: torch.optim.AdamW(ps, **SW.ZERO_ADAMW))
    axes = ("all", "ici") if W.LAYOUTS[layout][0] > 1 else ("all",)
    for res in results[layout]:
        for opt in W.SHARDED_OPTIMIZERS:
            for t, n in W.SHARDED_TENSORS.items():
                want = SW.replay(opt, SW.init_param(7, n),
                                 SW.exact_averages(opt, t, R, n, SW.STEPS))
                key = f"sharded/{opt}/{t}"
                np.testing.assert_array_equal(res[f"{key}/sharded"], want)
                np.testing.assert_array_equal(res[f"{key}/unsharded"], want)
                assert bool(res[f"{key}/buffered"]) == (t != "b")
        for a in axes:
            for kind in ("zero1", "fsdp"):
                for k, v in want_params.items():
                    np.testing.assert_allclose(res[f"zero/{a}/{kind}/{k}"],
                                               v, rtol=1e-5, atol=1e-7,
                                               err_msg=(a, kind, k))
