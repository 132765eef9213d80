"""The port's collectives, compressed push_pull and engine across gloo
processes, against numpy and the JAX package's codecs.

Three layouts: one node of two ranks (the hierarchical path's
reduce-scatter and all-gather, with ``n % local_size != 0`` padding),
two nodes of one (its cross-node all-reduce), and two nodes of two (both
levels, on separate process groups).  Rank r contributes row r of seeded
numpy arrays (tests/torch_collectives_worker.py).

Tolerances: all-reduces are exact (the inputs are chosen so that every
f32 sum is exact in any order, and the port accumulates f16/bf16 in f32
as the reference does); onebit words are bit-exact; the first-level
scales to rtol 1e-6, because an L1 sum is taken in another order; values
after the server's re-compression to rtol 1e-5, because XLA's CPU
reduction of the padded (32, L) merged chunk is itself off by up to
~3e-6 of an f64 sum at 5000 elements (the port's torch sum by ~1e-7).
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

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
    decompress_sum -> compress -> decompress, state threaded over steps."""
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
        p2, sst = server.compress(y, sst)
        outs.append((np.asarray(gathered["words"]),
                     np.asarray(gathered["scale"]),
                     np.asarray(server.decompress(p2))))
    return outs


@pytest.mark.parametrize("codec", list(W.CODECS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_compressed_push_pull_matches_jax_codec(results, layout, codec):
    R = _world(layout)
    steps = [W.rows(300 + s, R, W.CODEC_NUMEL)
             for s in range(W.CODEC_STEPS)]
    ref = _jax_codec_run(R, W.CODECS[codec], W.CODEC_NUMEL, steps)
    for rank in range(R):
        res = results[layout][rank]
        for s, (words, scales, out) in enumerate(ref):
            got_w = res[f"codec/{codec}/{s}/words"].view(np.uint32)
            np.testing.assert_array_equal(got_w, words)
            np.testing.assert_allclose(res[f"codec/{codec}/{s}/scales"],
                                       scales, rtol=1e-6)
            np.testing.assert_allclose(res[f"codec/{codec}/{s}/out"], out,
                                       rtol=1e-5)


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
        a_ref.append(np.concatenate([c[s][2] for c in per_chunk]) / R)
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
