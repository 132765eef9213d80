"""Buffer mode for every tensor, as the JAX engine routes it: an
uncompressed tensor of more than one chunk, or of at least
``buffer_min_bytes``, is reduce-scattered chunk by chunk into the scatter
accumulator and all-gathered once (``byteps_tpu/core/engine.py:538-557``).

Three gloo layouts run the ranks of ``tests/torch_buffer_worker.py`` at
once: one node of two ranks, two nodes of two, one node of four.  For
each tensor the worker records the collectives the process issued, the
engine's units and the result; the JAX engine runs the same rows on a
mesh of as many CPU devices (``n_dcn`` = nodes, ``n_ici`` = ranks a
node), with its dispatch methods wrapped to see which route it took.

- A buffered tensor's chunks are reduce-scattered (one a chunk, inside
  the node), then one all-gather inside the node; across nodes each
  reduced shard is summed over the node-crossing group (JAX's ``psum``
  over its DCN axis).  No all-reduce over the world or inside the node.
- Its result is bit-equal to the JAX engine's, in the declared dtype.
  The rows are multiples of 1/64 (integers for int32), so every sum is
  exact in any order and a difference can only come from routing,
  scaling or casting.
- Each control takes the parts path in both engines: one chunk under
  ``buffer_min_bytes``, a compressed tensor, a tensor pushed while debug
  sampling is on, and chunk bounds at odd offsets, which no ``[L, C]``
  view with L > 1 expresses.
- At 2 and 4 ranks one small model trained through the sharded update
  and through the replicated one ends with bit-equal parameters (seeded
  normal data: these sums round, and both arms take one route).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import ml_dtypes
import numpy as np
import pytest

from byteps_tpu.comm.mesh import CommContext as JaxComm
from byteps_tpu.comm.mesh import _build_mesh
from byteps_tpu.common.config import Config as JaxConfig
from byteps_tpu.core.engine import PushPullEngine as JaxEngine

from . import torch_buffer_worker as W

LAYOUTS = ("node_of_2", "2x2", "1x4")
SGD_LAYOUTS = ("node_of_2", "1x4")
BUFFERED = [c for c, v in W.CASES.items() if v[5]]
CONTROLS = [c for c, v in W.CASES.items() if not v[5]]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_buffer"))
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futures = {
            name: pool.submit(W.spawn, name, tmp,
                              ("push", "sgd") if name in SGD_LAYOUTS
                              else ("push",))
            for name in LAYOUTS}
        outs = {name: f.result() for name, f in futures.items()}
    return {name: [dict(np.load(o)) for o in files]
            for name, files in outs.items()}


_JAX = {}


def _jax_push(layout, case):
    """The JAX engine's result for ``case`` on the layout's rows, and the
    dispatch routes it took."""
    key = (layout, case)
    if key in _JAX:
        return _JAX[key]
    hosts, local = W.LAYOUTS[layout]
    R = hosts * local
    n, dt, op, comp, fields, _ = W.CASES[case]
    comm = JaxComm(mesh=_build_mesh(jax.devices()[:R], hosts), n_dcn=hosts,
                   n_ici=local)
    eng = JaxEngine(comm, JaxConfig(min_compress_bytes=0, **fields))
    routes = []
    for attr, route in (("_dispatch_buffer_run", "buffer"),
                        ("_dispatch_parts_group", "parts"),
                        ("_dispatch_single", "parts")):
        real = getattr(eng, attr)

        def rec(arg, _real=real, _route=route):
            routes.append(_route)
            return _real(arg)

        setattr(eng, attr, rec)
    try:
        rows = W.rows(len(case), R, n, dt)
        if dt == "bfloat16":
            rows = rows.astype(ml_dtypes.bfloat16)
        out = eng.push_pull(rows, case, op=op, compression=comp)
        out = np.asarray(out)
    finally:
        eng.shutdown(wait=True)
    _JAX[key] = (out, set(routes))
    return _JAX[key]


def _collectives(res, case):
    return [c.split(":") for c in res[f"{case}/collectives"]]


@pytest.mark.parametrize("case", BUFFERED)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_buffered_tensor_reduce_scatters_then_gathers_once(results, layout,
                                                           case):
    hosts, local = W.LAYOUTS[layout]
    for res in results[layout]:
        k = int(res[f"{case}/chunks"])
        assert list(res[f"{case}/units"]) == ["run:1"] * k
        calls = _collectives(res, case)
        names = [c[0] for c in calls]
        assert names.count("reduce_scatter_tensor") == k, calls
        gathers = [c for c in calls if c[0] == "all_gather_into_tensor"]
        assert len(gathers) == 1, calls
        # the gather is the last collective of the push, inside the node
        assert calls[-1] == gathers[0]
        assert gathers[0][2] == ("world" if hosts == 1 else "node")
        n = W.CASES[case][0]
        assert int(gathers[0][1]) == -(-n // local) * local
        reduces = [c for c in calls if c[0] == "all_reduce"]
        if hosts == 1:
            assert reduces == [], calls
        else:
            # the cross-node sum of each chunk's reduced shard
            assert len(reduces) == k and all(c[2] == "nodes"
                                             for c in reduces), calls
        assert not [c for c in calls if c[0] in ("all_gather", "broadcast")]


@pytest.mark.parametrize("case", BUFFERED)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_buffered_result_bit_equal_to_jax(results, layout, case):
    want, routes = _jax_push(layout, case)
    assert routes == {"buffer"}
    dt = W.CASES[case][1]
    want32 = want.astype(np.float32)
    for res in results[layout]:
        assert str(res[f"{case}/dtype"]) == f"torch.{dt}"
        got = res[f"{case}/out"]
        assert got.shape == want32.shape
        assert np.array_equal(got.view(np.int32), want32.view(np.int32)), \
            np.abs(got - want32).max()


@pytest.mark.parametrize("case", CONTROLS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_control_takes_the_parts_path(results, layout, case):
    hosts, _ = W.LAYOUTS[layout]
    _, routes = _jax_push(layout, case)
    assert routes == {"parts"}
    for res in results[layout]:
        units = list(res[f"{case}/units"])
        assert units and all(u.endswith(":0") for u in units), units
        calls = _collectives(res, case)
        if hosts == 1 and case != "compressed":
            # one all-reduce a chunk, nothing scattered
            assert [c[0] for c in calls] == (["all_reduce"]
                                             * int(res[f"{case}/chunks"]))
        if case == "compressed":
            assert "reduce_scatter_tensor" not in [c[0] for c in calls]


@pytest.mark.parametrize("case", [c for c in CONTROLS if c != "compressed"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_control_result_is_the_exact_mean(results, layout, case):
    hosts, local = W.LAYOUTS[layout]
    R = hosts * local
    n = W.CASES[case][0]
    want = W.rows(len(case), R, n).sum(0) / np.float32(R)
    for res in results[layout]:
        np.testing.assert_array_equal(res[f"{case}/out"], want)


@pytest.mark.parametrize("layout", SGD_LAYOUTS)
def test_sharded_and_unsharded_sgd_bit_equal(results, layout):
    for res in results[layout]:
        names = [k.split("/", 2)[2] for k in res
                 if k.startswith("sgd/sharded/")]
        assert len(names) == 4
        for name in names:
            a = res[f"sgd/sharded/{name}"]
            b = res[f"sgd/replicated/{name}"]
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), \
                (name, np.abs(a - b).max())
        # both weight matrices (8192 and 1280 floats, several chunks)
        # rode the accumulator in both arms; the biases took the parts
        # path in both
        assert sorted(res["sgd/buffered"]) == sorted(
            f"torch.grad.{arm}.{w}.weight" for arm in
            ("replicated", "sharded") for w in (0, 2))
    # every rank ends with the same parameters
    r0 = results[layout][0]
    for res in results[layout][1:]:
        for k in r0:
            if k.startswith("sgd/sharded/"):
                assert np.array_equal(res[k], r0[k]), k
