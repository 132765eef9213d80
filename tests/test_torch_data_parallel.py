"""The port's fused data-parallel step (``byteps_tpu_torch/parallel/
data_parallel.py``) and its collectives (``ops/collective_ops.py``)
against the JAX package's, on the same seeded inputs: the JAX side on
the conftest's CPU devices, the port at 2 or 4 gloo ranks
(``tests/torch_dp_worker.py``), rank r holding row r (or rows of block
r) of each global array.

Cases and tolerances:
- ``make_dp_train_step`` on ``bert_tiny`` (f32 compute) at 2 ranks
  against the JAX step on a 2-device mesh, 3 AdamW steps: each step's
  loss to rtol 1e-5; the first step's averaged gradient to 1e-5 of each
  tensor's max-abs (the key biases, whose exact gradient is 0, to 1e-6
  of the largest gradient); parameters within lr / 10 a step of the JAX
  value (read 0.065 lr over the 3 steps: Adam divides each gradient by
  its own RMS, so an element whose gradient is small against the sums'
  rounding moves by more than its neighbours), the key biases, which
  Adam steps on rounding noise of either sign, within 2 lr a step;
- ``accum_steps=2`` on the MLP at 2 ranks (SGD), losses rtol 1e-6 and
  parameters atol 1e-6 (SGD's update is one FMA in torch and two
  roundings in optax, ROADMAP Queue C 10), and the ValueError's text
  equal to the JAX step's;
- ``make_dp_train_step_with_state`` (through ``make_vision_trainer``) on
  ``resnet_tiny`` with cross-replica BatchNorm at 2 ranks, 2 steps of
  SGD with momentum: losses rtol 1e-5, parameters and running statistics
  atol 2e-5 (the convolutions sum in another order);
- ``make_dp_train_step`` with ``compress_dcn=make_onebit_pair()`` at one
  node of 2 ranks (the hop gathers over no node) on the MLP, every
  gradient forced past the gate, 2 SGD steps against the JAX step on a
  1x2 mesh: losses rtol 1e-6, parameters atol 1e-6 (each onebit
  gradient is a sign times an L1 scale summed in another order, Queue C
  2, moved by lr 0.1);
- ``hierarchical_push_pull`` at 2x2 and at one node of 2 ranks against
  the JAX one on a 2x2 and a 1x2 mesh: raw bit for bit (the inputs'
  sums are exact in any order); the onebit
  pair's signs bit for bit and values to 1e-5 of their max-abs (each L1
  scale is a sum in another order, ROADMAP Queue C 2, and an element is a
  signed sum of the nodes' scales); the PowerSGD pair to 1e-5
  of the max-abs (Queue C 6); the default 2 MiB gate compresses a 2 MiB
  shard and not one 4 bytes short, in both packages.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from byteps_tpu.comm.mesh import CommContext, _build_mesh
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import mlp as jmlp
from byteps_tpu.models import resnet as jres
from byteps_tpu.ops import collective_ops as jco
from byteps_tpu.parallel import (make_dp_train_step,
                                 make_dp_train_step_with_state, replicate,
                                 shard_batch)

from . import torch_dp_worker as W


def _flat(tree, prefix, sep):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + sep, sep))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _comm(n_dcn, n):
    return CommContext(mesh=_build_mesh(jax.devices()[:n], n_dcn),
                       n_dcn=n_dcn, n_ici=n // n_dcn)


@pytest.fixture(scope="module")
def inputs():
    """The JAX models' parameters and the global batches."""
    inp = {}
    bcfg = dataclasses.replace(jbert.bert_tiny(), dtype=jnp.float32)
    bmodel = jbert.BertForMLM(bcfg)
    bbatch = jbert.synthetic_batch(jax.random.PRNGKey(1), bcfg, 4, 32)
    bparams = bmodel.init(jax.random.PRNGKey(0), bbatch["input_ids"],
                          bbatch["attention_mask"])["params"]
    inp.update(_flat(bparams, "bert/", "."))
    inp.update({f"bert_batch/{k}": np.asarray(v) for k, v in bbatch.items()})
    mmodel = jmlp.MLP(features=(16, 10))
    mparams = mmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 4)))["params"]
    inp.update(_flat(mparams, "mlp/", "."))
    rng = np.random.RandomState(3)
    mbatch = {"x": rng.randn(8, 4).astype(np.float32),
              "y": rng.randint(0, 10, 8).astype(np.int32)}
    inp.update({f"mlp_batch/{k}": v for k, v in mbatch.items()})
    rmodel = jres.resnet_tiny(axis_name=("dcn", "ici"),
                              compute_dtype=jnp.float32)
    rvars = rmodel.init(jax.random.PRNGKey(4), jnp.zeros((2, 16, 16, 3)),
                        train=False)
    inp.update(_flat(rvars["params"], "resnet/", "/"))
    inp.update(_flat(rvars["batch_stats"], "resnet_stats/", "/"))
    rbatch = {"images": rng.randn(8, 16, 16, 3).astype(np.float32),
              "labels": rng.randint(0, 10, 8).astype(np.int32)}
    inp.update({f"resnet_batch/{k}": v for k, v in rbatch.items()})
    models = {"bert": (bmodel, bparams, bbatch),
              "mlp": (mmodel, mparams, mbatch),
              "resnet": (rmodel, rvars, rbatch)}
    return inp, models


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """Both layouts' ranks, started together in the background; calling
    the fixture's value waits for them: {layout: [npz by rank]}.  The
    tests compute their JAX references first, while the ranks run."""
    tmp = tmp_path_factory.mktemp("torch_dp")
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs[0])
    jobs = {"node_of_2": "bert,accum,bn,hier,dp_onebit", "2x2": "hier"}
    pool = ThreadPoolExecutor(len(jobs))
    futures = {k: pool.submit(W.spawn, k, path, str(tmp), cases)
               for k, cases in jobs.items()}
    done = {}

    def results():
        if not done:
            for k, f in futures.items():
                done[k] = [dict(np.load(o)) for o in f.result()]
        return done

    yield results
    pool.shutdown(wait=True)


def _jax_bert(models):
    model, params, batch = models["bert"]
    comm = _comm(1, 2)

    def loss_fn(p, b):
        logits = model.apply({"params": p}, b["input_ids"],
                             b["attention_mask"],
                             masked_positions=b["masked_positions"])
        return jbert.mlm_loss(logits, b["masked_labels"])

    tx = optax.adamw(1e-4)
    step = make_dp_train_step(comm, loss_fn, tx, donate=False)
    p, o = replicate(comm, params), replicate(comm, tx.init(params))
    b = shard_batch(comm, batch)
    losses = []
    for _ in range(W.BERT_STEPS):
        p, o, loss = step(p, o, b)
        losses.append(float(loss))
    return np.array(losses), _flat(jax.device_get(p), "", ".")


def _jax_rank_mean_grad(models):
    """The mean over the two ranks' rows of each rank's gradient."""
    model, params, batch = models["bert"]

    def loss_fn(p, b):
        logits = model.apply({"params": p}, b["input_ids"],
                             b["attention_mask"],
                             masked_positions=b["masked_positions"])
        return jbert.mlm_loss(logits, b["masked_labels"])

    grads = [_flat(jax.grad(loss_fn)(params, {k: v[2 * r:2 * r + 2]
                                              for k, v in batch.items()}),
                   "", ".") for r in range(2)]
    return {n: (grads[0][n] + grads[1][n]) / np.float32(2)
            for n in grads[0]}


def test_bert_dp_step_matches_jax(inputs, port):
    want_loss, want = _jax_bert(inputs[1])
    want_grad = _jax_rank_mean_grad(inputs[1])
    lr = 1e-4
    for res in port()["node_of_2"]:
        np.testing.assert_allclose(res["bert/loss"], want_loss, rtol=1e-5)
        for n, w in want.items():
            got = res[f"bert/param/{n}"]
            bound = (2 if n.endswith("attention.key.bias") else 0.1) * lr
            assert np.abs(got - w).max() <= bound * W.BERT_STEPS, n
        # the first step's averaged gradient, which Adam's normalization
        # would hide a wrong scale of: the mean of the ranks' gradients
        top = max(np.abs(g).max() for g in want_grad.values())
        for n, w in want_grad.items():
            got = res[f"bert/grad0/{n}"]
            if n.endswith("attention.key.bias"):
                assert np.abs(got - w).max() <= 1e-6 * top, n
            else:
                assert (np.abs(got - w).max()
                        <= 1e-5 * np.abs(w).max()), n
    # the replicas agree bit for bit: one average, one optimizer
    r0, r1 = port()["node_of_2"]
    for n in want:
        assert np.array_equal(r0[f"bert/param/{n}"], r1[f"bert/param/{n}"])


def test_accum_steps_matches_jax(inputs, port):
    model, params, batch = inputs[1]["mlp"]
    comm = _comm(1, 2)
    tx = optax.sgd(0.1)
    step = make_dp_train_step(
        comm, lambda p, b: jmlp.softmax_cross_entropy(
            model.apply({"params": p}, b["x"]), b["y"]), tx, donate=False,
        accum_steps=W.ACCUM_STEPS)
    p, o = replicate(comm, params), replicate(comm, tx.init(params))
    losses = []
    for _ in range(W.ACCUM_STEPS):
        p, o, loss = step(p, o, shard_batch(comm, batch))
        losses.append(float(loss))
    want = _flat(jax.device_get(p), "", ".")
    for res in port()["node_of_2"]:
        np.testing.assert_allclose(res["accum/loss"], losses, rtol=1e-6)
        for n, w in want.items():
            np.testing.assert_allclose(res[f"accum/param/{n}"], w, rtol=0,
                                       atol=1e-6, err_msg=n)
    # a per-rank batch of 3 rows does not split in 2: the JAX text
    with pytest.raises(ValueError) as e:
        step(p, o, shard_batch(comm, {k: v[:6] for k, v in batch.items()}))
    for res in port()["node_of_2"]:
        assert str(res["accum/error"]) == str(e.value)


def test_accum_steps_below_one_is_refused():
    from byteps_tpu_torch.parallel import make_dp_train_step as port_step
    with pytest.raises(ValueError, match="accum_steps"):
        port_step(None, torch.nn.Linear(2, 2), None, None, accum_steps=0)


def test_onebit_dp_step_at_one_node_matches_jax(inputs, port,
                                                monkeypatch):
    """The compressed hop at one node: no cross-node collective, the
    payload merged as the node's one row."""
    model, params, batch = inputs[1]["mlp"]
    comm = _comm(1, 2)
    tx = optax.sgd(0.1)
    monkeypatch.setenv("BYTEPS_DCN_COMPRESS_MIN_BYTES", "0")
    step = make_dp_train_step(
        comm, lambda p, b: jmlp.softmax_cross_entropy(
            model.apply({"params": p}, b["x"]), b["y"]), tx, donate=False,
        compress_dcn=jco.make_onebit_pair())
    p, o = replicate(comm, params), replicate(comm, tx.init(params))
    losses = []
    for _ in range(W.DP_ONEBIT_STEPS):
        p, o, loss = step(p, o, shard_batch(comm, batch))
        losses.append(float(loss))
    want = _flat(jax.device_get(p), "", ".")
    r0, r1 = port()["node_of_2"]
    for res in (r0, r1):
        np.testing.assert_allclose(res["dp_onebit/loss"], losses, rtol=1e-6)
        for n, w in want.items():
            # onebit moved every element: none is left at its start
            assert not np.array_equal(res[f"dp_onebit/param/{n}"],
                                      _flat(params, "", ".")[n]), n
            np.testing.assert_allclose(res[f"dp_onebit/param/{n}"], w,
                                       rtol=0, atol=1e-6, err_msg=n)
    for n in want:
        assert np.array_equal(r0[f"dp_onebit/param/{n}"],
                              r1[f"dp_onebit/param/{n}"]), n


def test_cross_replica_bn_step_matches_jax(inputs, port):
    model, variables, batch = inputs[1]["resnet"]
    comm = _comm(1, 2)
    tx = optax.sgd(0.1, momentum=0.9)

    def loss_fn(p, state, b):
        logits, mut = model.apply({"params": p, "batch_stats": state},
                                  b["images"], train=True,
                                  mutable=["batch_stats"])
        return (jres.softmax_cross_entropy(logits, b["labels"]),
                mut["batch_stats"])

    step = make_dp_train_step_with_state(comm, loss_fn, tx, donate=False)
    p = replicate(comm, variables["params"])
    s = replicate(comm, variables["batch_stats"])
    o = replicate(comm, tx.init(variables["params"]))
    b = shard_batch(comm, batch)
    losses = []
    for _ in range(W.BN_STEPS):
        p, s, o, loss = step(p, s, o, b)
        losses.append(float(loss))
    # the JAX trees carried through the port's loader name the port's way
    from byteps_tpu_torch.models import resnet as pres
    ref = pres.load_flax_resnet(
        pres.resnet_tiny(), _as_tree(jax.device_get(p)),
        _as_tree(jax.device_get(s)))
    want = {n: t.detach().numpy() for n, t in
            list(ref.named_parameters()) + list(ref.named_buffers())}
    r0, r1 = port()["node_of_2"]
    for res in (r0, r1):
        np.testing.assert_allclose(res["bn/loss"], losses, rtol=1e-5)
        for n, w in want.items():
            np.testing.assert_allclose(res[f"bn/state/{n}"], w, rtol=0,
                                       atol=2e-5, err_msg=n)
    # cross-replica statistics: both ranks' running statistics are equal
    for n in want:
        assert np.array_equal(r0[f"bn/state/{n}"], r1[f"bn/state/{n}"]), n


def test_local_bn_statistics_differ_across_ranks(inputs, port):
    """Control for the case above: BatchNorm without a group takes each
    rank's own statistics, which differ between the ranks' rows."""
    from byteps_tpu_torch.models import resnet as pres
    _, variables, batch = inputs[1]["resnet"]
    means = []
    for r in range(2):
        m = pres.load_flax_resnet(pres.resnet_tiny(),
                                  _as_tree(variables["params"]),
                                  _as_tree(variables["batch_stats"]))
        m.train()(torch.from_numpy(batch["images"][4 * r:4 * r + 4]))
        means.append(m.stem.bn.mean.numpy())
    assert not np.allclose(means[0], means[1])
    shared = port()["node_of_2"][0]["bn/state/stem.bn.mean"]
    assert not np.allclose(shared, means[0])


def _scale_close(got, want):
    """Onebit hop outputs: each element is a signed sum of the nodes'
    scales over the world size, and each scale is an L1 sum taken in
    another order (ROADMAP Queue C 2), so every element is held to 1e-5
    of the largest, the sum of the scales (an element where two nodes'
    signs differ is the difference of two scales, which a relative bound
    on the element itself would over-weigh)."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _as_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# the worker's layouts (nodes x ranks a node) the hop runs at; the JAX
# side runs on a mesh of the same shape
HOP_LAYOUTS = ["2x2", "node_of_2"]


def _jax_hier(layout, x, **kw):
    n_dcn, n_ici = W.LAYOUTS[layout]
    mesh = Mesh(np.array(jax.devices()[:n_dcn * n_ici]).reshape(
        n_dcn, n_ici), ("dcn", "ici"))

    def body(v):
        return jco.hierarchical_push_pull(v[0], **kw)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(("dcn", "ici")),
                              out_specs=P(), check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


def _world(layout):
    hosts, local = W.LAYOUTS[layout]
    return hosts * local


@pytest.mark.parametrize("layout", HOP_LAYOUTS)
def test_hierarchical_push_pull_matches_jax(port, layout):
    x = W.rows(7, _world(layout), W.HIER_N)
    for op in ("sum", "average"):
        want = _jax_hier(layout, x, op=op)
        for res in port()[layout]:
            np.testing.assert_array_equal(res[f"hier/raw/{op}"], want)
    c, d = jco.make_onebit_pair()
    want = _jax_hier(layout, x, op="average", compress=c, decompress=d,
                     compress_min_bytes=0)
    for res in port()[layout]:
        got = res["hier/onebit"]
        assert np.array_equal(np.signbit(got), np.signbit(want))
        _scale_close(got, want)
    c, d = jco.make_powersgd_pair(rank=4, iters=2)
    want = _jax_hier(layout, x, op="sum", compress=c, decompress=d,
                     compress_min_bytes=0)
    for res in port()[layout]:
        err = np.abs(res["hier/powersgd"] - want).max()
        assert err <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("layout", HOP_LAYOUTS)
def test_onebit_hop_gate_at_2_mib_matches_jax(port, monkeypatch, layout):
    monkeypatch.delenv("BYTEPS_DCN_COMPRESS_MIN_BYTES", raising=False)
    L = W.LAYOUTS[layout][1]
    for n in W.GATE_SIZES:
        x = W.rows(8, _world(layout), n)
        c, d = jco.make_onebit_pair()
        calls = []

        def counting(shard, c=c):
            calls.append(shard.size)
            return c(shard)

        want = _jax_hier(layout, x, op="average", compress=counting,
                         decompress=d)
        compressed = n * 4 // L >= jco.DCN_COMPRESS_MIN_BYTES
        assert bool(calls) == compressed
        for res in port()[layout]:
            assert int(res[f"gate/{n}/compressed"]) == int(compressed)
            got = res[f"gate/{n}"]
            if compressed:
                assert np.array_equal(np.signbit(got), np.signbit(want))
                _scale_close(got, want)
            else:
                np.testing.assert_array_equal(got, want)


def test_dcn_compress_min_bytes_reads_the_environment_per_call(monkeypatch):
    from byteps_tpu_torch.ops import collective_ops as pco
    monkeypatch.delenv("BYTEPS_DCN_COMPRESS_MIN_BYTES", raising=False)
    assert pco.dcn_compress_min_bytes() == jco.dcn_compress_min_bytes()
    for v in ("0", "4096"):
        monkeypatch.setenv("BYTEPS_DCN_COMPRESS_MIN_BYTES", v)
        assert pco.dcn_compress_min_bytes() == jco.dcn_compress_min_bytes()
        assert pco.dcn_compress_min_bytes() == int(v)
    monkeypatch.setenv("BYTEPS_DCN_COMPRESS_MIN_BYTES", "lots")
    with pytest.raises(ValueError, match="BYTEPS_DCN_COMPRESS_MIN_BYTES"):
        pco.dcn_compress_min_bytes()


def test_trees_at_one_rank():
    """push_pull_tree and broadcast_tree over a module and a dict at one
    gloo rank: the average of one rank is the tensor itself, bit for
    bit, in place or not, and a half tensor comes back in its dtype."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.ops import collective_ops as pco
    bps.init(device="cpu")
    try:
        comm = api.engine().comm
        m = torch.nn.Linear(3, 2)
        tree = {"a": torch.randn(5), "b": torch.randn(2, 2).bfloat16(),
                "c": torch.arange(4)}
        out = pco.push_pull_tree(comm, {k: tree[k] for k in "ab"})
        for k in "ab":
            assert out[k].dtype == tree[k].dtype
            assert torch.equal(out[k], tree[k]) and out[k] is not tree[k]
        assert torch.equal(pco.push_pull_tree(comm, {"c": tree["c"]},
                                              "sum")["c"], tree["c"])
        with pytest.raises(TypeError, match="average"):
            pco.push_pull_tree(comm, {"c": tree["c"]})
        w = m.weight.detach().clone()
        pco.push_pull_tree(comm, m, inplace=True)
        assert torch.equal(m.weight, w)
        assert sorted(pco.broadcast_tree(comm, m)) == ["bias", "weight"]
        with pytest.raises(ValueError, match="root"):
            pco.broadcast_tree(comm, m, root=1)
    finally:
        bps.shutdown()
