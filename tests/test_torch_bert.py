"""The port's BERT (``byteps_tpu_torch/models/bert.py``) against the JAX
package's (``byteps_tpu/models/bert.py``) on ``bert_tiny``, with the JAX
model's parameters loaded through ``load_flax_bert``.

Tolerances, each against the JAX value's max-abs:
- f32 compute: logits to 1e-5 (matmuls sum in another order; read
  ~8e-7), ``mlm_loss`` to rtol 1e-6, gradients to 1e-5 (the key
  biases, whose exact gradient is 0, to 1e-6 of the largest gradient);
- bf16 compute (the benchmark's): logits to 2**-5, four bf16 steps of
  the largest logit (read ~1e-2: the same rounding points, sums in
  another order, so a value can round the other way);
- one AdamW step against ``optax.adamw(1e-4)`` fed the same gradients:
  parameters to rtol 2.4e-7 (two f32 ulps: torch decays the parameter
  before the Adam update, optax adds the decay to the update) plus atol
  1e-9, 1e-5 of the step's size lr: optax takes the bias corrections in
  f32, where ``1 - 0.999`` is off by 1.3e-5 of itself, and torch in
  double, so an element's update differs by up to ~6.5e-6 of lr (read
  6.9e-10).  A control with torch's default weight decay (0.01) must
  break that bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models import bert as jb
from byteps_tpu_torch.models import bert as pb

LOGIT_TOL = {"float32": 1e-5, "bfloat16": 2**-5}
# two f32 ulps of the parameter, plus 1e-5 of the step's size lr = 1e-4
ADAMW_RTOL, ADAMW_ATOL = 2.4e-7, 1e-9
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(dname, **over):
    jdt, pdt = DTYPES[dname]
    jc = dataclasses.replace(jb.bert_tiny(), dtype=jdt, **over)
    pc = dataclasses.replace(pb.bert_tiny(), dtype=pdt, **over)
    jm = jb.BertForMLM(jc)
    batch = jb.synthetic_batch(jax.random.PRNGKey(1), jc, 4, 32)
    variables = jm.init(jax.random.PRNGKey(0), batch["input_ids"],
                        batch["attention_mask"])
    params = jax.tree.map(np.asarray, variables["params"])
    pm = pb.load_flax_bert(pb.BertForMLM(pc), params)
    mask = np.asarray(batch["attention_mask"]).copy()
    mask[:, -5:] = 0                 # padding: the additive mask matters
    b = {k: np.asarray(v) for k, v in batch.items()}
    b["attention_mask"] = mask
    return jm, variables, pm, b


def _t(x):
    return torch.from_numpy(np.array(x)).long()


def _share(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("gathered", [False, True], ids=["full", "gathered"])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_logits_match_jax(dname, gathered):
    jm, variables, pm, b = _pair(dname)
    jkw = {"masked_positions": b["masked_positions"]} if gathered else {}
    pkw = ({"masked_positions": _t(b["masked_positions"])} if gathered
           else {})
    want = np.asarray(jm.apply(variables, b["input_ids"],
                               b["attention_mask"], **jkw))
    got = pm(_t(b["input_ids"]), _t(b["attention_mask"]), **pkw)
    assert got.dtype == torch.float32
    got = got.detach().numpy()
    assert got.shape == want.shape == (4, 4 if gathered else 32, 512)
    assert _share(got, want) <= LOGIT_TOL[dname]


def test_mlm_loss_and_gradients_match_jax():
    jm, variables, pm, b = _pair("float32")

    def jloss(p):
        logits = jm.apply({"params": p}, b["input_ids"], b["attention_mask"],
                          masked_positions=b["masked_positions"])
        return jb.mlm_loss(logits, b["masked_labels"])

    want, jgrads = jax.value_and_grad(jloss)(variables["params"])
    logits = pm(_t(b["input_ids"]), _t(b["attention_mask"]),
                masked_positions=_t(b["masked_positions"]))
    got = pb.mlm_loss(logits, _t(b["masked_labels"]))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(jgrads, "")
    grads = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert sorted(grads) == sorted(flat)
    # a key bias's exact gradient is 0 (it shifts each query's logits by
    # a constant, which softmax ignores), so both sides hold rounding
    # noise (~1e-8): it is held to 1e-6 of the largest gradient (read
    # ~5e-8), every other gradient to 1e-5 of its own max-abs (read
    # under 2e-6)
    top = max(np.abs(v).max() for v in flat.values())
    for n, g in grads.items():
        if n.endswith("attention.key.bias"):
            assert np.abs(g - flat[n]).max() <= 1e-6 * top, n
        else:
            assert _share(g, flat[n]) <= 1e-5, n


def test_mlm_loss_full_head_weights_and_unmasked_labels():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 6, 11).astype(np.float32)
    labels = rng.randint(-1, 11, (2, 6))
    labels[0, 0] = -1
    weights = rng.rand(2, 6).astype(np.float32)
    for w in (None, weights):
        want = float(jb.mlm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 None if w is None else jnp.asarray(w)))
        got = pb.mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    # nothing masked: the denominator is max(sum w, 1), the loss 0
    none = -np.ones((2, 6), np.int64)
    assert pb.mlm_loss(torch.from_numpy(logits),
                       torch.from_numpy(none)).item() == 0.0


def test_one_adamw_step_matches_optax():
    _, variables, pm, _ = _pair("float32")
    params = variables["params"]
    rng = np.random.RandomState(5)
    grads = jax.tree.map(
        lambda p: rng.randn(*p.shape).astype(np.float32) * 1e-2, params)
    tx = optax.adamw(1e-4)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    opt = torch.optim.AdamW(pm.parameters(), lr=1e-4, weight_decay=1e-4)
    pg = {}

    def walk(tree, prefix, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".", out)
            else:
                out[prefix + k] = np.asarray(v)

    walk(grads, "", pg)
    start = {n: p.detach().clone() for n, p in pm.named_parameters()}
    for n, p in pm.named_parameters():
        p.grad = torch.from_numpy(pg[n])
    opt.step()
    flat = {}
    walk(want, "", flat)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[n],
                                   rtol=ADAMW_RTOL, atol=ADAMW_ATOL,
                                   err_msg=n)
    # control: torch's default weight decay (0.01) must break the bound
    with torch.no_grad():
        for n, p in pm.named_parameters():
            p.copy_(start[n])
    ctl = torch.optim.AdamW(pm.parameters(), lr=1e-4)
    ctl.step()
    w = dict(pm.named_parameters())["encoder.word_embeddings.embedding"]
    want_w = flat["encoder.word_embeddings.embedding"]
    assert not np.allclose(w.detach().numpy(), want_w, rtol=ADAMW_RTOL,
                           atol=ADAMW_ATOL)


def test_remat_keeps_loss_and_gradient_bits():
    grads = []
    for remat in (False, True):
        _, _, pm, b = _pair("bfloat16", remat=remat)
        logits = pm(_t(b["input_ids"]), _t(b["attention_mask"]),
                    masked_positions=_t(b["masked_positions"]))
        loss = pb.mlm_loss(logits, _t(b["masked_labels"]))
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone()
                                    for n, p in pm.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert l0 == l1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_synthetic_batch_structure_matches_jax():
    jc, pc = jb.bert_tiny(), pb.bert_tiny()
    want = {k: np.asarray(v) for k, v in
            jb.synthetic_batch(jax.random.PRNGKey(2), jc, 3, 40).items()}
    got = {k: v.numpy() for k, v in pb.synthetic_batch(
        torch.Generator().manual_seed(2), pc, 3, 40).items()}
    assert sorted(got) == sorted(want)
    n_pred = max(1, int(40 * 0.15))
    for k in want:
        assert got[k].shape == want[k].shape, k
    for b in (got, want):
        pos = b["masked_positions"]
        assert pos.shape == (3, n_pred)
        assert (np.diff(pos, axis=1) > 0).all()         # sorted, distinct
        masked = np.zeros((3, 40), bool)
        np.put_along_axis(masked, pos, True, axis=1)
        assert (b["input_ids"][masked] == 0).all()
        assert (b["labels"][~masked] == -1).all()
        assert (b["labels"][masked] >= 0).all()
        np.testing.assert_array_equal(
            np.take_along_axis(b["labels"], pos, axis=1), b["masked_labels"])
        assert (b["attention_mask"] == 1).all()
        assert ((0 <= b["input_ids"]) & (b["input_ids"] < 512)).all()
    assert got["input_ids"].dtype == np.int64
    # drawn from the generator: the same seed gives the same batch
    again = pb.synthetic_batch(torch.Generator().manual_seed(2), pc, 3, 40)
    for k, v in again.items():
        np.testing.assert_array_equal(v.numpy(), got[k])
