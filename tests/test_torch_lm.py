"""The port's language models (``models/gpt.py``, ``models/llama.py``)
against the JAX package's flax models, attention through flash on both
sides.

flax parameters of ``llama_tiny_f32`` and of ``gpt_tiny`` in f32 are
carried into the port with ``load_flax_llama`` / ``load_flax_gpt``; the
same numpy token ids go to both.  The JAX side runs the Pallas flash
kernels in interpret mode, the port its flash wrappers' plain versions.

Training: two SGD steps (lr 0.1, momentum 0.9) through the port's
``DistributedOptimizer`` at a world of one (gloo, ``init(device="cpu")``)
against ``make_dp_sp_train_step(attention="flash")`` on a 1x1 mesh with
``optax.sgd(0.1, momentum=0.9)``.  At one rank both objectives are the
mean NLL over the batch's valid tokens.

Tolerances (f32 on the CPU, XLA and torch summing in other orders):
logits and losses rtol 1e-5 / atol 1e-5; parameters after two steps
rtol 1e-4 / atol 1e-6 (two chained gradient and update steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import byteps_tpu_torch as port
from byteps_tpu.models import gpt as jax_gpt
from byteps_tpu.models import llama as jax_llama
from byteps_tpu.ops.flash_attention import flash_attention as jax_flash
from byteps_tpu.parallel import make_dp_sp_train_step, make_sp_mesh
from byteps_tpu.parallel import shard_lm_batch
from byteps_tpu.parallel.long_context import replicate
from byteps_tpu_torch.models import gpt as port_gpt
from byteps_tpu_torch.models import llama as port_llama
from byteps_tpu_torch.ops.flash_attention import flash_attention
from byteps_tpu_torch.parallel import long_context, sequence

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
BATCH, SEQ = 2, 24


def _families():
    gpt_f32 = dataclasses.replace(jax_gpt.gpt_tiny(), dtype=jnp.float32)
    port_gpt_f32 = dataclasses.replace(port_gpt.gpt_tiny(),
                                       dtype=torch.float32)
    return {
        "gpt": (gpt_f32, jax_gpt.GPT, port_gpt_f32, port_gpt.GPT,
                port_gpt.load_flax_gpt),
        "llama": (jax_llama.llama_tiny_f32(), jax_llama.Llama,
                  port_llama.llama_tiny_f32(), port_llama.Llama,
                  port_llama.load_flax_llama),
    }


FAMILIES = _families()


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _batch(vocab, seed):
    ids = np.random.RandomState(seed).randint(0, vocab, (BATCH, SEQ))
    labels = np.concatenate([ids[:, 1:], np.full((BATCH, 1), -1)], axis=1)
    return ids.astype(np.int32), labels.astype(np.int32)


def _flax(family):
    jcfg, jcls, _, _, _ = FAMILIES[family]
    ids, _ = _batch(jcfg.vocab_size, 0)
    return jcls(jcfg).init(jax.random.PRNGKey(1), jnp.asarray(ids))


def _port_model(family, params, attn_fn=flash_attention):
    _, _, pcfg, pcls, load = FAMILIES[family]
    return load(pcls(pcfg, attn_fn=attn_fn), _np_tree(params))


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_flax_with_flash(family):
    jcfg, jcls, pcfg, _, _ = FAMILIES[family]
    variables = _flax(family)
    ids, _ = _batch(jcfg.vocab_size, 2)
    want = np.asarray(jcls(jcfg, attn_fn=jax_flash).apply(
        variables, jnp.asarray(ids)))
    model = _port_model(family, variables["params"])
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
        exact = _port_model(family, variables["params"], attn_fn=None)(
            torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    assert got.shape == (BATCH, SEQ, pcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    np.testing.assert_allclose(exact.numpy(), want, **LOGIT_TOL)


def test_llama_gqa_repeats_each_kv_head_in_place():
    """4 query heads over 2 KV heads: the attention sees K/V heads
    [0, 0, 1, 1] (jnp.repeat / repeat_interleave), not [0, 1, 0, 1]; the
    logits then match flax (previous test)."""
    seen = []

    def recording(q, k, v, **kw):
        seen.append((k, v))
        return flash_attention(q, k, v, **kw)

    cfg = port_llama.llama_tiny_f32()
    assert (cfg.num_heads, cfg.num_kv_heads) == (4, 2)
    model = _port_model("llama", _flax("llama")["params"],
                        attn_fn=recording)
    ids, _ = _batch(cfg.vocab_size, 3)
    with torch.no_grad():
        model(torch.from_numpy(ids).long())
    assert len(seen) == cfg.num_layers
    for k, v in seen:
        assert k.shape[2] == v.shape[2] == 4
        for t in (k, v):
            assert torch.equal(t[:, :, 0], t[:, :, 1])
            assert torch.equal(t[:, :, 2], t[:, :, 3])
            assert not torch.equal(t[:, :, 0], t[:, :, 2])


@pytest.mark.parametrize("family", FAMILIES)
def test_two_sgd_steps_match_jax_train_step(family):
    jcfg, _, _, _, _ = FAMILIES[family]
    variables = _flax(family)
    ids, labels = _batch(jcfg.vocab_size, 4)
    tx = optax.sgd(0.1, momentum=0.9)

    mesh = make_sp_mesh(jax.devices()[:1], n_sp=1)
    step = make_dp_sp_train_step(mesh, jcfg, tx, attention="flash",
                                 donate=False)
    p, o = replicate(mesh, variables), replicate(mesh, tx.init(variables))
    batch = shard_lm_batch(mesh, {"input_ids": jnp.asarray(ids),
                                  "labels": jnp.asarray(labels)})
    jax_losses = []
    for _ in range(2):
        p, o, loss = step(p, o, batch)
        jax_losses.append(float(loss))

    model = _port_model(family, variables["params"])
    tids, tlabels = torch.from_numpy(ids).long(), torch.from_numpy(labels)
    port.init(device="cpu")
    try:
        opt = port.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        losses = []
        for _ in range(2):
            opt.zero_grad()
            loss = port_gpt.lm_loss(model(tids), tlabels.long())
            loss.backward()
            opt.step()
            losses.append(loss.item())
    finally:
        port.shutdown()

    np.testing.assert_allclose(losses, jax_losses, **LOGIT_TOL)
    want = dict(_port_model(family, _np_tree(p["params"]))
                .named_parameters())
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_lm_loss_matches_jax(family):
    jcfg = FAMILIES[family][0]
    logits = np.random.RandomState(5).randn(BATCH, SEQ, jcfg.vocab_size) \
        .astype(np.float32)
    _, labels = _batch(jcfg.vocab_size, 5)
    labels[0, :3] = -1
    s, c = port_gpt.token_nll(torch.from_numpy(logits),
                              torch.from_numpy(labels).long())
    js, jc = jax_gpt.token_nll(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-5)
    assert float(c) == float(jc) == BATCH * SEQ - BATCH - 3
    np.testing.assert_allclose(
        float(port_gpt.lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels).long())),
        float(jax_gpt.lm_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-5)


def test_rope_matches_jax():
    pos = np.arange(5, 37)
    cos, sin = port_llama.rope_frequencies(16, torch.from_numpy(pos)[None],
                                           500000.0)
    jcos, jsin = jax_llama.rope_frequencies(16, jnp.asarray(pos)[None],
                                            500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-5,
                               atol=1e-6)
    x = np.random.RandomState(6).randn(1, 32, 3, 16).astype(np.float32)
    got = port_llama.apply_rope(torch.from_numpy(x), cos, sin)
    want = jax_llama.apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("family,make,layers,params", [
    ("llama", port_llama.llama3_8b, 4, 1_923_125_248),
    ("gpt", port_gpt.gpt_small, 8, 75_584_512)])
def test_full_width_geometry(family, make, layers, params):
    """The slice models at full width, built on the meta device: the
    parameter count, and every flax variable of one block and the
    embeddings has a home of its shape in the port."""
    _, jcls, _, pcls, _ = FAMILIES[family]
    cfg = dataclasses.replace(make(), num_layers=layers)
    m = pcls(cfg, device="meta", generator=torch.Generator())
    assert sum(p.numel() for p in m.parameters()) == params
    jcfg = dataclasses.replace(
        {"llama": jax_llama.llama3_8b, "gpt": jax_gpt.gpt_small}[family](),
        num_layers=1)
    shapes = jax.eval_shape(lambda: jcls(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    one = pcls(dataclasses.replace(cfg, num_layers=1), device="meta",
               generator=torch.Generator())
    want = {n: tuple(p.shape) for n, p in one.named_parameters()}
    got = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            name = prefix + ("h.0" if k == "h0" else k)
            if isinstance(v, dict):
                walk(v, name + ".")
            else:
                got[name] = tuple(v.shape)

    walk(shapes["params"], "")
    assert got == want


def test_moe_is_not_ported_yet():
    """The name is older than the port of the MoE blocks: a MoE config now
    builds, with a switch block every ``moe_every``-th layer (their parity
    with the JAX model is in tests/test_torch_moe_lm.py)."""
    cfg = dataclasses.replace(port_gpt.gpt_tiny(), moe_experts=4)
    model = port_gpt.GPT(cfg)
    assert [hasattr(b, "moe") for b in model.h] == [False, True]
    assert model.h[1].moe.w1.shape == (4, cfg.hidden_size,
                                       cfg.intermediate_size)


def test_resolve_attention_kinds():
    fn = sequence.resolve_sp_attention("flash", causal=True)
    assert fn.func is flash_attention and fn.keywords == {"causal": True}
    assert sequence.resolve_sp_attention("full").func is \
        sequence.full_attention
    # the sequence-parallel kinds need their axis (their parity with the
    # JAX package is in tests/test_torch_sequence_parallel.py)
    for kind in ("ring", "striped", "ring_flash", "ulysses",
                 "ulysses_flash"):
        with pytest.raises(ValueError, match="pass axis"):
            sequence.resolve_sp_attention(kind)
    with pytest.raises(ValueError, match="needs sp=1"):
        sequence.resolve_sp_attention("flash", sp=2)
    with pytest.raises(ValueError, match="unknown"):
        sequence.resolve_sp_attention("bogus")


def test_synthetic_lm_batch_shifts_labels():
    cfg = port_llama.llama_tiny()
    gen = torch.Generator().manual_seed(0)
    b = long_context.synthetic_lm_batch(gen, cfg, 3, 16)
    ids, labels = b["input_ids"], b["labels"]
    assert ids.shape == labels.shape == (3, 16)
    assert int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab_size
    assert torch.equal(labels[:, :-1], ids[:, 1:])
    assert (labels[:, -1] == -1).all()
    again = long_context.synthetic_lm_batch(
        torch.Generator().manual_seed(0), cfg, 3, 16)
    assert torch.equal(again["input_ids"], ids)
