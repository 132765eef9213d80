"""The port's ``(fsdp, tp)`` Llama step (``byteps_tpu_torch/parallel/
fsdp_tp.py``) against the JAX package's ``make_fsdp_tp_train_step``, on
the same flax parameters and batch: the JAX side on the conftest's CPU
devices, the port over 4 gloo ranks (``tests/torch_mp_worker.py``), each
rank holding its slices and gathering each kernel's fsdp slice for its
product.

Cases on ``llama_tiny_f32`` (4 query heads over 2 K/V heads), each 3
steps of SGD 0.1: ``(fsdp 2, tp 2)``; ``(fsdp 1, tp 4)``, where the K/V
heads do not split over tp and stay whole while the query heads split
(the JAX fallback); ``(fsdp 4, tp 1)``; and an odd vocabulary (127) at
``(2, 2)``, where the tp axis is dropped from the word table and the
head.  The JAX tests' tolerances: each step's loss rtol 1e-5 / atol 1e-6,
every parameter slice of every rank rtol 2e-4 / atol 2e-5.  A control
mapping the K/V heads by local index at ``(1, 4)`` must miss.  The rule
table and its fallbacks, the leaf-by-leaf sharded init and the guard
against whole parameters are pinned in process.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models.llama import Llama, LlamaConfig, llama_tiny_f32
from byteps_tpu.parallel import fsdp_tp as jft
from byteps_tpu_torch.models import llama as tllama
from byteps_tpu_torch.parallel import fsdp_tp as tft
from byteps_tpu_torch.parallel.mesh_util import Mesh2D, MeshAxis
from byteps_tpu_torch.parallel.tp_layers import param_placements, take

from . import torch_mp_worker as W

STEPS, LR = 3, 0.1
LAYOUTS = [(2, 2), (1, 4), (4, 1)]
ODD = LlamaConfig(vocab_size=127, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=64, max_position=64,
                  rope_theta=10000.0, dtype=jnp.float32)
CONFIGS = {"llama": llama_tiny_f32(), "odd": ODD}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    inp, params, batches = {}, {}, {}
    for i, (key, cfg) in enumerate(CONFIGS.items()):
        batches[key] = W.lm_batch(3 + i, cfg.vocab_size)
        params[key] = Llama(cfg).init(
            jax.random.PRNGKey(3 + i),
            jnp.asarray(batches[key]["input_ids"][:1]))
        inp.update(W.flax_flat(params[key]["params"], f"{key}/"))
        inp.update({f"{key}_batch/{k}": v for k, v in batches[key].items()})
    base = {"type": "fsdp_tp", "steps": STEPS, "lr": LR, "params": "llama",
            "batch": "llama_batch", "config": "llama_tiny_f32"}
    cases = [dict(base, name=f"ft_{f}x{t}", mesh=[f, t]) for f, t in LAYOUTS]
    cases.append(dict(base, name="ft_1x4_kv_control", mesh=[1, 4],
                      control="kv_local_index"))
    cases.append(dict(base, name="ft_odd_2x2", mesh=[2, 2], params="odd",
                      batch="odd_batch", config="llama_odd_vocab_f32"))
    results, pool = W.start(tmp_path_factory.mktemp("torch_ft"), inp, cases,
                            [4])
    yield params, batches, results
    pool.shutdown(wait=True)


def jax_steps(key, params, batch, f, t):
    cfg = CONFIGS[key]
    mesh = jft.make_fsdp_tp_mesh(jax.devices()[:f * t], n_tp=t)
    tx = optax.sgd(LR)
    p = jft.shard_llama_params(mesh, params)
    o = jft.init_llama_opt_state(tx, p)
    step = jft.make_fsdp_tp_train_step(mesh, cfg, tx, donate=False)
    b = jft.shard_llama_batch(mesh, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, b)
        losses.append(float(loss))
    return np.array(losses), W.port_names(jax.device_get(p)["params"])


@pytest.mark.parametrize("f,t", LAYOUTS)
def test_fsdp_tp_step_matches_jax(setup, f, t):
    params, batches, results = setup
    losses, want = jax_steps("llama", params["llama"], batches["llama"], f, t)
    ranks = results()[4]
    assert W.compare(ranks, f"ft_{f}x{t}", losses, want) == []
    if (f, t) == (1, 4):
        # K/V heads whole on every rank, query heads split
        k = ranks[0]["ft_1x4/param/h.0.attn.k.kernel"]
        q = ranks[0]["ft_1x4/param/h.0.attn.q.kernel"]
        assert k.shape[1] == 2 and q.shape[1] == 1


def test_kv_by_local_index_control_misses(setup):
    params, batches, results = setup
    losses, want = jax_steps("llama", params["llama"], batches["llama"], 1, 4)
    bad = W.compare(results()[4], "ft_1x4_kv_control", losses, want)
    assert any("losses" in b for b in bad), bad


@pytest.mark.parametrize("h,kv,tp", [(4, 2, 1), (4, 2, 2), (4, 2, 4),
                                     (8, 2, 4), (12, 3, 2), (32, 8, 2),
                                     (32, 8, 16)])
def test_repeat_kv_is_index_select(h, kv, tp):
    """The GQA expansion equals ``index_select`` by ``kv_heads`` on every
    tp rank, K/V split or whole, and for the local-index control's
    mapping too; its gradient is the sum over each head's query heads."""
    groups, split = h // kv, kv % tp == 0
    hq, hk = h // tp, kv // tp if split else kv
    gen = torch.Generator().manual_seed(h * 100 + kv * 10 + tp)
    for r in range(tp):
        for idx in (tllama.kv_heads(r, hq, groups, hk, split),
                    torch.arange(hq) // groups):
            x = torch.randn(2, 3, hk, 4, generator=gen, requires_grad=True)
            g = torch.randn(2, 3, hq, 4, generator=gen)
            got = tllama.repeat_kv(x, idx, groups)
            want = x.index_select(2, idx)
            assert torch.equal(got, want), (r, idx)
            (dx,) = torch.autograd.grad(got, x, g)
            (dw,) = torch.autograd.grad(want, x, g)
            torch.testing.assert_close(dx, dw, rtol=1e-6, atol=1e-6)


def test_odd_vocabulary_drops_tp(setup):
    params, batches, results = setup
    losses, want = jax_steps("odd", params["odd"], batches["odd"], 2, 2)
    ranks = results()[4]
    assert W.compare(ranks, "ft_odd_2x2", losses, want) == []
    assert ranks[1]["ft_odd_2x2/param/wte.embedding"].shape == (127, 16)
    assert ranks[1]["ft_odd_2x2/param/lm_head.kernel"].shape == (16, 127)


PATHS = ["h0/attn/q/kernel", "h0/attn/k/kernel", "h0/attn/v/kernel",
         "h0/attn/out/kernel", "h1/mlp/gate/kernel", "h1/mlp/up/kernel",
         "h1/mlp/down/kernel", "h0/attn_norm/scale", "h0/mlp_norm/scale",
         "norm_f/scale", "wte/embedding", "lm_head/kernel"]


def test_rules_equal_the_jax_table():
    for path in PATHS:
        assert tft.fsdp_tp_spec_for(path) == \
            tuple(jft.fsdp_tp_spec_for(path)), path


def _fake_mesh(f, t, rank=0):
    comm = types.SimpleNamespace(size=f * t, rank=rank,
                                 device=torch.device("cpu"))
    o, i = divmod(rank, t)
    return Mesh2D(comm, (MeshAxis("fsdp", f, o, None, ()),
                         MeshAxis("tp", t, i, None, ())))


@pytest.mark.parametrize("key,f,t", [("llama", 2, 2), ("llama", 1, 4),
                                     ("llama", 4, 1), ("llama", 2, 4),
                                     ("odd", 2, 2)])
def test_shardings_equal_jax_with_fallbacks(key, f, t):
    """Every leaf's spec, the dropped axes included, and the unmatched
    large leaf's fsdp fallback, as ``llama_shardings`` gives them."""
    jmesh = jft.make_fsdp_tp_mesh(jax.devices()[:f * t], n_tp=t)
    shapes = jax.eval_shape(Llama(CONFIGS[key]).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    fake = {"params": dict(shapes["params"], adapter={
        "lora_A": jax.ShapeDtypeStruct((512, 256), jnp.float32),
        "tiny": jax.ShapeDtypeStruct((8,), jnp.float32)})}
    want = jft.llama_shardings(jmesh, fake)
    got = tft.llama_shardings(_fake_mesh(f, t), fake)

    def walk(w, g, path):
        for k in w:
            if isinstance(w[k], dict):
                walk(w[k], g[k], path + k + "/")
            else:
                assert g[k] == tuple(w[k].spec), path + k
    walk(want, got, "")
    assert got["params"]["adapter"]["lora_A"] == ("fsdp", None)
    assert got["params"]["adapter"]["tiny"] == ()


def test_sharded_init_is_the_whole_models_slices():
    """Each rank draws the whole model leaf by leaf and keeps its slice:
    the slices of every layout are those of the one seeded whole model."""
    cfg = tllama.llama_tiny_f32()
    whole = dict(tllama.Llama(cfg, generator=torch.Generator().manual_seed(
        6)).named_parameters())
    for f, t in LAYOUTS:
        for rank in range(f * t):
            mesh = _fake_mesh(f, t, rank)
            model = tft.init_llama_params_sharded(
                mesh, cfg, torch.Generator().manual_seed(6))
            places = param_placements(model)
            got = tft.shard_llama_params(
                mesh, {n: p.detach() for n, p in whole.items()})
            for n, p in model.named_parameters():
                assert torch.equal(p, take(whole[n], places[n])), n
                assert torch.equal(got[n], p.detach()), n
            if (f, t) == (2, 2):
                q = model.h[0].attn.q.kernel
                assert q.shape == (cfg.hidden_size // 2, cfg.num_heads // 2,
                                   cfg.hidden_size // cfg.num_heads)


def test_unsharded_params_rejected():
    cfg = tllama.llama_tiny_f32()
    mesh = _fake_mesh(2, 2)
    model = tllama.Llama(cfg)
    step = tft.make_fsdp_tp_train_step(
        mesh, model, torch.optim.SGD(model.parameters(), lr=LR))
    batch = W.lm_batch(0, cfg.vocab_size)
    with pytest.raises(ValueError, match="not mesh-sharded"):
        step({k: torch.from_numpy(v).long() for k, v in batch.items()})
