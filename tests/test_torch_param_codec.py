"""The quantized parameter leg of the port's sharded update
(``Config.sharded_param_codec``) against the JAX slot and the port's own
codec chains.

Two ranks run over gloo in tests/torch_sharded_worker.py (part
"param_codec"); one rank runs in this process.  Every codec spec rides
error feedback, on a 3001-element tensor in 3 chunks (the scatter
accumulator), SGD with momentum 0.9 at lr 0.1, 4 steps.

Tolerances:
- against the port's whole-vector chain (``compression.registry`` over
  all ``n`` elements, replayed here on the exact average): bit for bit
  for topk, randomk and max-norm dithering, whose selections and codes
  are exact; onebit's scale and PowerSGD's products are sums in another
  order, held to ``SUM_ATOL`` (1e-6; read 0 and 3.6e-7 at two ranks);
- against the JAX slot (``push_pull_update`` with the same spec):
  ``JAX_ATOL`` (4e-6).  The port quantizes ``u = p' - p`` after
  ``torch.optim`` has written ``p'``; optax's update is rounded once
  less, and torch's SGD is a fused multiply-add (ROADMAP Queue C 10, 15).
  Read: at most 4.8e-7 after 4 steps.  A learning rate 1 % off must
  break it (the control).  topk and randomk select the same indices as
  the JAX slot at every step on these inputs;
- the JAX slot with a codec fails at more than one device (ROADMAP
  Queue C 16), so the two-rank port is held to the one-device JAX slot
  fed the two ranks' average, which is what the slot steps at any
  width.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.comm.mesh import CommContext as JaxComm
from byteps_tpu.comm.mesh import _build_mesh
from byteps_tpu.common.config import Config as JaxConfig
from byteps_tpu.common.scheduler import ChunkPlanner as JaxPlanner
from byteps_tpu.common.telemetry import counters as jax_counters
from byteps_tpu.core.engine import PushPullEngine as JaxEngine

from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.common.scheduler import ChunkPlanner
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.compression import registry
from byteps_tpu_torch.core import api
from byteps_tpu_torch.core.sharded_update import (parse_codec_spec,
                                                  resolve_param_codec)

from . import torch_sharded_worker as W

SPECS = W.PARAM_SPECS
EXACT = ("topk:0.25", "randomk:0.25", "dithering:16")
SUM_ATOL = 1e-6
JAX_ATOL = 4e-6
N, STEPS = W.PC_N, W.PC_STEPS
P0 = W.init_param(11, N)
CFG = dict(sharded_update=True, partition_bytes=4096, min_compress_bytes=0,
           compress_error_ceiling=1.0)


def _avg(spec, s, R):
    return W.pc_grads(spec, s, R).sum(0) * np.float32(1 / R)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results of the worker's param_codec part."""
    out = str(tmp_path_factory.mktemp("torch_param_codec"))
    W.spawn("node_of_2", "cpu", out, part="param_codec")
    return [dict(np.load(f)) for f in
            sorted(glob.glob(f"{out}/cpu_param_codec_node_of_2_*.npz"))]


@pytest.fixture(scope="module")
def one_rank():
    """The same cases at one rank, in this process: the emitted
    parameters of every step, the wire of each leg, the param-leg
    counter and the slot."""
    out = {}
    api.init(Config(**CFG), device="cpu")
    try:
        eng = api.engine()
        for spec in SPECS + ("auto",):
            eng.cfg.sharded_param_codec = spec
            name = f"pc/{spec}"
            api.declare_update(name, (N,), torch.float32, optimizer=W.PC_OPT,
                               init_value=torch.from_numpy(P0))
            base = counters.get("compression.param_wire_bytes")
            before = dict(eng.stats)
            g_spec = "topk:0.25" if spec == "auto" else spec
            outs = [api.push_pull_update(
                torch.from_numpy(W.pc_grads(g_spec, s, 1)[0]), name).numpy()
                for s in range(STEPS)]
            out[spec] = {
                "outs": outs,
                "wire": [eng.stats[k] - before[k]
                         for k in ("wire_push", "wire_pull")],
                "param_wire": counters.get("compression.param_wire_bytes")
                - base,
                "kwargs": eng.update_slots[name].codec_kwargs,
                "payload": eng.update_slots[name].payload_nbytes,
            }
    finally:
        api.shutdown()
    return out


def _port_chain(spec, R):
    """The port's whole-vector chain on the exact average: the emitted
    parameters of every step and the final residual."""
    kw = parse_codec_spec(spec)
    chain = registry.create(dict(kw), N)
    st = chain.init_state(torch.device("cpu"))
    m = torch.from_numpy(P0.copy())
    opt = W.PC_OPT[0]([m], **W.PC_OPT[1])
    outs = []
    for s in range(STEPS):
        before = m.detach().clone()
        m.grad = torch.from_numpy(_avg(spec, s, R))
        opt.step()
        with torch.no_grad():
            u = m - before
            m.copy_(before)
            payload, st = chain.compress(u, st)
            m.add_(chain.decompress(payload))
        outs.append(m.detach().clone().numpy())
    return outs, st["error"].numpy()


_JAX = {}


def _jax_slot(spec, R, lr_scale=1.0):
    """JAX's push_pull_update on a one-device mesh, fed the average of R
    ranks' gradients: the parameters of every step, the pull-leg wire
    and the slot's payload bytes."""
    key = (spec, R, lr_scale)
    if key in _JAX:
        return _JAX[key]
    comm = JaxComm(mesh=_build_mesh(jax.devices()[:1], 1), n_dcn=1, n_ici=1)
    eng = JaxEngine(comm, JaxConfig(sharded_param_codec=spec, **CFG))
    try:
        eng.declare_update("w", (N,), np.float32,
                           tx=optax.sgd(0.1 * lr_scale, momentum=0.9),
                           init_value=P0)
        params = jnp.asarray(P0)
        pull0 = jax_counters.get("wire_bytes", leg="pull")
        outs = []
        for s in range(STEPS):
            upd = eng.push_pull_update(_avg(spec, s, R)[None], "w",
                                       stacked=True)
            params = optax.apply_updates(params, jnp.asarray(upd))
            outs.append(np.asarray(params))
        res = {"outs": outs,
               "pull": jax_counters.get("wire_bytes", leg="pull") - pull0,
               "payload": eng.update_slots["w"].payload_nbytes}
    finally:
        eng.shutdown(wait=True)
    _JAX[key] = res
    return res


def _changed(outs):
    """The indices each step moved: a sparsifier's selection."""
    prev = P0
    sel = []
    for o in outs:
        sel.append(np.flatnonzero(o != prev))
        prev = o
    return sel


# ----------------------------------------------------- the port's own chain

@pytest.mark.parametrize("spec", SPECS)
def test_two_ranks_replicas_equal_master_bit_for_bit(two_ranks, spec):
    """f32 parameters: both ranks emit the same bits at every step, and
    each rank's master block is its block of them."""
    a, b = two_ranks
    for s in range(STEPS):
        np.testing.assert_array_equal(a[f"pc/{spec}/out/{s}"],
                                      b[f"pc/{spec}/out/{s}"])
    for res in two_ranks:
        lo = int(res[f"pc/{spec}/lo"])
        master = res[f"pc/{spec}/master"]
        hi = min(lo + master.size, N)
        np.testing.assert_array_equal(
            master[:hi - lo], res[f"pc/{spec}/out/{STEPS - 1}"][lo:hi])
        assert not master[hi - lo:].any()


@pytest.mark.parametrize("spec", SPECS)
def test_two_ranks_match_whole_vector_chain(two_ranks, spec):
    want, err = _port_chain(spec, 2)
    atol = 0 if spec in EXACT else SUM_ATOL
    for s in range(STEPS):
        np.testing.assert_allclose(two_ranks[0][f"pc/{spec}/out/{s}"],
                                   want[s], rtol=0, atol=atol)
    # the exported residual: the whole vector's, on every rank
    for res in two_ranks:
        np.testing.assert_allclose(res[f"pc/{spec}/export_error"], err,
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("spec", SPECS)
def test_one_rank_equals_whole_vector_chain_bit_for_bit(one_rank, spec):
    want, _ = _port_chain(spec, 1)
    for s in range(STEPS):
        np.testing.assert_array_equal(one_rank[spec]["outs"][s], want[s])


@pytest.mark.parametrize("spec", SPECS)
def test_suspend_resume_keeps_the_trajectory(two_ranks, spec):
    """Two steps, suspend (the residual and the codec's counter or Q ride
    the stash), resume, two more: the uninterrupted run's bits."""
    for res in two_ranks:
        np.testing.assert_array_equal(res[f"pcrt/{spec}/params"],
                                      res[f"pc/{spec}/out/{STEPS - 1}"])


# ------------------------------------------------------------- the JAX slot

@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("spec", SPECS)
def test_matches_jax_slot(two_ranks, one_rank, spec, R):
    got = (one_rank[spec]["outs"] if R == 1 else
           [two_ranks[0][f"pc/{spec}/out/{s}"] for s in range(STEPS)])
    ref = _jax_slot(spec, R)
    for s in range(STEPS):
        np.testing.assert_allclose(got[s], ref["outs"][s], rtol=0,
                                   atol=JAX_ATOL)
    if spec.split(":")[0] in ("topk", "randomk"):
        for a, b in zip(_changed(got), _changed(ref["outs"])):
            np.testing.assert_array_equal(a, b)
    # control: a learning rate 1 % off must break the tolerance
    wrong = _jax_slot(spec, R, lr_scale=1.01)["outs"][-1]
    assert np.abs(got[-1] - wrong).max() > 10 * JAX_ATOL


@pytest.mark.parametrize("spec", SPECS)
def test_wire_is_the_payload(two_ranks, one_rank, spec):
    """The pull leg is the codec's payload share of each chunk (the JAX
    formula, equal to the JAX slot's pull leg), counted again under
    ``compression.param_wire_bytes``, and smaller than the push leg."""
    ref = _jax_slot(spec, 1)
    assert one_rank[spec]["payload"] == ref["payload"]
    assert one_rank[spec]["wire"][1] == ref["pull"]
    for res in two_ranks:
        push, pull = res[f"pc/{spec}/wire"]
        assert int(res[f"pc/{spec}/payload"]) == ref["payload"]
        assert pull == ref["pull"] == int(res[f"pc/{spec}/param_wire"])
        assert 0 < pull < push


def test_auto_is_the_lowest_error_rung_below_4_mib(one_rank):
    """``"auto"`` on a 12 KB tensor takes topk:0.25 (the ladder's lowest
    golden error), and its trajectory is that spec's."""
    assert one_rank["auto"]["kwargs"] == {"compressor": "topk", "k": "0.25",
                                          "ef": "vanilla"}
    for a, b in zip(one_rank["auto"]["outs"], one_rank["topk:0.25"]["outs"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nbytes", [0, 4096, 65535, 65536, 1 << 20,
                                    (4 << 20) - 1, 4 << 20, 1 << 30])
@pytest.mark.parametrize("ceiling", [0.55, 0.2, 1.0])
def test_plan_param_codec_matches_reference(nbytes, ceiling):
    kw = dict(min_compress_bytes=65536, compress_error_ceiling=ceiling)
    got = ChunkPlanner(Config(**kw)).plan_param_codec(nbytes)
    want = JaxPlanner(JaxConfig(**kw)).plan_param_codec(nbytes)
    assert got == want


# ------------------------------------------------------ gate and validation

@pytest.mark.parametrize("spec", ["", "auto", "onebit", "topk:0.25",
                                  "randomk:64", "dithering:16",
                                  "powersgd:2", "onebit:1"])
def test_every_reference_spec_is_accepted(spec):
    JaxConfig(sharded_update=True, sharded_param_codec=spec)
    cfg = Config(sharded_update=True, sharded_param_codec=spec)
    assert cfg.sharded_param_codec == spec


@pytest.mark.parametrize("spec", ["a:b:c", "top k", ":0.5"])
def test_malformed_specs_rejected_as_reference(spec):
    with pytest.raises(ValueError) as want:
        JaxConfig(sharded_update=True, sharded_param_codec=spec)
    with pytest.raises(ValueError) as got:
        Config(sharded_update=True, sharded_param_codec=spec)
    assert str(got.value) == str(want.value)


def test_codec_requires_sharded_update():
    with pytest.raises(ValueError, match="requires sharded_update"):
        Config(sharded_param_codec="onebit")


def test_env_var(monkeypatch):
    monkeypatch.setenv("BYTEPS_SHARDED_UPDATE", "1")
    monkeypatch.setenv("BYTEPS_SHARDED_PARAM_CODEC", "randomk:0.25")
    assert Config.from_env().sharded_param_codec == "randomk:0.25"


@pytest.mark.parametrize("spec,ceiling", [("onebit", 0.01),
                                          ("powersgd:2", 0.55)])
def test_quality_gate_error_text_matches_reference(spec, ceiling):
    from byteps_tpu.core.sharded_update import resolve_param_codec as jax_rp
    kw = dict(sharded_update=True, sharded_param_codec=spec,
              min_compress_bytes=0, compress_error_ceiling=ceiling)
    with pytest.raises(ValueError, match="quality gate") as want:
        jax_rp(JaxConfig(**kw), None, 1 << 20)
    with pytest.raises(ValueError, match="quality gate") as got:
        resolve_param_codec(Config(**kw), None, 1 << 20)
    assert str(got.value) == str(want.value)


def test_declare_update_runs_the_gate():
    api.init(Config(sharded_update=True, sharded_param_codec="onebit",
                    min_compress_bytes=0, compress_error_ceiling=0.01),
             device="cpu")
    try:
        with pytest.raises(ValueError, match="quality gate"):
            api.declare_update("w", (N,), torch.float32,
                               optimizer=W.PC_OPT)
        eng = api.engine()
        eng.cfg.sharded_param_codec = ""
        api.declare_update("v", (8,), torch.float32, optimizer=W.PC_OPT)
        with pytest.raises(ValueError, match="sharded_param_codec") as e:
            eng.push_pull_update_async(torch.zeros(8), "v",
                                       compression={"compressor": "onebit"})
        assert "not ported" not in str(e.value)
    finally:
        api.shutdown()


def test_parts_fallback_with_a_codec():
    """A small single-chunk tensor takes the parts fallback: the codec
    still quantizes its update (the chain's bits), the pull leg is
    accounted at full size, and the param-leg counter is not charged, as
    in the JAX engine."""
    n = 37
    api.init(Config(sharded_param_codec="onebit", **CFG), device="cpu")
    try:
        eng = api.engine()
        p0 = torch.from_numpy(W.init_param(3, n))
        api.declare_update("b", (n,), torch.float32, optimizer=W.PC_OPT,
                           init_value=p0)
        chain = registry.create(parse_codec_spec("onebit"), n)
        st = chain.init_state(torch.device("cpu"))
        m = p0.clone()
        opt = W.PC_OPT[0]([m], **W.PC_OPT[1])
        base = counters.get("compression.param_wire_bytes")
        before = dict(eng.stats)
        for s in range(3):
            g = torch.from_numpy(W.init_param(100 + s, n))
            out = api.push_pull_update(g, "b")
            prev = m.detach().clone()
            m.grad = g
            opt.step()
            with torch.no_grad():
                u = m - prev
                m.copy_(prev)
                payload, st = chain.compress(u, st)
                m.add_(chain.decompress(payload))
            assert torch.equal(out, m)
        assert eng.stats["wire_pull"] - before["wire_pull"] == 3 * n * 4
        assert counters.get("compression.param_wire_bytes") == base
    finally:
        api.shutdown()


def test_reference_codec_leg_fails_at_two_devices():
    """ROADMAP Queue C 16: the JAX slot's codec leg at two devices
    raises (its emit program was compiled for a sharded input, and the
    dequantized update arrives replicated); the port's runs (the
    two-rank cases above)."""
    comm = JaxComm(mesh=_build_mesh(jax.devices()[:2], 1), n_dcn=1, n_ici=2)
    eng = JaxEngine(comm, JaxConfig(sharded_param_codec="onebit", **CFG))
    try:
        eng.declare_update("w", (N,), np.float32,
                           tx=optax.sgd(0.1, momentum=0.9), init_value=P0)
        with pytest.raises(RuntimeError, match="sharding"):
            eng.push_pull_update(W.pc_grads("onebit", 0, 2), "w",
                                 stacked=True)
    finally:
        eng.shutdown(wait=True)
