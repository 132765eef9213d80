"""``remat`` of the port's LMs (``models/gpt.py``, ``models/llama.py``):
each block under ``torch.utils.checkpoint`` recomputes its forward in the
backward with the same ops on the same inputs, so the loss and every
gradient must be bit-equal with and without it (tolerance 0), in f32 and
in the models' bf16 compute.  The JAX configs carry the same field
(``byteps_tpu/models/gpt.py:37``, ``llama.py:54``)."""

import dataclasses

import pytest
import torch

from byteps_tpu.models import gpt as jgpt
from byteps_tpu.models import llama as jllama
from byteps_tpu_torch.models import gpt, llama

MODELS = {"gpt": (gpt.GPT, gpt.gpt_tiny), "llama": (llama.Llama,
                                                     llama.llama_tiny)}


def _run(name, dtype, remat):
    cls, cfg_fn = MODELS[name]
    cfg = dataclasses.replace(cfg_fn(), dtype=dtype, remat=remat)
    model = cls(cfg, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    logits = model(ids[:, :-1])
    loss = gpt.lm_loss(logits, ids[:, 1:])
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_remat_keeps_loss_and_gradient_bits(name, dtype):
    l0, g0 = _run(name, dtype, False)
    l1, g1 = _run(name, dtype, True)
    assert torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


@pytest.mark.parametrize("name", list(MODELS))
def test_remat_recomputes_each_block_in_the_backward(name, monkeypatch):
    """With remat each block's forward runs twice per step (once more in
    the backward), without it once; under no_grad it is never
    checkpointed."""
    cls, cfg_fn = MODELS[name]
    calls = []
    block_cls = type(cls(cfg_fn(), device="meta",
                         generator=torch.Generator()).h[0])
    real = block_cls.forward

    def counting(self, *a):
        calls.append(1)
        return real(self, *a)

    monkeypatch.setattr(block_cls, "forward", counting)
    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        _run(name, torch.float32, remat)
        assert len(calls) == want * cfg_fn().num_layers
    model = cls(dataclasses.replace(cfg_fn(), remat=True),
                generator=torch.Generator().manual_seed(0))
    calls.clear()
    with torch.no_grad():
        model(torch.zeros(1, 4, dtype=torch.long))
    assert len(calls) == cfg_fn().num_layers


@pytest.mark.parametrize("module", [jgpt, jllama], ids=["gpt", "llama"])
def test_config_field_matches_jax(module):
    port = {"GPTConfig": gpt.GPTConfig, "LlamaConfig": llama.LlamaConfig}
    name = "GPTConfig" if module is jgpt else "LlamaConfig"
    jf = {f.name: f.default for f in dataclasses.fields(getattr(module,
                                                                name))}
    pf = {f.name: f.default for f in dataclasses.fields(port[name])}
    assert jf["remat"] is pf["remat"] is False
