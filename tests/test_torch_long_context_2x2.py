"""The port's ``(dp, sp)`` training step at ``(dp 2, sp 2)`` against the
JAX package's, at 4 gloo ranks: ``gpt_tiny`` with every
sequence-parallel kind, 3 SGD steps, the losses to rtol 1e-5 and the
parameters to atol 2e-5 (the cases and tolerances of
``test_torch_long_context.py``, whose helpers this file uses; apart so
that each file runs in under a minute alone).
"""

import pytest

from .test_torch_long_context import (KINDS, check, jax_steps, make_inputs,
                                      start_port)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    inp, models, batches = make_inputs()
    results, pool = start_port(tmp_path_factory.mktemp("torch_lc22"), inp,
                               2, 2)
    yield models, batches, results
    pool.shutdown(wait=True)


@pytest.mark.parametrize("kind", KINDS)
def test_gpt_step_matches_jax_2x2(setup, kind):
    models, batches, results = setup
    cfg, params = models["gpt"]
    losses, want = jax_steps(cfg, params, batches["batch"], kind, 2, 2)
    for r in results():
        check(r, f"gpt_{kind}_2x2", losses, want)
