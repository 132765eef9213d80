"""Long-context language-model training data; port of
``synthetic_lm_batch`` from ``byteps_tpu/parallel/long_context.py``.

The JAX package trains an LM with ``make_dp_sp_train_step``, which sums
each device's token NLL and divides by the token count summed over the
whole (dp, sp) mesh.  The port trains through ``DistributedOptimizer``,
which averages each rank's gradient of its own ``lm_loss`` (NLL summed
over its tokens and divided by its own count).  The two agree when every
rank holds the same number of valid tokens, as the synthetic batch does
(one ignored position per row), and at one rank they are the same
objective.  The global-count normalization for uneven masking is not
ported yet (ROADMAP Queue A, with ``make_dp_sp_train_step``).
"""

from __future__ import annotations

from typing import Dict

import torch


def synthetic_lm_batch(generator: torch.Generator, cfg, batch: int,
                       seq_len: int) -> Dict[str, torch.Tensor]:
    """``[B, T]`` token ids drawn from ``generator`` (on its device), and
    the labels shifted by one with the last position ignored (-1)."""
    ids = torch.randint(0, cfg.vocab_size, (batch, seq_len),
                        generator=generator, device=generator.device)
    labels = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -1)], dim=1)
    return {"input_ids": ids, "labels": labels}
