"""BERT's FLOPs a sequence of masked-LM pretraining.

Forward, per token and encoder layer: the query, key, value and output
projections ``2 * 4 * H * H``, the feed-forward block ``2 * 2 * H * F``,
and attention's scores and context ``2 * 2 * T * H`` at sequence length
``T``.  The masked-LM head runs at the ``P`` masked positions only:
``2 * H * H + 2 * H * V``.  The embedding lookups are no FLOPs.
Training is three times the forward: every product also takes the
gradient of its weights and of its input (the first layer's input
gradient feeds the embeddings' gradient).  LayerNorm, GELU, softmax and
the loss are not counted.
"""

from __future__ import annotations


def forward_flops(config: dict, traffic: dict) -> int:
    h, f = config["hidden_size"], config["intermediate_size"]
    v, n_layers = config["vocab_size"], config["num_hidden_layers"]
    t = traffic["seq_len"]
    p = int(t * traffic["mask_frac"])
    per_token = 2 * 4 * h * h + 2 * 2 * h * f + 2 * 2 * t * h
    head = p * (2 * h * h + 2 * h * v)
    return n_layers * t * per_token + head


def train_flops_per_sample(config: dict, traffic: dict) -> int:
    return 3 * forward_flops(config, traffic)
