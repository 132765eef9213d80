"""BERT's masked-LM model through the port's ``models/bert.py``: f32
parameters, compute in the configuration's dtype, the head gathered at
the masked positions, the port's masked-LM loss."""

from __future__ import annotations

import torch


def build(config: dict, device) -> torch.nn.Module:
    """The model on ``device``, its own draws made there (the benchmark
    then loads its weights; a model drawn on ``meta`` would import
    ``torch._dynamo`` for the draws, seconds of set-up)."""
    from byteps_tpu_torch.models import bert
    cfg = bert.BertConfig(
        vocab_size=config["vocab_size"], hidden_size=config["hidden_size"],
        num_layers=config["num_hidden_layers"],
        num_heads=config["num_attention_heads"],
        intermediate_size=config["intermediate_size"],
        max_position=config["max_position_embeddings"],
        type_vocab_size=config["type_vocab_size"],
        dtype=getattr(torch, config["compute_dtype"]))
    return bert.BertForMLM(cfg, device=device,
                           generator=torch.Generator(device=device))


def loss(model: torch.nn.Module, batch: dict) -> torch.Tensor:
    from byteps_tpu_torch.models import bert
    logits = model(batch["input_ids"], batch["attention_mask"],
                   masked_positions=batch["masked_positions"])
    return bert.mlm_loss(logits, batch["masked_labels"])
