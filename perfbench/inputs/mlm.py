"""Masked-LM pretraining rows: token ids uniform over the published
vocabulary, ``int(seq_len * mask_frac)`` distinct positions of each row
masked (sorted), their ids replaced by ``mask_token_id``."""

import torch


def make(config: dict, traffic: dict, batch: int, g: torch.Generator,
         device) -> dict:
    t = traffic["seq_len"]
    p = int(t * traffic["mask_frac"])
    ids = torch.randint(0, config["published_vocab_size"], (batch, t),
                        generator=g, device=device)
    order = torch.rand(batch, t, generator=g, device=device).argsort(dim=1)
    positions = order[:, :p].sort(dim=1).values
    labels = torch.gather(ids, 1, positions)
    masked = ids.scatter(1, positions,
                         torch.full_like(positions,
                                         config["mask_token_id"]))
    return {"input_ids": masked,
            "attention_mask": torch.ones(batch, t, dtype=torch.int64,
                                         device=device),
            "masked_positions": positions, "masked_labels": labels}
