"""Image classification batches: NHWC float32 images, standard normal,
and labels uniform over the classes."""

import torch


def make(config: dict, traffic: dict, batch: int, g: torch.Generator,
         device) -> dict:
    s = config["image_size"]
    return {"images": torch.randn(batch, s, s, config["channels"],
                                  generator=g, device=device),
            "labels": torch.randint(0, config["num_classes"], (batch,),
                                    generator=g, device=device)}
