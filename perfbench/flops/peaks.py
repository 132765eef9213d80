"""The published peaks every share of a peak or a roofline is taken
against: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at
its full power limit of 700 W.  A run prints the card's own power limit
beside its result (``nvidia-smi``); a card set below 700 W reaches less.
"""

H100_SXM = {
    "name": "NVIDIA H100 SXM, data sheet, dense, 700 W",
    "bf16_flop_per_s": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}
