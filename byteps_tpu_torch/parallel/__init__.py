"""Parallel training strategies of the port (``byteps_tpu/parallel``
counterparts): the fused data-parallel step (``data_parallel.py``),
ZeRO-1 and flat FSDP (``zero.py``), and the sequence-parallel attention
kinds ported so far (``sequence.py``, ``long_context.py``)."""

from .data_parallel import (  # noqa: F401
    make_dp_train_step,
    make_dp_train_step_with_state,
    replicate,
    shard_batch,
)
