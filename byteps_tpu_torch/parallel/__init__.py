"""Parallel training strategies of the port (``byteps_tpu/parallel``
counterparts): the fused data-parallel step (``data_parallel.py``),
ZeRO-1 and flat FSDP (``zero.py``), the 2-D layouts of ranks
(``mesh_util.py``), sequence parallelism (``sequence.py``: ring, striped
ring and Ulysses; ``ring_flash.py``: the flash kernels inside the ring;
``long_context.py``: the ``(dp, sp)`` training step) and expert
parallelism (``expert.py``: switch MoE over an all-to-all;
``moe_lm.py``: the ``(dp, ep)`` MoE GPT step)."""

from .data_parallel import (  # noqa: F401
    make_dp_train_step,
    make_dp_train_step_with_state,
    replicate,
    shard_batch,
)
from .sequence import (  # noqa: F401
    full_attention,
    make_sp_attention,
    make_sp_mesh,
    ring_attention,
    stripe_batch,
    striped_attention,
    unstripe_batch,
    sp_mesh_from_comm,
    ulysses_attention,
)
from .ring_flash import ring_flash_attention  # noqa: F401
from .long_context import (  # noqa: F401
    make_dp_sp_train_step,
    shard_lm_batch,
    synthetic_lm_batch,
)
from .expert import (  # noqa: F401
    init_moe_params,
    make_dp_ep_train_step,
    make_ep_mesh,
    moe_mlp,
    moe_mlp_reference,
    shard_moe_params,
)
from .moe_lm import (  # noqa: F401
    make_moe_lm_train_step,
    shard_moe_lm_batch,
    shard_moe_lm_params,
)
