"""Parallel training strategies of the port (``byteps_tpu/parallel``
counterparts): the fused data-parallel step (``data_parallel.py``),
ZeRO-1 and flat FSDP (``zero.py``), the 2-D layouts of ranks
(``mesh_util.py``), sequence parallelism (``sequence.py``: ring, striped
ring and Ulysses; ``ring_flash.py``: the flash kernels inside the ring;
``long_context.py``: the ``(dp, sp)`` training step), expert
parallelism (``expert.py``: switch MoE over an all-to-all;
``moe_lm.py``: the ``(dp, ep)`` MoE GPT step), tensor parallelism
(``tensor_parallel.py``, on the building blocks of ``tp_layers.py``),
pipeline parallelism (``pipeline.py``, GPipe with its backward written
out), the ``(dp, pp, tp)`` composite (``three_d.py``) and the streamed
``(fsdp, tp)`` Llama composite (``fsdp_tp.py``, ZeRO-3 by gathered
products).  Every layout is held step for step against the JAX
package's by its CPU test file."""

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
from .pipeline import (  # noqa: F401
    init_pipeline_params,
    make_dp_pp_train_step,
    make_pp_mesh,
    pipeline_params_to_gpt,
    shard_pipeline_params,
    shard_pp_batch,
)
from .zero import (  # noqa: F401
    ZeroState,
    init_zero_state,
    make_fsdp_train_step,
    make_zero_train_step,
    zero_params,
)
from .tensor_parallel import (  # noqa: F401
    init_tp_opt_state,
    make_dp_tp_train_step,
    make_tp_mesh,
    shard_gpt_params,
    shard_tp_batch,
)
from .three_d import (  # noqa: F401
    init_3d_opt_state,
    make_3d_mesh,
    make_dp_pp_tp_train_step,
    shard_3d_batch,
    shard_3d_params,
)
from .fsdp_tp import (  # noqa: F401
    init_llama_opt_state,
    init_llama_params_sharded,
    llama_shardings,
    make_fsdp_tp_mesh,
    make_fsdp_tp_train_step,
    shard_llama_batch,
    shard_llama_params,
)
