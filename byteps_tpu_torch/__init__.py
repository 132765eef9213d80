"""byteps_tpu_torch: the PyTorch/CUDA port of ``byteps_tpu``.

A second package beside the JAX one, which stays the reference.  It
imports torch and never jax, nor anything of ``byteps_tpu``.  Entry
points run on the card unless the caller passes ``device="cpu"``.

The data-parallel gradient path is ported: ``DistributedOptimizer`` ->
``push_pull_async`` -> the engine (registry keys, partitioning at the
auto-tuned planner's chunk size, priority and credit scheduling in the
native queue, chunk-group dispatch and per-unit retirement threads) ->
an all-reduce over ``torch.distributed``, or for compressed tensors the
compressed push_pull of a codec of ``compression`` (onebit, whose pack,
unpack and merge are CUDA kernels of ``csrc/onebit.cu``; topk, randomk,
dithering, PowerSGD; error feedback and Nesterov momentum), chosen per
tensor or by the planner's compressor ladder.  Besides
``DistributedOptimizer`` the adapter has ``DistributedDataParallel``,
``CrossBarrier``, ``HalfPrecisionDistributedOptimizer`` and
``Compression``.  ``models`` carries the ResNet family, GPT and Llama,
whose attention is the flash kernels of ``csrc/flash_attention.cu``.
Under ``Config.sharded_update`` the engine also runs the optimizer on
each tensor's owner-resident reduce-scatter shard
(``core/sharded_update.py``, ``DistributedOptimizer(sharded_update=
True)``), and ``parallel/zero.py`` has the ZeRO-1 and flat FSDP steps.
The async parameter server: ``AsyncDistributedOptimizer`` pushes each
step's weight deltas, sealed in CRC32C envelopes
(``common/integrity.py``), to a ``KVStore`` that sums them on arrival,
and pulls the fresh weights; ``ServerEngine`` is the reference's
synchronous merge; ``fault/injector.py`` injects seeded faults into
their wire hops.  The observability plane (``common/tracing.py``,
``telemetry.py``, ``flight_recorder.py``, ``lock_witness.py``,
``timeseries.py``, ``health.py``, ``obs_server.py``) traces and
attributes every step, keeps a black box, and serves ``/metrics``,
``/healthz``, ``/debug/state`` and ``/timeseries`` under the JAX
package's names; ``metrics_snapshot()`` reads it in process.  Under
``Config.sharded_param_codec`` the sharded update's pull leg carries a
codec's payload (``core/param_codec.py``).

The package exports the JAX package's top level (``byteps_tpu/__init__.py``)
beside the adapter's names: the serving plane (``start_serving``,
``start_serving_tier``, ``PullClient``, ``ServingPlane``, ``ServingTier``,
``SnapshotStore``), ``durable_kv_store`` and ``__version__``.  The JAX
names the port leaves out stand, each with its reason, in ``_jax_only.py``.
"""

__version__ = "0.1.0"

from .torch import *  # noqa: F401,F403,E402 — the adapter's surface
from .torch import __all__ as _adapter_all  # noqa: E402
from .core.api import (durable_kv_store, start_serving,  # noqa: F401,E402
                       start_serving_tier)
from .server import (PullClient, ServingPlane, ServingTier,  # noqa: F401,E402
                     SnapshotStore)

__all__ = [*_adapter_all, "start_serving", "start_serving_tier",
           "durable_kv_store", "PullClient", "ServingPlane", "ServingTier",
           "SnapshotStore"]
