"""BytePS-backed ``tf.distribute`` integration; port of
``byteps_tpu/tensorflow/distribute/__init__.py``.

Counterpart of the reference's forked MirroredStrategy
(byteps/tensorflow/distribute/mirrored_strategy.py:349-,
cross_device_ops.py:585-627 — SURVEY.md §2.4): a strategy whose
cross-device reduction routes through the port's engine instead of
TF's collective ops.  Where the reference vendors ~1.6k lines of TF1
strategy internals to splice `push_pull` into `_batch_all_reduce`, TF2
exposes the seam as a public extension point — ``tf.distribute
.CrossDeviceOps`` — so the rebuild is a small subclass:

- ``BytePSCrossDeviceOps``: reduce = local add_n over the worker's
  replicas, then one engine push_pull across workers (the hierarchical
  two-level reduction, with the engine replacing ps-lite), then mirror
  to destinations.
- ``MirroredStrategy``: ``tf.distribute.MirroredStrategy`` with the
  BytePS cross-device ops pre-installed, mirroring the reference's
  ``MirroredStrategy(devices=..., cross_device_ops=...)`` constructor.

Unlike the JAX module, a reduction with one local replica still crosses
the processes: TensorFlow's own ``reduce`` / ``batch_reduce`` return such
a value untouched, which with one process a card would never reduce.

Same caveat as the rest of the TF adapter: the engine hop is a host
callback, so wrap steps in plain ``tf.function`` (no jit_compile) or run
eagerly.
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional

import numpy as np
import tensorflow as tf

from tensorflow.python.distribute import cross_device_ops as _cdo_lib

from .. import _engine_reduce, _anon_name
from ...core import api as _api

__all__ = ["BytePSCrossDeviceOps", "MirroredStrategy"]


class BytePSCrossDeviceOps(tf.distribute.CrossDeviceOps):
    """Cross-device reduction through the port's engine.

    Reference parity: BytepsCrossDeviceOps / BytepsAllReduce
    (cross_device_ops.py:585-627) — per-replica values are summed locally,
    pushed/pulled across workers, and the merged result is mirrored to the
    destination devices.  ``num_packs`` is accepted for API parity with the
    reference's gradient-chunking (cross_device_ops.py:251-280); chunking
    into engine partitions already happens inside the engine, so it is
    unused here.
    """

    _instances = itertools.count()

    def __init__(self, num_packs: int = 1):
        super().__init__()
        self.num_packs = num_packs
        self._lock = threading.Lock()
        self._counter = 0
        # disambiguates the positional-name fallback: two instances (or two
        # unnamed reductions of the same shape/dtype) must not alias onto
        # one engine tensor and share declared state/priority/compression
        self._instance_id = next(BytePSCrossDeviceOps._instances)

    # -- helpers -----------------------------------------------------------

    def _next_priority(self) -> int:
        # earlier reductions in a step get higher priority (reference
        # priority = -declared order, tensorflow/ops.cc:158)
        with self._lock:
            self._counter += 1
            return -self._counter

    def _stable_name(self, per_replica_value, destinations, pos: int) -> str:
        """Engine tensor name, stable across eager steps: derived from the
        destination variable when there is one (TF variable names are
        unique), else from instance+position+shape.  A fresh anonymous name
        per call would grow the engine registry without bound in eager
        loops; the instance id keeps unnamed reductions of the same
        shape/dtype from aliasing across strategy objects."""
        for obj in (destinations,
                    getattr(destinations, "primary", None)):
            name = getattr(obj, "name", None)
            if isinstance(name, str) and name:
                return f"tf.distribute.reduce.{name}"
        vals = BytePSCrossDeviceOps._local_values(per_replica_value)
        t = tf.convert_to_tensor(vals[0])
        shape = "x".join(str(d) for d in t.shape.as_list())
        return (f"tf.distribute.reduce.i{self._instance_id}"
                f".{pos}.{shape}.{t.dtype.name}")

    def _reduce_values(self, reduce_op, per_replica_value, name: str,
                       priority: Optional[int] = None):
        values = [tf.convert_to_tensor(v)
                  for v in self._local_values(per_replica_value)]
        local = values[0] if len(values) == 1 else tf.add_n(values)
        if priority is None:
            priority = self._next_priority()

        def _host(v):
            vn = v.numpy()
            out = _engine_reduce(vn, name, "sum", priority)
            return out.reshape(vn.shape)

        reduced = tf.py_function(_host, [local], Tout=local.dtype,
                                 name="BytePSCrossDeviceReduce")
        reduced.set_shape(local.shape)
        if reduce_op == tf.distribute.ReduceOp.MEAN:
            # global replicas = local replicas x processes; the engine sum
            # is over processes (one a device: size())
            reduced = reduced / (len(values) * _api.size())
        return reduced

    @staticmethod
    def _local_values(per_replica_value):
        if hasattr(per_replica_value, "values"):
            return per_replica_value.values
        return (per_replica_value,)

    # -- CrossDeviceOps interface -----------------------------------------

    # TensorFlow's reduce and batch_reduce hand a single local replica's
    # value back as it is when the strategy knows of one worker; here the
    # other workers are the engine's processes (one a card), so every
    # reduction goes through the engine
    def reduce(self, reduce_op, per_replica_value, destinations,
               options=None):
        return self.reduce_implementation(reduce_op, per_replica_value,
                                          destinations, options)

    def batch_reduce(self, reduce_op, value_destination_pairs,
                     options=None):
        return self.batch_reduce_implementation(
            reduce_op, value_destination_pairs, options)

    def reduce_implementation(self, reduce_op, per_replica_value,
                              destinations, options, _pos: int = 0):
        name = self._stable_name(per_replica_value, destinations, _pos)
        reduced = self._reduce_values(reduce_op, per_replica_value, name,
                                      priority=-_pos)
        return _cdo_lib.simple_broadcast(reduced, destinations,
                                         always_mirrored=True)

    def batch_reduce_implementation(self, reduce_op, value_destination_pairs,
                                    options):
        # positional order drives priority so the last-computed gradients
        # (first layers) are reduced first; names are destination-stable
        return [
            self.reduce_implementation(reduce_op, value, dest, options,
                                       _pos=i)
            for i, (value, dest) in enumerate(value_destination_pairs)
        ]

    def broadcast_implementation(self, tensor, destinations):
        # cross-worker broadcast = zero-non-root + sum push_pull (the
        # reference's broadcast identity, torch/__init__.py:259-291)
        name = _anon_name("tf.distribute.broadcast")
        tensor = tf.convert_to_tensor(tensor)

        def _host(v):
            vn = v.numpy()
            if _api.rank() != 0:
                vn = np.zeros_like(vn)
            return _engine_reduce(vn, name, "sum").reshape(vn.shape)

        out = tf.py_function(_host, [tensor], Tout=tensor.dtype,
                             name="BytePSBroadcast")
        out.set_shape(tensor.shape)
        return _cdo_lib.simple_broadcast(out, destinations,
                                         always_mirrored=True)


class MirroredStrategy(tf.distribute.MirroredStrategy):
    """``tf.distribute.MirroredStrategy`` with BytePS cross-device ops.

    Reference parity: MirroredStrategy(devices, cross_device_ops)
    (mirrored_strategy.py:349-372).  Initializes the engine on first use so
    ``strategy.reduce`` / ``strategy.run`` work without an explicit
    ``bps.init()``.
    """

    def __init__(self, devices=None,
                 cross_device_ops: Optional[tf.distribute.CrossDeviceOps]
                 = None):
        if not _api.initialized():
            _api.init()
        super().__init__(
            devices=devices,
            cross_device_ops=cross_device_ops or BytePSCrossDeviceOps())
