"""MXNet framework adapter; port of ``byteps_tpu/mxnet/__init__.py``.

Counterpart of the reference's byteps.mxnet plugin (mxnet/__init__.py,
mxnet/ops.py — SURVEY.md §2.4): the same surface —
``byteps_push_pull`` / ``byteps_declare_tensor`` (in-place, engine-async
in the reference), ``DistributedOptimizer`` (update = push_pull then local
update; async-PS mode pushes weight deltas), ``broadcast_parameters``
(zero-non-root + sum), and the gluon ``DistributedTrainer``
(``_allreduce_grads`` with 1/batch/size pre-scaling and per-parameter
intra-compressors) — running through the port's engine: each gradient,
a host array, is staged onto the engine's device (the card) and reduced
there (``PushPullEngine.push_pull_local``), through the onebit kernels
when it is declared with ``byteps_compressor_type=onebit``.

MXNet itself is optional: everything except ``DistributedTrainer`` is
duck-typed to the NDArray protocol (``asnumpy()``/``tensor[:] =``), so
the adapter imports and tests without mxnet installed;
``DistributedTrainer`` (a ``mx.gluon.Trainer`` subclass) is constructed
lazily and raises ImportError if mxnet is absent.

Deliberate departures from the reference:
- no ``lr.s`` mmap file (mxnet/__init__.py:211-214 wrote the trainer lr
  for the server-side vanilla-EF scale): the engine's error-feedback
  decorator takes lr explicitly via compression kwargs;
- compression_params are forwarded to the *engine's* compressor registry
  (``compression/``) rather than a serialized kwargs dict pushed to
  server processes;
- the async-PS mode's KV store (``server/kv_store.py``) lives in this
  process, its codecs on the engine's device.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict

from ..core import api as _api
from .compression import Compression
from .ops import (byteps_declare_tensor, byteps_push_pull,
                  compression_kwargs, _reset_declared)

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "byteps_push_pull", "byteps_declare_tensor", "DistributedOptimizer",
    "broadcast_parameters", "DistributedTrainer", "Compression",
]

init = _api.init
rank = _api.rank
size = _api.size
local_rank = _api.local_rank
local_size = _api.local_size

parameter_index = 0


def shutdown(*a, **kw):
    _reset_declared()
    return _api.shutdown(*a, **kw)


class DistributedOptimizer:
    """Wraps an MXNet optimizer: ``update`` runs push_pull on the gradient
    then the local update (reference mxnet/__init__.py:35-121); in async-PS
    mode it updates locally, pushes the weight *delta*, and pulls merged
    weights back (reference mxnet/__init__.py:74-92)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        from ..common.config import get_config
        self._enable_async = get_config().enable_async
        if self._enable_async:
            from ..server.kv_store import KVStore
            self._store = KVStore(device=_api.device())

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def create_state_multi_precision(self, index, weight):
        return self._optimizer.create_state_multi_precision(index, weight)

    @staticmethod
    def _as_lists(index, tensors):
        if isinstance(index, (tuple, list)):
            return list(index), list(tensors)
        return [index], [tensors]

    def _do_push_pull(self, index, grad):
        idxs, grads = self._as_lists(index, grad)
        for i, g in zip(idxs, grads):
            byteps_declare_tensor("gradient_" + str(i))
            byteps_push_pull(g, version=0, priority=-i,
                             name="gradient_" + str(i), is_average=True)

    def _update(self, index, weight, grad, state, method_name: str):
        inner = getattr(self._optimizer, method_name)
        if self._enable_async:
            # async-PS protocol (reference mxnet/__init__.py:74-92): update
            # locally, push the weight *delta* into the KV store (the
            # server's sum-on-arrival, server.cc:310-314), pull the merged
            # weights back — no barrier with other workers.
            idxs, weights = self._as_lists(index, weight)
            before = [w.asnumpy().copy() for w in weights]
            inner(index, weight, grad, state)
            for i, w, b in zip(idxs, weights, before):
                name = "weight_" + str(i)
                if name not in self._store.keys():
                    self._store.init_key(name, b)
                self._store.push_delta(name, w.asnumpy() - b)
                w[:] = self._store.pull(name).numpy()
        else:
            self._do_push_pull(index, grad)
            inner(index, weight, grad, state)

    def update(self, index, weight, grad, state):
        self._update(index, weight, grad, state, "update")

    def update_multi_precision(self, index, weight, grad, state):
        self._update(index, weight, grad, state, "update_multi_precision")

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self._optimizer.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._optimizer.set_wd_mult(args_wd_mult)


def broadcast_parameters(params: Dict[str, Any], root_rank: int = 0) -> None:
    """Broadcast a dict of parameters from ``root_rank`` (reference
    mxnet/__init__.py:124-161): zero-out non-root tensors, then a sum
    push_pull — broadcast as push+pull."""
    global parameter_index
    if not isinstance(params, dict):
        raise ValueError(f"Invalid params of type: {type(params)}")
    tensors = [p for _, p in sorted(params.items())]
    for t in tensors:
        name = "parameter_" + str(parameter_index)
        byteps_declare_tensor(name)
        if rank() != root_rank:
            t.__imul__(0)
        byteps_push_pull(t, version=0, priority=0, name=name,
                         is_average=False)
        parameter_index += 1


def _register_compression_attrs(params, optimizer_params,
                                compression_params) -> Any:
    """Translate a user-facing compression_params dict into per-parameter
    ``byteps_*`` attributes + the intra-worker compressor chain (reference
    mxnet/__init__.py:236-316)."""
    intra = Compression.none
    if not compression_params:
        return intra
    if compression_params.get("fp16"):
        intra = Compression.fp16
    if "compressor" not in compression_params:
        warnings.warn("Compressor is not defined")
        return intra

    compressor = compression_params["compressor"]
    for _, param in params.items():
        for item in ("compressor", "ef", "momentum"):
            if compression_params.get(item):
                if not isinstance(compression_params[item], str):
                    raise TypeError(f"{item} should be str")
                setattr(param, f"byteps_{item}_type",
                        compression_params[item])
        if compressor == "onebit":
            setattr(param, "byteps_compressor_onebit_scaling",
                    str(compression_params.get("scaling", False)))
        elif compressor in ("topk", "randomk", "dithering"):
            setattr(param, "byteps_compressor_k", compression_params["k"])
        if compression_params.get("momentum"):
            setattr(param, "byteps_momentum_mu",
                    optimizer_params["momentum"])
        if compression_params.get("seed") is not None:
            setattr(param, "byteps_seed", compression_params["seed"])
        if compression_params.get("partition"):
            part = {"linear": "0", "natural": "1"}.get(
                compression_params["partition"])
            if part is None:
                raise ValueError("Unsupported partition")
            setattr(param, "byteps_dithering_partition", part)
        if compression_params.get("normalize"):
            norm = {"max": "0", "l2": "1"}.get(
                compression_params["normalize"])
            if norm is None:
                raise ValueError("Unsupported normalization")
            setattr(param, "byteps_dithering_normalize", norm)

    if compression_params.get("momentum"):
        import os
        threshold = int(os.environ.get("BYTEPS_MIN_COMPRESS_BYTES", 65536))
        mu = optimizer_params["momentum"]
        if compressor == "onebit" and "wd" in optimizer_params:
            wd = optimizer_params["wd"]
            intra = Compression.wdmom(intra, mu, wd, threshold)
            del optimizer_params["wd"]
        intra = Compression.nag(intra, mu, threshold)
        del optimizer_params["momentum"]
    return intra


def DistributedTrainer(params, optimizer, optimizer_params=None,
                       root_rank: int = 0, compression_params=None):
    """gluon Trainer whose ``_allreduce_grads`` runs through the engine
    (reference mxnet/__init__.py:164-343): grads pre-scaled by
    1/batch_size/num_workers, summed via push_pull, intra-compressor
    applied around the hop; first ``step`` broadcasts initial params from
    ``root_rank``.  Requires mxnet (ImportError otherwise)."""
    try:
        import mxnet as mx
    except ImportError as e:
        raise ImportError(
            "byteps_tpu_torch.mxnet.DistributedTrainer requires mxnet; the "
            "rest of the adapter (DistributedOptimizer, byteps_push_pull, "
            "broadcast_parameters) works without it") from e

    import copy

    class _DistributedTrainer(mx.gluon.Trainer):
        def __init__(self, params, optimizer, optimizer_params=None,
                     root_rank=0, compression_params=None):
            if isinstance(optimizer, DistributedOptimizer):
                optimizer = optimizer._optimizer
                warnings.warn("DistributedTrainer does not take "
                              "DistributedOptimizer; unwrapped it for you.")
            param_list = params
            if isinstance(params, dict):
                param_list = [params[k] for k in sorted(params)]
            optimizer_params = dict(optimizer_params or {})
            self._intra_compressor = _register_compression_attrs(
                dict(enumerate(param_list)) if not isinstance(params, dict)
                else params, optimizer_params, compression_params)
            super().__init__(param_list, optimizer,
                             optimizer_params=optimizer_params,
                             kvstore=None)
            # workers = processes = ranks (one process a device): the
            # reference's 1/size() pre-scale (mxnet/__init__.py:320-343)
            self._bps_num_workers = size()
            self.root_rank = root_rank
            self._intra_compressors = {
                p.name: copy.deepcopy(self._intra_compressor)
                for p in self._params}
            for i, param in enumerate(self._params):
                byteps_declare_tensor("parameter_" + str(i))
                if param.grad_req != "null":
                    bp = {k: v for k, v in param.__dict__.items()
                          if k.startswith("byteps_")}
                    byteps_declare_tensor("gradient_" + str(i), **bp)

        def step(self, batch_size, ignore_stale_grad=False):
            # grads are pre-normalized in _allreduce_grads; _scale set to
            # batch_size prevents double normalization
            self._scale = batch_size
            super().step(batch_size, ignore_stale_grad)

        def _allreduce_grads(self):
            for i, param in enumerate(self._params):
                if param.grad_req == "null":
                    continue
                g = param._grad[0]
                g[:] = g.asnumpy() * (1.0 / self._scale
                                      / self._bps_num_workers)
                comp = self._intra_compressors[param.name]
                compressed, ctx = comp.compress(g)
                byteps_push_pull(compressed, is_average=False,
                                 name="gradient_" + str(i), priority=-i)
                g[:] = comp.decompress(compressed, ctx,
                                       x=param._data[0]).asnumpy()

        def _init_params(self):
            tensors = []
            for param in self._params_to_init:
                if param._deferred_init:
                    tensors.append(param)
                    continue
                arrs = param._check_and_get(param._data, list)
                idx = self._param2idx[param.name]
                if rank() != self.root_rank:
                    arrs[0].__imul__(0)
                byteps_push_pull(arrs[0], version=0, priority=0,
                                 name="parameter_" + str(idx),
                                 is_average=False)
            self._params_to_init = tensors

    return _DistributedTrainer(params, optimizer, optimizer_params,
                               root_rank, compression_params)
