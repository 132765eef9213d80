"""Asynchronous-PS training mode (BYTEPS_ENABLE_ASYNC equivalent); port of
``byteps_tpu/jax/async_opt.py`` for the torch frontend.

Reference behavior (torch/__init__.py:186-214, server.cc:310-314): each
worker trains locally, pushes the *weight delta* of its step to the
server (summed on arrival, no barrier), and pulls the current global
weights — trading gradient-consistency for the absence of stragglers'
barriers.  The server is the host-side ``KVStore`` (``server/
kv_store.py``); there is no gradient collective anywhere on this path.

One step of :class:`AsyncDistributedOptimizer`, on the parameters'
device:

1. snapshot the parameters and run the inner ``torch.optim`` step (or,
   with ``sharded_update``, the slot's step on its f32 master);
2. ``delta = new - old`` in f32 on the card — one IEEE subtraction, the
   bits numpy computes on the host in the JAX package;
3. the deltas go to the host through pinned staging buffers (or, with
   ``compression``, each is compressed on the card by the worker chain —
   onebit's pack and the EF residual's unpack are CUDA kernels — and its
   wire frame crosses instead);
4. each is pushed with a ``(worker_id, seq)`` token and the membership
   epoch stamped once per logical push, retried with the same token on
   :class:`~byteps_tpu_torch.common.integrity.AckLost` (the store's dedup
   makes a retry a no-op);
5. the fresh value is pulled and ``copy_``'d into the parameter.

``stage_ms`` holds the host milliseconds of the last step's stages
(``d2h``, ``push``, ``pull``, ``h2d``).

The optimizer talks to a ``KVStore`` in its own process (several
workers of one process may share it).  Across processes the TCP
transport (``comm/transport.py``) carries the same pushes and pulls: a
``TransportServer`` in front of the store, and a ``TcpEndpoint`` per
worker (``push_delta`` / ``push_delta_wire`` with the seq token,
``kv_pull``).  The optimizer gains no endpoint mode: it also calls
``init_key`` and ``register_compression``, which an endpoint lacks (in
the JAX package too), so cross-process training is driven through the
endpoint API, as ``byteps_tpu_torch/tools/fault_resnet.py`` does.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..comm.mesh import CommContext
from ..common import integrity as _integrity
from ..common.config import get_config
from ..common.retry import RetryPolicy
from ..core.sharded_update import ShardedUpdateSlot
from ..fault import membership as _membership
from ..server import KVStore
from ..common.logging import get_logger

_log = get_logger()

# Default sender identities: the store dedups by (key, worker) sequence
# floor, so two senders sharing a worker id would swallow each other's
# pushes as "duplicates".  One optimizer per process (the normal
# deployment) gets the host id unchanged (n=0); extra in-process
# instances (tests, multi-worker simulations sharing one store) get
# distinct high ids so their seq streams never collide.
_sender_ids = itertools.count()
_sender_lock = threading.Lock()


def _default_sender_id(host_id: int) -> int:
    with _sender_lock:
        n = next(_sender_ids)
    return host_id if n == 0 else (n << 20) | host_id


class AsyncDistributedOptimizer(torch.optim.Optimizer):
    """Wraps a torch optimizer with the async weight-delta protocol.

    ``store``: the shared ``KVStore`` (default: a new one on the
    parameters' device).  Every parameter is registered with it at
    construction (the reference's init-push barrier, server.cc:261-289)
    under ``f"{name_prefix}.{name}"``.

    ``compression``: the engine's kwargs dict (compressor/ef/...) —
    weight deltas then cross the worker->store boundary as wire-encoded
    compressed payloads, with per-parameter worker-side compressor state
    (error feedback) held here; the store owns the key's decode codec.

    ``worker_id`` (default: ``DMLC_WORKER_ID``, made unique per instance)
    plus a per-parameter sequence counter make every push idempotent.

    ``sharded_update`` (default: ``Config.sharded_update``): the local
    step runs on a :class:`~byteps_tpu_torch.core.sharded_update.
    ShardedUpdateSlot` per parameter (an f32 master and the optimizer's
    state over it) instead of the inner optimizer, and the delta is the
    slot's returned parameters minus the old ones.  The slot's group is
    this worker process alone: a slot sharded over a node's processes
    would mix blocks stepped from different workers' gradients, so a
    config with ``local_size > 1`` raises.  The trajectory equals the
    unsharded one bit for bit."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[
                     Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                 store: Optional[KVStore] = None,
                 name_prefix: str = "async",
                 compression: Optional[Dict[str, str]] = None,
                 worker_id: Optional[int] = None,
                 sharded_update: Optional[bool] = None):
        self._inner = optimizer
        self.param_groups = optimizer.param_groups
        self.defaults = optimizer.defaults
        self.state = optimizer.state
        if named_parameters is not None:
            named = [(n, p) for n, p in named_parameters if p.requires_grad]
        else:
            named = [(f"param.{gi}.{pi}", p)
                     for gi, g in enumerate(optimizer.param_groups)
                     for pi, p in enumerate(g["params"]) if p.requires_grad]
        if not named:
            raise ValueError("AsyncDistributedOptimizer: no parameters")
        self._params = [p for _, p in named]
        self._keys = [f"{name_prefix}.{n}" for n, _ in named]
        self.device = self._params[0].device
        cfg = get_config()
        self._store = store if store is not None else KVStore(self.device)
        self._worker_id = (worker_id if worker_id is not None
                           else _default_sender_id(cfg.host_id))
        self._ack_retry = RetryPolicy.from_config(
            cfg, retry_on=(_integrity.AckLost,), base_delay_s=0.0,
            max_delay_s=0.0)
        self._compression = dict(compression) if compression else None
        self._sharded = (cfg.sharded_update if sharded_update is None
                         else bool(sharded_update))
        self._seqs = [0] * len(self._params)
        self._staging: Dict[int, torch.Tensor] = {}
        self._codecs = []       # [(worker chain, state)] per parameter
        self._slots = []
        self.stage_ms: Dict[str, float] = {}
        group_of = {p: g for g in optimizer.param_groups for p in g["params"]}
        self._hyper = [{k: v for k, v in group_of[p].items()
                        if k != "params"} for p in self._params]
        if self._sharded:
            if self._compression is not None:
                raise ValueError(
                    "sharded_update + delta compression is not supported "
                    "on the async path: the delta is the slot's update")
            if cfg.local_size > 1:
                raise ValueError(
                    "async sharded_update shards each worker's optimizer "
                    "state over the worker process alone; with "
                    f"local_size={cfg.local_size} a slot over the node's "
                    "processes would mix blocks stepped from different "
                    "workers' gradients (not supported)")
        for key, p, hyper in zip(self._keys, self._params, self._hyper):
            self._store.init_key(key, p.detach())
            if self._sharded:
                comm = CommContext(rank=0, size=1, local_rank=0,
                                   local_size=1, num_nodes=1,
                                   device=p.device, backend="none")
                self._slots.append(ShardedUpdateSlot(
                    comm, cfg, key, p.shape, p.dtype,
                    (type(optimizer), hyper), init_value=p.detach()))
            if self._compression is not None:
                from ..compression import registry as reg
                wc = reg.create(self._compression, p.numel(), p.dtype)
                self._codecs.append([wc, wc.init_state(p.device)])
                self._store.register_compression(
                    key, self._compression, p.numel(), p.dtype)

    @property
    def store(self) -> KVStore:
        return self._store

    @property
    def worker_id(self) -> int:
        return self._worker_id

    def zero_grad(self, set_to_none: bool = True):
        return self._inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, sd):
        return self._inner.load_state_dict(sd)

    def _local_step(self):
        """The local update: ``(new values, deltas)`` on the device."""
        if self._sharded:
            new = [p.detach() if p.grad is None
                   else slot.apply_full(p.grad, hyper)
                   for p, slot, hyper in zip(self._params, self._slots,
                                             self._hyper)]
            self._inner._opt_called = True
        else:
            old = [p.detach().clone() for p in self._params]
            self._inner.step()
            new = [p.detach() for p in self._params]
            return new, [n - o for n, o in zip(new, old)]
        return new, [n - p.detach() for n, p in zip(new, self._params)]

    def _to_host(self, i: int, delta: torch.Tensor) -> torch.Tensor:
        """``delta`` on the host: through this parameter's pinned staging
        buffer when it is on a card (the copy is asynchronous; the caller
        synchronizes before the host reads it)."""
        if delta.device.type == "cpu":
            return delta
        buf = self._staging.get(i)
        if buf is None:
            buf = self._staging[i] = torch.empty(
                delta.shape, dtype=delta.dtype, pin_memory=True)
        buf.copy_(delta, non_blocking=True)
        return buf

    def _push(self, i: int, payload) -> None:
        key = self._keys[i]
        self._seqs[i] += 1
        seq = self._seqs[i]
        # stamp the membership epoch ONCE per logical push, outside the
        # ack-retry loop: a retry that crosses an elastic world change
        # must carry the OLD epoch so the store's stale gate drops it
        mepoch = _membership.current_epoch()
        if self._compression is not None:
            def push():
                return self._store.push_delta_wire(
                    key, payload, worker_id=self._worker_id, seq=seq,
                    mepoch=mepoch)
        else:
            def push():
                return self._store.push_delta(
                    key, payload, worker_id=self._worker_id, seq=seq,
                    mepoch=mepoch)
        try:
            self._ack_retry.call(push, describe=f"async push {key}")
        except _integrity.AckLost:
            # AckLost is only raised AFTER the delta applied, and the seq
            # token made the retries no-ops, so the sum is correct
            _log.warning("async push %s: ack lost on every attempt; delta "
                         "landed exactly once (seq dedup)", key)

    def step(self, closure=None):
        """One async step: local update -> push delta -> pull fresh.  No
        barrier: concurrent workers interleave their deltas in arrival
        order, the server's sum-on-arrival semantics."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        with torch.no_grad():
            new, deltas = self._local_step()
            t0 = time.perf_counter()
            if self._compression is not None:
                payloads = []
                for i, d in enumerate(deltas):
                    wc, st = self._codecs[i]
                    payload, self._codecs[i][1] = wc.compress(
                        d.reshape(-1), st)
                    payloads.append(wc.wire_encode(payload))
            else:
                payloads = [self._to_host(i, d) for i, d in
                            enumerate(deltas)]
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            t1 = time.perf_counter()
            for i, payload in enumerate(payloads):
                self._push(i, payload)
            t2 = time.perf_counter()
            pulled = [self._store.pull(k) for k in self._keys]
            t3 = time.perf_counter()
            for i, (p, value) in enumerate(zip(self._params, pulled)):
                p.copy_(value.view(p.shape))
                if self._sharded and not torch.equal(p, new[i]):
                    # another worker's delta landed: the slot's master
                    # must match what the store serves, or a
                    # params-dependent update (weight decay) would
                    # integrate stale weights
                    self._slots[i].sync_master(value)
            t4 = time.perf_counter()
        self.stage_ms = {"d2h": (t1 - t0) * 1e3, "push": (t2 - t1) * 1e3,
                         "pull": (t3 - t2) * 1e3, "h2d": (t4 - t3) * 1e3}
        return loss
