"""The sharded weight update on the push_pull pipeline; port of
``byteps_tpu/core/sharded_update.py``.

Under ``Config.sharded_update`` (``BYTEPS_SHARDED_UPDATE``) a tensor
declared with ``declare_update`` is pushed like any gradient, but its pull
leg returns the owner-updated *parameters* instead of the merged
gradient:

- the scatter accumulator (``comm/collectives.py``) leaves block
  ``local_rank`` of the summed gradient on this rank: the owner-resident
  gradient shard, never gathered;
- a ``torch.optim`` optimizer steps that shard against a flat f32 master
  block, with per-element state born at the block's length
  (``comm/shard_math.py``, the geometry ``parallel/zero.py`` shares);
- the owners' updated blocks, cast to the declared dtype, are
  all-gathered over the node, and the caller ``copy_``s the result into
  its parameter.

The JAX slot emits optax *updates*, which the caller adds to its
parameters.  A torch optimizer writes the new value itself, so emitting
``new - old`` and adding it on the replica would round a second time and
the sharded trajectory would leave the replicated one; the port emits
the parameters.

Wire accounting (the reference's): the replicated update ships push N +
pull N (the merged gradient comes back whole and every replica runs the
same optimizer); the sharded update ships push N + pull N/R.  The parts
fallback (chunk bounds the column view cannot express, or a small
single-chunk tensor) all-reduces the merged gradient as the replicated
path does, so its pull leg is accounted at full size.

Geometry: ``C = ceil(n / L)``, ``n_pad = C * L`` with ``L =
local_size``: the slot is sharded within a node and replicated across
nodes (zero.py's ``"ici"`` layout), because the cross-node all-reduce
of each slab leaves every node with the same sum.

The pad region ``[n, n_pad)`` of the last block carries zero gradients
forever.  SGD (with momentum, dampening, Nesterov and weight decay),
Adam and AdamW keep its master and state at exactly 0.0: every update is
a product with the zero gradient or the zero master (``0 * (1 - lr*wd)``
for AdamW's decoupled decay), and Adam's step there is ``0 / (0 + eps)``.
An optimizer whose update depends on anything but the element's own
gradient and value could move it; the pad is never emitted either way.

The quantized parameter leg (``Config.sharded_param_codec``, JAX
``sharded_update.py:94-132, 186-205, 313-391``): the spec names a codec
of the registry (``"onebit"``, ``"topk:0.25"``, ...), always with error
feedback, that must pass the same golden-error quality gate as the
gradient ladder at declare; ``"auto"`` asks the planner
(``ChunkPlanner.plan_param_codec``).  With a codec the slot steps its
block, takes the update ``u = p' - p`` of the block, and the codec
(``core/param_codec.py``) quantizes the update of the whole vector
across the node's blocks; every rank dequantizes the whole update and
adds it to its f32 copy of the parameters, of which the master is the
own block (a view).  So the master advances by the same dequantized
update the replicas integrate and cannot drift from them, and the pull
leg carries the codec's payload, not the dense blocks.  The emitted
parameters are that copy cast to the declared dtype.  The JAX slot
quantizes optax's update directly; ``p' - p`` rounds once more (ROADMAP
Queue C 10 and 15).  The residual and the codec's state ride the slot:
:meth:`ShardedUpdateSlot.export` and ``restore`` carry them (``cstate``)
as the JAX slot's ``cstate``.  The copy costs ``4 n`` bytes per rank,
where the master alone holds ``4 C``; at one rank they are the same
tensor.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Tuple, Type

import torch
import torch.distributed as dist

from ..comm.collectives import assemble_scatter
from ..comm.mesh import CommContext
from ..comm.shard_math import (init_sharded_opt_state, is_sharded_state,
                               set_hyperparameters)
from ..common.config import Config
from ..compression import registry as codecs
from .param_codec import BlockCodec

__all__ = ["ShardedUpdateSlot", "parse_codec_spec", "resolve_param_codec"]

OptimizerSpec = Tuple[Type[torch.optim.Optimizer], Dict[str, Any]]

# "name:param" -> the registry kwarg the parameter sets; every codec rides
# the error-feedback decorator, as the gradient ladder's rungs do
_PARAM_KEY = {"topk": "k", "randomk": "k", "powersgd": "rank",
              "dithering": "s"}


def parse_codec_spec(spec: str) -> Optional[Dict[str, str]]:
    """``"onebit"`` / ``"randomk:0.25"`` -> registry kwargs, ``""`` ->
    None.  ``"auto"`` is :func:`resolve_param_codec`'s."""
    if not spec:
        return None
    name, _, param = spec.partition(":")
    kwargs = {"compressor": name, "ef": "vanilla"}
    if param:
        kwargs[_PARAM_KEY.get(name, "k")] = param
    return kwargs


def resolve_param_codec(cfg: Config, planner, nbytes: int
                        ) -> Optional[Dict[str, str]]:
    """The pull-leg codec of one declared tensor of ``nbytes``, or None
    (full precision).  An explicit spec passes the gradient ladder's
    golden-error gate here, in the caller's stack; ``"auto"`` is the
    planner's per-size choice (already ceiling-filtered)."""
    spec = cfg.sharded_param_codec
    if not spec or nbytes < cfg.min_compress_bytes:
        return None
    if spec == "auto":
        return (planner.plan_param_codec(nbytes) if planner is not None
                else None)
    kwargs = parse_codec_spec(spec)
    codecs.validate_kwargs(kwargs)
    err = codecs.golden_error(kwargs)
    if err > cfg.compress_error_ceiling:
        raise ValueError(
            f"sharded_param_codec {spec!r} fails the quality gate: "
            f"golden error {err:.3f} > compress_error_ceiling "
            f"{cfg.compress_error_ceiling} (BYTEPS_COMPRESS_ERROR_"
            f"CEILING) — pick a gentler codec or raise the ceiling")
    return kwargs


class ShardedUpdateSlot:
    """Owner-resident optimizer state for one declared tensor.

    ``master`` is this rank's f32 block ``[C]`` of the flat parameter
    vector (block ``local_rank``, elements ``[b*C, b*C + C)``), seeded
    from ``init_value``; ``optimizer`` is the ``torch.optim`` optimizer
    over it, named by ``(cls, hyperparameters)``.  ``applied`` counts the
    steps taken (carried through ``export``/``restore``).

    The slot's step and its all-gather are issued by the engine's
    dispatcher thread, on the engine stream, after the tensor's last
    reduce-scatter (a process group's collectives must come in the same
    order on every rank, and only the dispatcher issues them)."""

    def __init__(self, comm: CommContext, cfg: Config, name: str, shape,
                 dtype: torch.dtype, optimizer: OptimizerSpec, *,
                 planner=None, init_value=None,
                 restore: Optional[Dict[str, Any]] = None):
        self.comm = comm
        self.name = name
        self.out_shape = tuple(shape)
        self.dtype = dtype
        self.n = math.prod(self.out_shape)
        self.nbytes = self.n * dtype.itemsize
        L = comm.local_size
        self.C = -(-self.n // L)
        self.n_pad = self.C * L
        self.block = comm.local_rank
        self.applied = int(restore["applied"]) if restore else 0
        seed = restore["master"] if restore is not None else init_value
        # the quantized parameter leg: the codec, its state, and the f32
        # copy of the whole vector whose own block is the master
        self.codec_kwargs = resolve_param_codec(cfg, planner, self.nbytes)
        self.codec = None
        self.payload_nbytes = 0
        self.full = None
        self.stage_ms: Dict[str, float] = {}
        if self.codec_kwargs is not None:
            self.codec = BlockCodec(self.codec_kwargs, comm, self.n, self.C)
            self.payload_nbytes = self.codec.payload_nbytes
            self.full = torch.zeros(self.n_pad, dtype=torch.float32,
                                    device=comm.device)
            if seed is not None:
                self.full[:self.n].copy_(
                    torch.as_tensor(seed).detach().reshape(-1))
            lo = self.block * self.C
            self.master = self.full[lo:lo + self.C]
            self.cstate = self.codec.init_state(comm.device)
            saved = restore.get("cstate") if restore is not None else None
            if saved is not None:
                self.cstate = self._restore_cstate(saved)
        else:
            self.master = self._my_block(seed, torch.float32)
        state = None
        if restore is not None:
            state = {k: (self._my_block(v, v.dtype)
                         if k in restore["sharded"] else v)
                     for k, v in restore["state"].items()}
        self.optimizer = init_sharded_opt_state(
            optimizer, self.master, fused=cfg.sharded_update_fused,
            state=state)

    def _my_block(self, value, dtype: torch.dtype) -> torch.Tensor:
        """This rank's ``[C]`` block of a logical-length vector (zeros
        where it runs past ``n``, and for ``value=None``), on the
        engine's device."""
        out = torch.zeros(self.C, dtype=dtype, device=self.comm.device)
        if value is not None:
            flat = torch.as_tensor(value).detach().reshape(-1)
            lo = self.block * self.C
            hi = min(lo + self.C, self.n)
            if hi > lo:
                out[:hi - lo].copy_(flat[lo:hi])
        return out

    # ------------------------------------------------------------ the step
    def _step(self, grad: torch.Tensor,
              hyperparameters: Optional[Dict[str, Any]]) -> torch.Tensor:
        if hyperparameters:
            set_hyperparameters(self.optimizer, hyperparameters)
        t0 = time.perf_counter()
        before = self.master.clone() if self.codec is not None else None
        self.master.grad = grad
        self.optimizer.step()
        self.master.grad = None
        self.applied += 1
        if self.codec is None:
            return assemble_scatter(self.comm, self.master, self.n, self.C,
                                    self.out_shape, self.dtype)
        with torch.no_grad():
            # the update the optimizer made, quantized across the node;
            # the master is put back and advanced with the replicas
            u = self.master - before
            self.master.copy_(before)
            del before
            t1 = time.perf_counter()
            d, self.cstate = self.codec.step(u, self.cstate)
            del u
            t2 = time.perf_counter()
            self.full.add_(d)
            del d
            out = self.full[:self.n].view(self.out_shape)
            out = (out.clone() if self.dtype == torch.float32
                   else out.to(self.dtype))
        t3 = time.perf_counter()
        self.stage_ms = {"step": (t1 - t0) * 1e3,
                         **self.codec.stage_ms,
                         "apply": (t3 - t2) * 1e3}
        return out

    def apply_buffer(self, buf: torch.Tensor, scale: Optional[float],
                     hyperparameters: Optional[Dict[str, Any]] = None
                     ) -> torch.Tensor:
        """One completed buffer-mode push: the accumulator ``buf`` (this
        rank's summed block, f32) times the fused 1/R ``scale`` is the
        master's gradient.  Returns the updated parameters, gathered."""
        grad = buf * scale if scale is not None else buf
        return self._step(grad.to(torch.float32), hyperparameters)

    def apply_full(self, merged: torch.Tensor,
                   hyperparameters: Optional[Dict[str, Any]] = None
                   ) -> torch.Tensor:
        """The parts fallback: the fully merged, averaged gradient (in the
        declared dtype); this rank steps its own block of it."""
        return self._step(self._my_block(merged, torch.float32),
                          hyperparameters)

    # ------------------------------------------------------------ state io
    def _gather(self, block: torch.Tensor) -> torch.Tensor:
        """The logical-length vector from every rank's block (collective
        over the node; none for the master under a codec, whose whole
        copy every rank holds)."""
        if block is self.master and self.full is not None:
            return self.full[:self.n]
        if self.comm.local_size > 1:
            full = block.new_empty(self.n_pad)
            dist.all_gather_into_tensor(full, block.contiguous(),
                                        group=self.comm.intra_group)
        else:
            full = block
        return full[:self.n]

    def export(self) -> Dict[str, Any]:
        """Snapshot for suspend/resume, on the host: the master and every
        sharded state tensor at logical length ``n`` (the pad is layout,
        not state), gathered so every rank holds the same snapshot; the
        replicated state (``step``) as it is.  A collective over the
        node: every rank calls it, with nothing in flight."""
        st = self.optimizer.state.get(self.master, {})
        sharded = [k for k, v in st.items() if is_sharded_state(v, self.C)]
        state = {k: (self._gather(v) if k in sharded else v)
                 for k, v in st.items()}
        cstate = None
        if self.codec is not None:
            err = self.cstate["error"]
            cstate = {"error": (None if err is None
                                else self._gather(err).cpu().clone()),
                      "inner": {k: v.cpu().clone() for k, v
                                in self.cstate["inner"].items()}}
        return {
            "master": self._gather(self.master).cpu().clone(),
            "state": {k: (v.cpu().clone() if torch.is_tensor(v) else v)
                      for k, v in state.items()},
            "sharded": sharded,
            "cstate": cstate,
            "applied": self.applied,
            "shape": self.out_shape,
            "dtype": str(self.dtype),
        }

    def _restore_cstate(self, saved: Dict[str, Any]) -> Dict[str, Any]:
        """A codec state from :meth:`export`: the residual re-blocked to
        this world's geometry, the replicated state as it was.  A saved
        state of another codec's shape is dropped for a fresh one, as
        the JAX slot drops it."""
        fresh = self.cstate
        inner = fresh["inner"]
        if set(saved["inner"]) == set(inner) and all(
                tuple(saved["inner"][k].shape) == tuple(v.shape)
                for k, v in inner.items()):
            inner = {k: saved["inner"][k].to(v.device, v.dtype)
                     for k, v in inner.items()}
        error = fresh["error"]
        if error is not None and saved.get("error") is not None \
                and saved["error"].numel() == self.n:
            error = self._my_block(saved["error"], torch.float32)
        return {"error": error, "inner": inner}

    def sync_master(self, value) -> None:
        """Re-seed this rank's f32 block from externally authoritative
        parameters (the async-PS pull leg, ``torch/async_opt.py``: the
        store's fresh weights absorb OTHER workers' deltas the local
        master never saw).  In place: the optimizer holds ``master``."""
        with torch.no_grad():
            if self.full is not None:
                self.full[:self.n].copy_(
                    torch.as_tensor(value).detach().reshape(-1))
            else:
                self.master.copy_(self._my_block(value, torch.float32))

    def params(self) -> torch.Tensor:
        """The current parameters: the gathered master, shaped and cast
        to the declared dtype (a collective over the node, as
        :meth:`export`)."""
        return self._gather(self.master).view(self.out_shape).to(self.dtype)

    def state_nbytes(self) -> int:
        """Bytes this rank holds: its master block and the optimizer's
        tensors."""
        st = self.optimizer.state.get(self.master, {})
        held = self.full if self.full is not None else self.master
        extra = 0
        if self.codec is not None and self.cstate["error"] is not None:
            extra = self.cstate["error"].numel() * 4
        return (held.numel() * held.element_size() + extra
                + sum(v.numel() * v.element_size() for v in st.values()
                      if torch.is_tensor(v)))

    # ------------------------------------------------------------ wire
    def pull_share(self, task_nbytes: int, buffered: bool) -> int:
        """Pull-leg wire bytes of one completed chunk of ``task_nbytes``
        push-leg bytes: the owner's slice, 1/R, in buffer mode, or under
        a codec the payload's share of the chunk; full size on the parts
        fallback, which all-reduced the merged gradient.  (At more than
        one node each rank's all-gather sends its block of N/L; the
        reference's accounting, kept here, is N/R.)"""
        if not buffered:
            return task_nbytes
        if self.codec is not None:
            return (self.payload_nbytes * task_nbytes) // max(1, self.nbytes)
        return task_nbytes // self.comm.size
