"""Checkpoint / resume; port of ``byteps_tpu/utils/checkpoint.py``.

The reference has no checkpoint code of its own: it delegates saving to
the frameworks and guarantees *consistency* by broadcasting parameters
and optimizer state from rank 0 after a restore (torch/__init__.py:
259-411).  The port keeps that contract; storage is ``torch.save`` and
``torch.load(weights_only=True)`` (the JAX package's orbax is on neither
machine):

- :func:`save_checkpoint` / :class:`CheckpointManager` write a state tree
  (dicts, lists and tuples of tensors, numpy arrays and Python scalars,
  e.g. ``{"model": m.state_dict(), "optimizer": opt.state_dict(),
  "step": 5}``).  Only the root writes; with more than one process every
  rank enters the save and they meet at a barrier after the write.
  Each write lands in a temporary directory that is renamed into place,
  so a reader never sees half a checkpoint;
- :func:`restore_and_broadcast` and :meth:`CheckpointManager.
  restore_latest` load onto the TEMPLATE's leaves (each tensor on the
  template tensor's device and dtype, numpy arrays and scalars as the
  template has them) and broadcast every leaf from the root over
  ``torch.distributed``, so every replica resumes identical even if its
  local files diverged (the reference's broadcast-after-restore).

The manager keeps the JAX directory semantics: one directory per step
(``<directory>/<step>/``), the newest ``max_to_keep`` kept, and
:meth:`~CheckpointManager.reload` re-scanning a directory that another
process or manager wrote.

:func:`pack_state` / :func:`unpack_state` are the wire form of a state
for a rejoining rank: the tree's leaves as numpy arrays (torch tensors
are turned into numpy at the edge, so no torch object is ever pickled),
dict keys sorted as ``jax.tree.map`` rebuilds them, pickled, and sealed
in a CRC32C envelope when integrity is on.  For the same numpy state the
bytes equal the JAX package's, sealed and unsealed, and each package's
``unpack_state`` reads the other's.

Not ported: the slots of the sharded update carry their state in the
engine, not in ``DistributedOptimizer.state_dict()`` (empty in sharded
mode, as the JAX adapter's ``optax.EmptyState``); a checkpoint of such an
optimizer restarts its moments from zero (ROADMAP Queue C 11).
"""

from __future__ import annotations

import os
import pickle
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

STATE_FILE = "state.pt"
# leaves of a stored tree that were numpy arrays are tensors tagged so
_NUMPY_TAG = "__bps_numpy__"


# -- trees ------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts, lists and tuples (and
    the matching leaves of ``rest``, which must have the same structure
    as ``tree``).  ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError(
                    f"checkpoint tree mismatch: {type(tree).__name__} of "
                    f"{len(tree)} against {type(r).__name__}")
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return fn(tree, *rest)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            raise TypeError("pack_state: numpy has no bfloat16; cast the "
                            "leaf to float32 first")
        return t.cpu().numpy()
    a = np.asarray(x)
    if a.dtype == object:
        raise TypeError(f"pack_state: leaf of type {type(x).__name__} is "
                        "not an array or a number")
    return a


def _numpy_tree(state):
    """``jax.tree.map(np.asarray, state)`` on a tree of builtins, numpy and
    torch: leaves become numpy arrays (a Python number a 0-d array), and
    dicts are rebuilt with their keys sorted, as a JAX pytree flattens
    and unflattens them."""
    if isinstance(state, dict):
        return {k: _numpy_tree(state[k]) for k in sorted(state)}
    if isinstance(state, (list, tuple)):
        out = [_numpy_tree(v) for v in state]
        return tuple(out) if isinstance(state, tuple) else out
    if state is None:
        return None
    return _to_numpy(state)


# -- the root and the broadcast ---------------------------------------------

def _world() -> Tuple[int, int]:
    """(rank, size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _is_root(root_rank: int) -> bool:
    return _world()[0] == root_rank


def _barrier() -> None:
    if _world()[1] > 1:
        dist.barrier()


def _broadcast_device() -> torch.device:
    """Where a broadcast's buffers live: the engine's device when one
    runs, else the card (NCCL) or the host (gloo) by the group's
    backend."""
    from ..core import api
    if api.initialized():
        return api.device()
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast_leaf(leaf, root_rank: int, device: torch.device):
    # a fresh buffer: a non-root rank passes the template's own leaves
    if isinstance(leaf, torch.Tensor):
        buf = leaf.detach().to(device, copy=True).contiguous()
        dist.broadcast(buf, src=root_rank)
        return buf.to(leaf.device)
    if isinstance(leaf, np.ndarray):
        buf = torch.from_numpy(np.array(leaf, copy=True)).to(device)
        dist.broadcast(buf, src=root_rank)
        return buf.cpu().numpy()
    box = [leaf]
    dist.broadcast_object_list(box, src=root_rank, device=device)
    return box[0]


def _broadcast_from_root(state: Any, root_rank: int) -> Any:
    """Every leaf broadcast from ``root_rank``.  A single process (no
    group, or a group of one) restores the file it read: the broadcast
    is the identity and is skipped."""
    if _world()[1] == 1:
        return state
    device = _broadcast_device()
    return tree_map(lambda x: _broadcast_leaf(x, root_rank, device), state)


# -- storage ----------------------------------------------------------------

def _storable(x):
    """A leaf in the form ``torch.load(weights_only=True)`` reads back: a
    CPU tensor (numpy arrays tagged), or a builtin number or string."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, (np.ndarray, np.generic)):
        return {_NUMPY_TAG: torch.from_numpy(np.array(x, copy=True))}
    if isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"checkpoint: cannot store a leaf of type "
                    f"{type(x).__name__}")


def _snapshot(state):
    return tree_map(_storable, state)


def _loaded(tree):
    """The stored tree with its tagged numpy leaves untagged."""
    if isinstance(tree, dict):
        if set(tree) == {_NUMPY_TAG}:
            return tree[_NUMPY_TAG].numpy()
        return {k: _loaded(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_loaded(v) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return tree


def _onto(saved, template):
    """One saved leaf in the template leaf's kind, device and dtype."""
    if isinstance(template, torch.Tensor):
        t = saved if isinstance(saved, torch.Tensor) else torch.as_tensor(
            saved)
        if tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} "
                             f"against template {tuple(template.shape)}")
        return t.to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        a = saved.numpy() if isinstance(saved, torch.Tensor) \
            else np.asarray(saved)
        return a.astype(template.dtype, copy=False).reshape(template.shape)
    if isinstance(template, (bool, int, float)):
        v = saved.item() if isinstance(saved, (torch.Tensor, np.ndarray)) \
            else saved
        return type(template)(v)
    return saved


def _write(path: str, stored) -> None:
    """``stored`` into directory ``path`` atomically: a temporary sibling
    directory, then one rename."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{os.path.basename(path)}-"
                               f"{os.getpid()}-{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(stored, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)   # no half-written leftovers
        raise


def _read(path: str, template: Any) -> Any:
    stored = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                        map_location="cpu", weights_only=True)
    stored = _loaded(stored)
    if template is None:
        return stored
    return tree_map(lambda t, s: _onto(s, t), template, _match(template,
                                                                 stored))


def _match(template, stored):
    """``stored`` cut to the template's structure (a dict template takes
    its own keys; missing keys raise)."""
    if isinstance(template, dict):
        if not isinstance(stored, dict):
            raise ValueError("checkpoint tree mismatch: dict template "
                             f"against {type(stored).__name__}")
        missing = [k for k in template if k not in stored]
        if missing:
            raise KeyError(f"checkpoint lacks {missing}")
        return {k: _match(v, stored[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_match(v, s) for v, s in zip(template,
                                                             stored))
    return stored


# -- the one-shot API -------------------------------------------------------

class PendingSave:
    """Handle of an asynchronous checkpoint write.

    **Every process that received one must call ``wait()``**: it joins
    the background write and, with more than one process, meets the
    others at the barrier.  ``wait()`` (and truthiness, ``.owned``) is
    True on the process that owned the write."""

    def __init__(self, thread: Optional[threading.Thread] = None,
                 owned: bool = False, collective: bool = False):
        self._thread = thread
        self._error: List[BaseException] = []
        self._collective = collective
        self.owned = owned

    def __bool__(self) -> bool:
        return self.owned

    def wait(self) -> bool:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._collective:
            self._collective = False
            _barrier()
        if self._error:
            raise self._error.pop()
        return self.owned


def _start_write(path: str, stored, collective: bool) -> PendingSave:
    pending = PendingSave(owned=True, collective=collective)

    def run():
        try:
            _write(path, stored)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            pending._error.append(e)

    pending._thread = threading.Thread(target=run, daemon=True,
                                       name="bps-checkpoint-write")
    pending._thread.start()
    return pending


def save_checkpoint(path: str, state: Any, *, force: bool = True,
                    root_rank: int = 0, asynchronous: bool = False):
    """Write ``state`` to the directory ``path`` (root only; with more
    than one process every rank calls this and they meet at a barrier
    after the write).

    Synchronous (default): returns True on the process that wrote.
    ``asynchronous=True``: the tensors are copied to the host now, so
    training may overwrite them at once, and the file is written by a
    background thread; returns a :class:`PendingSave` whose ``wait()``
    every process must call before relying on the file.  ``force=False``
    refuses to replace an existing checkpoint at ``path``."""
    collective = _world()[1] > 1
    owned = _is_root(root_rank)
    if owned and not force and os.path.exists(os.path.abspath(path)):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    if not owned:
        if asynchronous:
            return PendingSave(collective=collective)
        _barrier()
        return False
    stored = _snapshot(state)
    if asynchronous:
        return _start_write(path, stored, collective)
    _write(path, stored)
    _barrier()
    return True


def restore_and_broadcast(path: str, template: Any, *,
                          root_rank: int = 0) -> Any:
    """Load the checkpoint at ``path`` onto ``template``'s leaves and
    broadcast it from ``root_rank`` so every replica resumes identical.
    With more than one process only the root reads the file; the others
    receive every leaf into buffers shaped like the template's."""
    if _world()[1] == 1:
        return _read(path, template)
    state = _read(path, template) if _is_root(root_rank) else template
    return _broadcast_from_root(state, root_rank)


# -- the wire form for a rejoining rank --------------------------------------

def pack_state(state: Any, seal: bool = True) -> bytes:
    """A state tree as bytes for a rejoining rank: leaves as numpy, dict
    keys sorted, pickled, and, with integrity on
    (``BYTEPS_INTEGRITY``), sealed in a CRC32C envelope: a rejoiner must
    never unpack corrupt parameters.  ``seal=False`` skips the envelope
    for a transport that seals every message itself.  Control-plane use
    only: the stream is pickle over a trusted intra-cluster socket."""
    from ..common import integrity as _integrity
    data = pickle.dumps(_numpy_tree(state),
                        protocol=pickle.HIGHEST_PROTOCOL)
    if seal and _integrity.enabled():
        data = _integrity.seal_bytes(data, key="pack_state")
    return data


def unpack_state(data: bytes) -> Any:
    """Inverse of :func:`pack_state` (numpy leaves).  Verifies the
    envelope when present; a corrupt blob raises
    :class:`~byteps_tpu_torch.common.integrity.IntegrityError` instead of
    deserializing garbage into a resuming rank."""
    from ..common import integrity as _integrity
    from ..common.telemetry import counters
    if _integrity.is_frame(data):
        try:
            data, _ = _integrity.open_bytes(data)
        except _integrity.IntegrityError as e:
            counters.inc("integrity.crc_reject")
            raise _integrity.IntegrityError(
                f"refusing to unpack corrupt rejoin state: {e}") from None
    return pickle.loads(data)


# -- the manager ------------------------------------------------------------

class CheckpointManager:
    """Step-indexed checkpoints with retention, behind the root-only save
    and the broadcast on restore.

    >>> mgr = CheckpointManager(dir, max_to_keep=3)
    >>> mgr.save(step, {"model": model.state_dict(), "step": step})
    >>> step, state = mgr.restore_latest(template)
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 root_rank: int = 0, async_save: bool = False):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.root_rank = root_rank
        self.async_save = async_save
        self._lock = threading.Lock()
        self._pending: Optional[PendingSave] = None
        if _is_root(root_rank):
            os.makedirs(self.directory, exist_ok=True)
        self._steps = self._scan()

    def _scan(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.isfile(
            os.path.join(self.directory, n, STATE_FILE)))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any) -> bool:
        """Write ``state`` as step ``step`` (root only; a collective with
        more than one process), then drop the steps past
        ``max_to_keep``.  Returns True on the process that wrote.  With
        ``async_save`` the write runs in the background; the next save,
        :meth:`wait_until_finished` or :meth:`restore_latest` joins it."""
        self.wait_until_finished()
        if not _is_root(self.root_rank):
            if _world()[1] > 1 and not self.async_save:
                _barrier()
            return False
        stored = _snapshot(state)
        if self.async_save:
            self._pending = _start_write(self._path(step), stored,
                                         _world()[1] > 1)
            with self._lock:
                self._steps = sorted(set(self._steps) | {step})
            return True
        _write(self._path(step), stored)
        self._retire(step)
        _barrier()
        return True

    def _retire(self, step: int) -> None:
        with self._lock:
            self._steps = sorted(set(self._steps) | {step})
            old, self._steps = (self._steps[:-self.max_to_keep],
                                self._steps[-self.max_to_keep:])
        for s in old:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Block until an in-flight asynchronous save is on disk."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.wait()
            with self._lock:
                newest = self._steps[-1] if self._steps else None
            if newest is not None:
                self._retire(newest)

    def reload(self) -> None:
        """Re-scan the directory for steps this instance did not write
        (another process or manager wrote them)."""
        self.wait_until_finished()
        with self._lock:
            self._steps = self._scan()

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        with self._lock:
            return self._steps[-1] if self._steps else None

    def restore_latest(self, template: Any) -> Tuple[Optional[int], Any]:
        """(step, state broadcast from the root) of the newest step, on
        the template's leaves; (None, template) when there is none."""
        step = self.latest_step()
        if _world()[1] > 1:
            # the root's directory decides, on every rank
            box = [step]
            dist.broadcast_object_list(box, src=self.root_rank,
                                       device=_broadcast_device())
            step = box[0]
        if step is None:
            return None, template
        return step, restore_and_broadcast(self._path(step), template,
                                           root_rank=self.root_rank)

    def close(self) -> None:
        self.wait_until_finished()
