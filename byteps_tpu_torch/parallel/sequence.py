"""Sequence (context) parallelism: ring attention, striped ring attention
and Ulysses; port of ``byteps_tpu/parallel/sequence.py``.

Each rank holds ``[B, T/sp, H, D]`` shards of q, k and v (the sequence
axis sharded over the ``sp`` axis of a :class:`~.mesh_util.Mesh2D`, in
ring order) and gets its shard of the output back:

- :func:`ring_attention`: the K/V block travels the ring (a shift to
  ``my + 1`` per step, :func:`~.mesh_util.shift`) while an online softmax
  (running max and normalizer) folds each block into the output.  Blocks
  wholly in the causal future are skipped.
- :func:`striped_attention`: the same ring over the round-robin layout of
  :func:`stripe_batch` (local slot ``l`` of rank ``r`` holds token
  ``l * sp + r``), where every (rank, step) pair sees the same
  near-triangular visible set; no skip.
- :func:`ulysses_attention`: one all-to-all turns the sequence shards into
  head shards over the whole sequence, attention runs locally, and one
  all-to-all turns the result back.  Needs ``H % sp == 0``.

The JAX package differentiates the ring through ``lax.ppermute``, which
runs on every device whatever ``lax.cond`` skipped.  Here a skipped block
leaves that rank's rotated copy unused, so autograd would never run that
shift's backward on the rank while its peer waits in it: the ring is one
``torch.autograd.Function`` per call whose backward is written out (the
Dao backward from the saved output and log-sum-exp, as
``ring_flash.py``), rotating K/V with their gradient accumulators and
taking dK/dV home with one more hop.  Every rank then runs the same
shifts in the same order.  Ulysses differentiates through
:func:`~.mesh_util.all_to_all`, whose graph is the same on every rank.

:func:`full_attention` is the exact single-device oracle and the models'
default attention.  :func:`resolve_sp_attention` is the one switch of
attention kinds, shared by :func:`make_sp_attention` and the ``(dp, sp)``
training step.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from ..comm.mesh import CommContext
from ..ops.flash_attention import flash_attention
from .mesh_util import Mesh2D, MeshAxis, all_to_all, make_2d_mesh, shift

# finite stand-in for -inf: exp(_NEG - anything real) is exactly 0 in f32,
# so fully-masked blocks contribute nothing once a real block lands
_NEG = -1e30

DP_AXIS = "dp"
SP_AXIS = "sp"


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention.  ``[B, Tq, H, D] x [B, Tk, H, D] -> [B, Tq, H,
    D]``; scores in f32, probabilities cast to V's type for the product.
    With ``causal`` the query rows are the last ``Tq`` key positions."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = (k.shape[1] - q.shape[1]) + torch.arange(q.shape[1],
                                                         device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)


# --- the ring -----------------------------------------------------------------

def _to3(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, D] -> [B*H, T, D]``, contiguous."""
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _from3(x3: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, t, d = x3.shape
    return x3.reshape(b, h, t, d).transpose(1, 2)


def ring_backward(axis: MeshAxis, q3, k3, v3, block_grads):
    """The ring's backward skeleton, shared by every ring kind: K/V
    rotate as in the forward and dK/dV ride with their block, so after
    ``sp`` hops (the last one after the final step) every block's
    gradient is home.  ``block_grads(k3, v3, src)`` gives the block's
    ``(dq, dk, dv)``, or None for a skipped block.  Accumulates in f32 and
    casts to the inputs' types at the end."""
    n, my = axis.size, axis.index
    dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
    dk = torch.zeros(k3.shape, dtype=torch.float32, device=k3.device)
    dv = torch.zeros_like(dk)
    for step in range(n):
        src = (my - step) % n
        g = block_grads(k3, v3, src)
        if g is not None:
            dq += g[0].float()
            dk += g[1].float()
            dv += g[2].float()
        if step < n - 1:
            k3, v3, dk, dv = shift([k3, v3, dk, dv], axis)
        else:
            dk, dv = shift([dk, dv], axis)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def _block_scores(q3, k3, scale, mask):
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    return s if mask is None else s.masked_fill(~mask, _NEG)


class _RingCore(torch.autograd.Function):
    """The exact blockwise ring (``_ring_core``): ``mask_fn(my, src)`` is
    the ``[tq, tk]`` visible set of the block that started on rank
    ``src`` (None: unmasked), ``skip_fn(my, src)`` whether it has any
    visible entry (None: always attend)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, axis, scale, mask_fn, skip_fn):
        n, my = axis.size, axis.index
        bh, tq, d = q3.shape
        m = torch.full((bh, tq), _NEG, dtype=torch.float32, device=q3.device)
        l = torch.zeros_like(m)
        o = torch.zeros((bh, tq, d), dtype=torch.float32, device=q3.device)
        k_cur, v_cur = k3, v3
        for step in range(n):
            # the resident block started at rank (my - step) mod n
            src = (my - step) % n
            if skip_fn is None or skip_fn(my, src):
                mask = None if mask_fn is None else mask_fn(my, src)
                s = _block_scores(q3, k_cur, scale, mask)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.matmul(p, v_cur.float())
                m = m_new
            # the last block's rotation would be discarded
            if step < n - 1:
                k_cur, v_cur = shift([k_cur, v_cur], axis)
        out = o / l.clamp_min(1e-30)[..., None]
        ctx.save_for_backward(q3, k3, v3, out, m + torch.log(l))
        ctx.args = (axis, scale, mask_fn, skip_fn)
        return out.to(q3.dtype)

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out, lse = ctx.saved_tensors
        axis, scale, mask_fn, skip_fn = ctx.args
        do = g.float()
        delta = (do * out).sum(-1)

        def block_grads(k_blk, v_blk, src):
            my = axis.index
            if skip_fn is not None and not skip_fn(my, src):
                return None
            mask = None if mask_fn is None else mask_fn(my, src)
            p = torch.exp(_block_scores(q3, k_blk, scale, mask)
                          - lse[..., None])
            dp = torch.matmul(do, v_blk.float().transpose(1, 2))
            ds = p * (dp - delta[..., None]) * scale
            return (torch.matmul(ds, k_blk.float()),
                    torch.matmul(ds.transpose(1, 2), q3.float()),
                    torch.matmul(p.transpose(1, 2), do))

        dq, dk, dv = ring_backward(axis, q3, k3, v3, block_grads)
        return dq, dk, dv, None, None, None, None


def _ring(q, k, v, axis, scale, mask_fn, skip_fn):
    b, _, h, _ = q.shape
    out = _RingCore.apply(_to3(q), _to3(k), _to3(v), axis, scale, mask_fn,
                          skip_fn)
    return _from3(out, b, h)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: MeshAxis, *, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over the sequence shards of ``axis``: the local
    ``[B, T/sp, H, D]`` output shard, in q's type.  With ``causal``, the
    blocks wholly in the future are skipped (a host-side test on each
    rank: no collective sits inside the attend body)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    tq, tk = q.shape[1], k.shape[1]
    if not causal:
        return _ring(q, k, v, axis, scale, None, None)
    dev = q.device

    def mask(my, src):
        q_pos = my * tq + torch.arange(tq, device=dev)
        k_pos = src * tk + torch.arange(tk, device=dev)
        return q_pos[:, None] >= k_pos[None, :]

    def skip(my, src):
        # a block entirely in the future is all masked: without the skip
        # about half the ring's products compute _NEG blocks
        return src * tk <= my * tq + (tq - 1)

    return _ring(q, k, v, axis, scale, mask, skip)


def stripe_batch(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Round-robin permutation of a sequence axis: token ``t`` moves to
    position ``(t % n) * (T/n) + t // n``, so a contiguous n-way sharding
    of the result gives rank ``r`` the stripe ``{r, r+n, r+2n, ...}``."""
    t = x.shape[axis]
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by sp={n}")
    xm = x.movedim(axis, 0)
    xm = xm.reshape(t // n, n, *xm.shape[1:]).transpose(0, 1)
    return xm.reshape(t, *xm.shape[2:]).movedim(0, axis)


def unstripe_batch(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`stripe_batch`."""
    t = x.shape[axis]
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by sp={n}")
    xm = x.movedim(axis, 0)
    xm = xm.reshape(n, t // n, *xm.shape[1:]).transpose(0, 1)
    return xm.reshape(t, *xm.shape[2:]).movedim(0, axis)


def striped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: MeshAxis, *, causal: bool = True,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Striped ring attention (Brandon et al. 2023): the ring of
    :func:`ring_attention` over the round-robin layout of
    :func:`stripe_batch`, so that the causal work is the same at every
    (rank, step): strictly-lower ``lq > lk`` plus the diagonal when
    ``my >= src``.  Every block is partly visible, so nothing is
    skipped.  Non-causal, the layout does not matter: an unmasked ring."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    tq, tk = q.shape[1], k.shape[1]
    if causal and tq != tk:
        raise ValueError("striped causal attention needs equal q/k shards")
    if not causal:
        return _ring(q, k, v, axis, scale, None, None)
    lq = torch.arange(tq, device=q.device)[:, None]
    lk = torch.arange(tk, device=q.device)[None, :]

    def mask(my, src):
        # global positions: q at lq*n + my, k at lk*n + src
        return (lq > lk) | ((lq == lk) & (my >= src))

    return _ring(q, k, v, axis, scale, mask, None)


# --- Ulysses ----------------------------------------------------------------

def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: MeshAxis, *, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      local_attn: Optional[Callable] = None) -> torch.Tensor:
    """Ulysses sequence parallelism: q, k and v (stacked, one all-to-all)
    go from ``[B, T/sp, H, D]`` to ``[B, T, H/sp, D]``, ``local_attn``
    (exact by default; ``flash_attention`` for the kernels) runs over the
    whole sequence, and a second all-to-all restores the sequence
    shards.  Requires ``H % sp == 0``."""
    n = axis.size
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by sp ({n})")
    # [3, B, T/sp, H, D] -> [3, B, T, H/sp, D]
    qkv = all_to_all(torch.stack([q, k, v]), axis, split_dim=3,
                     concat_dim=2)
    attn = local_attn if local_attn is not None else full_attention
    out = attn(qkv[0], qkv[1], qkv[2], causal=causal, sm_scale=sm_scale)
    # [B, T, H/sp, D] -> [B, T/sp, H, D]
    return all_to_all(out, axis, split_dim=1, concat_dim=2)


# --- layouts and the switch ---------------------------------------------------

def make_sp_mesh(comm: CommContext, n_sp: Optional[int] = None) -> Mesh2D:
    """A ``(dp, sp)`` layout of ``comm``'s world; ``sp`` defaults to every
    rank.  The sp axis takes consecutive ranks, so the K/V ring runs
    between neighbours of a node."""
    return make_2d_mesh(comm, n_sp or comm.size, (DP_AXIS, SP_AXIS))


def sp_mesh_from_comm(comm: CommContext, n_sp: Optional[int] = None
                      ) -> Mesh2D:
    """The ``(dp, sp)`` layout whose sp ring is carved out of a node's
    ranks (``comm.local_size``, the ``ici`` level), never across nodes:
    rotating K/V blocks over the network between nodes would gate every
    attention layer on it.  dp covers the rest."""
    n_sp = n_sp or comm.local_size
    if comm.local_size % n_sp:
        raise ValueError(
            f"node size {comm.local_size} not divisible by sp={n_sp}")
    return make_sp_mesh(comm, n_sp)


def resolve_sp_attention(kind: str, *, axis: Optional[MeshAxis] = None,
                         sp: Optional[int] = None, **bound) -> Callable:
    """The attention callable of ``kind``, with ``bound`` kwargs (causal,
    sm_scale) bound onto it: ``"ring"``, ``"striped"``, ``"ring_flash"``,
    ``"ulysses"``, ``"ulysses_flash"`` (over the sequence-parallel
    ``axis``), ``"flash"`` (the local CUDA kernels) or ``"full"`` (exact
    local attention); the local kinds need ``sp == 1`` (``sp`` defaults to
    ``axis.size``, else 1).

    Layout contract for ``"striped"``: the local shards must hold the
    round-robin layout (:func:`stripe_batch`) and the positions must be
    computed striped, or the causal mask is silently wrong;
    :func:`make_sp_attention` re-stripes around the call for contiguous
    callers, and the ``(dp, sp)`` step takes a striped batch and computes
    striped positions."""
    if sp is None:
        sp = axis.size if axis is not None else 1
    if kind in ("flash", "full"):
        if sp != 1:
            raise ValueError(
                f"attention={kind!r} runs local attention and needs sp=1, "
                f"got sp={sp}; use 'ring' or 'ulysses' for a sharded "
                f"sequence axis")
        return functools.partial(
            flash_attention if kind == "flash" else full_attention, **bound)
    if kind == "ring":
        fn = ring_attention
    elif kind == "striped":
        fn = striped_attention
    elif kind == "ring_flash":
        from .ring_flash import ring_flash_attention as fn
    elif kind == "ulysses":
        fn = ulysses_attention
    elif kind == "ulysses_flash":
        fn = functools.partial(ulysses_attention,
                               local_attn=flash_attention)
    else:
        raise ValueError(f"unknown sequence-parallel kind: {kind!r}")
    if axis is None:
        raise ValueError(f"attention={kind!r} runs over a sequence-parallel "
                         f"axis: pass axis=")
    return functools.partial(fn, axis=axis, **bound)


def _a2a_stripes(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Contiguous sequence shards -> their striped layout.  With ``T/sp``
    a multiple of ``sp``, local token ``i`` of rank ``r`` (global ``r*T/sp
    + i``) belongs to rank ``i % sp``, at its slot ``r*T/sp/sp + i // sp``:
    one all-to-all."""
    n = axis.size
    b, t = x.shape[:2]
    if t % n:
        raise ValueError(f"re-striping needs T/sp ({t}) divisible by "
                         f"sp ({n})")
    send = x.reshape(b, t // n, n, *x.shape[2:]).movedim(2, 0)
    return all_to_all(send, axis, 0, 0).movedim(0, 1).reshape(x.shape)


def _a2a_unstripes(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Inverse of :func:`_a2a_stripes`: striped slot ``r*T/sp/sp + a`` of
    rank ``j`` is token ``a*sp + j`` of contiguous rank ``r``."""
    n = axis.size
    b, t = x.shape[:2]
    send = x.reshape(b, n, t // n, *x.shape[2:]).movedim(1, 0)
    return all_to_all(send, axis, 0, 0).movedim(0, 2).reshape(x.shape)


def make_sp_attention(mesh: Mesh2D, kind: str = "ring", *,
                      causal: bool = False,
                      sm_scale: Optional[float] = None) -> Callable:
    """``attn(q, k, v)`` on this rank's ``[B/dp, T/sp, H, D]`` shards
    (contiguous sequence shards), returning its output shard.  For
    ``"striped"`` with ``causal`` the shards are re-striped around the
    striped ring (two all-to-alls each way; needs ``T/sp % sp == 0``); a
    training loop that keeps its batch striped calls
    :func:`striped_attention` itself and skips them.  Non-causal
    striping would buy nothing (the load is already balanced), so the
    call is the unmasked ring on the contiguous shards."""
    axis = mesh.axis(SP_AXIS)
    inner = resolve_sp_attention(kind, axis=axis, causal=causal,
                                 sm_scale=sm_scale)
    if kind != "striped" or not causal or axis.size == 1:
        return inner

    def attn(q, k, v):
        qs, ks, vs = (_a2a_stripes(x, axis) for x in (q, k, v))
        return _a2a_unstripes(inner(qs, ks, vs), axis)

    return attn
