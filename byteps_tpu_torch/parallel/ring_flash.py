"""Ring-flash attention: the CUDA flash kernels inside ring sequence
parallelism; port of ``byteps_tpu/parallel/ring_flash.py``.

The ring of ``sequence.py`` with each block's math in the flash kernels
(``ops/flash_attention.py``):

- forward: at each ring step the flash forward runs on (local q, resident
  K/V block) with the causal offset ``q_off = (my - src) * t_local`` and
  ``kv_len = t_local``, runtime integers of the kernel, and the returned
  normalized output and log-sum-exp are merged into the running
  accumulator (:func:`_merge`);
- backward: K/V rotate again; each block's dQ, dK and dV come from the two
  backward kernels with the saved log-sum-exp (the Dao backward); dQ
  accumulates locally while dK/dV ride the ring with their block and take
  one more hop home (``sequence.ring_backward``).

With ``causal``, blocks that started on a later rank (``src > my``) are
wholly in the future and skipped on both passes; for ``src < my`` the
offset is at least ``Tk``, so every key of the block is visible; the
diagonal block (``src == my``) has ``q_off = 0``.  Accumulation is f32,
cast to the inputs' type at the end.  The JAX module pads T and D to
Mosaic's tiles and snaps its block sizes; the port's kernels take any T
and pad D up to 32, 64 or 128 themselves, so none of that is here.

Striped layouts are left to ``sequence.striped_attention``, as in the
JAX package: the kernels' masks are those of contiguous blocks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.flash_attention import _NEG, delta, flash_bwd, flash_fwd
from .mesh_util import MeshAxis, shift
from .sequence import _from3, _to3, ring_backward

__all__ = ["ring_flash_attention"]


def _merge(o_acc, lse_acc, o_b, lse_b):
    """Fold one block's normalized output into the running accumulator:
    the two-term log-sum-exp, each side weighted by ``exp(lse - m)``.  A
    fully masked block comes back with ``lse ~ -1e30`` and weight 0."""
    m = torch.maximum(lse_acc, lse_b)
    wa = torch.exp(lse_acc - m)[..., None]
    wb = torch.exp(lse_b - m)[..., None]
    denom = (wa + wb).clamp_min(1e-30)
    o_new = (o_acc * wa + o_b.float() * wb) / denom
    return o_new, m + torch.log(denom[..., 0])


def _q_offset(my: int, src: int, t_local: int, causal: bool) -> int:
    """The causal offset of the local rows against the block that started
    on rank ``src``."""
    return (my - src) * t_local if causal else 0


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, k3, v3, axis, scale, causal):
        n, my = axis.size, axis.index
        t_local = k3.shape[1]
        o_acc = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
        lse_acc = torch.full(q3.shape[:2], 2 * _NEG, dtype=torch.float32,
                             device=q3.device)
        k_cur, v_cur = k3, v3
        for step in range(n):
            src = (my - step) % n
            if not causal or src <= my:
                o_b, lse_b = flash_fwd(
                    q3, k_cur, v_cur, scale, causal,
                    _q_offset(my, src, t_local, causal), t_local)
                o_acc, lse_acc = _merge(o_acc, lse_acc, o_b, lse_b)
            if step < n - 1:
                k_cur, v_cur = shift([k_cur, v_cur], axis)
        out = o_acc.to(q3.dtype)
        ctx.save_for_backward(q3, k3, v3, out, lse_acc)
        ctx.args = (axis, scale, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out, lse = ctx.saved_tensors
        axis, scale, causal = ctx.args
        g = g.contiguous()
        dlt = delta(g, out)
        t_local = k3.shape[1]
        my = axis.index

        def block_grads(k_blk, v_blk, src):
            if causal and src > my:
                return None
            return flash_bwd(q3, k_blk, v_blk, g, lse, dlt, scale, causal,
                                _q_offset(my, src, t_local, causal), t_local)

        dq, dk, dv = ring_backward(axis, q3, k3, v3, block_grads)
        return dq, dk, dv, None, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis: MeshAxis, *, causal: bool = False,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention with flash-kernel block math; the contract of
    ``sequence.ring_attention``: the local ``[B, T/sp, H, D]`` shards of
    q, k and v (sequence in ring order) in, the local output shard out.
    CUDA tensors run the kernels, CPU tensors their plain versions."""
    b, _, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = _RingFlash.apply(_to3(q), _to3(k), _to3(v), axis, scale, causal)
    return _from3(out, b, h)
