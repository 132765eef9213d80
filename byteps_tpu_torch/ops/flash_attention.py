"""Flash attention: CUDA kernels for the forward and the two backward
passes, their plain versions, and the autograd function; port of
``byteps_tpu/ops/flash_attention.py``.

Entry points on ``[BH, T, D]`` tensors, kept apart as the JAX package
keeps them (``parallel/ring_flash.py`` calls them directly):

- :func:`flash_fwd` ``(q3, k3, v3, scale, causal, q_off, kv_len) -> (o,
  lse)``;
- :func:`flash_bwd` ``(q3, k3, v3, do3, lse, delta, scale, causal, q_off,
  kv_len) -> (dq, dk, dv)``, which runs :func:`flash_bwd_dkv` and
  :func:`flash_bwd_dq`;
- :func:`delta` ``(do3, o3)``, ``rowsum(dO * O)`` in f32.

``lse`` and ``delta`` are ``[BH, Tq]`` f32 (the JAX package broadcasts
them over 128 lanes only for Mosaic's tiling).  ``q_off`` (the absolute
position of query row 0 relative to key 0, for the causal mask) and
``kv_len`` (keys at or past it are masked; ``1 <= kv_len <= Tk``) are
runtime integers.

:func:`flash_attention` is the public function on ``[B, T, H, D]``, with
the JAX package's contract: ``sm_scale`` defaults to ``1/sqrt(D)``,
``causal`` aligns the queries with the last ``Tq`` keys (``q_off = Tk -
Tq``) and rejects ``Tq > Tk``.

Each wrapper runs its plain PyTorch version (exact softmax with the same
masks and casts) only for tensors on the CPU; for CUDA tensors it
launches its kernel of ``csrc/flash_attention.cu`` on the current stream
or raises.  The kernels take float32 and bfloat16 and head sizes 32, 64
and 128; other sizes up to 128 are padded with zero columns, which are
exact.  ``launches`` counts kernel launches per wrapper.

Which TPU kernel each replaces, and what bounds it on an H100 (matrix
products of ``[Tq, Tk] x D`` per head; half are live when causal):

- ``flash_fwd``: ``byteps_tpu/ops/flash_attention.py:115`` ``_fwd``
  (``_fwd_kernel``, ``_mask_block``); 2 products, ``4 BH Tq Tk D`` FLOPs.
- ``flash_bwd_dkv``: ``flash_attention.py:255`` ``_bwd_impl``, dK/dV
  (``_bwd_dkv_kernel``); 4 products.
- ``flash_bwd_dq``: ``flash_attention.py:255`` ``_bwd_impl``, dQ
  (``_bwd_dq_kernel``); 3 products.

The source says how the design meets them (one block per output tile, a
loop over the reduction tiles, no atomics).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build as _build

SOURCE = "flash_attention.cu"
KERNEL_DIMS = (32, 64, 128)      # head sizes the kernels are built for
# Width of the bf16 forward kernel's key tile, over which P is rounded
# against the running row max; must equal kFwdBlockK in the .cu, and the
# reference of the bf16 forward walks the keys in blocks of it
FWD_BLOCK_K = 64
_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per wrapper since the last reset_launches()
launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0,
                            "flash_bwd_dq": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def kernel_dim(d: int) -> int:
    """The head size the kernels run ``d`` at: the next of KERNEL_DIMS."""
    for kd in KERNEL_DIMS:
        if d <= kd:
            return kd
    raise ValueError(f"flash attention kernels take head sizes up to "
                     f"{KERNEL_DIMS[-1]}, got {d}")


# --- plain versions ----------------------------------------------------------

def _scores(q3, k3, scale, causal, q_off, kv_len) -> torch.Tensor:
    """Scaled f32 scores with the kv-tail and causal masks (_mask_block)."""
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    rows = q_off + torch.arange(q3.shape[1], device=q3.device)[:, None]
    cols = torch.arange(k3.shape[1], device=q3.device)[None, :]
    valid = cols < kv_len
    if causal:
        valid = valid & (rows >= cols)
    return s.masked_fill(~valid, _NEG)


def flash_fwd_plain(q3, k3, v3, scale: float, causal: bool, q_off: int,
                    kv_len: int, block_k: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)``.  With ``block_k=None`` the exact softmax, P rounded to
    V's type against the global row max.  With an integer, the keys are
    walked in blocks of ``block_k`` as ``_fwd_kernel`` walks them: a running
    row max, ``p = exp(s - m_new)`` in f32, ``l = l * alpha + sum(p)`` from
    the f32 p, and ``acc = acc * alpha + p.to(V's type) @ V``.  That rounds
    P where the kernels round it, so it is the reference of a low-precision
    kernel whose key tile is ``block_k`` wide (FWD_BLOCK_K)."""
    if block_k is None:
        s = _scores(q3, k3, scale, causal, q_off, kv_len)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        acc = torch.matmul(p.to(v3.dtype).float(), v3.float())
        return (acc / l).to(q3.dtype), (m + torch.log(l)).squeeze(-1)
    bh, tq, d = q3.shape
    m = torch.full((bh, tq, 1), _NEG, dtype=torch.float32, device=q3.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(bh, tq, d, dtype=torch.float32, device=q3.device)
    # blocks wholly past kv_len or past the last row's diagonal add p = 0
    # and alpha = 1 to every row, exactly, so they are left out
    end = min(k3.shape[1], kv_len)
    if causal:
        end = min(end, max(q_off + tq, 1))
    for k0 in range(0, end, block_k):
        kb, vb = k3[:, k0:k0 + block_k], v3[:, k0:k0 + block_k]
        s = _scores(q3, kb, scale, causal, q_off - k0, kv_len - k0)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v3.dtype).float(), vb.float())
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l).to(q3.dtype), (m + torch.log(l)).squeeze(-1)


def _p_ds(q3, k3, v3, do3, lse, delta, scale, causal, q_off, kv_len):
    p = torch.exp(_scores(q3, k3, scale, causal, q_off, kv_len)
                  - lse[..., None])
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, scale: float,
                        causal: bool, q_off: int, kv_len: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    p, ds = _p_ds(q3, k3, v3, do3, lse, delta, scale, causal, q_off, kv_len)
    dv = torch.matmul(p.to(do3.dtype).float().transpose(1, 2), do3.float())
    dk = torch.matmul(ds.to(q3.dtype).float().transpose(1, 2), q3.float())
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, scale: float,
                       causal: bool, q_off: int, kv_len: int) -> torch.Tensor:
    _, ds = _p_ds(q3, k3, v3, do3, lse, delta, scale, causal, q_off, kv_len)
    return torch.matmul(ds.to(k3.dtype).float(), k3.float()).to(q3.dtype)


def delta(do3: torch.Tensor, o3: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in f32, ``[BH, Tq]`` (``_delta``)."""
    return (do3.float() * o3.float()).sum(-1)


# --- CUDA wrappers ----------------------------------------------------------

_c_fns = None


def _lib():
    """The kernels' C entry points, built and typed on first use."""
    global _c_fns
    if _c_fns is None:
        lib = _build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i, i, i, i, i, f, i, i, i, p]   # bh..kv_len, stream
        lib.bps_flash_error_string.argtypes = [i]
        lib.bps_flash_error_string.restype = ctypes.c_char_p
        lib.bps_flash_fwd.argtypes = [p] * 5 + shape
        lib.bps_flash_bwd_dkv.argtypes = [p] * 8 + shape
        lib.bps_flash_bwd_dq.argtypes = [p] * 7 + shape
        for fn in (lib.bps_flash_fwd, lib.bps_flash_bwd_dkv,
                   lib.bps_flash_bwd_dq):
            fn.restype = i
        _c_fns = lib
    return _c_fns


def _check_kv_len(name: str, kv_len: int, k3) -> None:
    """Every row needs a live key: with none, the plain version's all-masked
    softmax (mean of V) and the kernels' skipped tiles would disagree."""
    if not 1 <= kv_len <= k3.shape[1]:
        raise ValueError(f"{name}: kv_len {kv_len} outside [1, "
                         f"{k3.shape[1]}]")


def _check(name: str, q3, k3, v3, do3=None, lse=None, dlt=None) -> None:
    """Raise on what the kernels do not take."""
    if not q3.is_cuda:
        raise ValueError(f"{name}: tensors must be CUDA or CPU tensors, got "
                         f"{q3.device}")
    if q3.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q3.dtype} is not supported "
                        f"(float32 or bfloat16)")
    big = [("q", q3), ("k", k3), ("v", v3)] + ([("do", do3)] if do3 is not
                                               None else [])
    for what, t in big:
        if t.dtype != q3.dtype or t.device != q3.device:
            raise TypeError(f"{name}: {what} is {t.dtype} on {t.device}, q "
                            f"is {q3.dtype} on {q3.device}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"[BH, T, D] tensor")
    bh, tq, d = q3.shape
    if (k3.shape != (bh, k3.shape[1], d) or v3.shape != k3.shape
            or (do3 is not None and do3.shape != q3.shape)):
        raise ValueError(f"{name}: shapes q {tuple(q3.shape)}, k "
                         f"{tuple(k3.shape)}, v {tuple(v3.shape)} do not "
                         f"agree")
    for what, t in (("lse", lse), ("delta", dlt)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (bh, tq)
                              or not t.is_contiguous()
                              or t.device != q3.device):
            raise ValueError(f"{name}: {what} must be a contiguous f32 "
                             f"[{bh}, {tq}] tensor on {q3.device}")


def _padded(*ts) -> Tuple[int, list]:
    d = ts[0].shape[-1]
    kd = kernel_dim(d)
    return kd, [t if kd == d else F.pad(t, (0, kd - d)) for t in ts]


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().bps_flash_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _tail(q3, k3, kd, scale, causal, q_off, kv_len):
    """The shape and mask arguments every kernel takes, then the stream."""
    return (q3.shape[0], q3.shape[1], k3.shape[1], kd, _DTYPES[q3.dtype],
            float(scale), int(bool(causal)), int(q_off), int(kv_len),
            torch.cuda.current_stream(q3.device).cuda_stream)


def flash_fwd(q3, k3, v3, scale: float, causal: bool, q_off: int,
              kv_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[BH, Tq, D] x [BH, Tk, D] -> (O [BH, Tq, D], lse [BH, Tq] f32)``."""
    _check_kv_len("flash_fwd", kv_len, k3)
    if q3.device.type == "cpu":
        return flash_fwd_plain(q3, k3, v3, scale, causal, q_off, kv_len)
    _check("flash_fwd", q3, k3, v3)
    d = q3.shape[-1]
    kd, (qp, kp, vp) = _padded(q3, k3, v3)
    with torch.cuda.device(q3.device):
        o = torch.empty(qp.shape, dtype=q3.dtype, device=q3.device)
        lse = torch.empty(q3.shape[:2], dtype=torch.float32,
                          device=q3.device)
        rc = _lib().bps_flash_fwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *_tail(q3, k3, kd, scale, causal, q_off, kv_len))
    _raise_on(rc, "flash_fwd")
    launches["flash_fwd"] += 1
    return (o if kd == d else o[..., :d].contiguous()), lse


def flash_bwd_dkv(q3, k3, v3, do3, lse, dlt, scale: float, causal: bool,
                  q_off: int, kv_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV, each ``[BH, Tk, D]`` in the input type."""
    _check_kv_len("flash_bwd_dkv", kv_len, k3)
    if q3.device.type == "cpu":
        return flash_bwd_dkv_plain(q3, k3, v3, do3, lse, dlt, scale, causal,
                                   q_off, kv_len)
    _check("flash_bwd_dkv", q3, k3, v3, do3, lse, dlt)
    d = q3.shape[-1]
    kd, (qp, kp, vp, dop) = _padded(q3, k3, v3, do3)
    with torch.cuda.device(q3.device):
        dk = torch.empty(kp.shape, dtype=k3.dtype, device=k3.device)
        dv = torch.empty(kp.shape, dtype=v3.dtype, device=v3.device)
        rc = _lib().bps_flash_bwd_dkv(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
            lse.data_ptr(), dlt.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_tail(q3, k3, kd, scale, causal, q_off, kv_len))
    _raise_on(rc, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1
    if kd != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


def flash_bwd_dq(q3, k3, v3, do3, lse, dlt, scale: float, causal: bool,
                 q_off: int, kv_len: int) -> torch.Tensor:
    """dQ, ``[BH, Tq, D]`` in the input type."""
    _check_kv_len("flash_bwd_dq", kv_len, k3)
    if q3.device.type == "cpu":
        return flash_bwd_dq_plain(q3, k3, v3, do3, lse, dlt, scale, causal,
                                  q_off, kv_len)
    _check("flash_bwd_dq", q3, k3, v3, do3, lse, dlt)
    d = q3.shape[-1]
    kd, (qp, kp, vp, dop) = _padded(q3, k3, v3, do3)
    with torch.cuda.device(q3.device):
        dq = torch.empty(qp.shape, dtype=q3.dtype, device=q3.device)
        rc = _lib().bps_flash_bwd_dq(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
            lse.data_ptr(), dlt.data_ptr(), dq.data_ptr(),
            *_tail(q3, k3, kd, scale, causal, q_off, kv_len))
    _raise_on(rc, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq if kd == d else dq[..., :d].contiguous()


def flash_bwd(q3, k3, v3, do3, lse, dlt, scale: float, causal: bool,
              q_off: int, kv_len: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the two backward kernels (``_bwd_impl``)."""
    args = (q3, k3, v3, do3, lse, dlt, scale, causal, q_off, kv_len)
    dk, dv = flash_bwd_dkv(*args)
    return flash_bwd_dq(*args), dk, dv


# --- autograd and the public function ---------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Flash attention on ``[BH, T, D]``; the backward recomputes P from
    the saved (Q, K, lse) in the backward kernels."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal, q_off, kv_len):
        o, lse = flash_fwd(q3, k3, v3, scale, causal, q_off, kv_len)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.mask = (scale, causal, q_off, kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = flash_bwd(q3, k3, v3, do, lse, delta(do, o), *ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention.  ``[B, Tq, H, D] x [B, Tk, H, D] -> [B, Tq, H,
    D]``, differentiable through the backward kernels.  Same contract as
    ``parallel/sequence.py`` :func:`full_attention`, including the
    decode-style alignment: with ``causal`` and ``Tq < Tk`` the query rows
    are the last ``Tq`` key positions."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if causal and tq > tk:
        # rows before the first key would be wholly masked, and the
        # backward's exp(s - lse) would blow up
        raise ValueError(f"flash_attention(causal=True) requires Tq <= Tk, "
                         f"got Tq={tq} > Tk={tk}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)

    def to3(x):   # a view when B == 1, so make it contiguous
        return x.transpose(1, 2).reshape(b * h, x.shape[1], d).contiguous()

    o3 = _FlashAttention.apply(to3(q), to3(k), to3(v), scale, causal,
                               tk - tq, tk)
    return o3.reshape(b, h, tq, d).transpose(1, 2)
