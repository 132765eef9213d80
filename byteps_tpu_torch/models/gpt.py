"""Causal transformer LM with pluggable attention; port of
``byteps_tpu/models/gpt.py`` (the long-context flagship, dense MLPs).

Parameters keep flax's names and layouts, so :func:`load_flax_gpt` is a
copy: a ``DenseGeneral`` kernel is ``(input axes..., output axes...)``
(``qkv`` is ``(C, 3, H, hd)`` with bias ``(3, H, hd)``, ``out`` is ``(H,
hd, C)``), a ``Dense`` kernel is ``(in, out)``, an ``Embed`` table is
``(vocab, C)``, and block ``i`` is ``h.{i}`` where flax says ``h{i}``.

Numerics follow flax with ``dtype=cfg.dtype`` over f32 parameters:

- ``Dense``/``DenseGeneral`` cast the input and the f32 kernel and bias to
  ``cfg.dtype`` before the product (explicitly, not through autocast, so
  gradients reach the f32 parameters);
- ``Embed`` gathers rows and casts them (the values flax's cast-then-take
  gives; the table's gradient is summed in f32);
- ``LayerNorm`` (``epsilon=1e-6``) takes its statistics in f32 with the
  fast variance ``E[x^2] - E[x]^2``, clipped at 0;
- ``gelu`` is the tanh form (``jax.nn.gelu``'s default);
- logits are returned in f32.

``remat`` (the JAX config's ``nn.remat`` of each block) wraps each block
in ``torch.utils.checkpoint`` (non-reentrant): the block's activations
are dropped after the forward and recomputed in the backward, which runs
the same ops on the same inputs, so the loss and gradients keep their
bits.

Mixture of experts (``moe_experts > 0``): every block with ``i %
moe_every == moe_every - 1`` takes a switch MLP (:class:`MoEMLP`,
``parallel/expert.py``) in place of the dense one, under flax's scope
``h{i}/moe`` (``router``, ``w1``, ``b1``, ``w2``, ``b2``).  Its
parameters are f32; the expert stacks are cast to ``cfg.dtype`` for the
products, and the router stays f32.  Built with an ``ep_axis``, a block
holds this rank's slice of the expert stacks and dispatches over that
axis.  Each block keeps the load-balance loss of its last forward
(``MoEMLP.aux``; :meth:`GPT.moe_aux_losses`), the JAX model's ``moe_aux``
collection.  A dense config keeps the dense parameter tree.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel.sequence import full_attention
from ..parallel.tp_layers import (at, copy_to, gather_param, gathered_matmul,
                                  local_shape, param_placements, place,
                                  reduce_from, take, vocab_parallel_lookup,
                                  vocab_parallel_token_nll)

AttnFn = Callable  # (q, k, v, *, causal, sm_scale) -> out


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32768
    hidden_size: int = 512
    num_layers: int = 8
    num_heads: int = 8
    intermediate_size: int = 2048
    max_position: int = 32768        # long-context by default
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False              # checkpoint each block
    # switch-MoE MLPs: 0 = dense everywhere; > 0 turns every
    # ``moe_every``-th block's MLP into a switch layer of that many experts
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity: float = 1.25

    def __post_init__(self):
        if self.moe_experts > 0 and self.moe_every < 1:
            raise ValueError(
                "moe_every must be >= 1 when moe_experts > 0 (a value "
                "of 0 would silently produce a fully dense model)")


def gpt_small() -> GPTConfig:
    return GPTConfig()


def gpt_tiny() -> GPTConfig:
    """CPU tests."""
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=128, max_position=512)


# --- flax layers -------------------------------------------------------------

class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: contracts the last
    ``len(in_shape)`` axes of the input with a kernel of shape ``in_shape +
    out_shape``; input, kernel and bias are cast to ``dtype`` first.

    With a ``layout`` (``parallel/tp_layers.Layout``, scoped to this
    layer) the layer holds its rank's slice of the kernel and bias.  An
    output axis sliced over a split axis (``tp``) makes it column-parallel
    (``col_axis``; its input comes through ``copy_to`` in the caller); an
    input axis, row-parallel (``row_axis``: the product is summed over the
    axis, then the bias is added once); an axis sliced over a gathered
    axis (``fsdp``) is all-gathered for the product
    (``tp_layers.gathered_matmul``).  ``partial_axis`` is set by a caller
    whose product is split over an axis this layer is whole on: its
    kernel's gradient is then a partial sum over that axis."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype, bias: bool = True, device=None,
                 layout=None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        full = self.in_shape + self.out_shape
        self.full = {"kernel": full}
        self.place = {"kernel": place(layout, "kernel", full)}
        self.kernel = nn.Parameter(torch.empty(
            *local_shape(full, self.place["kernel"]), device=device))
        self.gather = self.row_axis = self.col_axis = None
        self.partial_axis = None
        n_in = len(self.in_shape)
        for d, a in enumerate(self.place["kernel"]):
            if a is None:
                continue
            if layout.is_gathered(a):
                self.gather = (d, a)
            elif d < n_in:
                self.row_axis = a
            else:
                self.col_axis = a
        # the kernel's shape in the product: gathered dimensions whole
        self._mm_shape = list(self.kernel.shape)
        if self.gather is not None:
            self._mm_shape[self.gather[0]] = full[self.gather[0]]
        self.bias = None
        if bias:
            self.full["bias"] = self.out_shape
            self.place["bias"] = place(layout, "bias", self.out_shape)
            if any(a is not None and a is not self.col_axis
                   for a in self.place["bias"]):
                raise ValueError("a bias is sliced only as the output of a "
                                 "column-parallel kernel")
            self.bias = nn.Parameter(torch.zeros(
                *local_shape(self.out_shape, self.place["bias"]),
                device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = len(self.in_shape)
        n_in = math.prod(self._mm_shape[:k])
        out = self._mm_shape[k:]
        n_out = math.prod(out)
        lead = x.shape[:x.dim() - k]
        x2 = x.reshape(*lead, n_in).to(self.dtype)
        if self.gather is None:
            y = torch.matmul(x2, self.kernel.reshape(n_in, n_out)
                             .to(self.dtype))
        else:
            d, axis = self.gather
            y = gathered_matmul(x2.reshape(-1, n_in), self.kernel, axis, d,
                                self.dtype).reshape(*lead, n_out)
        y = reduce_from(y, self.row_axis)
        if self.bias is not None:
            y = y + self.bias.reshape(n_out).to(self.dtype)
        return y.reshape(*lead, *out)


class Embed(nn.Module):
    """flax ``Embed``: rows of an f32 ``(num, features)`` table, cast to
    ``dtype``.  With a ``layout``: the vocabulary sliced over a split axis
    (``tp_layers.vocab_parallel_lookup``) and the features over a gathered
    one (``tp_layers.gather_param`` before the lookup)."""

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 device=None, layout=None):
        super().__init__()
        self.dtype = dtype
        self.full = {"embedding": (num, features)}
        self.place = {"embedding": place(layout, "embedding",
                                         (num, features))}
        self.embedding = nn.Parameter(torch.empty(
            *local_shape((num, features), self.place["embedding"]),
            device=device))
        self.gather = self.vocab_axis = None
        for d, a in enumerate(self.place["embedding"]):
            if a is None:
                continue
            if layout.is_gathered(a):
                self.gather = (d, a)
            elif d == 0:
                self.vocab_axis = a
            else:
                raise ValueError("an embedding splits only its vocabulary")

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.embedding
        if self.gather is not None:
            d, axis = self.gather
            table = gather_param(table, axis, d)
        if self.vocab_axis is not None:
            return vocab_parallel_lookup(ids, table, self.vocab_axis,
                                         self.dtype)
        return F.embedding(ids, table).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` (epsilon 1e-6): f32 statistics with the fast
    variance, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def run_block(block: nn.Module, remat: bool, *args) -> torch.Tensor:
    """``block(*args)``; with ``remat``, under a non-reentrant
    ``torch.utils.checkpoint`` when autograd records (the JAX models'
    ``nn.remat`` of each layer)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(block, *args,
                                                 use_reentrant=False)
    return block(*args)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights: kernels and embedding tables normal with standard
    deviation ``1/sqrt(fan_in)``, biases 0, norm scales 1.  A sliced leaf
    (a layout's, or a switch MLP's expert stacks) is drawn whole and its
    rank's slice kept, leaf by leaf, so every layout of one seed holds the
    same weights and the whole model is never on one rank.  A model that
    holds some of its blocks (a pipeline stage) draws the others too, as
    ``model._init_walk`` yields them, and drops them."""
    walk = (model._init_walk() if hasattr(model, "_init_walk")
            else ((m, False) for m in model.modules()))
    for m, phantom in walk:
        if isinstance(m, Dense):
            _draw(m, "kernel", 1.0 / math.sqrt(math.prod(m.in_shape)),
                  generator, phantom)
        elif isinstance(m, Embed):
            _draw(m, "embedding", 1.0 / math.sqrt(m.full["embedding"][1]),
                  generator, phantom)
        elif isinstance(m, MoEMLP):
            m.router.normal_(0.0, m.router.shape[0] ** -0.5,
                             generator=generator)
            for name in ("w1", "w2"):
                w = getattr(m, name)
                full = torch.empty((m.num_experts,) + tuple(w.shape[1:]),
                                   device=w.device)
                full.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
                w.copy_(m.local(full))


def _draw(m: nn.Module, name: str, std: float, generator: torch.Generator,
          phantom: bool) -> None:
    p = getattr(m, name)
    shape = m.full[name]
    if phantom:
        torch.empty(shape, device=generator.device).normal_(
            0.0, std, generator=generator)
    elif tuple(p.shape) == tuple(shape):
        p.normal_(0.0, std, generator=generator)
    else:
        full = torch.empty(shape, device=p.device).normal_(
            0.0, std, generator=generator)
        p.copy_(take(full, m.place[name]))


# --- the model ---------------------------------------------------------------

class CausalSelfAttention(nn.Module):
    """Causal self-attention; with a layout, ``qkv`` column-parallel and
    ``out`` row-parallel over the heads (Megatron)."""

    def __init__(self, cfg: GPTConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, layout=None):
        super().__init__()
        c, h = cfg.hidden_size, cfg.num_heads
        self.head_dim = c // h
        self.attn_fn = attn_fn or full_attention
        self.qkv = Dense((c,), (3, h, self.head_dim), cfg.dtype,
                         device=device, layout=at(layout, "qkv"))
        self.out = Dense((h, self.head_dim), (c,), cfg.dtype, device=device,
                         layout=at(layout, "out"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(copy_to(x, self.qkv.col_axis))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ctx = self.attn_fn(q, k, v, causal=True,
                           sm_scale=1.0 / math.sqrt(self.head_dim))
        return self.out(ctx)


class MoEMLP(nn.Module):
    """Switch-MoE MLP (``parallel/expert.py`` ``moe_mlp``) over the
    block's ``[B, T, C]`` tokens.  Without ``ep_axis`` it holds the full
    expert stacks; with one, ``E / ep`` experts (:meth:`local`) and its
    tokens cross that axis.  ``aux`` is the load-balance loss of the last
    forward."""

    def __init__(self, cfg: GPTConfig, ep_axis=None, device=None):
        super().__init__()
        h, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.moe_experts
        ep = 1 if ep_axis is None else ep_axis.size
        if e % ep:
            raise ValueError(f"{e} experts do not split over ep={ep}")
        self.cfg, self.ep_axis, self.num_experts = cfg, ep_axis, e
        e_loc = e // ep
        self.router = nn.Parameter(torch.empty(h, e, device=device))
        self.w1 = nn.Parameter(torch.empty(e_loc, h, f, device=device))
        self.b1 = nn.Parameter(torch.zeros(e_loc, f, device=device))
        self.w2 = nn.Parameter(torch.empty(e_loc, f, h, device=device))
        self.b2 = nn.Parameter(torch.zeros(e_loc, h, device=device))
        self.aux = None

    def local(self, stack: torch.Tensor) -> torch.Tensor:
        """This rank's experts of a full ``[E, ...]`` stack."""
        if self.ep_axis is None:
            return stack
        e_loc = self.w1.shape[0]
        i = self.ep_axis.index
        return stack[i * e_loc:(i + 1) * e_loc]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.expert import moe_mlp
        dt = self.cfg.dtype
        # products in cfg.dtype as the dense path; the router stays f32
        params = {"router": self.router, "w1": self.w1.to(dt),
                  "b1": self.b1.to(dt), "w2": self.w2.to(dt),
                  "b2": self.b2.to(dt)}
        b, t, h = x.shape
        out, self.aux = moe_mlp(x.reshape(b * t, h), params,
                                self.num_experts, self.cfg.moe_capacity,
                                axis=self.ep_axis)
        return out.reshape(b, t, h)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, moe: bool = False, ep_axis=None, layout=None):
        super().__init__()
        c, dt = cfg.hidden_size, cfg.dtype
        self.ln1 = LayerNorm(c, dt, device=device)
        self.attn = CausalSelfAttention(cfg, attn_fn, device=device,
                                        layout=at(layout, "attn"))
        self.ln2 = LayerNorm(c, dt, device=device)
        if moe:
            self.moe = MoEMLP(cfg, ep_axis, device=device)
        else:
            self.mlp_in = Dense((c,), (cfg.intermediate_size,), dt,
                                device=device, layout=at(layout, "mlp_in"))
            self.mlp_out = Dense((cfg.intermediate_size,), (c,), dt,
                                 device=device, layout=at(layout, "mlp_out"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        if hasattr(self, "moe"):
            return x + self.moe(h)
        h = F.gelu(self.mlp_in(copy_to(h, self.mlp_in.col_axis)),
                   approximate="tanh")
        return x + self.mlp_out(h)


class GPT(nn.Module):
    """Decoder-only LM on ``[B, T]`` token ids; ``positions`` defaults to
    ``arange(T)``.  Weights are drawn from ``generator`` (on ``device``).
    ``ep_axis`` (a ``parallel/mesh_util.MeshAxis``) shards the switch
    MLPs' experts over that axis.

    ``tp_axis`` lays the dense model out for tensor parallelism by
    ``parallel/tensor_parallel.py``'s rules: ``qkv`` and ``mlp_in``
    column-parallel (heads and width), ``out`` and ``mlp_out``
    row-parallel, ``wte`` and ``lm_head`` sliced on the vocabulary, the
    rest whole; the logits are then this rank's vocabulary slice
    (:meth:`token_nll` takes them).  ``layers`` are the blocks this
    instance holds (a pipeline stage's; all by default): ``h.{j}`` is
    block ``layers[j]``.  :meth:`embed`, :meth:`run_blocks` and
    :meth:`head` are the three parts of :meth:`forward`."""

    def __init__(self, cfg: GPTConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 ep_axis=None, tp_axis=None, layers=None):
        super().__init__()
        self.cfg = cfg
        layout = None
        if tp_axis is not None:
            if cfg.moe_experts > 0:
                raise ValueError("tensor parallelism lays out dense blocks; "
                                 "MoE configs take the (dp, ep) layout")
            from ..parallel.tensor_parallel import gpt_layout
            layout = gpt_layout(tp_axis)
        self.mesh_axes = {"tp": tp_axis, "ep": ep_axis}
        self.layers = (tuple(range(cfg.num_layers)) if layers is None
                       else tuple(layers))
        if list(self.layers) != sorted(set(self.layers)) or not all(
                0 <= i < cfg.num_layers for i in self.layers):
            raise ValueError(f"layers {self.layers} are not increasing "
                             f"block indices of {cfg.num_layers}")
        if cfg.moe_experts > 0 and len(self.layers) != cfg.num_layers:
            raise ValueError("a model of some of its blocks needs "
                             "homogeneous blocks; MoE configs interleave "
                             "dense and switch MLPs")
        self._attn_fn, self._ep_axis = attn_fn, ep_axis
        c, dt = cfg.hidden_size, cfg.dtype
        self.wte = Embed(cfg.vocab_size, c, dt, device=device,
                         layout=at(layout, "wte"))
        self.wpe = Embed(cfg.max_position, c, dt, device=device,
                         layout=at(layout, "wpe"))
        self.h = nn.ModuleList(
            Block(cfg, attn_fn, device=device, ep_axis=ep_axis,
                  moe=self._moe(i), layout=at(layout, f"h{i}"))
            for i in self.layers)
        self.ln_f = LayerNorm(c, dt, device=device)
        self.lm_head = Dense((c,), (cfg.vocab_size,), dt, device=device,
                             layout=at(layout, "lm_head"))
        init_params(self, generator
                    or torch.Generator(device=device or "cpu").manual_seed(0))

    def _moe(self, i: int) -> bool:
        cfg = self.cfg
        return cfg.moe_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1

    def _init_walk(self):
        """The modules in the whole model's order for ``init_params``; a
        block this instance does not hold comes as a phantom (its leaves
        drawn and dropped)."""
        held = dict(zip(self.layers, self.h))
        yield from ((m, False) for m in (self.wte, self.wpe))
        for i in range(self.cfg.num_layers):
            if i in held:
                yield from ((m, False) for m in held[i].modules())
            else:
                ghost = Block(self.cfg, self._attn_fn, device="meta",
                              moe=self._moe(i), ep_axis=self._ep_axis)
                yield from ((m, True) for m in ghost.modules())
        yield from ((m, False) for m in (self.ln_f, self.lm_head))

    def embed(self, input_ids: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(input_ids.shape[1],
                                     device=input_ids.device)[None]
        return self.wte(input_ids) + self.wpe(positions)

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.h:
            x = run_block(block, self.cfg.remat, x)
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        h = copy_to(self.ln_f(x), self.lm_head.col_axis)
        return self.lm_head(h).float()

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head(self.run_blocks(self.embed(input_ids, positions)))

    def token_nll(self, logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -1):
        """:func:`token_nll` of this model's logits: vocabulary-parallel
        where ``lm_head`` is sliced on the vocabulary."""
        return head_token_nll(self.lm_head, logits, labels, ignore)

    def moe_aux_losses(self) -> List[torch.Tensor]:
        """The switch blocks' load-balance losses of the last forward, in
        block order (empty for a dense model)."""
        return [b.moe.aux for b in self.h if hasattr(b, "moe")]


# --- loss ------------------------------------------------------------------

def token_nll(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -1):
    """(sum of per-token NLL over valid positions, valid-token count)."""
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                          labels.reshape(-1), ignore_index=ignore,
                          reduction="sum")
    return nll, (labels != ignore).sum().float()


def head_token_nll(head: Dense, logits: torch.Tensor, labels: torch.Tensor,
                   ignore: int = -1):
    """:func:`token_nll` of the logits of ``head``: over the vocabulary
    axis where the head is sliced on it (each rank holds its slice of
    the logits), else plain."""
    if head.col_axis is None:
        return token_nll(logits, labels, ignore)
    return vocab_parallel_token_nll(logits, labels, head.col_axis, ignore)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -1):
    """Next-token cross-entropy; ``labels == ignore`` positions skipped.
    Callers shift: ``labels[t]`` is the target for ``logits[t]``."""
    s, c = token_nll(logits, labels, ignore)
    return s / c.clamp_min(1.0)


# --- flax weights ----------------------------------------------------------

@torch.no_grad()
def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Copy a flax parameter tree (numpy arrays) into ``model`` in place.
    Scope ``h{i}`` is ``h.{i}``; every leaf must land on a parameter and
    every parameter must get one.  A sliced parameter (a layout's,
    ``parallel/tp_layers.py``) takes its rank's slice of the leaf; the
    rest take the leaf whole, of the same shape."""
    flat = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            name = prefix + re.sub(r"^h(\d+)$", r"h.\1", key)
            if isinstance(val, Mapping):
                walk(val, name + ".")
            else:
                flat[name] = val

    walk(params, "")
    own = dict(model.named_parameters())
    places = param_placements(model)
    if set(flat) != set(own):
        raise ValueError(
            f"flax tree and model differ: only in flax "
            f"{sorted(set(flat) - set(own))}, only in the model "
            f"{sorted(set(own) - set(flat))}")
    for name, val in flat.items():
        t = torch.from_numpy(np.array(val, dtype=np.float32))
        if len(places[name]) == t.dim():
            t = take(t, places[name])
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: flax shape {tuple(t.shape)} does not "
                             f"fit {tuple(own[name].shape)}")
        own[name].copy_(t)
    return model


def load_flax_gpt(model: GPT, params) -> GPT:
    """The JAX package's GPT parameters (``variables["params"]``) into a
    port :class:`GPT`.  Switch blocks take the full expert stacks, or,
    in a model built with an ``ep_axis``, their rank's slice of them; a
    model built with a ``tp_axis`` takes its slices, and one holding some
    blocks (``layers``) takes those (flax ``h{layers[j]}`` into
    ``h.{j}``)."""
    src = dict(params)
    params = {k: v for k, v in src.items() if not re.fullmatch(r"h\d+", k)}
    for j, i in enumerate(model.layers):
        if f"h{i}" in src:
            params[f"h{j}"] = src[f"h{i}"]
    for i, block in enumerate(model.h):
        if hasattr(block, "moe") and f"h{i}" in params:
            scope = dict(params[f"h{i}"])
            moe = dict(scope.get("moe", {}))
            for k in ("w1", "b1", "w2", "b2"):
                if k in moe:
                    moe[k] = block.moe.local(
                        torch.from_numpy(np.array(moe[k], np.float32)))
            scope["moe"] = moe
            params[f"h{i}"] = scope
    return load_flax_params(model, params)
