"""TensorFlow framework adapter; port of
``byteps_tpu/tensorflow/__init__.py``.

Counterpart of the reference's byteps.tensorflow plugin
(tensorflow/__init__.py, tensorflow/ops.py — SURVEY.md §2.4): the same
surface — ``push_pull(tensor, op=Average|Sum)``, ``broadcast_variables`` /
``broadcast_global_variables``, ``BroadcastGlobalVariablesHook``,
``DistributedOptimizer`` and ``DistributedGradientTape`` — with the
communication running through the port's engine.  TF stays the modeling
frontend; each value crosses to the host as numpy, is staged onto the
engine's device (the card) and reduced there
(``PushPullEngine.push_pull_local``); bfloat16 crosses through its bits.

Where the reference registers a custom ``BytepsPushPull`` AsyncOpKernel with
CUDA ready-events (tensorflow/ops.cc:167-231), the TF2-native equivalent is a
``tf.py_function`` bridge into the engine wrapped in ``tf.custom_gradient``
(the reference's registered gradient is likewise a push_pull of the incoming
gradient, tensorflow/ops.py:138-147).  This works in eager mode and inside
``tf.function`` graphs; it cannot run under ``jit_compile=True`` (XLA cannot
compile host callbacks) — use ``run_eagerly=True`` or ``jit_compile=False``
in Keras, or :func:`make_compiled_train_step`, which reduces between two
compiled programs.

TensorFlow is imported here only: ``import byteps_tpu_torch`` does not
import it.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import tensorflow as tf

from ..core import api as _api
from .compression import Compression  # noqa: F401

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "declare", "push_pull", "push_pull_async", "broadcast_variables",
    "broadcast_global_variables", "BroadcastGlobalVariablesHook",
    "DistributedOptimizer", "DistributedGradientTape", "Compression",
    "make_compiled_train_step", "reduce_gradients_eager",
]

init = _api.init
shutdown = _api.shutdown
rank = _api.rank
size = _api.size
local_rank = _api.local_rank
local_size = _api.local_size
declare = _api.declare

_anon_counter = [0]
_anon_lock = threading.Lock()
_warned_anon = [False]


def _anon_name(prefix: str = "tf.tensor") -> str:
    with _anon_lock:
        _anon_counter[0] += 1
        return f"{prefix}_{_anon_counter[0]}"


def _engine_reduce(x: np.ndarray, name: str, op: str,
                   priority: Optional[int] = None,
                   compression_kwargs: Optional[dict] = None) -> np.ndarray:
    eng = _api._require()
    return eng.push_pull_local(np.ascontiguousarray(x), name, op=op,
                               priority=priority,
                               compression=compression_kwargs)


def _push_pull_op(tensor: tf.Tensor, name: str, op: str,
                  priority: Optional[int] = None,
                  compression_kwargs: Optional[dict] = None) -> tf.Tensor:
    """Differentiable push_pull: value is the cross-worker reduction, the
    gradient is a push_pull of the incoming gradient (reference
    tensorflow/ops.py:138-147 @ops.RegisterGradient)."""

    @tf.custom_gradient
    def _pp(x):
        def _host(v):
            vn = v.numpy()
            return _engine_reduce(vn, name, op, priority,
                                  compression_kwargs).reshape(vn.shape)

        y = tf.py_function(_host, [x], Tout=x.dtype,
                           name="BytePSPushPull")
        y.set_shape(x.shape)

        def grad(dy):
            def _host_g(v):
                vn = v.numpy()
                return _engine_reduce(vn, name + "_grad", op, priority,
                                      compression_kwargs).reshape(vn.shape)
            g = tf.py_function(_host_g, [dy], Tout=dy.dtype,
                               name="BytePSPushPullGrad")
            g.set_shape(dy.shape)
            return g

        return y, grad

    return _pp(tensor)


def push_pull(tensor, scope: str = "", average: Optional[bool] = None,
              device_dense: str = "", device_sparse: str = "",
              compression=Compression.none, op: Optional[str] = None,
              name: Optional[str] = None, priority: Optional[int] = None,
              compression_kwargs: Optional[dict] = None):
    """Sum or average ``tensor`` over all workers (reference
    tensorflow/__init__.py:40-81).  ``op`` is "Average" (default) or "Sum";
    the legacy ``average=`` bool is honored for parity.  ``device_dense`` /
    ``device_sparse`` are accepted and ignored (the engine's device is the
    process's card)."""
    if op is None:
        op = "Average" if (average is None or average) else "Sum"
    opl = op.lower()
    if opl not in ("average", "sum"):
        raise ValueError(f"push_pull op must be Average or Sum, got {op!r}")
    # sparse_as_dense: IndexedSlices densify here — the engine reduces dense
    # chunks (the reference likewise densifies, tensorflow/__init__.py:52-58)
    tensor = tf.convert_to_tensor(tensor)
    if name is None:
        # each anonymous call registers a fresh engine tensor context; in a
        # tf.function this happens once at trace time (stable name across
        # steps), but an unnamed eager loop grows the registry every step
        if tf.executing_eagerly() and not _warned_anon[0]:
            _warned_anon[0] = True
            import warnings
            warnings.warn(
                "byteps_tpu_torch.tensorflow.push_pull called eagerly "
                "without "
                "name=; each call registers a new tensor context. Pass a "
                "stable name (or wrap the step in tf.function) for long "
                "training loops.", RuntimeWarning, stacklevel=2)
        name = _anon_name(f"byteps_push_pull{('.' + scope) if scope else ''}")
    compressed, ctx = compression.compress(tensor)
    reduced = _push_pull_op(compressed, name, opl, priority,
                            compression_kwargs)
    return compression.decompress(reduced, ctx)


def push_pull_async(tensor, name: Optional[str] = None, average: bool = True,
                    priority: Optional[int] = None,
                    compression_kwargs: Optional[dict] = None):
    """Async handle-based variant (engine-native; the reference's TF path is
    graph-async instead).  Returns a Handle; resolve with
    ``handle.wait()``."""
    eng = _api._require()
    arr = np.ascontiguousarray(tensor.numpy() if hasattr(tensor, "numpy")
                               else np.asarray(tensor))
    return eng.push_pull_local_async(
        arr, name or _anon_name(), op="average" if average else "sum",
        priority=priority, compression=compression_kwargs)


# ------------------------------------------------------------ broadcast

def _broadcast_host_value(arr: np.ndarray, root_rank: int) -> np.ndarray:
    from ..comm.collectives import broadcast_host
    return broadcast_host(_api.engine().comm, np.ascontiguousarray(arr),
                          root=root_rank)


def broadcast_variables(variables, root_rank: int = 0, scope: str = "",
                        session=None):
    """Assign every variable the root rank's value (reference
    tensorflow/__init__.py:110-150).  Implemented as a broadcast of the
    host value on the engine's device (``comm/collectives.broadcast_host``)
    — the reference's equivalent trick is zero-non-root + sum push_pull
    (torch/__init__.py:259-291).

    Eager variables are read/assigned directly; graph-mode variables need a
    ``session`` (values are session.run, assignment goes through per-var
    placeholder assign ops, built here — so the graph must not be finalized;
    for MonitoredTrainingSession use :class:`BroadcastGlobalVariablesHook`,
    which pre-builds the ops in ``begin()``)."""
    variables = list(variables)
    if tf.executing_eagerly() and session is None:
        for var in variables:
            out = _broadcast_host_value(var.numpy(), root_rank)
            var.assign(out.reshape(var.shape))
        return
    if session is None:
        raise RuntimeError(
            "broadcast_variables() in graph mode needs session= to read "
            "and assign variable values")
    values = session.run(variables)
    feeds, ops = {}, []
    for var, val in zip(variables, values):
        out = _broadcast_host_value(np.asarray(val), root_rank)
        ph = tf.compat.v1.placeholder(var.dtype.base_dtype, shape=val.shape)
        feeds[ph] = out.reshape(val.shape)
        ops.append(tf.compat.v1.assign(var, ph))
    session.run(ops, feed_dict=feeds)


def broadcast_global_variables(root_rank: int = 0, session=None):
    """TF1-compat global-variable broadcast (reference
    tensorflow/__init__.py:93-108).  In TF2 eager there is no global
    collection; pass variables to :func:`broadcast_variables` instead."""
    if tf.executing_eagerly():
        raise RuntimeError(
            "broadcast_global_variables() is graph-mode only; in eager/TF2 "
            "use broadcast_variables(model.variables, root_rank)")
    broadcast_variables(tf.compat.v1.global_variables(), root_rank,
                        session=session)


class BroadcastGlobalVariablesHook(tf.compat.v1.train.SessionRunHook):
    """SessionRunHook that broadcasts all global variables from root after
    session creation (reference tensorflow/__init__.py:152-189).  Assign ops
    and placeholders are built in ``begin()`` because MonitoredTrainingSession
    finalizes the graph before ``after_create_session``."""

    def __init__(self, root_rank: int = 0, device: str = ""):
        super().__init__()
        self.root_rank = root_rank
        self.device = device  # accepted for parity; the engine's device
        self._vars = None
        self._phs = None
        self._assigns = None

    def begin(self):
        self._vars = list(tf.compat.v1.global_variables())
        self._phs = [tf.compat.v1.placeholder(v.dtype.base_dtype,
                                              shape=v.shape)
                     for v in self._vars]
        self._assigns = [tf.compat.v1.assign(v, ph)
                         for v, ph in zip(self._vars, self._phs)]

    def after_create_session(self, session, coord):
        values = session.run(self._vars)
        feeds = {ph: _broadcast_host_value(np.asarray(val),
                                           self.root_rank).reshape(val.shape)
                 for ph, val in zip(self._phs, values)}
        session.run(self._assigns, feed_dict=feeds)


# ------------------------------------------------------- optimizer wrappers

def _reduce_grads(grads, compression, op: str, priority_by_index: bool,
                  compression_kwargs: Optional[dict], scope: str):
    """push_pull every gradient with priority = -index so earlier layers
    (needed first next forward pass) communicate first (reference
    tensorflow/ops.cc:158: priority = -declared_key).

    All gradients cross the host boundary in ONE py_function: the host body
    enqueues every tensor async and only then waits, so the engine scheduler
    sees the whole burst and the priorities actually order the chunk issue
    (one py_function per grad would serialize — enqueue, wait, enqueue —
    and make priority meaningless)."""
    live = [(i, g) for i, g in enumerate(grads) if g is not None]
    if not live:
        return list(grads)
    opl = op.lower()
    compressed, ctxs = [], []
    for _, g in live:
        c, ctx = compression.compress(tf.convert_to_tensor(g))
        compressed.append(c)
        ctxs.append(ctx)

    def _host_all(*tensors):
        eng = _api._require()
        handles = []
        for (i, _), t in zip(live, tensors):
            vn = t.numpy()
            # shape captured BEFORE ascontiguousarray (it promotes 0-d to 1-d)
            handles.append((vn.shape, eng.push_pull_local_async(
                np.ascontiguousarray(vn), _stable_grad_name(scope, i),
                op=opl, priority=-i if priority_by_index else None,
                compression=compression_kwargs)))
        results = []
        for shape, h in handles:
            results.append(h.wait().reshape(shape))
            eng.handles.release(h.id)
        return results

    reduced = tf.py_function(_host_all, compressed,
                             Tout=[c.dtype for c in compressed],
                             name="BytePSPushPullGrads")
    if len(live) == 1:
        reduced = [reduced] if not isinstance(reduced, (list, tuple)) \
            else list(reduced)
    out = list(grads)
    for (i, g), r, c, ctx in zip(live, reduced, compressed, ctxs):
        r.set_shape(c.shape)
        out[i] = compression.decompress(r, ctx)
    return out


_grad_name_lock = threading.Lock()


def _stable_grad_name(scope: str, index: int) -> str:
    # stable across steps (engine contexts are keyed by name) but unique
    # per optimizer instance via the scope string
    return f"byteps_grad.{scope}.{index}"


_scope_counter = [0]


def _next_scope() -> str:
    with _grad_name_lock:
        _scope_counter[0] += 1
        return f"opt{_scope_counter[0]}"


def _make_distributed_keras_class(cls, compression=Compression.none,
                                  op: str = "Average",
                                  compression_kwargs: Optional[dict] = None):
    """Dynamic subclass of a Keras optimizer class whose
    ``apply_gradients`` push_pulls first (reference keras wrapping,
    _keras/__init__.py:20-84)."""

    class _Distributed(cls):
        _bps_scope = None
        _bps_compression = compression
        _bps_op = op
        _bps_kwargs = compression_kwargs

        def apply_gradients(self, grads_and_vars, *args, **kw):
            if self._bps_scope is None:
                self._bps_scope = _next_scope()
            grads_and_vars = list(grads_and_vars)
            grads = [g for g, _ in grads_and_vars]
            tvars = [v for _, v in grads_and_vars]
            reduced = _reduce_grads(grads, self._bps_compression,
                                    self._bps_op, True,
                                    self._bps_kwargs, self._bps_scope)
            return super().apply_gradients(
                list(zip(reduced, tvars)), *args, **kw)

    _Distributed.__name__ = "Distributed" + cls.__name__
    _Distributed.__qualname__ = _Distributed.__name__
    return _Distributed


def distributed_optimizer_custom_objects(compression=Compression.none):
    """custom_objects map for keras (de)serialization of wrapped
    optimizers — every builtin optimizer class gets a locatable
    Distributed<Name> entry (reference keras/__init__.py load_model's
    horovod-style custom-object map)."""
    import keras

    objs = {}
    for attr in dir(keras.optimizers):
        cls = getattr(keras.optimizers, attr)
        if (isinstance(cls, type)
                and issubclass(cls, keras.optimizers.Optimizer)
                and cls is not keras.optimizers.Optimizer):
            wrapped = _make_distributed_keras_class(cls, compression)
            objs[wrapped.__name__] = wrapped
    return objs


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         use_locking: bool = False, device_dense: str = "",
                         device_sparse: str = "",
                         compression=Compression.none,
                         sparse_as_dense: bool = True, op: str = "Average",
                         compression_kwargs: Optional[dict] = None):
    """Wrap a Keras (v3) or tf.compat.v1 optimizer so gradients are
    push_pulled across workers before being applied (reference
    tensorflow/__init__.py:186-341).

    Keras path: returns an instance of a dynamic subclass of the wrapped
    optimizer's class whose ``apply_gradients`` reduces first.  v1 path:
    dynamic subclass overriding ``compute_gradients``.
    """
    scope = _next_scope()

    try:
        import keras
        keras_opt_base = keras.optimizers.Optimizer
    except Exception:  # pragma: no cover - keras always ships with tf2
        keras_opt_base = ()

    if keras_opt_base and isinstance(optimizer, keras_opt_base):
        cls = _make_distributed_keras_class(
            optimizer.__class__, compression, op, compression_kwargs)
        new = cls.from_config(optimizer.get_config())
        new._bps_scope = scope
        return new

    v1_base = tf.compat.v1.train.Optimizer
    if isinstance(optimizer, v1_base):
        cls = optimizer.__class__

        class _DistributedV1(cls):  # pragma: no cover - exercised w/ TF1 only
            def compute_gradients(self, *args, **kw):
                gradvars = super().compute_gradients(*args, **kw)
                grads = [g for g, _ in gradvars]
                tvars = [v for _, v in gradvars]
                reduced = _reduce_grads(grads, compression, op, True,
                                        compression_kwargs, scope)
                return list(zip(reduced, tvars))

        _DistributedV1.__name__ = "Distributed" + cls.__name__
        optimizer.__class__ = _DistributedV1
        return optimizer

    raise TypeError(f"unsupported optimizer type {type(optimizer)!r}")


def DistributedGradientTape(gradtape, device_dense: str = "",
                            device_sparse: str = "",
                            compression=Compression.none,
                            sparse_as_dense: bool = True,
                            op: str = "Average",
                            compression_kwargs: Optional[dict] = None):
    """Wrap a tf.GradientTape so ``gradient()`` returns push_pulled
    gradients (reference tensorflow/__init__.py:343-417)."""
    scope = _next_scope()

    class _DistributedGradientTape:
        def __init__(self, tape):
            self._tape = tape

        def __enter__(self):
            self._tape.__enter__()
            return self

        def __exit__(self, *exc):
            return self._tape.__exit__(*exc)

        def __getattr__(self, item):
            return getattr(self._tape, item)

        def gradient(self, target, sources, output_gradients=None):
            grads = self._tape.gradient(target, sources, output_gradients)
            single = not isinstance(grads, (list, tuple))
            glist = [grads] if single else list(grads)
            reduced = _reduce_grads(glist, compression, op, True,
                                    compression_kwargs, scope)
            return reduced[0] if single else reduced

    return _DistributedGradientTape(gradtape)


# ----------------------------------------------- compiled-compute boundary

def reduce_gradients_eager(grads, scope: Optional[str] = None,
                           op: str = "average",
                           compression_kwargs: Optional[dict] = None):
    """Burst-reduce a list of gradient tensors through the engine, eagerly.

    All gradients are enqueued async before any wait, so the engine
    scheduler sees the whole burst and priority (-index) orders the chunk
    issue — the same pattern _reduce_grads uses inside a py_function, but
    without entering a TF graph at all.  For use at the boundary between
    two compiled programs (see :func:`make_compiled_train_step`).

    ``scope`` namespaces the engine tensor names and must be stable across
    steps (engine contexts — compression state, keys, priorities — live
    under these names).  The default is one shared stable scope: correct
    for a single model per process; training several models concurrently
    needs a distinct scope per model (a reused name with different
    geometry raises, it never silently mixes state).
    """
    eng = _api._require()
    if scope is None:
        scope = "eager"
    live = [(i, g) for i, g in enumerate(grads) if g is not None]
    handles = []
    for i, g in live:
        vn = g.numpy() if hasattr(g, "numpy") else np.asarray(g)
        handles.append((i, vn.shape, eng.push_pull_local_async(
            np.ascontiguousarray(vn), _stable_grad_name(scope, i),
            op=op, priority=-i, compression=compression_kwargs)))
    out = list(grads)
    for i, shape, h in handles:
        out[i] = tf.constant(h.wait().reshape(shape), dtype=grads[i].dtype)
        eng.handles.release(h.id)
    return out


def make_compiled_train_step(model, loss_fn, optimizer,
                             compression_kwargs: Optional[dict] = None,
                             jit_compile: bool = True):
    """Training step with XLA-compiled compute and engine communication at
    the program boundary.

    The reference runs communication *inside* the TF graph as an
    AsyncOpKernel (reference tensorflow/ops.cc:167-231) because its
    transport is host/NIC-side and the graph is the only scheduler.  Under
    XLA the inverse composition is native: forward+backward lower to one
    compiled program, gradients cross the engine *between* programs, and
    the optimizer update is a second compiled program.
    ``jit_compile=True`` therefore composes with byteps communication,
    which the py_function path cannot do.

    Returns ``step(x, y) -> loss``.
    """
    scope = _next_scope()

    @tf.function(jit_compile=jit_compile)
    def _forward_backward(x, y):
        with tf.GradientTape() as tape:
            loss = loss_fn(model(x, training=True), y)
        return loss, tape.gradient(loss, model.trainable_variables)

    @tf.function(jit_compile=jit_compile)
    def _apply(*grads):
        optimizer.apply_gradients(zip(grads, model.trainable_variables))

    def step(x, y):
        loss, grads = _forward_backward(x, y)
        reduced = reduce_gradients_eager(
            grads, scope=scope, compression_kwargs=compression_kwargs)
        _apply(*reduced)
        return loss

    return step
