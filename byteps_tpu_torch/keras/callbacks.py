"""Keras callbacks (reference byteps/_keras/callbacks.py, SURVEY.md §2.4);
port of ``byteps_tpu/keras/callbacks.py``.

The reference ships four callbacks shared by its keras/tf.keras frontends:
broadcast-on-start, cross-worker metric averaging, an LR multiplier
schedule, and LR warmup.  Same surface here against Keras 3; the averaging
runs through the port's engine (``push_pull_local``) instead of a TF
push_pull op.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import keras

from ..core import api as _api


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcast model + optimizer variables from ``root_rank`` at the start
    of training (reference _keras/callbacks.py:23-49: fires on the first
    batch end so optimizer slots already exist)."""

    def __init__(self, root_rank: int = 0, device: str = ""):
        super().__init__()
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        from . import broadcast_global_variables
        broadcast_global_variables(self.model, self.root_rank)
        self.broadcast_done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """Average epoch-end metrics over all workers (reference
    _keras/callbacks.py:51-91) so rank-0's logged metrics reflect the whole
    job, not its local shard."""

    def __init__(self, device: str = ""):
        super().__init__()

    def _average(self, value: float, name: str) -> float:
        eng = _api._require()
        out = eng.push_pull_local(np.asarray([value], dtype=np.float32),
                                  f"byteps_metric.{name}", op="average")
        return float(out[0])

    def on_epoch_end(self, epoch, logs=None):
        if logs:
            for name in list(logs):
                try:
                    logs[name] = self._average(float(logs[name]), name)
                except (TypeError, ValueError):
                    pass  # non-scalar entries stay local


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """Multiply the initial LR by ``multiplier(epoch)`` over
    [start_epoch, end_epoch) (reference _keras/callbacks.py:93-174).
    ``staircase=True`` adjusts once per epoch; ``False`` interpolates per
    batch using ``steps_per_epoch``."""

    def __init__(self, multiplier: Union[float, Callable[[float], float]],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 initial_lr: Optional[float] = None):
        super().__init__()
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.initial_lr = initial_lr
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = 0
        self.restore_momentum = None
        if callable(multiplier):
            self.staircase = staircase
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    # -- helpers --------------------------------------------------------
    def _lr_var(self):
        return self.model.optimizer.learning_rate

    def _set_lr(self, lr: float):
        opt = self.model.optimizer
        try:
            opt.learning_rate.assign(lr)
        except AttributeError:
            opt.learning_rate = lr

    def _in_window(self, epoch: float) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def _adjust(self, epoch: float):
        if not self._in_window(epoch):
            return
        lr = self.initial_lr * self.multiplier(epoch)
        # momentum correction (reference _keras/callbacks.py:129-143):
        # when LR jumps, scale momentum by new_lr/old_lr for one step so the
        # accumulated velocity keeps its effective magnitude
        opt = self.model.optimizer
        mom = getattr(opt, "momentum", None)
        old_lr = float(np.asarray(keras.ops.convert_to_numpy(
            self._lr_var())))
        if (self.momentum_correction and mom is not None
                and not callable(mom) and old_lr > 0 and lr != old_lr):
            self.restore_momentum = float(mom)
            opt.momentum = float(mom) * lr / old_lr
        self._set_lr(lr)

    def _restore_momentum_if_needed(self):
        if self.restore_momentum is not None:
            self.model.optimizer.momentum = self.restore_momentum
            self.restore_momentum = None

    # -- keras hooks ----------------------------------------------------
    def on_train_begin(self, logs=None):
        if self.initial_lr is None:
            self.initial_lr = float(np.asarray(
                keras.ops.convert_to_numpy(self._lr_var())))
        if not self.staircase and not self.steps_per_epoch:
            self.steps_per_epoch = self.params.get("steps")
            if not self.steps_per_epoch:
                raise ValueError(
                    "steps_per_epoch is required for smooth (staircase="
                    "False) schedules when Keras cannot infer it")

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase:
            self._adjust(epoch)

    def on_batch_begin(self, batch, logs=None):
        if not self.staircase:
            self._adjust(self.current_epoch + float(batch) /
                         self.steps_per_epoch)

    def on_batch_end(self, batch, logs=None):
        self._restore_momentum_if_needed()

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = float(np.asarray(
                keras.ops.convert_to_numpy(self._lr_var())))


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual LR ramp from ``initial_lr`` to ``initial_lr * size()`` over
    the first ``warmup_epochs`` (reference _keras/callbacks.py:176-196,
    after Goyal et al. "Accurate, Large Minibatch SGD")."""

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 verbose: int = 0, initial_lr: Optional[float] = None):
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

        def multiplier(epoch):
            # epoch=0 -> 1/size ... epoch=warmup -> 1.0, then scaled by the
            # size() factor the user bakes into initial_lr
            size = _api.size()
            return 1.0 / size + epoch * (1.0 - 1.0 / size) / warmup_epochs

        super().__init__(multiplier=multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch,
                         initial_lr=initial_lr)

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.warmup_epochs - 1 and self.verbose and \
                _api.rank() == 0:
            print(f"Epoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {self.initial_lr}.")
