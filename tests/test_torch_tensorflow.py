"""The port's TensorFlow, Keras and tf.distribute adapters
(byteps_tpu_torch/{tensorflow,keras}) against the JAX package's, case by
case as tests/test_tensorflow_adapter.py and tests/test_tf_distribute.py
drive them: the same seeded numpy inputs (and the same Keras seeds)
through both packages.

Tolerances: at one process the port's push_pull is the identity, so the
port's results are held bit for bit to the input (or to plain TensorFlow
on the same weights); the JAX adapter's reduction on the 8-device CPU
mesh sums eight replicas and divides them back out, so the packages are
held to each other at the JAX tests' tolerances (rtol 1e-5 for values,
1e-2 after an fp16 cast).  At two gloo ranks
(tests/torch_frontend_worker.py) each rank's result is the exact numpy
mean (or sum) of the ranks' rows.

TensorFlow and torch share this process: TensorFlow is held to one
inter-op thread and two intra-op threads.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
tf.config.threading.set_inter_op_parallelism_threads(1)
tf.config.threading.set_intra_op_parallelism_threads(2)
import keras  # noqa: E402

import byteps_tpu.keras as jax_keras  # noqa: E402
import byteps_tpu.tensorflow as jax_tf  # noqa: E402
import byteps_tpu_torch.keras as port_keras  # noqa: E402
import byteps_tpu_torch.tensorflow as port_tf  # noqa: E402
from byteps_tpu.tensorflow import distribute as jax_dist  # noqa: E402
from byteps_tpu_torch.tensorflow import distribute as port_dist  # noqa: E402

from . import torch_frontend_worker as FW  # noqa: E402

PKGS = {"jax": (jax_tf, jax_keras, jax_dist),
        "port": (port_tf, port_keras, port_dist)}


@pytest.fixture
def both():
    jax_tf.init()
    port_tf.init(device="cpu")
    yield
    port_tf.shutdown()
    jax_tf.shutdown()


def _each(fn):
    return {k: fn(*mods) for k, mods in PKGS.items()}


def _close(got, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(got["port"], got["jax"], rtol=rtol, atol=atol)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_push_pull_identity_and_sum(both):
    x = _x(0, 13, 5)
    got = _each(lambda btf, *_: [
        btf.push_pull(tf.constant(x), name="tfa").numpy(),
        btf.push_pull(tf.constant(x), op="Sum", name="tfa").numpy()])
    for a in got["port"]:
        np.testing.assert_array_equal(a, x)
    _close(got, atol=1e-6)


def test_push_pull_fp16_compression(both):
    x = _x(1, 64)

    def run(btf, *_):
        out = btf.push_pull(tf.constant(x), name="tfc",
                            compression=btf.Compression.fp16)
        assert out.dtype == tf.float32
        return out.numpy()

    got = _each(run)
    np.testing.assert_array_equal(got["port"],
                                  x.astype(np.float16).astype(np.float32))
    _close(got, rtol=1e-2, atol=1e-2)


def test_push_pull_inside_tf_function(both):
    x = np.arange(8, dtype=np.float32)

    def run(btf, *_):
        @tf.function
        def reduced(v):
            return btf.push_pull(v, name="tfg", op="Sum")
        return reduced(tf.constant(x)).numpy()

    got = _each(run)
    np.testing.assert_array_equal(got["port"], x)
    _close(got, rtol=1e-6)


def test_push_pull_gradient_is_push_pull(both):
    x = _x(2, 4)

    def run(btf, *_):
        v = tf.Variable(x)
        with tf.GradientTape() as tape:
            y = tf.reduce_sum(btf.push_pull(v, name="tfgrad", op="Sum")
                              * 3.0)
        return tape.gradient(y, v).numpy()

    got = _each(run)
    np.testing.assert_array_equal(got["port"], np.full(4, 3.0, np.float32))
    _close(got, rtol=1e-6)


def test_broadcast_variables(both):
    x = _x(3, 6)

    def run(btf, *_):
        v = tf.Variable(x)
        btf.broadcast_variables([v], root_rank=0)
        return v.numpy()

    got = _each(run)
    np.testing.assert_array_equal(got["port"], x)
    _close(got, rtol=1e-6)


def test_broadcast_variables_graph_mode(both):
    x = _x(4, 5)

    def run(btf, *_):
        g = tf.Graph()
        with g.as_default():
            v = tf.compat.v1.get_variable("bv", initializer=x)
            init_op = tf.compat.v1.global_variables_initializer()
            with tf.compat.v1.Session(graph=g) as sess:
                sess.run(init_op)
                btf.broadcast_global_variables(0, session=sess)
                return sess.run(v)

    got = _each(run)
    np.testing.assert_array_equal(got["port"], x)
    _close(got, rtol=1e-6)


def test_distributed_gradient_tape(both):
    def run(btf, *_):
        w = tf.Variable(2.0)
        with btf.DistributedGradientTape(tf.GradientTape()) as tape:
            loss = w * w
        return float(tape.gradient(loss, [w])[0])

    got = _each(run)
    assert got["port"] == 4.0 and abs(got["jax"] - 4.0) < 1e-5


def test_distributed_optimizer_applies_reduced_grads(both):
    def run(btf, *_):
        opt = btf.DistributedOptimizer(
            keras.optimizers.SGD(learning_rate=0.5))
        v = tf.Variable(np.array([1.0, 2.0], dtype=np.float32))
        g = tf.constant(np.array([1.0, 1.0], dtype=np.float32))
        opt.apply_gradients([(g, v)])
        return type(opt).__name__, v.numpy()

    got = _each(run)
    assert got["port"][0] == got["jax"][0] == "DistributedSGD"
    np.testing.assert_array_equal(got["port"][1], [0.5, 1.5])
    np.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=1e-5)


def test_keras_fit_with_callbacks(both, monkeypatch):
    """A tiny fit: DistributedOptimizer + broadcast + metric averaging +
    warmup, run eagerly, from the same seed in both packages.  The warmup
    ramps from 1/size(): the JAX package's size() counts the mesh's eight
    devices, so it is read as one process here, as the port's is."""
    from byteps_tpu.core import api as jax_api
    monkeypatch.setattr(jax_api, "size", lambda: 1)
    xs = _x(5, 32, 4)
    ys = (xs.sum(axis=1, keepdims=True) > 0).astype(np.float32)

    def run(btf, bk, _):
        keras.utils.set_random_seed(5)
        model = keras.Sequential([
            keras.layers.Dense(8, activation="relu"),
            keras.layers.Dense(1, activation="sigmoid"),
        ])
        opt = bk.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.1))
        model.compile(optimizer=opt, loss="binary_crossentropy",
                      metrics=["accuracy"], run_eagerly=True)
        cbs = [bk.callbacks.BroadcastGlobalVariablesCallback(0),
               bk.callbacks.MetricAverageCallback(),
               bk.callbacks.LearningRateWarmupCallback(
                   warmup_epochs=2, steps_per_epoch=4, verbose=0)]
        hist = model.fit(xs, ys, batch_size=8, epochs=2, callbacks=cbs,
                         verbose=0, shuffle=False)
        return hist.history["loss"], model.get_weights()

    got = _each(run)
    assert len(got["port"][0]) == 2
    assert all(np.isfinite(v) for v in got["port"][0])
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=1e-5)
    for a, b in zip(got["port"][1], got["jax"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_lr_schedule_callback_staircase(both):
    xs, ys = _x(6, 8, 3), _x(7, 8, 1)

    def run(btf, bk, _):
        keras.utils.set_random_seed(6)
        model = keras.Sequential([keras.layers.Dense(1)])
        model.compile(optimizer=keras.optimizers.SGD(learning_rate=1.0),
                      loss="mse", run_eagerly=True)
        cb = bk.callbacks.LearningRateScheduleCallback(
            multiplier=lambda epoch: 0.1 ** epoch, staircase=True,
            momentum_correction=False)
        hist = model.fit(xs, ys, batch_size=4, epochs=3, callbacks=[cb],
                         verbose=0, shuffle=False)
        return hist.history["lr"], hist.history["loss"]

    got = _each(run)
    np.testing.assert_allclose(got["port"][0], [1.0, 0.1, 0.01], rtol=1e-5)
    assert got["port"] == got["jax"]


def test_make_compiled_train_step_matches_plain(both):
    """The compiled-boundary step equals plain jit training on one
    process, in both packages, from the same weights."""
    loss_fn = tf.keras.losses.MeanSquaredError()
    x, y = tf.constant(_x(8, 32, 8)), tf.constant(_x(9, 32, 1))

    def run(btf, *_):
        keras.utils.set_random_seed(4)
        m1 = tf.keras.Sequential([tf.keras.layers.Dense(16,
                                                        activation="relu"),
                                  tf.keras.layers.Dense(1)])
        m1.build((None, 8))
        m2 = tf.keras.models.clone_model(m1)
        m2.build((None, 8))
        m2.set_weights(m1.get_weights())
        o1, o2 = tf.keras.optimizers.SGD(0.05), tf.keras.optimizers.SGD(0.05)
        step = btf.make_compiled_train_step(
            m2, lambda logits, yb: loss_fn(yb, logits), o2,
            jit_compile=True)

        @tf.function(jit_compile=True)
        def plain_step(xb, yb):
            with tf.GradientTape() as tape:
                loss = loss_fn(yb, m1(xb, training=True))
            o1.apply_gradients(zip(tape.gradient(loss,
                                                 m1.trainable_variables),
                                   m1.trainable_variables))
            return loss

        for _ in range(4):
            l_plain = float(plain_step(x, y))
            l_bps = float(step(x, y))
        return l_plain, l_bps, m1.get_weights(), m2.get_weights()

    got = _each(run)
    l_plain, l_bps, w1, w2 = got["port"]
    np.testing.assert_allclose(l_bps, l_plain, rtol=1e-5)
    for a, b in zip(w1, w2):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(l_bps, got["jax"][1], rtol=1e-5)
    for a, b in zip(w2, got["jax"][3]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_reduce_gradients_eager_priority_burst(both):
    grads0 = [_x(10 + i, 4) for i in range(3)]

    def run(btf, *_):
        out = btf.reduce_gradients_eager(
            [tf.constant(g) for g in grads0] + [None], scope="t",
            op="average")
        assert out[3] is None
        return [o.numpy() for o in out[:3]]

    got = _each(run)
    for a, b, g in zip(got["port"], got["jax"], grads0):
        np.testing.assert_array_equal(a, g)
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_bf16_and_zero_d_cross_the_bridge(both):
    """TensorFlow's bfloat16 ``.numpy()`` (ml_dtypes) and a 0-d tensor keep
    their dtype and shape through the port's host bridge."""
    x = _x(11, 6)

    def run(btf, *_):
        b = btf.push_pull(tf.constant(x, dtype=tf.bfloat16), name="bf")
        s = btf.push_pull(tf.constant(3.25), name="scalar", op="Sum")
        return b, s

    got = _each(run)
    b, s = got["port"]
    assert b.dtype == tf.bfloat16 and s.shape == ()
    np.testing.assert_array_equal(
        tf.cast(b, tf.float32).numpy(),
        tf.cast(tf.constant(x, dtype=tf.bfloat16), tf.float32).numpy())
    assert float(s) == 3.25 == float(got["jax"][1])


def test_a_name_traced_with_a_new_shape_raises(both):
    """A name's geometry is fixed at its first push: a tf.function traced
    again for a new shape pushes the same name, which raises in both
    packages, eagerly too; it never mixes state."""
    def run(btf, *_):
        @tf.function
        def reduced(v):
            return btf.push_pull(v, name="fixed")

        np.testing.assert_allclose(reduced(tf.constant(_x(12, 4))).numpy(),
                                   _x(12, 4), rtol=1e-6)
        with pytest.raises(Exception, match="fixed"):
            reduced(tf.constant(_x(13, 5)))
        with pytest.raises(Exception, match="fixed"):
            btf.push_pull(tf.constant(_x(13, 5)), name="fixed")

    _each(run)


# ------------------------------------------------------- tf.distribute

def test_cross_device_ops_reduce_sum_and_mean(both):
    x = _x(14, 8, 3)

    def run(btf, bk, dist):
        ops = dist.BytePSCrossDeviceOps()
        return [ops.reduce(op, tf.constant(x), destinations=tf.constant(x))
                .numpy() for op in (tf.distribute.ReduceOp.SUM,
                                    tf.distribute.ReduceOp.MEAN)]

    got = _each(run)
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, x)
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_mirrored_strategy_reduce(both):
    def run(btf, bk, dist):
        strat = dist.MirroredStrategy(["/cpu:0"])
        ext = strat.extended
        ops = (ext._inferred_cross_device_ops
               if hasattr(ext, "_inferred_cross_device_ops")
               else ext._cross_device_ops)
        assert isinstance(ops, dist.BytePSCrossDeviceOps)
        per_replica = strat.run(lambda: tf.constant(3.0))
        return float(strat.reduce(tf.distribute.ReduceOp.SUM, per_replica,
                                  axis=None))

    got = _each(run)
    assert got["port"] == 3.0 == pytest.approx(got["jax"])


def test_mirrored_strategy_training_step(both):
    def run(btf, bk, dist):
        strat = dist.MirroredStrategy(["/cpu:0"])
        with strat.scope():
            v = tf.Variable(2.0)
        opt = tf.keras.optimizers.SGD(0.5)

        @tf.function
        def step():
            def replica_fn():
                with tf.GradientTape() as tape:
                    loss = v * v
                opt.apply_gradients([(tape.gradient(loss, v), v)])
                return loss
            return strat.run(replica_fn)

        return [float(strat.reduce(tf.distribute.ReduceOp.MEAN, step(),
                                   axis=None)) for _ in range(3)]

    got = _each(run)
    assert got["port"][0] > got["port"][-1]
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-5)


def test_broadcast_mirrors_root_value(both):
    x = np.arange(6, dtype=np.float32)

    def run(btf, bk, dist):
        out = dist.BytePSCrossDeviceOps().broadcast(
            tf.constant(x), destinations=tf.constant(x))
        return tf.convert_to_tensor(out).numpy()

    got = _each(run)
    np.testing.assert_array_equal(got["port"], x)
    np.testing.assert_array_equal(got["port"], got["jax"])


def test_two_ranks_give_the_exact_mean(tmp_path):
    """push_pull (average, sum and its gradient), DistributedGradientTape,
    broadcast_variables, the cross-device ops' SUM and MEAN, the metric
    callback's average, a bfloat16 tensor and reduce_gradients_eager at two
    gloo ranks, TensorFlow in each rank's process."""
    ranks = FW.spawn("tf", 2, str(tmp_path))
    for r, res in enumerate(ranks):
        for k, want in FW.tf_want(2, r).items():
            np.testing.assert_array_equal(res[k], want, err_msg=k)
