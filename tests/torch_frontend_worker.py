"""One rank of the frontends' two-rank checks (tests/test_torch_mxnet.py,
tests/test_torch_tensorflow.py): the port's MXNet or TensorFlow/Keras
adapter at ``world`` gloo ranks, rank r contributing row r of seeded
numpy arrays whose entries are multiples of 1/64 (1/8 for bfloat16), so
every mean over 2 or 4 ranks is exact.  Imports neither jax nor
byteps_tpu.

    python -m tests.torch_frontend_worker OUT.npz mxnet|tf

with DMLC_*/BYTEPS_LOCAL_* set and ORDER_DIR / ORDER_WORLD as for
tests/torch_order_worker.py, whose rendezvous it uses.  The expected
values are :func:`mxnet_want` and :func:`tf_want`.
"""

import os
import subprocess
import sys
import uuid

import numpy as np


def rows(seed, world, shape, step=64, limit=None):
    x = np.random.RandomState(seed).randn(world, *shape) * 4
    if limit is not None:
        x = np.clip(x, -limit, limit)
    return (np.round(x * step) / step).astype(np.float32)


class NDArray:
    """An mx.nd.NDArray stand-in: asnumpy, slice assignment, imul."""

    def __init__(self, arr):
        self._a = np.array(arr)

    def asnumpy(self):
        return self._a

    def __setitem__(self, key, value):
        self._a[key] = np.asarray(value)

    def __imul__(self, other):
        self._a *= other
        return self


LR = 0.25
METRIC = (0.25, 0.75, 1.5, 2.0)        # each rank's metric value


def mxnet_want(world, r):
    want = {"pp_avg": rows(1, world, (33,)).mean(0),
            "pp_sum": rows(2, world, (3, 5)).sum(0),
            "bcast": rows(4, world, (7,))[0]}
    want["opt"] = np.ones(9, np.float32) - LR * rows(3, world, (9,)).mean(0)
    return want


def run_mxnet(res):
    import byteps_tpu_torch.mxnet as mx
    world, r = mx.size(), mx.rank()
    t = NDArray(rows(1, world, (33,))[r])
    mx.byteps_push_pull(t, name="pp_avg", is_average=True)
    res["pp_avg"] = t.asnumpy()
    t = NDArray(rows(2, world, (3, 5))[r])
    mx.byteps_push_pull(t, name="pp_sum", is_average=False)
    res["pp_sum"] = t.asnumpy()

    class SGD:
        def update(self, index, weight, grad, state):
            for w, g in zip(weight, grad):
                w[:] = w.asnumpy() - LR * g.asnumpy()

    w = [NDArray(np.ones(9, np.float32))]
    mx.DistributedOptimizer(SGD()).update(
        [0], w, [NDArray(rows(3, world, (9,))[r])], [None])
    res["opt"] = w[0].asnumpy()
    p = {"p": NDArray(rows(4, world, (7,))[r])}
    mx.broadcast_parameters(p)
    res["bcast"] = p["p"].asnumpy()


def tf_want(world, r):
    x = rows(5, world, (4, 3))
    want = {"pp": x.mean(0), "pp_sum": x.sum(0),
            "pp_grad": np.full((4, 3), 3.0 * world, np.float32),
            "tape": (2 * rows(7, world, (6,))).mean(0),
            "bcast": rows(8, world, (5,))[0],
            "cdo_sum": rows(9, world, (2, 2)).sum(0),
            "cdo_mean": rows(9, world, (2, 2)).mean(0),
            "metric": np.float32(np.mean(METRIC[:world])),
            "bf16": rows(10, world, (16,), step=8, limit=8).mean(0)}
    for i in range(3):
        want[f"eager{i}"] = rows(20 + i, world, (i + 1, 2)).mean(0)
    return want


def run_tf(res):
    import tensorflow as tf
    tf.config.threading.set_inter_op_parallelism_threads(1)
    tf.config.threading.set_intra_op_parallelism_threads(2)
    import byteps_tpu_torch.tensorflow as btf
    from byteps_tpu_torch.keras import callbacks
    from byteps_tpu_torch.tensorflow.distribute import BytePSCrossDeviceOps

    world, r = btf.size(), btf.rank()
    x = tf.constant(rows(5, world, (4, 3))[r])
    res["pp"] = btf.push_pull(x, name="pp").numpy()
    res["pp_sum"] = btf.push_pull(x, name="pp", op="Sum").numpy()
    v = tf.Variable(x)
    with tf.GradientTape() as tape:
        y = tf.reduce_sum(btf.push_pull(v, name="pp_grad", op="Sum") * 3.0)
    res["pp_grad"] = tape.gradient(y, v).numpy()
    w = tf.Variable(rows(7, world, (6,))[r])
    with btf.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = tf.reduce_sum(w * w)
    res["tape"] = tape.gradient(loss, [w])[0].numpy()
    b = tf.Variable(rows(8, world, (5,))[r])
    btf.broadcast_variables([b], root_rank=0)
    res["bcast"] = b.numpy()
    ops = BytePSCrossDeviceOps()
    c = tf.constant(rows(9, world, (2, 2))[r])
    res["cdo_sum"] = ops.reduce(tf.distribute.ReduceOp.SUM, c,
                                destinations=c).numpy()
    res["cdo_mean"] = ops.reduce(tf.distribute.ReduceOp.MEAN, c,
                                 destinations=c).numpy()
    res["metric"] = np.float32(
        callbacks.MetricAverageCallback()._average(METRIC[r], "m"))
    h = tf.constant(rows(10, world, (16,), step=8, limit=8)[r],
                    dtype=tf.bfloat16)
    out = btf.push_pull(h, name="bf16")
    assert out.dtype == tf.bfloat16
    res["bf16"] = tf.cast(out, tf.float32).numpy()
    grads = [tf.constant(rows(20 + i, world, (i + 1, 2))[r])
             for i in range(3)] + [None]
    out = btf.reduce_gradients_eager(grads, scope="w")
    assert out[3] is None
    for i in range(3):
        res[f"eager{i}"] = out[i].numpy()


def main(out, mode):
    from byteps_tpu_torch.core import api

    from .torch_order_worker import _rendezvous
    _rendezvous(mode)
    api.init(device="cpu")
    res = {}
    try:
        {"mxnet": run_mxnet, "tf": run_tf}[mode](res)
    finally:
        api.shutdown()
    np.savez(out, **res)


def spawn(mode, world, out_dir, timeout=240):
    """Every rank of one node of ``world`` ranks; the results by rank."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    token = uuid.uuid4().hex
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(out_dir, f"{mode}_{world}_{rank}.npz")
        env = dict(os.environ, DMLC_NUM_WORKER="1", DMLC_WORKER_ID="0",
                   BYTEPS_LOCAL_SIZE=str(world), BYTEPS_LOCAL_RANK=str(rank),
                   DMLC_PS_ROOT_URI="127.0.0.1", ORDER_DIR=out_dir,
                   ORDER_WORLD=token, OMP_NUM_THREADS="1",
                   TF_CPP_MIN_LOG_LEVEL="2", KERAS_BACKEND="tensorflow",
                   PYTHONPATH=root)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_frontend_worker", out, mode],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    failed = []
    for rank, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            failed.append(f"{mode} rank {rank} timed out:\n{log[-4000:]}")
            continue
        if p.returncode != 0:
            failed.append(f"{mode} rank {rank} rc={p.returncode}:\n"
                          f"{log[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [dict(np.load(o)) for o in outs]


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
