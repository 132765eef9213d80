"""Steps/s of three ways to put the engine in a TensorFlow step: no
communication under ``jit_compile`` (the bound), the compiled boundary
(``make_compiled_train_step``: forward and backward compiled, gradients
through the engine between programs), and the in-graph ``py_function``
tape; port of ``example/tensorflow/bench_compiled_boundary.py``.

TensorFlow exists on the CPU test host only (not on the card's machine),
so this example is held on the CPU: pass ``--device cpu``.

Run:  python -m byteps_tpu_torch.examples.bench_compiled_boundary
      [--steps N] [--device cuda|cpu]
"""

import argparse
import json
import sys
import time


def _model(tf):
    # a real (if small) model: 4-block MLP-mixer-ish tower, ~1.1M params
    inputs = tf.keras.Input((256,))
    h = inputs
    for _ in range(4):
        h = tf.keras.layers.Dense(512, activation="gelu")(h)
    outputs = tf.keras.layers.Dense(10)(h)
    return tf.keras.Model(inputs, outputs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import tensorflow as tf

    import byteps_tpu_torch.tensorflow as bps_tf

    tf.random.set_seed(0)
    bps_tf.init(device=args.device)
    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)
    rng = np.random.RandomState(0)
    x = tf.constant(rng.randn(64, 256).astype(np.float32))
    y = tf.constant(rng.randint(0, 10, 64).astype(np.int64))

    def time_steps(step, n):
        step(x, y)  # warmup/trace/compile
        t0 = time.perf_counter()
        for _ in range(n):
            loss = step(x, y)
        _ = float(loss)
        return n / (time.perf_counter() - t0)

    results = {}

    # 1. no-comm jit bound
    m1 = _model(tf)
    o1 = tf.keras.optimizers.SGD(0.01)

    @tf.function(jit_compile=True)
    def step_nocomm(xb, yb):
        with tf.GradientTape() as tape:
            loss = loss_fn(yb, m1(xb, training=True))
        o1.apply_gradients(zip(tape.gradient(loss, m1.trainable_variables),
                               m1.trainable_variables))
        return loss
    results["nocomm_jit"] = time_steps(step_nocomm, args.steps)

    # 2. compiled boundary
    m2 = _model(tf)
    o2 = tf.keras.optimizers.SGD(0.01)
    step_boundary = bps_tf.make_compiled_train_step(
        m2, lambda logits, yb: loss_fn(yb, logits), o2)
    results["boundary_jit"] = time_steps(step_boundary, args.steps)

    # 3. in-graph py_function (cannot jit_compile)
    m3 = _model(tf)
    o3 = tf.keras.optimizers.SGD(0.01)

    @tf.function
    def step_ingraph(xb, yb):
        with bps_tf.DistributedGradientTape(tf.GradientTape()) as tape:
            loss = loss_fn(yb, m3(xb, training=True))
        o3.apply_gradients(zip(tape.gradient(loss, m3.trainable_variables),
                               m3.trainable_variables))
        return loss
    results["ingraph_pyfunc"] = time_steps(step_ingraph, args.steps)

    bps_tf.shutdown()
    bound = results["nocomm_jit"]
    out = {k: round(v, 2) for k, v in results.items()}
    out["boundary_overhead_pct"] = round(
        100 * (1 - results["boundary_jit"] / bound), 1)
    out["ingraph_overhead_pct"] = round(
        100 * (1 - results["ingraph_pyfunc"] / bound), 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
