"""MNIST-class training under ``tf.distribute`` with the port's
``MirroredStrategy`` (BytePS cross-device ops); port of
``example/tensorflow/tensorflow2_mnist_bps_MirroredStrategy.py``.

The engine starts on ``--device`` before the strategy is built (the
strategy would otherwise start it on the card).  TensorFlow exists on the
CPU test host only (not on the card's machine), so this example is held
on the CPU: pass ``--device cpu``.

Run:  python -m byteps_tpu_torch.examples.tensorflow2_mnist_bps_MirroredStrategy
      [--steps N] [--device cuda|cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import tensorflow as tf

    import byteps_tpu_torch.tensorflow as bps
    from byteps_tpu_torch.tensorflow.distribute import MirroredStrategy

    bps.init(device=args.device)
    strategy = MirroredStrategy()  # engine cross-device ops installed
    with strategy.scope():
        model = tf.keras.Sequential([
            tf.keras.layers.Dense(128, activation="relu"),
            tf.keras.layers.Dense(10),
        ])
        opt = tf.keras.optimizers.SGD(0.05)

    rng = np.random.RandomState(0)
    x = tf.constant(rng.randn(args.batch, 784).astype(np.float32))
    y = tf.constant(rng.randint(0, 10, args.batch))

    @tf.function
    def step():
        def replica_fn():
            with tf.GradientTape() as tape:
                logits = model(x, training=True)
                loss = tf.reduce_mean(
                    tf.nn.sparse_softmax_cross_entropy_with_logits(
                        y, logits))
            grads = tape.gradient(loss, model.trainable_variables)
            opt.apply_gradients(zip(grads, model.trainable_variables))
            return loss
        return strategy.run(replica_fn)

    for i in range(args.steps):
        loss = strategy.reduce(tf.distribute.ReduceOp.MEAN, step(),
                               axis=None)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}")
    bps.shutdown()


if __name__ == "__main__":
    main()
