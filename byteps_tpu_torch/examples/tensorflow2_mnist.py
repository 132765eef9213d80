"""TF2 eager/function MNIST-class training over the port's TensorFlow
adapter; port of ``example/tensorflow/tensorflow2_mnist.py`` (synthetic
data).

TensorFlow exists on the CPU test host only (not on the card's machine),
so this example is held on the CPU: pass ``--device cpu``.

Run:  python -m byteps_tpu_torch.examples.tensorflow2_mnist [--steps N]
      [--device cuda|cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import tensorflow as tf

    import byteps_tpu_torch.tensorflow as bps

    bps.init(device=args.device)
    model = tf.keras.Sequential([
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])
    opt = tf.keras.optimizers.SGD(0.05)

    rng = np.random.RandomState(bps.rank())
    x = tf.constant(rng.randn(args.batch, 784).astype(np.float32))
    y = tf.constant(rng.randint(0, 10, args.batch))

    @tf.function
    def step():
        with tf.GradientTape() as tape:
            logits = model(x, training=True)
            loss = tf.reduce_mean(
                tf.nn.sparse_softmax_cross_entropy_with_logits(y, logits))
        tape = bps.DistributedGradientTape(tape)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        return loss

    model.build((None, 784))
    # consistent start across workers (eager: before the first traced step)
    bps.broadcast_variables(model.variables, root_rank=0)

    for i in range(args.steps):
        loss = step()
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}")
    bps.shutdown()


if __name__ == "__main__":
    main()
