"""Keras MNIST-class training with the port's Keras optimizer and
callbacks; port of ``example/keras/keras_mnist.py`` (synthetic data).

Keras and TensorFlow exist on the CPU test host only (not on the card's
machine), so this example is held on the CPU: pass ``--device cpu``.

Run:  python -m byteps_tpu_torch.examples.keras_mnist [--epochs N]
      [--device cuda|cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import byteps_tpu_torch.keras as bps_keras
    import byteps_tpu_torch.tensorflow as bps
    import tensorflow as tf

    bps.init(device=args.device)
    rng = np.random.RandomState(bps.rank())
    x = rng.randn(512, 784).astype(np.float32)
    y = rng.randint(0, 10, 512)

    model = tf.keras.Sequential([
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10, activation="softmax"),
    ])
    # scale lr by worker count (reference keras examples do the same)
    opt = tf.keras.optimizers.SGD(0.05 * bps.size())
    opt = bps_keras.DistributedOptimizer(opt)
    model.compile(optimizer=opt,
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"],
                  run_eagerly=True)  # engine hop is a host callback

    callbacks = [
        bps_keras.callbacks.BroadcastGlobalVariablesCallback(0),
        bps_keras.callbacks.MetricAverageCallback(),
        bps_keras.callbacks.LearningRateWarmupCallback(
            warmup_epochs=1, verbose=0),
    ]
    model.fit(x, y, batch_size=args.batch, epochs=args.epochs,
              callbacks=callbacks,
              verbose=2 if bps.rank() == 0 else 0)
    bps.shutdown()


if __name__ == "__main__":
    main()
