"""The PyTorch examples of the port, run as modules; ports of
``example/pytorch/*.py``.  Each takes ``--device`` (default ``cuda``;
``--device cpu`` runs on the host over gloo) and runs at one rank, or at
one rank per GPU under bpslaunch::

    python -m byteps_tpu_torch.examples.train_mnist_byteps
    python -m byteps_tpu_torch.launcher.launch \\
        python -m byteps_tpu_torch.examples.benchmark_byteps

- ``train_mnist_byteps``: an MLP on synthetic MNIST-shaped data through
  ``DistributedOptimizer``;
- ``benchmark_byteps``: timed push_pull of gradient-sized tensors, with
  an optional codec, and the onebit kernel launches;
- ``benchmark_byteps_ddp``: ``DistributedDataParallel`` with
  ``no_sync()`` accumulation;
- ``benchmark_cross_barrier_byteps``: ``CrossBarrier``, communication
  overlapping the next forward;
- ``elastic_benchmark_byteps``: ``suspend()`` and ``resume()`` mid-run.
"""
