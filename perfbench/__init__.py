"""The benchmark of ``byteps_tpu_torch``, the PyTorch and CUDA port.

One run trains one cell of ``BENCHMARK.json`` through the port's
``DistributedOptimizer``, one process a card started by the port's
launcher, and prints one JSON line.  Everything that belongs to one
configuration, traffic mix, metric or cell's limits sits in a file of
its own under this folder, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the model's published sizes, and the names
  of its builder (``builders/``), its reference (``reference/``), its
  FLOP count (``flops/``) and its input kind (``inputs/``);
- ``traffic/<traffic>.json``: batch, sequence, optimizer (its kind is a
  file of ``optimizers/``), codec, warm-up and profiled steps;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
- ``candidates/<cell>.json``: the manifest entries of a cell measured
  but not in ``BENCHMARK.json``.

Run from the root of a checkout::

    python3 -m perfbench.run --workload resnet50.onebit --seed 7 \\
        --seconds 10 --trace 0
"""
