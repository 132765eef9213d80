"""The plain reference that decides ``correct``.

Plain PyTorch in float32 (TF32 off), written from the published models
and the codec's stated semantics: ResNet-50 (``resnet.py``), BERT's
masked-LM pretraining (``bert.py``), onebit with error feedback over
the engine's chunking (``onebit.py``); the optimizers' plain updates are
``optimizers/<kind>.py``'s ``step``.  ``replay.py`` replays a cell's first steps from the seed and reads what
``compare.py`` holds the program's readings against.  ``numerics.py``
rounds the products' operands to a lower precision: the control.

Nothing here imports the program, the JAX package or JAX; it takes
nothing the program made (weights and batches come from ``data.py``,
chunk bounds and residuals are worked out here).
"""
