"""The program side of each configuration: the port's model built as a
user builds it, the benchmark's weights loaded into it, and the loss the
training step takes.  One file per model family, named by a
configuration's ``builder``."""
