"""Utilities of the port (``byteps_tpu/utils`` counterparts)."""
