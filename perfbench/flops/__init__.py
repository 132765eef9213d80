"""Operation and byte counts, and the chip's peaks: one file per
configuration or kernel, the peaks in ``peaks.py``."""
