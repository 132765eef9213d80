"""Fault injection and the membership epoch; port of the
``byteps_tpu/fault`` parts the parameter server needs
(``injector.py``, whole; ``membership.py``'s epoch)."""

from . import injector, membership  # noqa: F401
