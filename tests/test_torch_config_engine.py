"""The last ``Config`` fields and engine pieces of the port held against
the JAX package: the seven fields ported with this slice
(``buffer_min_bytes``, ``debug_sample_tensor``, ``restart_limit``,
``dcn_size``, ``force_distributed``, ``use_pallas``, ``deferred_gather``)
with the JAX env names, defaults, parsing and validation messages; the
whole field list; ``BYTEPS_DEBUG_SAMPLE_TENSOR``'s log lines (their
format is the JAX engine's, their numbers the chunk's input and its
reduction); and ``buffer_min_bytes`` routing a single-chunk
sharded-update tensor to the scatter accumulator."""

import dataclasses
import logging
import re

import numpy as np
import pytest
import torch

from byteps_tpu.common import config as jcfg
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.core import api

# field -> (env, a set value, its parsed value, a value validation
# refuses or None)
KNOBS = {
    "buffer_min_bytes": ("BYTEPS_BUFFER_MIN_BYTES", "4096", 4096, "-1"),
    "debug_sample_tensor": ("BYTEPS_DEBUG_SAMPLE_TENSOR", "grad/w", "grad/w",
                            None),
    "restart_limit": ("BYTEPS_RESTART_LIMIT", "3", 3, "-2"),
    "dcn_size": ("BYTEPS_DCN_SIZE", "2", 2, "-1"),
    "force_distributed": ("BYTEPS_FORCE_DISTRIBUTED", "1", True, None),
    "use_pallas": ("BYTEPS_PALLAS", "0", False, None),
    "deferred_gather": ("BYTEPS_DEFERRED_GATHER", "off", False, None),
}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for env, *_ in KNOBS.values():
        monkeypatch.delenv(env, raising=False)
    pcfg.reset_config()
    yield
    pcfg.reset_config()


def test_every_jax_field_is_a_port_field():
    jaxf = {f.name for f in dataclasses.fields(jcfg.Config)}
    portf = {f.name for f in dataclasses.fields(pcfg.Config)}
    assert jaxf <= portf


@pytest.mark.parametrize("field", list(KNOBS))
def test_field_env_default_and_validation_match_jax(field, monkeypatch):
    env, raw, parsed, bad = KNOBS[field]
    assert (getattr(pcfg.Config(), field) == getattr(jcfg.Config(), field)
            == getattr(pcfg.Config.from_env(), field))
    monkeypatch.setenv(env, raw)
    got = getattr(pcfg.Config.from_env(), field)
    assert got == getattr(jcfg.Config.from_env(), field) == parsed
    if bad is None:
        return
    monkeypatch.setenv(env, bad)
    with pytest.raises(ValueError) as pe:
        pcfg.Config.from_env()
    with pytest.raises(ValueError) as je:
        jcfg.Config.from_env()
    assert str(pe.value) == str(je.value)


def test_dcn_size_follows_the_environment_for_explicit_configs(monkeypatch):
    """As in the JAX Config, an explicit ``Config(...)`` reads
    ``BYTEPS_DCN_SIZE`` too (the mesh follows the launcher's env)."""
    monkeypatch.setenv("BYTEPS_DCN_SIZE", "4")
    assert pcfg.Config().dcn_size == jcfg.Config().dcn_size == 4


@pytest.mark.parametrize("field", sorted(pcfg._INERT))
def test_inert_field_set_away_from_default_is_logged_once(field,
                                                          monkeypatch):
    """A field the port parses and does not act on, set by its env var,
    warns once per process naming the variable; its default warns not."""
    env, raw, parsed, _ = KNOBS[field]
    monkeypatch.setattr(pcfg, "_inert_warned", set())
    handler = _Lines()
    log = logging.getLogger("byteps_tpu_torch")
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.WARNING)
    try:
        pcfg.Config.from_env()
        assert not [line for line in handler.lines if env in line]
        monkeypatch.setenv(env, raw)
        pcfg.Config.from_env()
        pcfg.Config.from_env()
    finally:
        log.setLevel(level)
        log.removeHandler(handler)
    got = [line for line in handler.lines if env in line]
    assert len(got) == 1 and "ignored" in got[0], handler.lines
    assert f"{field}={parsed!r}" in got[0]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _sampled(lines):
    pat = re.compile(
        r"sample (\S+) key=(\d+) off=(\d+) in\[sum=(\S+) abs=(\S+) "
        r"first=(\S+)\] out\[sum=(\S+) abs=(\S+) first=(\S+)\]")
    return [pat.fullmatch(line) for line in lines if line.startswith(
        "sample ")]


def test_debug_sample_logs_matching_chunks():
    handler = _Lines()
    log = logging.getLogger("byteps_tpu_torch")
    log.addHandler(handler)
    api.init(pcfg.Config(debug_sample_tensor="grad/w",
                         partition_bytes=4096), device="cpu")
    try:
        x = torch.arange(3000, dtype=torch.float32) - 1000.0
        api.push_pull(x, "grad/w", op="sum")
        api.push_pull(torch.ones(8), "grad/b")
    finally:
        api.shutdown()
        log.removeHandler(handler)
    got = _sampled(handler.lines)
    assert got and all(m is not None for m in got)
    assert {m.group(1) for m in got} == {"grad/w"}
    chunk = 4096 // 4
    assert sorted(int(m.group(3)) for m in got) == [0, chunk, 2 * chunk]
    for m in got:
        off = int(m.group(3))
        part = x[off:off + chunk].double()
        # one rank: the reduction is the chunk itself
        for s, t in ((4, 7), (5, 8), (6, 9)):
            assert float(m.group(s)) == float(m.group(t))
        assert float(m.group(4)) == pytest.approx(float(part.sum()),
                                                  rel=1e-5)
        assert float(m.group(5)) == pytest.approx(float(part.abs().sum()),
                                                  rel=1e-5)
        assert float(m.group(6)) == float(part[0])


def _slot_layout(cfg, name, n):
    api.init(cfg, device="cpu")
    try:
        api.declare_update(name, (n,), optimizer=(torch.optim.SGD,
                                                  {"lr": 0.1}))
        eng = api.engine()
        ctx = eng.registry.get(name)
        with ctx.lock:
            layout = eng._scatter_layout_locked(ctx)
        out = api.push_pull_update(torch.ones(n), name)
        return layout, out
    finally:
        api.shutdown()


@pytest.mark.parametrize("min_bytes, buffered", [(1 << 20, False),
                                                 (4096, True)])
def test_buffer_min_bytes_routes_single_chunk_tensors(min_bytes, buffered):
    """A single-chunk sharded-update tensor of 16 KiB takes the scatter
    accumulator from ``buffer_min_bytes`` down, the parts fallback above
    it; either way the update is the same."""
    cfg = pcfg.Config(sharded_update=True, buffer_min_bytes=min_bytes)
    layout, out = _slot_layout(cfg, "w", 4096)
    assert (layout is not None) == buffered
    np.testing.assert_array_equal(out.numpy(),
                                  np.full(4096, -0.1, np.float32))


def test_debug_sample_keeps_a_tensor_off_the_accumulator():
    cfg = pcfg.Config(sharded_update=True, buffer_min_bytes=4096,
                      debug_sample_tensor="w")
    layout, out = _slot_layout(cfg, "w", 4096)
    assert layout is None
    np.testing.assert_array_equal(out.numpy(),
                                  np.full(4096, -0.1, np.float32))
