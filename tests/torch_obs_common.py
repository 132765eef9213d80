"""Shared fixture of the port's observability tests: every process-wide
singleton of both packages' observability planes is reset around each
test (the port's config, metrics registry, flight recorder, tracer,
attribution sink, health engine, time-series sampler and endpoint; the
JAX package's tracer, flight recorder, registry and attribution), so no
count or event leaks between tests or files."""

import pytest


def reset_all():
    from byteps_tpu.common import flight_recorder as jflight
    from byteps_tpu.common import metrics as jmetrics
    from byteps_tpu.common import tracing as jtracing
    from byteps_tpu.common.config import reset_config as jreset
    from byteps_tpu.common.telemetry import attribution as jattr

    from byteps_tpu_torch.common import flight_recorder as pflight
    from byteps_tpu_torch.common import health as phealth
    from byteps_tpu_torch.common import lock_witness as pwitness
    from byteps_tpu_torch.common import metrics as pmetrics
    from byteps_tpu_torch.common import obs_server as pobs
    from byteps_tpu_torch.common import timeseries as pts
    from byteps_tpu_torch.common import tracing as ptracing
    from byteps_tpu_torch.common.config import reset_config as preset
    from byteps_tpu_torch.common.telemetry import attribution as pattr

    for mod in (jtracing, ptracing, jflight, pflight, phealth):
        mod._reset_for_tests()
    for reg in (jmetrics.registry, pmetrics.registry):
        reg.reset()
    jattr.reset()
    pattr.reset()
    pts.stop_for_tests()
    pobs.stop_server()
    pwitness._force_for_tests(None)
    pwitness.reset_witness_for_tests()
    jreset()
    preset()


@pytest.fixture(autouse=True)
def fresh_port_plane():
    reset_all()
    yield
    reset_all()
