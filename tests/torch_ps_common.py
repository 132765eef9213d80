"""Shared set-up of the parity tests of the async parameter server
(``tests/test_torch_{integrity,fault_injector,kv_store,server_engine,
async_opt}.py``): both packages' process config, counters, injector and
membership epoch start fresh around every test."""

import pytest

from byteps_tpu.common import config as jcfg
from byteps_tpu.common.telemetry import counters as jcounters
from byteps_tpu.fault import injector as jinj
from byteps_tpu.fault import membership as jmem
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common.telemetry import counters as pcounters
from byteps_tpu_torch.fault import injector as pinj
from byteps_tpu_torch.fault import membership as pmem

# the counters the parameter server and its wire hops write
PS_COUNTERS = (
    "integrity.crc_reject", "integrity.retransmit", "integrity.dup_dropped",
    "integrity.nonfinite_zeroed", "integrity.nonfinite_skipped",
    "integrity.nonfinite_rejected", "integrity.quarantine_dropped",
    "integrity.loopback_fast", "membership.stale_pushes_dropped",
    "fault.bitflip", "fault.drop", "retry.attempt", "retry.gave_up",
    "wire_bytes", "wire_bytes_wasted")


def configure(**kw):
    """Install the same process config in both packages."""
    jcfg.set_config(jcfg.Config(**kw))
    pcfg.set_config(pcfg.Config(**kw))


def counter_values(counters):
    return {k: counters.get(k) for k in PS_COUNTERS}


def _reset():
    jcfg.reset_config()
    pcfg.reset_config()
    jcounters.reset()
    pcounters.reset()
    jinj.disarm()
    pinj.disarm()
    jinj._reset_lifetime_for_tests()
    pinj._reset_lifetime_for_tests()
    jmem._reset_epoch_for_tests()
    pmem._reset_epoch_for_tests()


@pytest.fixture(autouse=True)
def fresh_ps_state():
    _reset()
    yield
    _reset()
