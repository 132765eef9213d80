"""Shared set-up of the fault-plane parity tests of the port
(``tests/test_torch_{slowness,failure_detector,checkpoint,transport}.py``):
both packages' process config, counters, injector, membership epoch,
slowness tracker, transport registry and installed failure action start
fresh around every test, a port engine left running is shut down, and
:func:`threads_settle` waits for the threads a test started to end."""

import os
import sys
import threading
import time

import pytest

from byteps_tpu.common import config as jcfg
from byteps_tpu.common.telemetry import counters as jcounters
from byteps_tpu.fault import injector as jinj
from byteps_tpu.fault import membership as jmem
from byteps_tpu.utils import failure_detector as jfd
from byteps_tpu.utils import slowness as jslow
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common import metrics as pmetrics
from byteps_tpu_torch.common.telemetry import counters as pcounters
from byteps_tpu_torch.core import api as papi
from byteps_tpu_torch.fault import injector as pinj
from byteps_tpu_torch.fault import membership as pmem
from byteps_tpu_torch.utils import failure_detector as pfd
from byteps_tpu_torch.utils import slowness as pslow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reset():
    if papi.initialized():
        papi.shutdown(wait=False)
    papi._suspended = None
    papi._declared_order.clear()
    for mod in ("byteps_tpu.comm.transport", "byteps_tpu_torch.comm.transport"):
        tp = sys.modules.get(mod)
        if tp is not None:
            tp._reset_for_tests()
    jcfg.reset_config()
    pcfg.reset_config()
    jcounters.reset()
    pcounters.reset()
    pmetrics.registry.reset()
    jinj.disarm()
    pinj.disarm()
    jinj._reset_lifetime_for_tests()
    pinj._reset_lifetime_for_tests()
    jmem._reset_epoch_for_tests()
    pmem._reset_epoch_for_tests()
    jslow._reset_for_tests()
    pslow._reset_for_tests()
    jfd.install_failure_action(None)
    pfd.install_failure_action(None)


# what resume() and the recovery coordinator write into the environment
_ENV = ("DMLC_NUM_WORKER", "DMLC_WORKER_ID", "BYTEPS_HEARTBEAT_ON")


@pytest.fixture(autouse=True)
def fresh_fault_state():
    env = {k: os.environ.get(k) for k in _ENV}
    _reset()
    yield
    _reset()
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def threads_settle(baseline: int, timeout: float = 10.0) -> None:
    """Wait until no more threads run than ``baseline`` (every socket,
    supervisor and handler thread a test started has ended); fail with
    their names otherwise."""
    deadline = time.monotonic() + timeout
    while (threading.active_count() > baseline
           and time.monotonic() < deadline):
        time.sleep(0.02)
    assert threading.active_count() <= baseline, \
        [t.name for t in threading.enumerate()]


@pytest.fixture
def thread_count():
    """Yields the thread count before the test; after the test (and the
    state reset, which closes transports) the count must come back."""
    base = threading.active_count()
    yield base
    _reset()
    threads_settle(base)


def wait_for(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"{what} not reached within {timeout}s")


def child_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["BYTEPS_LOG_LEVEL"] = "ERROR"
    env.pop("BYTEPS_FAULT_SPEC", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env
