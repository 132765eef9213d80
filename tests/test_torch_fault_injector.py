"""Parity of the port's fault injector with the JAX package's
(``fault/injector.py``): the same specs are accepted and rejected with the
same messages, and the same spec and seed give the same schedule —
``corrupt_bytes``, ``corrupt``, ``should_drop``, ``fire`` and
``socket_fault`` over 1000 visits each — because every rule's RNG is a
``random.Random`` seeded with the same string in both packages."""

import numpy as np
import pytest

from byteps_tpu.common.telemetry import counters as jcounters
from byteps_tpu.fault import injector as jinj
from byteps_tpu_torch.common.telemetry import counters as pcounters
from byteps_tpu_torch.fault import injector as pinj

from .torch_ps_common import fresh_ps_state  # noqa: F401 — autouse

GOOD = [
    "bitflip:site=kv_push:p=0.05;drop:site=kv_push:p=0.1",
    "bitflip:site=server_push:p=0.001",
    "kill:rank=1:step=40",
    "kill:site=coordinator:step=4",
    "delay:site=dcn:p=0.01:ms=200, straggler:rank=2:ms=50",
    "slow:rank=1:site=sync:ms=300:n=20",
    "drop:site=heartbeat:p=0.2",
    "partition:rank=2:n=5",
    "partition:ranks=0|1.2:ms=50",
    "conn_reset:p=0.05:n=3;partial_write:p=0.05;slow_socket:ms=20:p=1",
    "bitflip:site=wal_write:p=1;bitflip:site=serve_pull:p=0.3",
]
BAD = [
    "", ";", "explode:site=kv_push", "bitflip:site=nowhere", "bitflip",
    "bitflip:site=dcn", "kill:rank=1", "kill:p=0.1:step=3",
    "delay:ms=5", "drop:p=0.5", "bitflip:site=kv_push:p=0",
    "bitflip:site=kv_push:p=1.5", "straggler:rank=1", "slow:ms=0",
    "slow:ms=5:n=0", "partition:ranks=0", "partition:ranks=0|0",
    "partition:ranks=a|b", "conn_reset:site=kv_push", "slow_socket:ms=0",
    "delay:site=coordinator:ms=1", "kill:site=dcn:step=1",
    "bitflip:site=kv_push:rank=x", "drop:site=kv_push:bogus=1",
    "bitflip:site=kv_push:ms=3",
]


@pytest.mark.parametrize("spec", GOOD)
def test_accepted_specs_parse_alike(spec):
    assert ([repr(r) for r in pinj.parse_spec(spec)]
            == [repr(r) for r in jinj.parse_spec(spec)])


@pytest.mark.parametrize("spec", BAD)
def test_rejected_specs_fail_alike(spec):
    with pytest.raises(ValueError) as pe:
        pinj.parse_spec(spec)
    with pytest.raises(ValueError) as je:
        jinj.parse_spec(spec)
    assert str(pe.value) == str(je.value)


def _schedule(inj, counters, spec, seed, rank):
    inj.arm(spec, seed=seed, rank=rank)
    data = np.random.RandomState(seed).bytes(64)
    arr = np.arange(16, dtype=np.float32)
    out = {"bytes": [], "arr": [], "drop": [], "fire": [], "socket": []}
    for _ in range(1000):
        out["bytes"].append(inj.corrupt_bytes("kv_push", data))
        out["arr"].append(inj.corrupt("server_push", arr).tobytes())
        out["drop"].append(inj.should_drop("kv_push"))
        before = counters.get("fault.delay")
        inj.fire("kv_push")
        out["fire"].append(counters.get("fault.delay") - before)
        out["socket"].append(inj.socket_fault("transport", "send"))
    out["counters"] = {k: v for k, v in counters.snapshot().items()
                       if k.startswith("fault.")}
    inj.disarm()
    return out


@pytest.mark.parametrize("seed", [0, 11])
def test_same_spec_and_seed_give_the_same_schedule(seed):
    spec = ("bitflip:site=kv_push:p=0.05;drop:site=kv_push:p=0.1;"
            "bitflip:site=server_push:p=0.2;delay:site=kv_push:p=0.3:ms=0;"
            "conn_reset:p=0.02:n=7;partial_write:p=0.01")
    got = _schedule(pinj, pcounters, spec, seed, 0)
    want = _schedule(jinj, jcounters, spec, seed, 0)
    assert got == want
    assert 0 < sum(got["drop"]) < 1000 and 0 < sum(got["fire"]) < 1000
    assert sum(b != got["bytes"][0] for b in got["bytes"]) > 0


def test_rank_scoped_rules_and_kill_step(monkeypatch):
    exits = []
    monkeypatch.setattr(pinj, "_exit", exits.append)
    pinj.arm("drop:rank=1:site=kv_push:p=1;kill:step=3:code=9", rank=0)
    assert not any(pinj.should_drop("kv_push") for _ in range(10))
    for _ in range(4):
        pinj.on_step()
    assert exits == [9] and pcounters.get("fault.kill") == 1
    # site=coordinator never fires: the port has no coordinator yet
    pinj.arm("kill:site=coordinator:step=1", rank=0)
    pinj.on_step()
    assert exits == [9]


def test_persist_survives_engine_scoped_disarm():
    pinj.arm("drop:site=kv_push:p=1", persist=True)
    pinj.disarm(engine_scoped_only=True)
    assert pinj.ENABLED and pinj.should_drop("kv_push")
    pinj.disarm()
    assert not pinj.ENABLED and not pinj.should_drop("kv_push")
