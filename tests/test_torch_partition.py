"""The split-brain proof on the port (``byteps_tpu_torch/fault/
membership.py`` quorum gate + ``fault/gossip.py``): the JAX package's
``tests/test_partition.py`` over three ``tests/torch_elastic_worker.py``
processes.  ``partition:ranks=0|1.2:ms=10000`` severs the coordinator
(rank 0) from ranks 1 and 2 at one step boundary; the majority shrinks
to {1, 2} and trains, the minority parks with no epoch advanced, the heal
readmits it at epoch 2, every final ``w`` is the bit-exact replay of the
piecewise world schedule (the JAX worker's ``_simulate``), no epoch is
agreed with two worlds in any rank's flight ring, and the port's
``bps_doctor`` folds the dumps into the incident the JAX tool reads from
the same directory.  The transport's 4-process partition lane (the JAX
package's ``tests/test_transport_chaos.py`` case) runs here too: a rank
whose sockets are blackholed leaves restartably at its send deadline and
the other three shrink and finish.
"""

import json

from tests.test_elastic import _simulate

from .torch_member_common import (communicate, final, free_port,  # noqa: F401
                                  fresh_member_state, spawn)

_free_port = free_port


def _world_step(out, epoch, world):
    """Parse 'WORLD <epoch> <world> at <step>' (first occurrence)."""
    for line in out.splitlines():
        if line.startswith(f"WORLD {epoch} {world} at "):
            return int(line.rsplit(" ", 1)[1])
    raise AssertionError(
        f"no 'WORLD {epoch} {world}' line in:\n" + out[-3000:])


def _flight_paths(out):
    return [line.split(" ", 1)[1].strip() for line in out.splitlines()
            if line.startswith("FLIGHT ")]


def _events(path):
    with open(path) as f:
        return json.load(f)["events"]


def _applied_worlds(events):
    """{epoch: world} committed by this rank, per its flight ring."""
    out = {}
    for ev in events:
        if ev.get("kind") == "membership.applied":
            out[int(ev["epoch"])] = tuple(ev["world"])
    return out


def test_partition_minority_parks_majority_trains_heal_rejoins(tmp_path):
    n, cut_at, heal_ms = 40, 4, 10000
    ports = [_free_port() for _ in range(3)]
    hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
    extra = {
        # EMPTY bus: per-view host-map resolution, so the failover
        # successor binds its OWN entry — rank 0's process is alive
        # across the cut, still holding hosts[0]
        "BYTEPS_ELASTIC_BUS": "",
        "BYTEPS_MEMBERSHIP_HOSTS": hosts,
        "BYTEPS_GOSSIP_ON": "1",
        "BYTEPS_GOSSIP_INTERVAL_S": "0.1",
        # tight budgets so each severed round surfaces in seconds
        "BYTEPS_BUS_RETRIES": "8",
        "BYTEPS_RETRY_DEADLINE": "3",
        "BYTEPS_MEMBERSHIP_SYNC_TIMEOUT": "4",
        "BYTEPS_MEMBERSHIP_RENDEZVOUS_TIMEOUT": "5",
        "BYTEPS_ELASTIC_STEP_SLEEP": "0.4",
        "BYTEPS_ELASTIC_PARTITION_SPEC":
            f"partition:ranks=0|1.2:ms={heal_ms}",
        "BYTEPS_ELASTIC_PARTITION_STEP": str(cut_at),
        "BYTEPS_FLIGHT_DIR": str(tmp_path),
    }
    procs = {r: spawn(r, (0, 1, 2), None, None, n, extra=extra)
             for r in (0, 1, 2)}
    outs = communicate(procs, timeout=240)
    for r in (0, 1, 2):
        assert procs[r].returncode == 0, outs[r][-4000:]
        assert f"PARTITION-ARMED {r} at {cut_at}" in outs[r]

    # -- the minority parked; nobody exited ---------------------------
    assert "PARKED 0 0" in outs[0], outs[0][-4000:]
    assert "REJOINED 2 0,1,2" in outs[0], outs[0][-4000:]

    # -- the majority shrank to {1,2} (epoch 1), then re-admitted rank
    #    0 after the heal (epoch 2) — both survivors agree both steps
    s1 = _world_step(outs[2], 1, "1,2")
    s2 = _world_step(outs[2], 2, "0,1,2")
    assert _world_step(outs[1], 1, "1,2") == s1
    assert _world_step(outs[1], 2, "0,1,2") == s2
    assert cut_at <= s1 < s2 <= n

    # -- finals: all three ranks, same epoch/world/weights, and the
    #    weights are a bit-exact float32 replay of the world schedule
    finals = {r: final(outs[r]) for r in (0, 1, 2)}
    for r in (0, 1, 2):
        assert finals[r][0] == 2 and finals[r][1] == "0,1,2", finals[r]
    expected = _simulate(
        _simulate(_simulate(0.0, (0, 1, 2), s1 - 1), (1, 2), s2 - s1),
        (0, 1, 2), n - s2 + 1)
    for r in (0, 1, 2):
        assert finals[r][2] == expected, (finals, expected, s1, s2)

    # -- the split-brain proof, from the flight records ---------------
    # rank 0's FIRST dump is the park-time ring: the minority side
    # recorded the refusal and NEVER started a shrink or committed an
    # epoch past the last agreed one
    park_events = _events(_flight_paths(outs[0])[0])
    park_kinds = [e["kind"] for e in park_events]
    assert "membership.partition_minority" in park_kinds
    minority = [e for e in park_events
                if e["kind"] == "membership.partition_minority"][0]
    assert minority["epoch"] == 0 and minority["world"] == [0, 1, 2]
    assert "membership.shrink_started" not in park_kinds
    assert all(ep == 0 for ep in _applied_worlds(park_events)), \
        park_kinds
    # no epoch is ever agreed with two different worlds across ALL
    # ranks' records — concurrent epochs would show up exactly here
    agreed = {}
    for r in (0, 1, 2):
        for ep, world in _applied_worlds(
                _events(_flight_paths(outs[r])[-1])).items():
            assert agreed.setdefault(ep, world) == world, \
                (r, ep, world, agreed)
    assert agreed[1] == (1, 2) and agreed[2] == (0, 1, 2)

    # the majority side observed the cut and (later) the heal
    maj_events = _events(_flight_paths(outs[1])[-1])
    maj_kinds = [e["kind"] for e in maj_events]
    assert "fault.partition" in maj_kinds
    assert "fault.partition_healed" in maj_kinds
    healed = [e for e in maj_events
              if e["kind"] == "fault.partition_healed"][0]
    assert healed["after_ms"] >= heal_ms

    # -- bps_doctor folds the dumps into one incident, as the JAX tool
    #    does over the same directory ----------------------------------
    from byteps_tpu_torch.tools.bps_doctor import (diagnose_postmortem,
                                                   render_markdown)
    report = diagnose_postmortem(str(tmp_path))
    p = report["partition"]
    assert p["side_a"] == [0] and p["side_b"] == [1, 2]
    assert p["parked_ranks"] == [0]
    assert p["healed"] is True
    assert p["split_ms"] >= heal_ms
    assert "Network partition" in render_markdown(report)
    from tools.bps_doctor import diagnose_postmortem as jax_diagnose
    assert jax_diagnose(str(tmp_path))["partition"] == p


def test_transport_partition_4proc_shrinks_instead_of_hanging():
    """The port's analog of the JAX package's
    ``tests/test_transport_chaos.py`` partition lane
    (``tests/torch_fault_worker.py`` partition mode): a 4-rank elastic
    world pushing to rank 0's store over the TCP transport;
    ``partition:rank=2:site=transport`` blackholes rank 2, whose pushes
    surface as ``AckLost`` at the send deadline (never a hang), so it
    exits restartable; the other three shrink and finish every step;
    their finals are the replay of the shrunk world, and the store holds
    exactly one push per (survivor, step)."""
    import subprocess
    import sys

    import numpy as np

    from .torch_fault_common import child_env
    from .torch_fault_worker import LR, _elastic_grad
    from .torch_member_common import REPO
    port, bus_port, hb_port = free_port(), free_port(), free_port()
    steps = 10
    env = {"BPS_FW_MODE": "partition", "BPS_FW_PORT": port,
           "BPS_FW_STEPS": steps, "BPS_FW_WORLD": "0,1,2,3",
           "BPS_FW_BUS": f"127.0.0.1:{bus_port}", "BPS_FW_HB_PORT": hb_port,
           "BYTEPS_MEMBERSHIP_RENDEZVOUS_TIMEOUT": "3",
           "BYTEPS_MEMBERSHIP_SYNC_TIMEOUT": "15",
           "BYTEPS_FAULT_SPEC": "partition:rank=2:site=transport",
           "BYTEPS_FAULT_SEED": "0", "BYTEPS_FAILURE_EXIT_CODE": "17"}
    worker = f"{REPO}/tests/torch_fault_worker.py"
    procs = {r: subprocess.Popen(
        [sys.executable, worker], env=child_env(BPS_FW_RANK=r, **env),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)}
    outs = communicate(procs, timeout=240)
    assert procs[2].returncode == 17, outs[2][-4000:]
    line = next(ln for ln in outs[2].splitlines()
                if ln.startswith("PARTITIONED "))
    assert int(line.split()[1]) >= 1     # the send deadline surfaced it
    w = np.zeros(4, np.float32)
    for _ in range(steps):
        g = np.sum([_elastic_grad(r) for r in (0, 1, 3)], axis=0,
                   dtype=np.float32) / np.float32(3)
        w = w - LR * g
    for r in (0, 1, 3):
        assert procs[r].returncode == 0, f"rank {r}:\n{outs[r][-4000:]}"
        epoch, world, w0 = final(outs[r])
        assert epoch >= 1 and world == "0,1,3", (epoch, world)
        assert w0 == float(w[0]), (w0, float(w[0]))
    total = next(ln for ln in outs[0].splitlines() if ln.startswith("SUM "))
    assert float(total.split()[1]) == float(3 * steps)
