"""Worker body of the port's gray-failure test
(``tests/test_torch_straggler.py``); port of the JAX package's
``tests/straggler_worker.py`` on the CPU, each member its own engine at a
world of one (``DMLC_NUM_WORKER=1``, ``DMLC_WORKER_ID=<rank>``).  The
JAX worker's description follows.

Same toy topology as elastic_worker.py — three real processes, each
with its own engine on the virtual CPU mesh, sharing one heartbeat
endpoint and one membership bus; the cross-process data plane is the
bus's step_sync payload all-gather.  What THIS worker adds is the
gray-failure lifecycle under ``BYTEPS_STRAGGLER_POLICY=demote``:

- One rank runs under a sustained ``slow`` fault
  (``BYTEPS_FAULT_SPEC=slow:rank=R:site=sync:ms=...:n=...``): every
  engine sync visit sleeps, so the rank reaches each step barrier last
  by ~ms — slow-but-alive, invisible to heartbeats and kill detection.
- The bus scores arrival lags; after ``straggler_demote_after``
  consecutive slow barriers it demotes the rank: survivors apply a
  shrink (``WORLD`` line) and keep stepping at full speed, while the
  straggler gets :class:`Demoted` (``DEMOTED`` line) and parks on
  probation.
- On probation the straggler probes its own data path (a small local
  ``push_pull`` — it visits the chaos ``sync`` site, so the probe stays
  honest until the fault's ``n`` budget really clears), and once
  ``utils.slowness.wait_recovered`` sees consecutive healthy probes
  (``RECOVERED`` line) it suspends and rejoins through the ordinary
  step-boundary admission (``REJOINED`` line) with survivor-broadcast
  parameters — probation cleared bus-side.

Every step prints ``STEP <step> <wall_s>`` so the test can compare
throughput across the faulted / demoted / readmitted windows, and the
``FINAL`` line carries the converged state for the zero-lost /
zero-double-counted gradient equivalence check.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

LR = 0.1
DIM = 8


def _grad(rank: int) -> np.ndarray:
    # rank-distinct so demotion/readmission change the mean: the test's
    # window-by-window simulation catches any lost or double-counted
    # contribution
    return np.full(DIM, float((rank + 1) ** 2), np.float32)


def main() -> int:
    rank = int(os.environ["BYTEPS_ELASTIC_RANK"])
    world = [int(r) for r in os.environ["BYTEPS_ELASTIC_WORLD"].split(",")]
    bus = os.environ["BYTEPS_ELASTIC_BUS"]
    hb_port = os.environ.get("BYTEPS_ELASTIC_HB_PORT", "")
    n_steps = int(os.environ["BYTEPS_ELASTIC_STEPS"])
    sleep_s = float(os.environ.get("BYTEPS_ELASTIC_STEP_SLEEP", "0.1"))
    probe_baseline = float(os.environ.get("BYTEPS_PROBE_BASELINE_S", "0.1"))

    os.environ["DMLC_NUM_WORKER"] = "1"
    os.environ["DMLC_WORKER_ID"] = str(rank)

    import torch

    import byteps_tpu_torch.core.api as api
    from byteps_tpu_torch.fault import membership as mm
    from byteps_tpu_torch.fault.membership import (Demoted,
                                                   ElasticMembership,
                                                   MembershipTimeout,
                                                   WorldChanged)
    from byteps_tpu_torch.utils.failure_detector import install_failure_action
    from byteps_tpu_torch.utils.slowness import wait_recovered

    torch.set_num_threads(1)

    def push(x, name):
        return api.engine().push_pull(torch.from_numpy(x), name,
                                      op="sum").numpy()

    api.init(device="cpu")   # arms the slow fault from BYTEPS_FAULT_SPEC
    m = ElasticMembership(rank, world, bus).start()
    w = np.zeros(DIM, np.float32)
    install_failure_action(m.on_failure)
    if hb_port:
        m.host_heartbeat(interval=0.08, timeout=2.0, grace=60.0,
                         addr="127.0.0.1:" + hb_port,
                         on_failure=m.on_failure)
    # warm the engine's compiled programs BEFORE the measured loop: the
    # first push's compile stall otherwise lands in first-round arrival lags
    # and pollutes every rank's early slowness baseline (the scorer is
    # MAD-robust, but there is no reason to feed it startup noise; the
    # straggler's warm pushes deliberately consume slow-fault budget —
    # the fault is armed, so warmup is slow too, exactly like a real
    # throttled host)
    for i in range(3):
        push(_grad(rank), "grad")
    print("START", rank, flush=True)

    step = 1
    retries = 0
    while step <= n_steps:
        if retries > 300:
            print("RETRY-BUDGET-EXHAUSTED at", step, flush=True)
            return 6
        t_step = time.monotonic()
        try:
            red = push(_grad(rank), "grad")
        except RuntimeError:
            # engine torn down / rebuilt by a concurrent world change
            retries += 1
            m.wait_ready(mm.current_epoch(), timeout=30)
            time.sleep(0.05)
            continue
        try:
            _, payloads = m.step_sync(step, payload=red,
                                      state={"w": w, "step": step - 1})
        except Demoted as e:
            # -- the gray-failure lifecycle ------------------------------
            print("DEMOTED at", step, "probation",
                  ",".join(map(str, e.probation)), flush=True)
            install_failure_action(None)
            m.stop()
            # probation: probe the very data path whose slowness got us
            # demoted (the probe's push visits the chaos `sync` site, so
            # it stays slow until the fault window really ends)
            probe_i = [0]

            def probe():
                probe_i[0] += 1
                push(np.ones(4, np.float32), "probe")

            if not wait_recovered(probe, baseline_s=probe_baseline,
                                  factor=2.0, consecutive=3,
                                  interval_s=0.02, timeout_s=120.0):
                print("NEVER-RECOVERED", flush=True)
                return 7
            print("RECOVERED after", probe_i[0], "probes", flush=True)
            api.suspend()
            m, step0, state = ElasticMembership.rejoin(rank, bus,
                                                       device="cpu")
            w = np.asarray(state["w"], np.float32)
            step = int(step0) + 1
            install_failure_action(m.on_failure)
            if hb_port:
                # re-arm the managed heartbeat: the readmitted rank must
                # beat again or the survivors' rebuilt monitors would
                # eventually declare it stale after the startup grace
                m.host_heartbeat(interval=0.08, timeout=2.0, grace=60.0,
                                 addr="127.0.0.1:" + hb_port,
                                 on_failure=m.on_failure)
            print("REJOINED", mm.current_epoch(),
                  ",".join(map(str, m.view().world)), step0, flush=True)
            continue
        except WorldChanged as e:
            print("WORLD", e.view.epoch,
                  ",".join(map(str, e.view.world)), "at", step, flush=True)
            continue   # engine already on the new world; retry the step
        except MembershipTimeout:
            retries += 1
            continue
        retries = 0
        grads = [np.asarray(p) for p in payloads.values()]
        w = w - np.float32(LR) * (np.sum(grads, axis=0, dtype=np.float32)
                                  / np.float32(len(grads)))
        print("STEP", step, round(time.monotonic() - t_step, 4), flush=True)
        step += 1
        time.sleep(sleep_s)

    assert np.all(w == w[0]), w   # uniform by construction
    from byteps_tpu_torch.common.telemetry import counters as _counters
    print("SLOW-FIRED", _counters.get("fault.slow"),
          "CLEARED", _counters.get("fault.slow_cleared"), flush=True)
    view = m.view()
    print("FINAL", view.epoch, ",".join(map(str, view.world)),
          repr(float(w[0])), flush=True)
    install_failure_action(None)
    m.stop()
    api.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
