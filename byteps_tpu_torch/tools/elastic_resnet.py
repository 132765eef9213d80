"""ResNet-50 members of an elastic world: the child processes of
``chip_smoke.py``'s phase 12, one member per process.

    python -m byteps_tpu_torch.tools.elastic_resnet --rank R \\
        --world 0,1,2 --bus 127.0.0.1:P --hb-port H --steps 8 --out DIR
    # a restarted member: parks on the bus, joins at a step boundary
    python -m byteps_tpu_torch.tools.elastic_resnet --rank 2 --rejoin \\
        --go DIR/go ...

``--device cpu --batch 2 --image 64`` rehearses a member on the host.

Each member is the JAX package's single-host elastic topology
(``tests/elastic_worker.py``): its own engine at a world of one
(``DMLC_NUM_WORKER=1``, ``DMLC_WORKER_ID=<rank>``, so the injector is
armed at the member's rank), the world in the membership layer
(``fault/membership.py``), and the bus's ``step_sync`` as the data plane
between processes.  A member trains ResNet-50 at full width (1000
classes, NHWC images, bf16 compute, f32 parameters; weights from seed 0,
its batch from seed ``1 + rank``) through ``DistributedOptimizer(SGD(
momentum=0.9), compression={"compressor": "onebit"})``, so every
compressed chunk runs the onebit kernels of ``csrc/onebit.cu``.  Onebit
without error feedback keeps no compressor state across a world change:
a member's state is its parameters and momenta.  Each step:

1. forward, backward and ``synchronize()``: the engine's averaged
   (onebit-decoded) gradients land in ``p.grad``;
2. the gradients flattened to one host f32 vector go to ``step_sync``
   with CRC32Cs of this member's parameters and momenta (taken before
   the step, so every member of an epoch must send the same two);
3. the members' vectors are summed in rank order, divided by the world
   size, copied back, and ``step()`` runs the inner SGD alone
   (``skip_synchronize``).

A member whose engine was torn down under it (a shrink, a rejoin or a
reconcile suspends and resumes it) waits for the new view and runs the
step again from the same parameters.  Heartbeats are
membership-managed (0.2 s interval, 2 s timeout), and the installed
failure action is ``ElasticMembership.on_failure``.  Options:

- ``--go FILE``: build the model, then wait for FILE before joining the
  world (a member started ahead of its turn);
- ``--rejoin``: ``ElasticMembership.rejoin`` (after the ``--go`` file);
  the survivors' parameters and momenta load onto the device and their
  CRC32C must equal the received bytes';
- ``--hold-for-rejoin``: after this member's world shrank, hold the
  next step barrier until a joiner is parked on the bus it hosts (the
  joiner is then admitted at a known boundary, not raced);
- ``--wedge-step K --wedge-ms D``: at step K arm a one-visit
  ``slow:site=sync`` fault of D ms (with ``BYTEPS_SYNC_DEADLINE_S``
  below it, the deadline trips and the installed action reconciles);
- ``--stale-probe``: after training, a chunk enqueued under epoch e must
  fail with ``StaleEpochError`` at dispatch and, issued before the epoch
  moves, at retirement; a stale ``KVStore`` and ``ServerEngine`` push
  must be dropped;
- ``--linger``: after training, write the result and wait for
  ``DIR/release`` before leaving (the parent reads the bus meanwhile).

The member prints ``START``, ``WORLD``, ``REJOINED`` and ``FINAL <epoch>
<world>`` lines, and one ``ELASTIC_RESULT`` JSON line: step times, the
``step_sync`` round trips and payload bytes, the CRC agreement of every
step, detections, world changes (wall clock), suspend and resume times,
counters and the onebit launches.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import sys
import time

RESULT = "ELASTIC_RESULT "
ONEBIT = {"compressor": "onebit"}
SGD = {"lr": 0.1, "momentum": 0.9}
WAIT_S = 300.0            # the go/release files, a parked joiner
MAX_RETRIES = 50          # steps run again after a torn engine


def _emit(doc: dict) -> None:
    print(RESULT + json.dumps(doc), flush=True)


def _wait_file(path: str, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise SystemExit(f"elastic_resnet: no {what} within {WAIT_S} s")
        time.sleep(0.02)


def _host_crc(torch, tensors) -> int:
    """CRC32C of the tensors' bytes, concatenated in order, on the host."""
    from byteps_tpu_torch.common.integrity import crc32c
    if not tensors:
        return 0
    flat = torch.cat([t.detach().reshape(-1) for t in tensors]).cpu()
    return crc32c(flat.numpy().view("uint8"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", default="0,1,2")
    ap.add_argument("--bus", required=True)
    ap.add_argument("--hb-port", type=int, required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rejoin", action="store_true")
    ap.add_argument("--go", default="")
    ap.add_argument("--hold-for-rejoin", action="store_true")
    ap.add_argument("--wedge-step", type=int, default=0)
    ap.add_argument("--wedge-ms", type=int, default=0)
    ap.add_argument("--stale-probe", action="store_true")
    ap.add_argument("--linger", action="store_true")
    args = ap.parse_args(argv)
    rank = args.rank
    # single-host engines; the world lives in the membership layer
    os.environ["DMLC_NUM_WORKER"] = "1"
    os.environ["DMLC_WORKER_ID"] = str(rank)

    import numpy as np
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.fault import injector as inj
    from byteps_tpu_torch.fault import membership as mm
    from byteps_tpu_torch.fault.membership import (ElasticMembership,
                                                   MembershipTimeout,
                                                   WorldChanged)
    from byteps_tpu_torch.models import resnet
    from byteps_tpu_torch.ops import onebit_kernels as ok
    from byteps_tpu_torch.utils.failure_detector import install_failure_action

    # the members' parameters agree bit for bit only if every member's
    # step is the same computation
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    model = resnet.resnet50(
        num_classes=1000,
        generator=torch.Generator().manual_seed(0)).to(device)
    batch = resnet.synthetic_images(
        torch.Generator().manual_seed(1 + rank), args.batch, args.image,
        1000, device)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    inner = torch.optim.SGD(params, **SGD)

    def sync_device():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # wall-clock events the parent lines up across processes
    ev = {"detect": [], "world": [], "suspend_ms": [], "resume_ms": [],
          "reconcile": []}

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ev[key].append((time.perf_counter() - t0) * 1e3)
        return run

    # every world change suspends and resumes the engine through these
    api.suspend = timed(api.suspend, "suspend_ms")
    api.resume = timed(api.resume, "resume_ms")

    def on_world_change(view):
        ev["world"].append({"t": time.time(), "epoch": view.epoch,
                            "world": list(view.world)})

    doc = {"rank": rank, "rejoined": False}
    if args.go:
        _wait_file(args.go, "go file")
    if args.rejoin:
        t_req = time.time()
        m, step0, state = ElasticMembership.rejoin(
            rank, args.bus, device=args.device,
            on_world_change=on_world_change)
        t_adm = time.time()
        with torch.no_grad():
            for n, p in named:
                p.copy_(torch.from_numpy(state["params"][n]).to(device))
            for n, p in named:
                inner.state[p]["momentum_buffer"] = torch.from_numpy(
                    state["momenta"][n]).to(device)
        sync_device()
        got = _host_crc(torch, params)
        want = _host_crc(torch, [torch.from_numpy(state["params"][n])
                                 for n, _ in named])
        mgot = _host_crc(torch, [inner.state[p]["momentum_buffer"]
                                 for p in params])
        mwant = _host_crc(torch, [torch.from_numpy(state["momenta"][n])
                                  for n, _ in named])
        doc.update(rejoined=True, t_request=t_req, t_admitted=t_adm,
                   admitted_epoch=m.view().epoch,
                   admitted_world=list(m.view().world), state_step=step0,
                   state_bits_equal=bool(got == want and mgot == mwant))
        start = int(step0) + 1
        print("REJOINED", mm.current_epoch(),
              ",".join(map(str, m.view().world)), step0, flush=True)
    else:
        bps.init(device=args.device)   # arms BYTEPS_FAULT_SPEC at the rank
        world = [int(r) for r in args.world.split(",")]
        m = ElasticMembership(rank, world, args.bus,
                              on_world_change=on_world_change).start()
        start = 1
    initial_world = len(m.view().world)

    def on_failure(stale):
        t0 = time.time()
        ev["detect"].append({"t": t0, "stale": sorted(stale)})
        try:
            m.on_failure(stale)
        finally:
            if not stale:
                ev["reconcile"].append({"t": t0, "ms": (time.time() - t0)
                                        * 1e3})

    install_failure_action(on_failure)
    m.host_heartbeat(interval=0.2, timeout=2.0, grace=60.0,
                     addr=f"127.0.0.1:{args.hb_port}", on_failure=on_failure)
    if m.heartbeat is not None and not m.heartbeat.wait_server(60.0):
        raise SystemExit(f"member {rank}: no heartbeat server")

    def make_opt():
        return bps.DistributedOptimizer(
            inner, named_parameters=named, compression=ONEBIT)

    opt = make_opt()
    ok.reset_launches()
    print("START", rank, flush=True)
    steps, sync_s, retries = [], [], 0
    frame = None
    held = wedged = False
    step = start
    while step <= args.steps:
        if retries > MAX_RETRIES:
            raise SystemExit(f"member {rank}: {retries} retries at step "
                             f"{step}")
        if args.wedge_step == step and not wedged:
            wedged = True
            # one visit of the engine's sync site sleeps: the wedged unit
            inj.arm(f"slow:rank={rank}:site=sync:ms={args.wedge_ms}:n=1",
                    seed=7, rank=rank, persist=True)
            print("WEDGING", rank, "at", step, flush=True)
        t0 = time.perf_counter()
        try:
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(
                model(batch["images"]), batch["labels"])
            loss.backward()
            opt.synchronize()
            flat = torch.cat([p.grad.reshape(-1) for p in params]).float()
            flat = flat.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — the engine went away
            retries += 1
            print("RETRY", rank, "at", step, type(e).__name__, flush=True)
            m.wait_ready(mm.current_epoch(), timeout=120)
            opt = make_opt()
            continue
        payload = {"grad": flat, "crc": _host_crc(torch, params),
                   "mcrc": _host_crc(torch, [
                       inner.state[p]["momentum_buffer"] for p in params
                       if "momentum_buffer" in inner.state[p]])}
        if frame is None:
            frame = len(pickle.dumps(payload,
                                     protocol=pickle.HIGHEST_PROTOCOL))
        state = {"params": {n: p.detach() for n, p in named},
                 "momenta": {n: inner.state[p]["momentum_buffer"]
                             for n, p in named
                             if "momentum_buffer" in inner.state[p]}}
        if (args.hold_for_rejoin and not held and m.hosting_bus
                and len(m.view().world) < initial_world):
            held = True
            deadline = time.monotonic() + WAIT_S
            while not m.parked_joiners():
                if time.monotonic() > deadline:
                    raise SystemExit("member: no joiner parked")
                time.sleep(0.02)
            print("HELD", rank, "at", step, flush=True)
        ts = time.perf_counter()
        try:
            view, payloads = m.step_sync(step, payload=payload, state=state)
        except WorldChanged as e:
            print("WORLD", e.view.epoch, ",".join(map(str, e.view.world)),
                  "at", step, flush=True)
            opt = make_opt()
            continue
        except MembershipTimeout:
            retries += 1
            continue
        t_sync = time.perf_counter() - ts
        order = sorted(payloads)
        acc = payloads[order[0]]["grad"].copy()
        for r in order[1:]:
            acc += payloads[r]["grad"]
        mean = torch.from_numpy(acc / np.float32(len(order))).to(device)
        off = 0
        with torch.no_grad():
            for p in params:
                p.grad.copy_(mean[off:off + p.numel()].view_as(p))
                off += p.numel()
        with opt.skip_synchronize():
            opt.step()
        sync_device()
        steps.append({"step": step, "epoch": view.epoch,
                      "world": list(view.world),
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "sync_ms": t_sync * 1e3,
                      "reply_bytes": sum(payloads[r]["grad"].nbytes
                                         for r in order),
                      "crc_agree": len({payloads[r]["crc"]
                                        for r in order}) == 1,
                      "mcrc_agree": len({payloads[r]["mcrc"]
                                         for r in order}) == 1,
                      "loss": loss.item()})
        sync_s.append(t_sync)
        retries = 0
        step += 1

    probes = _stale_probes(torch, api, mm, counters, device) \
        if args.stale_probe else None
    view = m.view()
    print("FINAL", view.epoch, ",".join(map(str, view.world)), flush=True)
    doc.update(
        final_epoch=view.epoch, final_world=list(view.world), steps=steps,
        step_ms=statistics.median(s["ms"] for s in steps) if steps else None,
        frame_bytes=frame, events=ev, probes=probes,
        launches=dict(ok.launches),
        counters={k: counters.get(k) for k in (
            "membership.shrink_started", "membership.shrink_agreed",
            "membership.reconcile_started", "membership.rejoin_admitted",
            "membership.coordinator_failover",
            "membership.heartbeat_rehosted",
            "membership.stale_chunks_dropped",
            "membership.stale_pushes_dropped",
            "engine.sync_deadline_trips", "gossip.suspect", "gossip.dead",
            "fault.slow", "integrity.crc_reject")})
    if args.linger:
        path = os.path.join(args.out, f"member{rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f)
        os.replace(path + ".tmp", path)
        _wait_file(os.path.join(args.out, "release"), "release file")
    install_failure_action(None)
    m.stop()
    bps.shutdown()
    _emit(doc)
    return 0


def _stale_probes(torch, api, mm, counters, device) -> dict:
    """A chunk enqueued under epoch e and dispatched under e + 1 (dropped
    at dispatch), one issued under e and retired under e + 1 (dropped at
    retirement), and stale KVStore / ServerEngine pushes."""
    import threading

    import numpy as np

    from byteps_tpu_torch.server.engine import ServerEngine
    from byteps_tpu_torch.server.kv_store import KVStore

    out = {}
    eng = api.engine()
    x = torch.ones(1024, device=device)

    def outcome(h):
        try:
            h.wait(timeout=30)
            return "delivered"
        except RuntimeError as e:
            return ("StaleEpochError" if "stale membership epoch" in str(e)
                    else f"error: {e}")

    before = counters.get("membership.stale_chunks_dropped")
    eng.pause_dispatch()
    h = eng.push_pull_async(x, "stale_probe.dispatch", op="sum")
    mm.advance_epoch()
    eng.resume_dispatch()
    out["dispatch"] = outcome(h)
    # retirement: hold the syncer inside its wait until the epoch moved
    inside, go = threading.Event(), threading.Event()
    real = eng._block

    def held(done):
        eng._block = real
        inside.set()
        go.wait(30)
        return real(done)
    eng._block = held
    h = eng.push_pull_async(x, "stale_probe.retire", op="sum")
    if not inside.wait(30):
        out["retire"] = "never issued"
    else:
        mm.advance_epoch()
        go.set()
        out["retire"] = outcome(h)
    out["chunks_dropped"] = (counters.get("membership.stale_chunks_dropped")
                             - before)
    ep = mm.current_epoch()
    kv = KVStore(device="cpu")
    kv.init_key("w", np.zeros(4, np.float32))
    kv.set_membership_epoch(ep)
    kv.push_delta("w", np.full(4, 50.0, np.float32), mepoch=ep - 1)
    kv.push_delta("w", np.ones(4, np.float32), mepoch=ep)
    out["kv_value"] = float(kv.pull("w")[0])
    srv = ServerEngine(num_threads=1, device="cpu")
    srv.set_membership_epoch(ep)
    srv.push("digest", np.full(4, 100.0, np.float32), 0, 1, mepoch=ep - 1)
    srv.push("digest", np.full(4, 2.0, np.float32), 0, 1, mepoch=ep)
    out["server_value"] = float(srv.pull("digest", timeout=30)[0])
    srv.shutdown()
    out["pushes_dropped"] = counters.get("membership.stale_pushes_dropped")
    return out


if __name__ == "__main__":
    sys.exit(main())
