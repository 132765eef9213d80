"""ResNet-50 across processes: workers that push weight deltas over the TCP
transport to a ``KVStore`` in another process, and a worker killed
mid-step whose peer recovers from a checkpoint.  The child bodies of
``chip_smoke.py``'s phase 11, one role per process:

    # a store behind a TransportServer, then two workers pushing to it
    python -m byteps_tpu_torch.tools.fault_resnet server --port P \\
        --arm raw --out DIR
    python -m byteps_tpu_torch.tools.fault_resnet worker --rank 0 \\
        --port P --arm raw --out DIR
    python -m byteps_tpu_torch.tools.fault_resnet worker --rank 1 ...
    # two trainers sharing a heartbeat server and a checkpoint directory;
    # rank 1 under BYTEPS_FAULT_SPEC=kill:rank=1:step=N
    python -m byteps_tpu_torch.tools.fault_resnet recover --rank 0 \\
        --hb-port H --out DIR
    python -m byteps_tpu_torch.tools.fault_resnet recover --rank 1 ...

``--device cpu --batch 2 --image 64`` rehearses a role on the host.

Roles:

- ``server``: ``KVStore(device)`` behind a ``TransportServer`` on
  127.0.0.1:``--port``, ResNet-50's 161 parameters initialised from the
  seed (``--arm onebit`` also registers the onebit + EF codec on every
  key, decoded on the store's device).  It records the order in which
  deltas are applied, ``(key, worker, seq)`` under the store's lock, and
  when both workers have pushed their end marker it writes ``init.pt``,
  ``store.pt`` and ``order.pt`` to ``--out`` and prints one
  ``FAULT_RESULT`` line (counters, onebit launches);
- ``worker``: ResNet-50 from the same seed on ``--device``, its own
  seeded batch, a local ``SGD(momentum=0.9)``; for 1 warm-up and
  ``--steps`` timed steps it runs forward and backward (``--replay``:
  sets the gradients an earlier run saved instead), steps, and pushes
  ``p' - p`` per parameter with ``TcpEndpoint.push_delta`` (``--arm
  onebit``: packed by the worker chain on the device and pushed with
  ``push_delta_wire``) with the step as its seq token, retried with the
  same token on ``AckLost``, then pulls every parameter with
  ``kv_pull``.  ``--arm chaos`` sends one deliberate duplicate of a
  landed token.  It writes what it pushed (``pushed_w<R>.pt``) and, in
  the raw arm, its gradients (``grads_w<R>.pt``), and prints a ``FAULT_RESULT`` line:
  step times, host ms per stage (device to host or compress, seal + CRC,
  send to ack, pull, host to device), the round-trip time of each
  request (``Connection.last_rtt_ms``, the value ``transport.rtt_ms``
  observes), wire bytes per step, counters and onebit launches;
- ``recover``: an engine at a world of one on ``--device``, ResNet-50
  trained through ``DistributedOptimizer(SGD(momentum=0.9))``, a
  ``HeartbeatMonitor`` (interval 0.2 s, timeout 2 s) on the shared
  ``--hb-port`` (rank 0 hosts it).  Rank 0 saves ``{model, optimizer,
  step}`` every 2 steps with a ``CheckpointManager`` and recovers with a
  ``RecoveryCoordinator`` when its peer's beats stop: it checks that the
  restored parameters and momentum equal the saved ones bit for bit,
  trains 2 more steps, and prints a ``FAULT_RESULT`` line (detection
  time, suspend / resume / restore ms, save ms and bytes).  Rank 1 arms
  ``BYTEPS_FAULT_SPEC`` with its own rank (a world of one has host id
  0), so ``kill:rank=1:step=N`` ends it with the injector's exit code 1.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import sys
import time

ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
SGD = {"lr": 0.1, "momentum": 0.9}
DONE_KEY = "__done__"   # each worker's end marker (not a parameter)
RESULT = "FAULT_RESULT "
WORKERS = 2
TIMEOUT_S = 300.0        # a server waiting for its workers, a worker for
#                          its server
DEADLINE_S = 30.0        # each request's send deadline
MAX_STEPS = 200          # a trainer that sees no failure in this many fails


def _model(torch, device, num_classes=1000):
    from byteps_tpu_torch.models import resnet
    return resnet.resnet50(
        num_classes=num_classes,
        generator=torch.Generator().manual_seed(0)).to(device)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _counters(*names):
    from byteps_tpu_torch.common.telemetry import counters
    return {n: counters.get(n) for n in names}


def _launches():
    from byteps_tpu_torch.ops import onebit_kernels as ok
    return dict(ok.launches)


def _emit(doc: dict) -> None:
    print(RESULT + json.dumps(doc), flush=True)


# -- server ---------------------------------------------------------------

def run_server(args) -> int:
    import torch

    from byteps_tpu_torch.comm import transport as tp
    from byteps_tpu_torch.ops import onebit_kernels as ok
    from byteps_tpu_torch.server.kv_store import KVStore

    store = KVStore(device=args.device)
    model = _model(torch, torch.device("cpu"))
    init = {}
    for name, p in model.named_parameters():
        store.init_key(name, p.detach())
        init[name] = p.detach().clone()
        if args.arm == "onebit":
            store.register_compression(name, ONEBIT_EF, p.numel(),
                                       torch.float32)
    store.init_key(DONE_KEY, torch.zeros(1))
    # the application order, recorded under the store's lock where each
    # landed delta is summed (duplicates never reach it)
    order = []
    land = store._land_delta_locked

    def recording(key, delta, worker_id, seq, wire_len=None):
        version = land(key, delta, worker_id, seq, wire_len)
        if key != DONE_KEY:
            order.append((key, worker_id, seq))
        return version

    store._land_delta_locked = recording
    ok.reset_launches()
    srv = tp.TransportServer(host="127.0.0.1", port=args.port, rank=0,
                             kv=store)
    print("SRV-UP", flush=True)
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while store.version(DONE_KEY) < WORKERS:
            if time.monotonic() > deadline:
                raise SystemExit("server: the workers never finished")
            time.sleep(0.05)
    finally:
        srv.close()
    os.makedirs(args.out, exist_ok=True)
    torch.save(init, os.path.join(args.out, "init.pt"))
    torch.save({k: store.pull(k) for k in init},
               os.path.join(args.out, "store.pt"))
    torch.save(order, os.path.join(args.out, "order.pt"))
    _emit({"role": "server", "arm": args.arm, "applied": len(order),
           "launches": _launches(),
           "counters": _counters("integrity.crc_reject",
                                 "integrity.dup_dropped",
                                 "integrity.retransmit", "fault.bitflip"),
           "wire_bytes": store.wire_bytes,
           "wire_bytes_wasted": store.wire_bytes_wasted,
           "versions": sorted({store.version(k) for k in init})})
    return 0


# -- worker ---------------------------------------------------------------

class _Timer:
    """Host seconds spent in wrapped callables, by stage."""

    def __init__(self):
        self.s = {}

    def wrap(self, mod, attr, stage):
        real = getattr(mod, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                self.s[stage] = self.s.get(stage, 0.0) + (
                    time.perf_counter() - t0)
        setattr(mod, attr, timed)


def _wire_counter(tp):
    """Bytes this process's transport frames put on the wire, both ways:
    sent frames as packed, received ones as header + meta + payload."""
    box = {"bytes": 0}
    pack, read = tp._pack_frame, tp._read_frame

    def counting_pack(op, req_id, meta, payload=b""):
        frame = pack(op, req_id, meta, payload)
        box["bytes"] += len(frame)
        return frame

    def counting_read(sock):
        op, req_id, meta, payload = read(sock)
        box["bytes"] += tp._HEADER.size + len(payload) + (
            len(pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL))
            if meta else 0)
        return op, req_id, meta, payload

    tp._pack_frame, tp._read_frame = counting_pack, counting_read
    return box


def run_worker(args) -> int:
    import torch

    from byteps_tpu_torch.comm import transport as tp
    from byteps_tpu_torch.common import integrity
    from byteps_tpu_torch.compression import registry
    from byteps_tpu_torch.fault import injector as inj
    from byteps_tpu_torch.models import resnet
    from byteps_tpu_torch.ops import onebit_kernels as ok

    device = torch.device(args.device)
    w = args.rank
    model = _model(torch, device)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = torch.optim.SGD(params, **SGD)
    batch = resnet.synthetic_images(torch.Generator().manual_seed(1 + w),
                                    args.batch, args.image, 1000, device)
    replay = (torch.load(os.path.join(args.replay, f"grads_w{w}.pt"))
              if args.replay else None)
    codecs = None
    if args.arm == "onebit":
        codecs = []
        for p in params:
            wc = registry.create(ONEBIT_EF, p.numel(), p.dtype)
            codecs.append([wc, wc.init_state(device)])
    staging = [torch.empty(p.shape, dtype=p.dtype,
                           pin_memory=device.type == "cuda")
               for p in params]
    timer = _Timer()
    timer.wrap(integrity, "seal_array", "seal+crc")
    timer.wrap(integrity, "seal_bytes", "seal+crc")
    wire = _wire_counter(tp)
    spec = os.environ.get("BYTEPS_FAULT_SPEC", "")
    if spec:
        inj.arm(spec, seed=int(os.environ.get("BYTEPS_FAULT_SEED", "7")),
                rank=w)
    ep = tp.TcpEndpoint(("127.0.0.1", args.port), peer=0, rank=w + 1,
                        send_deadline_s=DEADLINE_S)
    t_end = time.monotonic() + TIMEOUT_S
    while ep.state != tp.READY:          # the server may still be starting
        if time.monotonic() > t_end:
            raise SystemExit(f"worker {w}: no server at port {args.port}")
        time.sleep(0.05)

    def push(key, payload, seq, fn=None):
        fn = fn or (ep.push_delta_wire if codecs is not None
                    else ep.push_delta)
        while True:
            try:
                fn(key, payload, worker_id=w, seq=seq)
                return
            except integrity.AckLost:
                continue     # the same token: a landed original is deduped

    ok.reset_launches()
    pushed, grads, step_ms, losses, rtts = [], {}, [], [], []
    wire_step = []
    stages = {}
    for i in range(1 + args.steps):
        timer.s.clear()
        wire_before = wire["bytes"]
        _sync(torch, device)
        t0 = time.perf_counter()
        opt.zero_grad()
        if replay is None:
            loss = torch.nn.functional.cross_entropy(
                model(batch["images"]), batch["labels"])
            loss.backward()
            losses.append(loss.item())
            if args.arm == "raw":    # the chaos arm replays these
                grads[i] = [p.grad.detach().cpu() for p in params]
        else:
            for p, g in zip(params, replay[i]):
                p.grad = g.to(device)
        old = [p.detach().clone() for p in params]
        opt.step()
        deltas = [p.detach() - o for p, o in zip(params, old)]
        t1 = time.perf_counter()
        if codecs is not None:
            payloads = []
            for j, d in enumerate(deltas):
                wc, st = codecs[j]
                payload, codecs[j][1] = wc.compress(d.reshape(-1), st)
                payloads.append(wc.wire_encode(payload))
        else:
            for buf, d in zip(staging, deltas):
                buf.copy_(d, non_blocking=True)
            _sync(torch, device)
            payloads = staging
        t2 = time.perf_counter()
        seq = i + 1
        for name, payload in zip(names, payloads):
            push(name, payload, seq)
            rtts.append(ep.connection.last_rtt_ms)
            pushed.append((name, w, seq, bytes(payload)
                           if codecs is not None else payload.clone()))
            if args.arm == "chaos" and i == 0 and name == names[0]:
                push(name, payload, seq)      # a landed token, again
        t3 = time.perf_counter()
        pulled = []
        for name in names:
            value, _version = ep.kv_pull(name)
            rtts.append(ep.connection.last_rtt_ms)
            pulled.append(value)
        t4 = time.perf_counter()
        with torch.no_grad():
            for p, value in zip(params, pulled):
                p.copy_(torch.from_numpy(value).view(p.shape))
        _sync(torch, device)
        t5 = time.perf_counter()
        if i:
            step_ms.append((t5 - t0) * 1e3)
            seal = timer.s.get("seal+crc", 0.0)
            for k, v in (("step", t1 - t0),
                         ("compress" if codecs is not None else "d2h",
                          t2 - t1),
                         ("seal+crc", seal), ("send to ack", t3 - t2 - seal),
                         ("pull", t4 - t3), ("h2d", t5 - t4)):
                stages[k] = stages.get(k, 0.0) + v * 1e3 / args.steps
            wire_step.append(wire["bytes"] - wire_before)
    launches = _launches()
    push(DONE_KEY, torch.ones(1), 1, fn=ep.push_delta)
    ep.close()
    inj.disarm()
    os.makedirs(args.out, exist_ok=True)
    torch.save(pushed, os.path.join(args.out, f"pushed_w{w}.pt"))
    if grads:
        torch.save(grads, os.path.join(args.out, f"grads_w{w}.pt"))
    rtts = sorted(r for r in rtts if r is not None)
    _emit({"role": "worker", "rank": w, "arm": args.arm,
           "step_ms": step_ms, "median_ms": statistics.median(step_ms),
           "stages_ms": stages, "losses": losses,
           "wire_bytes_per_step": statistics.median(wire_step),
           "rtt_ms": {"n": len(rtts), "p50": rtts[len(rtts) // 2],
                      "p99": rtts[min(len(rtts) - 1,
                                      int(0.99 * len(rtts)))]},
           "pushes": len(pushed), "launches": launches,
           "counters": _counters("integrity.retransmit",
                                 "transport.conn_resets",
                                 "transport.reconnects",
                                 "transport.send_deadline_trips",
                                 "fault.bitflip", "fault.conn_reset"),
           "connection": {"connects": ep.connection.connects,
                          "reconnects": ep.connection.reconnects}})
    return 0


# -- recover --------------------------------------------------------------

def run_recover(args) -> int:
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.common.telemetry import counters
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.fault import injector as inj
    from byteps_tpu_torch.fault.recovery import RecoveryCoordinator
    from byteps_tpu_torch.models import resnet
    from byteps_tpu_torch.utils.checkpoint import CheckpointManager
    from byteps_tpu_torch.utils.failure_detector import HeartbeatMonitor

    rank = args.rank
    cfg = Config.from_env()
    bps.init(cfg, device=args.device)
    if cfg.fault_spec:
        # a world of one has host id 0: arm with this trainer's rank
        inj.arm(cfg.fault_spec, seed=cfg.fault_seed, rank=rank)
    device = api.device()
    model = _model(torch, device)
    batch = resnet.synthetic_images(
        torch.Generator().manual_seed(1 + rank), args.batch, args.image,
        1000, device)

    def make_opt():
        return bps.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), **SGD),
            named_parameters=model.named_parameters())

    def train_step(opt):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(batch["images"]),
                                                 batch["labels"])
        loss.backward()
        opt.step()
        _sync(torch, device)
        return loss.item()

    opt = make_opt()
    ckdir = os.path.join(args.out, "ckpt")
    times = {}
    step = 1
    losses = [train_step(opt)]   # the warm-up builds the momentum buffers

    def snapshot():
        return {"model": model.state_dict(), "optimizer": opt.state_dict(),
                "step": step}

    template = snapshot()
    coordinator = None
    if rank == 0:
        mgr = CheckpointManager(ckdir, max_to_keep=3)
        coordinator = RecoveryCoordinator(
            checkpoint_manager=CheckpointManager(ckdir, max_to_keep=3),
            template=template)
        for fn in ("suspend", "resume"):
            _time_call(api, fn, times)
        _time_call(coordinator.checkpoint_manager, "restore_latest", times)

    def on_failure(stale):
        times["detected_at"] = time.time()
        coordinator.on_failure(stale)

    mon = HeartbeatMonitor(rank, 2, f"127.0.0.1:{args.hb_port}",
                           interval=0.2, timeout=2.0, grace=60.0,
                           on_failure=(on_failure if rank == 0
                                       else lambda stale: None)).start()
    if not mon.wait_server(60.0):
        raise SystemExit(f"rank {rank}: no heartbeat server")
    print("START", rank, flush=True)
    saved, save_ms, save_bytes = {}, [], []
    while step < MAX_STEPS:
        if coordinator is not None and coordinator.triggered:
            break
        try:
            losses.append(train_step(opt))
        except Exception:  # noqa: BLE001 — the engine went away mid-step
            if coordinator is not None and coordinator.triggered:
                break
            raise
        step += 1
        if rank == 0 and step % 2 == 0 and not coordinator.triggered:
            state = snapshot()
            t0 = time.perf_counter()
            mgr.save(step, state)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            save_bytes.append(os.path.getsize(os.path.join(
                ckdir, str(step), "state.pt")))
            saved[step] = _host_state(torch, state)
            saved.pop(step - 6, None)
    else:
        raise SystemExit(f"rank {rank}: no failure detected in "
                         f"{MAX_STEPS} steps")
    res = coordinator.wait(timeout=120)
    if res is None:
        raise SystemExit("rank 0: recovery did not complete")
    want = saved[res.step]
    # a fresh optimizer on the resumed engine; the old one (and its hooks)
    # held handles of the engine that was torn down
    del opt
    opt = make_opt()
    model.load_state_dict(res.state["model"])
    opt.load_state_dict(res.state["optimizer"])
    differ = [k for k, v in model.state_dict().items()
              if not _same_bits(v, want["model"][k])]
    moms = opt.state_dict()["state"]
    differ += [f"momentum.{i}" for i, st in moms.items()
               if not _same_bits(
                   st["momentum_buffer"],
                   want["optimizer"]["state"][i]["momentum_buffer"])]
    on_card = all(v.device == device for v in model.state_dict().values())
    after = [train_step(opt) for _ in range(2)]
    mon.stop()
    bps.shutdown()
    _emit({"role": "recover", "rank": 0, "restored_step": res.step,
           "steps_before": step, "differ": differ[:8],
           "n_differ": len(differ), "momenta": len(moms),
           "restored_on_card": on_card, "losses_after": after,
           "detected_at": times.get("detected_at"),
           "suspend_ms": times.get("suspend"),
           "resume_ms": times.get("resume"),
           "restore_ms": times.get("restore_latest"),
           "recovery_s": res.elapsed_s, "save_ms": save_ms,
           "save_bytes": save_bytes, "failed_ranks": sorted(
               res.failed_ranks), "num_workers": res.num_workers,
           "counters": {k: counters.get(k) for k in (
               "recovery.attempt", "recovery.completed",
               "recovery.failed")}})
    return 0


def _same_bits(a, b) -> bool:
    """Equal bytes (a -0.0 is not a +0.0), whatever the devices."""
    import torch
    a = a.detach().contiguous().reshape(-1).view(torch.uint8)
    b = b.detach().to(a.device).contiguous().reshape(-1).view(torch.uint8)
    return torch.equal(a, b)


def _time_call(obj, attr, times):
    real = getattr(obj, attr)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            times[attr] = (time.perf_counter() - t0) * 1e3
    setattr(obj, attr, timed)


def _host_state(torch, state):
    """A host copy of a {model, optimizer, step} snapshot, to hold the
    restore against."""
    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, list):
            return [copy(v) for v in x]
        return x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x
    return copy(state)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("role", choices=("server", "worker", "recover"))
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--hb-port", type=int, default=0)
    ap.add_argument("--arm", default="raw", choices=("raw", "onebit",
                                                     "chaos"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--replay", default="",
                    help="directory of an earlier run's grads_w<R>.pt")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    return {"server": run_server, "worker": run_worker,
            "recover": run_recover}[args.role](args)


if __name__ == "__main__":
    sys.exit(main())
