"""A ResNet-50 async store that serves its cuts and comes back from its
journal: the child bodies of ``chip_smoke.py``'s phase 13, one role per
process:

    # the trainer: init() opens the durable store (BYTEPS_DURABLE_DIR),
    # the serving tier ships each cut to the hosts of the bus's directory
    python -m byteps_tpu_torch.tools.serve_resnet train --bus HOST:PORT \\
        --out DIR
    # a fresh process recovers the store from the durable directory and
    # serves one cut through a fresh tier
    python -m byteps_tpu_torch.tools.serve_resnet recover --bus HOST:PORT \\
        --out DIR

``--device cpu --batch 2 --image 64`` (``--model tiny`` for a narrow
net) rehearses a role on the host.

Roles:

- ``train``: ``init()`` on ``--device`` with ``BYTEPS_DURABLE_DIR`` set
  (the store journals every push before it merges, under the
  environment's ``BYTEPS_WAL_FSYNC``); ResNet-50 at full width from the
  seed, its own seeded batch; two ``AsyncDistributedOptimizer``\\ s over
  ``SGD(momentum=0.9)`` share the store: the tensors of
  ``min_compress_bytes`` and more push onebit + EF deltas (worker 0,
  packed on the device, decoded by the store on its device), the others
  raw (worker 1).  ``start_serving_tier`` ships each cut to the
  directory's hosts (two replicas a key).  The trainer takes commands
  from files ``DIR/cmd.<n>`` (written by the caller, in order):
  ``step`` runs one training step, then cuts; ``cut`` cuts without a
  step; ``pause K`` runs a step and stops after K acknowledged pushes
  of it, printing ``PAUSED <n> <launches>`` (the caller kills it
  there); ``stop``
  ends.  It prints ``ACK <key> <version> <crc32c>`` after every
  acknowledged push (the store's value), and ``CUT <json>`` after every
  cut: the snapshot's versions, the CRC32C of each raw key, the CPU
  chain's onebit frame of each compressed key (the CRC32C of its sign
  words and its scale), and the host milliseconds of the step, the
  journal (append, fsync), the cut, the encode, each host's ship and
  the durable cut's save, with the bytes shipped and saved and the
  process's onebit launches;
- ``recover``: ``wal.recover`` of ``<BYTEPS_DURABLE_DIR>/trainer`` into
  a store on ``--device``, the codecs registered again by the same
  size rule; each key's last acknowledged token replayed (the rebuilt
  dedup floor must absorb it: value and version unchanged); then a
  fresh ``ServingTier`` over the bus cuts once.  It prints ``RECOVERED
  <json>`` (the replay's ms, records and bytes, every key's version and
  CRC32C, the replays absorbed) and ``CUT <json>`` as the trainer does,
  and waits for ``DIR/cmd.done`` before it exits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
SGD = {"lr": 0.1, "momentum": 0.9}
REPLICAS = 2             # hosts a key is shipped to
SHIP_DEADLINE_S = 60.0   # a host's stage + commit (the commit persists the
#                          host's arc: ~100 MB sealed and fsynced)
TIMEOUT_S = 600.0        # waiting for a command


def _model(torch, device, tiny):
    from byteps_tpu_torch.models import resnet
    gen = torch.Generator().manual_seed(0)
    if tiny:
        return resnet.resnet_tiny(num_classes=1000, generator=gen).to(device)
    return resnet.resnet50(num_classes=1000, generator=gen).to(device)


def _crc(torch, t) -> int:
    from byteps_tpu_torch.native import crc32c
    a = t.detach().cpu().contiguous() if torch.is_tensor(t) else t
    return crc32c(memoryview(a.numpy() if torch.is_tensor(a) else a)
                  .cast("B"))


def _launches():
    from byteps_tpu_torch.ops import onebit_kernels as ok
    return dict(ok.launches)


class _Timer:
    """Host milliseconds and calls of wrapped callables, by stage."""

    def __init__(self):
        self.ms, self.n = {}, {}

    def wrap(self, owner, attr, stage, on_return=None):
        real = getattr(owner, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = real(*a, **kw)
            finally:
                self.ms[stage] = self.ms.get(stage, 0.0) + (
                    time.perf_counter() - t0) * 1e3
                self.n[stage] = self.n.get(stage, 0) + 1
            if on_return is not None:
                on_return(a, out)
            return out
        setattr(owner, attr, timed)

    def take(self):
        out = {"ms": dict(self.ms), "n": dict(self.n)}
        self.ms.clear()
        self.n.clear()
        return out


def _cpu_chain(torch, registry, value, numel):
    """The CPU chain's onebit frame of a cut value: (CRC32C of the sign
    words, the scale) of ``compress(value, init_state())``."""
    comp = registry.create(ONEBIT_EF, numel, torch.float32, for_server=True)
    cpu = torch.device("cpu")
    x = torch.from_numpy(value.copy()).reshape(-1)
    payload, _ = comp.compress(x, comp.init_state(cpu))
    return [_crc(torch, payload["words"]), float(payload["scale"])]


def _cut_doc(torch, registry, snap, compressed):
    doc = {"sid": snap.id, "gen": snap.gen, "versions": dict(snap.versions),
           "crc": {}, "onebit": {}}
    for k, v in snap.refs.items():
        if k in compressed:
            doc["onebit"][k] = _cpu_chain(torch, registry, v, v.size)
        else:
            doc["crc"][k] = _crc(torch, v)
    return doc


def _instrument(torch, tier, wal_mod, tier_mod, timer):
    """Timers around the journal, the durable cut, the encode and each
    host's ship; returns the per-host ship ms box."""
    timer.wrap(wal_mod.WriteAheadLog, "append", "wal_append")
    timer.wrap(wal_mod, "_maybe_fsync", "wal_fsync")
    saved = {"bytes": 0}
    timer.wrap(wal_mod, "save_snapshot", "save",
               on_return=lambda a, path: saved.__setitem__(
                   "bytes", saved["bytes"] + os.path.getsize(path)))
    timer.wrap(tier_mod, "encode_value", "encode")
    ships = {}
    real = tier._ship_host

    def ship(host, snap, results, probe=None):
        t0 = time.perf_counter()
        try:
            return real(host, snap, results, probe)
        finally:
            ships[host] = (time.perf_counter() - t0) * 1e3
    tier._ship_host = ship
    return ships, saved


def _cut(torch, registry, tier, timer, ships, saved, compressed, extra):
    from byteps_tpu_torch.common.telemetry import counters
    b0 = counters.get("serve.tier_ship_bytes")
    h0 = counters.get("wal.arc_probe_hits")
    ships.clear()
    saved["bytes"] = 0
    t0 = time.perf_counter()
    snap = tier.cut()
    cut_ms = (time.perf_counter() - t0) * 1e3
    doc = _cut_doc(torch, registry, snap, compressed)
    t = timer.take()
    doc.update(extra)
    doc.update(cut_ms=cut_ms, encode_ms=t["ms"].get("encode", 0.0),
               encodes=t["n"].get("encode", 0),
               save_ms=t["ms"].get("save", 0.0), save_bytes=saved["bytes"],
               ship_ms={str(h): ms for h, ms in ships.items()},
               ship_bytes=counters.get("serve.tier_ship_bytes") - b0,
               arc_probe_hits=counters.get("wal.arc_probe_hits") - h0,
               hosts=sorted(tier.ring.hosts()), launches=_launches())
    print("CUT " + json.dumps(doc), flush=True)


def _command(out, n):
    path = os.path.join(out, f"cmd.{n}")
    deadline = time.monotonic() + TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise SystemExit(f"no command {n} within {TIMEOUT_S} s")
        time.sleep(0.01)
    with open(path) as f:
        return f.read().split()


def _compressed(cfg, model):
    return {name for name, p in model.named_parameters()
            if p.numel() * 4 >= cfg.min_compress_bytes}


def run_train(args) -> int:
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.compression import registry
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.models import resnet
    from byteps_tpu_torch.server import serving_tier as tier_mod
    from byteps_tpu_torch.server import wal as wal_mod
    from byteps_tpu_torch.torch.async_opt import AsyncDistributedOptimizer

    bps.init(device=args.device)
    store = api.durable_kv_store()
    if store is None:
        raise SystemExit("train: BYTEPS_DURABLE_DIR is not set")
    device = api.device()
    cfg = get_config()
    model = _model(torch, device, args.model == "tiny")
    big = _compressed(cfg, model)
    named = list(model.named_parameters())
    opts = [AsyncDistributedOptimizer(
        torch.optim.SGD([p for n, p in named if (n in big) == comp], **SGD),
        named_parameters=[(n, p) for n, p in named if (n in big) == comp],
        store=store, compression=ONEBIT_EF if comp else None,
        worker_id=w)
        for w, comp in ((0, True), (1, False))]
    compressed = {f"async.{n}" for n in big}
    batch = resnet.synthetic_images(torch.Generator().manual_seed(1),
                                    args.batch, args.image, 1000, device)
    tier = api.start_serving_tier(store, bus=args.bus, replicas=REPLICAS,
                                  cut_interval_s=None,
                                  ship_deadline_s=SHIP_DEADLINE_S)
    timer = _Timer()
    ships, saved = _instrument(torch, tier, wal_mod, tier_mod, timer)
    acks = {"n": 0, "stop_at": None}

    def acked(key, version):
        acks["n"] += 1
        print("ACK", key, version, _crc(torch, store.pull(key)), flush=True)
        if acks["stop_at"] is not None and acks["n"] >= acks["stop_at"]:
            print("PAUSED", acks["n"], json.dumps(_launches()), flush=True)
            while True:
                time.sleep(60)

    for attr in ("push_delta", "push_delta_wire"):
        real = getattr(store, attr)

        def wrapped(key, *a, _real=real, **kw):
            v = _real(key, *a, **kw)
            acked(key, v)
            return v
        setattr(store, attr, wrapped)
    print("TRAINER-UP", json.dumps({
        "keys": len(named), "compressed": len(big),
        "raw_bytes": sum(p.numel() * 4 for _, p in named),
        "durable": store._durable.dir}), flush=True)
    step = 0
    n = 0
    while True:
        n += 1
        cmd = _command(args.out, n)
        if cmd[0] == "stop":
            break
        extra = {"cmd": cmd[0]}
        if cmd[0] in ("step", "pause"):
            if cmd[0] == "pause":
                acks["n"], acks["stop_at"] = 0, int(cmd[1])
            step += 1
            timer.take()
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for o in opts:
                o.zero_grad()
            loss = torch.nn.functional.cross_entropy(
                model(batch["images"]), batch["labels"])
            loss.backward()
            for o in opts:
                o.step()
            if device.type == "cuda":
                torch.cuda.synchronize()
            t = timer.take()
            extra.update(step=step, loss=loss.item(),
                         step_ms=(time.perf_counter() - t0) * 1e3,
                         wal_append_ms=t["ms"].get("wal_append", 0.0),
                         wal_fsync_ms=t["ms"].get("wal_fsync", 0.0),
                         wal_appends=t["n"].get("wal_append", 0),
                         stage_ms=[o.stage_ms for o in opts])
        _cut(torch, registry, tier, timer, ships, saved, compressed, extra)
    tier.close()
    bps.shutdown()
    return 0


def run_recover(args) -> int:
    import torch

    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.compression import registry
    from byteps_tpu_torch.server import serving_tier as tier_mod
    from byteps_tpu_torch.server import wal as wal_mod
    from byteps_tpu_torch.server.serving_tier import ServingTier

    cfg = get_config()
    if not cfg.durable_dir:
        raise SystemExit("recover: BYTEPS_DURABLE_DIR is not set")
    t0 = time.perf_counter()
    store, stats = wal_mod.recover(os.path.join(cfg.durable_dir, "trainer"),
                                   device=args.device)
    recover_ms = (time.perf_counter() - t0) * 1e3
    model = _model(torch, torch.device("meta"), args.model == "tiny")
    big = {f"async.{n}" for n in _compressed(cfg, model)}
    for name, p in model.named_parameters():
        if f"async.{name}" in big:
            store.register_compression(f"async.{name}", ONEBIT_EF,
                                       p.numel(), torch.float32)
    keys = sorted(store.keys())
    doc = {"recover_ms": recover_ms, "stats": stats,
           "versions": {k: store.version(k) for k in keys},
           "crc": {k: _crc(torch, store.pull(k)) for k in keys}}
    # each key's last token again: the rebuilt floor must absorb it
    absorbed, floors = 0, {}
    for (key, worker), seq in sorted(store._seen.items()):
        floors[key] = (worker, seq)
    for key, (worker, seq) in floors.items():
        v0, c0 = store.version(key), doc["crc"][key]
        value = store.pull(key)
        store.push_delta(key, torch.ones_like(value), worker_id=worker,
                         seq=seq)
        absorbed += (store.version(key), _crc(torch, store.pull(key))) \
            == (v0, c0)
    doc.update(replayed=len(floors), absorbed=absorbed,
               launches=_launches())
    print("RECOVERED " + json.dumps(doc), flush=True)
    tier = ServingTier(store, bus=args.bus, replicas=REPLICAS,
                       cut_interval_s=None, ship_deadline_s=SHIP_DEADLINE_S)
    timer = _Timer()
    ships, saved = _instrument(torch, tier, wal_mod, tier_mod, timer)
    _cut(torch, registry, tier, timer, ships, saved, big, {"cmd": "recut"})
    _command(args.out, "done")
    tier.close()
    store._durable.close()
    print("RECOVER-LAUNCHES " + json.dumps(_launches()), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("role", choices=("train", "recover"))
    ap.add_argument("--bus", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="resnet50",
                    choices=("resnet50", "tiny"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    return {"train": run_train, "recover": run_recover}[args.role](args)


if __name__ == "__main__":
    sys.exit(main())
