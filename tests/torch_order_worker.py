"""One rank of the root-ordered dispatch tests (tests/test_torch_dispatch_order.py).

Runs the cases named on the command line in turn, each in a process
group of its own (its own rendezvous port), and saves what each rank
issued and received.  Rank r contributes row r of seeded numpy arrays.
Imports neither jax nor byteps_tpu.

    python -m tests.torch_order_worker OUT.npz CASE [CASE ...]

with DMLC_*/BYTEPS_LOCAL_* set, ORDER_PORTS holding the rendezvous
ports, one per case and a second for ``suspend``'s resume, and
ORDER_DEVICE the device (default cpu).  Every rank of one world, and
the checks that need no JAX, from one command:

    # CPU, gloo
    python -m tests.torch_order_worker --spawn cpu OUT_DIR 4 order skew_py
    # a card a rank, NCCL (a 4-card host)
    python -m tests.torch_order_worker --spawn cuda OUT_DIR 4 order \
        control skew_py skew_native even paths_skew paths_even
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.core import api
from byteps_tpu_torch.fault import membership

K = 6                                    # tensors of the order cases
ORDER_N = 64
# the skew cases: multi-chunk and single-chunk tensors (4 KiB chunks)
SKEW_SIZES = (3000, 64, 5000, 1, 2048, 777)
STEPS = 3
SKEW_S = 0.02                            # rank 1's sleep between pushes
ONEBIT = {"compressor": "onebit", "ef": "vanilla"}
SGD = (torch.optim.SGD, {"lr": 0.1, "momentum": 0.9})
DEVICE = os.environ.get("ORDER_DEVICE", "cpu")


def rows(seed, world, n):
    """Multiples of 1/64: every f32 sum of a few of them is exact in any
    order, so a mean over 2 or 4 ranks is exact."""
    x = np.random.RandomState(seed).randn(world, n) * 8
    return (np.round(x * 64) / 64).astype(np.float32)


def _init(use_native=True, **kw):
    cfg = Config.from_env()
    cfg.partition_bytes = 4096
    cfg.use_native = use_native
    for k, v in kw.items():
        setattr(cfg, k, v)
    api.init(cfg, device=DEVICE)
    eng = api.engine()
    issued = []
    real = eng._dispatch_unit

    def recording(kind, unit):
        issued.extend(t.name for t in unit)
        real(kind, unit)

    eng._dispatch_unit = recording
    return eng, issued


def _mine(seed, n):
    return torch.from_numpy(rows(seed, api.size(), n)[api.rank()]).to(
        api.device())


def case_order(res, tag, control=False):
    """Pause, push K tensors in reverse declared order, resume."""
    eng, issued = _init()
    if control:
        # the engine's order before root ordering: enqueue order
        seq = iter(range(1, 1 << 30))
        eng._priority = lambda ctx, priority: -next(seq)
    names = [f"t{i}" for i in range(K)]
    for n in names:
        api.declare(n, (ORDER_N,))
    eng.pause_dispatch()
    hs = [api.push_pull_async(_mine(10 + i, ORDER_N), names[i])
          for i in reversed(range(K))]
    eng.resume_dispatch()
    for h in hs:
        h.wait(timeout=60)
    res[f"{tag}/issued"] = np.array(issued)
    res[f"{tag}/order_msgs"] = np.array(eng.stats["order_msgs"])
    api.shutdown()


def _skewed_pushes(tag, res, skew, steps, push):
    rank = api.rank()
    for s in range(steps):
        hs = []
        for i in reversed(range(len(SKEW_SIZES))):
            hs.append((i, push(s, i)))
            if skew and rank == 1:
                time.sleep(SKEW_S)
        for i, h in hs:
            res[f"{tag}/{s}/{i}"] = h.wait(timeout=60).cpu().numpy()


def case_skew(res, tag, skew, use_native):
    eng, issued = _init(use_native=use_native)
    for i, n in enumerate(SKEW_SIZES):
        api.declare(f"s{i}", (n,))
    _skewed_pushes(tag, res, skew, STEPS, lambda s, i: api.push_pull_async(
        _mine(100 * s + i, SKEW_SIZES[i]), f"s{i}"))
    res[f"{tag}/issued"] = np.array(issued)
    res[f"{tag}/order_msgs"] = np.array(eng.stats["order_msgs"])
    res[f"{tag}/order_wait_ms"] = np.array(eng.stats["order_wait_ms"])
    api.shutdown()


def case_paths(res, tag, skew):
    """The onebit all-gather and the sharded update (its reduce-scatter,
    slot step and all-gather, and the parts fallback of a small tensor),
    two steps."""
    _init(sharded_update=True)
    p0 = {n: torch.from_numpy(rows(7, 1, n)[0]).to(api.device())
          for n in (3001, 37)}
    for n in p0:
        api.declare_update(f"w{n}", (n,), optimizer=SGD, init_value=p0[n])
    rank = api.rank()
    for s in range(2):
        hs = []
        for i in range(3):
            hs.append((f"onebit{i}", api.push_pull_async(
                _mine(300 + 10 * s + i, 3000), f"onebit{i}",
                compression=ONEBIT)))
            if skew and rank == 1:
                time.sleep(SKEW_S)
        for n in p0:
            hs.append((f"w{n}", api.push_pull_update_async(
                _mine(400 + 10 * s, n), f"w{n}")))
            if skew and rank == 1:
                time.sleep(SKEW_S)
        for k, h in hs:
            res[f"{tag}/{s}/{k}"] = h.wait(timeout=60).cpu().numpy()
    api.shutdown()


def case_epoch(res, tag):
    """The root drops a paused push as stale (its epoch moved, the
    follower's did not): every rank drops it, then the next push runs."""
    eng, issued = _init()
    eng.pause_dispatch()
    h = api.push_pull_async(_mine(500, 64), "e")
    if api.rank() == 0:
        membership.advance_epoch()
    eng.resume_dispatch()
    try:
        h.wait(timeout=60)
        res[f"{tag}/stale_error"] = np.array("")
    except RuntimeError as e:
        res[f"{tag}/stale_error"] = np.array(str(e))
    res[f"{tag}/after"] = api.push_pull(_mine(501, 64), "e").cpu().numpy()
    res[f"{tag}/issued"] = np.array(issued)
    api.shutdown()


def case_suspend(res, tag):
    """A push, suspend(), resume(), a push: the resumed engines connect
    to the root's order again."""
    _init()
    res[f"{tag}/0"] = api.push_pull(_mine(600, 2000), "u").cpu().numpy()
    key0 = api.engine().registry.get("u").declared_key
    api.suspend()
    # a rendezvous of its own: the old group's store may still be up
    os.environ["DMLC_PS_ROOT_PORT"] = next(_PORTS)
    api.resume(config=Config.from_env(), device=DEVICE)
    res[f"{tag}/1"] = api.push_pull(_mine(601, 2000), "u").cpu().numpy()
    res[f"{tag}/keys"] = np.array(
        [key0, api.engine().registry.get("u").declared_key])
    api.shutdown()


def case_shutdown_wait(res, tag):
    """A follower waits for an announcement that never comes; its
    shutdown returns at once and fails the push."""
    _init()
    api.push_pull(_mine(700, 64), "ready")       # both ranks are up
    if api.rank() != 0:
        h = api.push_pull_async(_mine(701, 64), "orphan")
        time.sleep(0.3)
        t0 = time.monotonic()
        api.shutdown(wait=False)
        res[f"{tag}/shutdown_s"] = np.array(time.monotonic() - t0)
        res[f"{tag}/status"] = np.array(h.status.code.name)
    else:
        time.sleep(0.5)
        api.shutdown()


CASES = {
    "order": lambda r: case_order(r, "order"),
    "control": lambda r: case_order(r, "control", control=True),
    "skew_py": lambda r: case_skew(r, "skew_py", True, False),
    "skew_native": lambda r: case_skew(r, "skew_native", True, True),
    "even": lambda r: case_skew(r, "even", False, True),
    "paths_skew": lambda r: case_paths(r, "paths_skew", True),
    "paths_even": lambda r: case_paths(r, "paths_even", False),
    "epoch": lambda r: case_epoch(r, "epoch"),
    "suspend": lambda r: case_suspend(r, "suspend"),
    "shutdown_wait": lambda r: case_shutdown_wait(r, "shutdown_wait"),
}


# one rendezvous port per case, and one more for a resume
PORTS_PER_CASE = {"suspend": 2}
_PORTS = iter(())


def main(out, cases):
    global _PORTS
    _PORTS = iter(os.environ["ORDER_PORTS"].split(","))
    res = {}
    for case in cases:
        os.environ["DMLC_PS_ROOT_PORT"] = next(_PORTS)
        CASES[case](res)
    np.savez(out, **res)


def free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [str(s.getsockname()[1]) for s in socks]
    for s in socks:
        s.close()
    return ports


def spawn(world, cases, out_dir, device="cpu", timeout=150):
    """Every rank of one node of ``world`` ranks running ``cases``;
    returns the results by rank."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n_ports = sum(PORTS_PER_CASE.get(c, 1) for c in cases)
    ports = ",".join(free_ports(n_ports))
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(out_dir, f"order_{world}_{rank}.npz")
        env = dict(os.environ, DMLC_NUM_WORKER="1", DMLC_WORKER_ID="0",
                   BYTEPS_LOCAL_SIZE=str(world), BYTEPS_LOCAL_RANK=str(rank),
                   DMLC_PS_ROOT_URI="127.0.0.1", ORDER_PORTS=ports,
                   ORDER_DEVICE=device, BYTEPS_MIN_COMPRESS_BYTES="0",
                   OMP_NUM_THREADS="1", PYTHONPATH=root)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_order_worker", out, *cases],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    failed = []
    for rank, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            failed.append(f"world {world} rank {rank} timed out:\n{log}")
            continue
        if p.returncode != 0:
            failed.append(f"world {world} rank {rank} rc={p.returncode}:\n"
                          f"{log[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [dict(np.load(o)) for o in outs]


def check(ranks, world):
    """The checks that need no JAX, over every case present: the
    declared order (the JAX engine's, which the CPU tests pin), its
    enqueue-order control, one order on every rank, the exact mean, and
    bit-equality of skewed and unskewed runs.  Returns the failures."""
    bad = []
    r0 = ranks[0]
    names = [f"t{i}" for i in range(K)]

    def same_bits(a, b):
        return a.shape == b.shape and np.array_equal(
            a.view(np.int32), b.view(np.int32))

    for res in ranks:
        if "order/issued" in res and list(res["order/issued"]) != names:
            bad.append(f"order: issued {list(res['order/issued'])}")
        if ("control/issued" in res
                and list(res["control/issued"]) != names[::-1]):
            bad.append(f"control: issued {list(res['control/issued'])}")
        for k in res:
            tag, _, rest = k.partition("/")
            if rest == "issued" and list(res[k]) != list(r0[k]):
                bad.append(f"{tag}: ranks issued different orders")
            if tag in ("skew_py", "skew_native", "even") and rest[:1].isdigit():
                s, i = map(int, rest.split("/"))
                want = rows(100 * s + i, world, SKEW_SIZES[i]).mean(0)
                if not np.array_equal(res[k], want):
                    bad.append(f"{k}: not the numpy mean")
                if f"even/{rest}" in res and not same_bits(
                        res[k], res[f"even/{rest}"]):
                    bad.append(f"{k}: not the unskewed run's bits")
            if tag == "paths_skew" and not same_bits(
                    res[k], res[f"paths_even/{rest}"]):
                bad.append(f"{k}: not the unskewed run's bits")
    return bad


if __name__ == "__main__":
    if sys.argv[1] == "--spawn":
        device, out_dir, world = sys.argv[2], sys.argv[3], int(sys.argv[4])
        os.makedirs(out_dir, exist_ok=True)
        ranks = spawn(world, sys.argv[5:], out_dir, device)
        bad = check(ranks, world)
        for b in bad:
            print("FAIL", b)
        waits = [float(r.get("skew_native/order_wait_ms", 0)) for r in ranks]
        msgs = [int(r.get("skew_native/order_msgs", 0)) for r in ranks]
        print(f"{device} world {world}: {len(bad)} failures; skew_native "
              f"order_msgs by rank {msgs}, order_wait_ms {waits}")
        sys.exit(1 if bad else 0)
    main(sys.argv[1], sys.argv[2:])
