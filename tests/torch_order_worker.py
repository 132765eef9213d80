"""One rank of the root-ordered dispatch tests (tests/test_torch_dispatch_order.py).

Runs the cases named on the command line in turn, each in a process
group of its own, and saves what each rank issued and received.  Rank r
contributes row r of seeded numpy arrays.  Imports neither jax nor
byteps_tpu.

    python -m tests.torch_order_worker OUT.npz CASE [CASE ...]

with DMLC_*/BYTEPS_LOCAL_* set, ORDER_DIR a directory of the world's,
ORDER_WORLD a token of the world's and ORDER_DEVICE the device (default
cpu).  Each rendezvous (one a case, and a second for ``suspend``'s
resume) is rank 0's store, bound on a port the system picks at the bind
(:func:`_rendezvous`): no port is picked ahead and left free until a
later bind, where another process could take it, and two worlds that run
at once cannot meet in one store.  Every rank of one world, and the
checks that need no JAX, from one command:

    # CPU, gloo
    python -m tests.torch_order_worker --spawn cpu OUT_DIR 4 order skew_py
    # a card a rank, NCCL (a 4-card host)
    python -m tests.torch_order_worker --spawn cuda OUT_DIR 4 order \
        control skew_py skew_native even paths_skew paths_even
"""

import contextlib
import os
import subprocess
import sys
import time
import uuid

import numpy as np
import torch
from torch.distributed import TCPStore

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


def _skewed_pushes(tag, res, skew, steps, push, hold=None):
    """``steps`` steps of pushes in reverse order, rank 1 sleeping
    between its pushes under ``skew``; ``hold`` (the skew cases'
    :func:`_announced_first`) brackets each step's pushes."""
    rank = api.rank()
    for s in range(steps):
        hs = []
        with hold() if hold else contextlib.nullcontext():
            for i in reversed(range(len(SKEW_SIZES))):
                hs.append((i, push(s, i)))
                if skew and rank == 1:
                    time.sleep(SKEW_S)
        for i, h in hs:
            res[f"{tag}/{s}/{i}"] = h.wait(timeout=60).cpu().numpy()


def _announced(order):
    """The root's announced entries a follower's order has not handed
    out yet (read under the order's lock)."""
    with order._cv:
        return len(order._announced)


@contextlib.contextmanager
def _announced_first(eng, timeout=60.0):
    """One step of the skew cases with the order's two conditions made
    sure, whatever the load: the root holds its dispatch until it has
    enqueued the whole step, so its first pop takes more than one chunk
    (fewer announcements than chunks); a follower starts its pushes only
    once the root's first announcement of the step has reached it, so it
    waits for announced chunks it has not enqueued (``order_wait_ms``)."""
    if api.rank() == 0:
        eng.pause_dispatch()
        try:
            yield
        finally:
            eng.resume_dispatch()
        return
    # nothing of this step is enqueued here and every earlier step's
    # entries were handed out: an entry now is this step's announcement
    end = time.monotonic() + timeout
    while not _announced(eng.scheduler):
        if time.monotonic() > end:
            raise TimeoutError("no announcement of the root's reached "
                               "this follower")
        time.sleep(0.001)
    yield


def case_skew(res, tag, skew, use_native):
    eng, issued = _init(use_native=use_native)
    for i, n in enumerate(SKEW_SIZES):
        api.declare(f"s{i}", (n,))
    _skewed_pushes(tag, res, skew, STEPS, lambda s, i: api.push_pull_async(
        _mine(100 * s + i, SKEW_SIZES[i]), f"s{i}"),
        hold=(lambda: _announced_first(eng)) if skew else None)
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
    _rendezvous("suspend.resume")
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


# the stores rank 0 holds for the case that runs
_held = []


def _rendezvous(tag, timeout=120.0):
    """This rendezvous's port in DMLC_PS_ROOT_PORT.  Rank 0 (of the world:
    worker 0's local rank 0) binds a store on a port the system picks at
    the bind, marks it with the world's token and hands the port to the
    other ranks through a file in ORDER_DIR; ``init_process_group`` at rank 0 then takes that store
    (a multi-tenant server of this process).  Every other rank checks the
    token before it joins."""
    token = os.environ["ORDER_WORLD"]
    path = os.path.join(os.environ["ORDER_DIR"], f"{token}.{tag}.port")
    rank = (int(os.environ.get("DMLC_WORKER_ID", "0"))
            * int(os.environ.get("BYTEPS_LOCAL_SIZE", "1"))
            + int(os.environ["BYTEPS_LOCAL_RANK"]))
    if rank == 0:
        store = TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False, multi_tenant=True)
        store.set("order_world", token)
        _held.append(store)
        with open(path + ".tmp", "w") as f:
            f.write(str(store.port))
        os.replace(path + ".tmp", path)
        port = store.port
    else:
        end = time.monotonic() + timeout
        while not os.path.exists(path):
            if time.monotonic() > end:
                raise TimeoutError(f"rank 0 bound no store for {tag}")
            time.sleep(0.01)
        with open(path) as f:
            port = int(f.read())
        got = TCPStore("127.0.0.1", port, is_master=False).get(
            "order_world").decode()
        if got != token:
            raise RuntimeError(f"{tag}: the store at port {port} is "
                               f"another world's ({got} != {token})")
    os.environ["DMLC_PS_ROOT_PORT"] = str(port)
    print(f"{tag}: rendezvous on port {port} at t={time.time():.3f}",
          flush=True)


def main(out, cases):
    res = {}
    for case in cases:
        _rendezvous(case)
        CASES[case](res)
        _held.clear()
    np.savez(out, **res)


def spawn(world, cases, out_dir, device="cpu", timeout=150):
    """Every rank of one node of ``world`` ranks running ``cases``;
    returns the results by rank, each with its rank's output under
    ``log``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    token = uuid.uuid4().hex
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(out_dir, f"order_{world}_{rank}.npz")
        env = dict(os.environ, DMLC_NUM_WORKER="1", DMLC_WORKER_ID="0",
                   BYTEPS_LOCAL_SIZE=str(world), BYTEPS_LOCAL_RANK=str(rank),
                   DMLC_PS_ROOT_URI="127.0.0.1", ORDER_DIR=out_dir,
                   ORDER_WORLD=token, ORDER_DEVICE=device,
                   BYTEPS_MIN_COMPRESS_BYTES="0", OMP_NUM_THREADS="1",
                   PYTHONPATH=root)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_order_worker", out, *cases],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    failed, logs = [], []
    for rank, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            failed.append(f"world {world} rank {rank} timed out:\n{log}")
            continue
        logs.append(log)
        if p.returncode != 0:
            failed.append(f"world {world} rank {rank} rc={p.returncode}:\n"
                          f"{log[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [dict(np.load(o), log=np.array(log))
            for o, log in zip(outs, logs)]


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
