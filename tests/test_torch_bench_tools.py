"""The port's bench tools (byteps_tpu_torch/tools/) against the JAX
package's (tools/), on the CPU at the JAX tests' sizes.

- ``_bench_util``: the quantiles equal the JAX helper's on the same
  samples, and core pinning parses the same specs;
- every tool's JSON has the JAX tool's keys (the JAX tools run here at
  small sizes, or with their process launches replaced), plus the root
  order's ``order_msgs`` and ``order_wait_ms`` where ranks take part;
  ``mechanism_bench`` also runs at two ranks under the port's bpslaunch;
- ``serve_bench.delta_check`` ships the bytes JAX's ships (the wire is
  byte-equal);
- ``async_bench``'s sync arm, started from the JAX tool's initial
  weights, ends at the JAX tool's final loss within 1e-5 relative;
- ``weak_scaling`` runs at N = 1, 2 under the port's bpslaunch, and its
  dcn sweep at two processes;
- ``fsdp_memory`` runs over two gloo ranks, and its ``n_params`` equals
  the JAX tool's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from byteps_tpu_torch.tools import _bench_util as pbu  # noqa: E402
from byteps_tpu_torch.tools import (async_bench, mechanism_bench,  # noqa
                                    overlap_bench, serve_bench,
                                    weak_scaling)
from byteps_tpu_torch.common.scheduler import ChunkScheduler  # noqa: E402
from byteps_tpu_torch.core.engine import PushPullEngine  # noqa: E402
from tools import _bench_util as jbu  # noqa: E402


class _LoggedQueue(ChunkScheduler):
    """The Python priority queue, logging each add and pop under its own
    lock, so the log's order is the order in which they happened.  The
    blocking pop's wait releases the (reentrant) lock whole."""

    def __init__(self, credit_bytes=0):
        super().__init__(credit_bytes)
        self.log = []

    def add_task(self, task):
        with self._cv:
            super().add_task(task)
            self.log.append(("add", task.name))

    def get_task(self, block=False, timeout=None):
        with self._cv:
            task = super().get_task(block, timeout)
            if task is not None:
                self.log.append(("pop", task.name))
            return task


def _keys(d, prefix=""):
    """Every key path of a nested dict."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def _child_env(**kw):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               BYTEPS_BENCH_PIN="off")
    for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
              "DMLC_WORKER_ID", "BYTEPS_LOCAL_RANK", "BYTEPS_LOCAL_SIZE"):
        env.pop(k, None)
    env.update(kw)
    return env


@pytest.fixture(scope="module")
def background():
    """The multi-process tools, started at once and read later."""
    procs = {
        "fsdp": subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.tools.fsdp_memory",
             "--spawn", "2", "--device", "cpu", "--steps", "1"],
            cwd=ROOT, env=_child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True),
        "mechanism2": subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
             sys.executable, "-m", "byteps_tpu_torch.tools.mechanism_bench",
             "--device", "cpu", "--small", "--reps", "3", "--all-ranks"],
            cwd=ROOT, env=_child_env(BYTEPS_LOCAL_SIZE="2"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "weak": subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.tools.weak_scaling",
             "--device", "cpu", "--counts", "1,2", "--sweep-procs", "2",
             "--steps", "2", "--no-pinned"],
            cwd=ROOT, env=_child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True),
    }
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _read(p, timeout=150):
    out, _ = p.communicate(timeout=timeout)
    assert p.returncode == 0, out[-3000:]
    return out


# ------------------------------------------------------------ bench util

SAMPLES = ([0.1, 0.2, 0.3, 0.4], [0.05], [4e-8, 4e-8, 4e-8],
           list(np.random.RandomState(3).exponential(0.01, 37)))


@pytest.mark.parametrize("i", range(len(SAMPLES)))
def test_quantiles_match_jax(background, i):
    xs = SAMPLES[i]
    assert pbu.quantile_stats(xs) == jbu.quantile_stats(xs)
    assert pbu.quantile_stats(xs, 3) == jbu.quantile_stats(xs, 3)
    assert pbu.quantile_stats_raw(xs) == jbu.quantile_stats_raw(xs)


@pytest.mark.parametrize("spec,avail", [
    ("off", {0, 1, 2, 3}), ("1", {0, 1, 2, 3}), ("0-2", {0, 1, 2, 3}),
    ("0,2", {0, 1, 2, 3}), ("bogus", {0, 1, 2, 3}), ("0-3", {0, 1, 2, 3}),
    ("", {0}), ("", {0, 1, 2, 3}), ("", {0, 1})])
def test_pin_cores_matches_jax(monkeypatch, spec, avail):
    monkeypatch.setenv("BYTEPS_BENCH_PIN", spec)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(avail),
                        raising=False)
    applied = []
    monkeypatch.setattr(os, "sched_setaffinity",
                        lambda pid, cores: applied.append(sorted(cores)),
                        raising=False)
    assert pbu.pin_cores() == jbu.pin_cores()
    assert len(applied) in (0, 2) and applied[:1] == applied[1:]


def test_conditions_block_has_the_jax_keys():
    assert set(jbu.conditions_block()) <= set(pbu.conditions_block())
    assert set(jbu.metrics_diag()) == set(pbu.metrics_diag())


# ------------------------------------------------------------- the tools

def test_mechanism_bench_keys(monkeypatch):
    import jax

    from byteps_tpu.comm.mesh import CommContext, _build_mesh
    from tools import mechanism_bench as jmb
    devices = jax.devices()
    comm = CommContext(mesh=_build_mesh(devices, 1), n_dcn=1,
                       n_ici=len(devices))
    want = {"priority": jmb.priority_latency(comm, len(devices), mbytes=1,
                                             reps=2),
            "partitioning": jmb.partition_latency(
                comm, len(devices), big_mb=1, small_kb=16, reps=2)}
    # every engine of the tool on a queue that logs its adds and pops in
    # the order they happened (both inside the queue's own lock)
    queues = []

    def logged(cfg):
        q = _LoggedQueue(credit_bytes=cfg.scheduling_credit)
        queues.append((cfg.enable_priority, q))
        return q

    monkeypatch.setattr(PushPullEngine, "_make_scheduler",
                        staticmethod(logged))
    got = mechanism_bench.run("cpu", small=True, reps=2)
    assert _keys(want) <= _keys(got)
    assert {"order_msgs", "order_wait_ms"} <= set(got)
    assert got["size"] == 1 and got["order_msgs"] == 0
    # What the priority measurement rests on, whatever the load: each pop
    # of the priority arm takes the lowest layer then queued (layer 0
    # goes ahead of every layer still queued when it was pushed), and
    # each pop of the fifo arm the earliest pushed.  The latency itself
    # is not asserted: its clock starts once the six pushes are enqueued,
    # and on a loaded host layer 0 may be ready before it (the JAX tool's
    # clock too).
    layer_queues = {prio: q.log for prio, q in queues
                    if q.log and q.log[0][1].startswith("layer")}
    assert set(layer_queues) == {True, False}
    for prio, log in layer_queues.items():
        queued = []
        for event, name in log:
            if event == "add":
                queued.append(name)
                continue
            want_next = (min(queued, key=lambda n: int(n[len("layer"):]))
                         if prio else queued[0])
            assert name == want_next, (prio, log)
            queued.remove(name)
        assert not queued
        # the warm-up's 6 pushes and 2 repetitions of 6
        assert sum(e == "pop" for e, _ in log) == 18


def test_print_line_writes_the_line_and_its_newline_at_once(monkeypatch):
    """Ranks that share a launcher's pipe print whole lines, even where
    Python runs unbuffered."""
    writes = []

    class Out:
        def write(self, text):
            writes.append(text)

        def flush(self):
            pass

    monkeypatch.setattr(sys, "stdout", Out())
    pbu.print_line('WS_RESULT {"rank": 1}')
    assert writes == ['WS_RESULT {"rank": 1}\n']


def test_mechanism_bench_at_two_ranks_under_bpslaunch(background):
    """Every rank prints its figures, and the followers' root-order
    counters beside the root's."""
    out = _read(background["mechanism2"])
    rows = sorted((json.loads(ln) for ln in out.splitlines()
                   if ln.startswith("{")), key=lambda r: r["rank"])
    assert [(r["rank"], r["size"]) for r in rows] == [(0, 2), (1, 2)]
    for r in rows:
        assert r["order_msgs"] > 0
        assert set(r["priority"]["order"]) == {"priority", "fifo"}
    # both ranks count the same announcements, sent and received
    assert rows[0]["order_msgs"] == rows[1]["order_msgs"]
    # the counters' largest over the ranks, gathered: the root's send
    # time, the follower's waits
    worst = rows[0]["order_worst"]
    assert rows[1]["order_worst"] == worst
    assert worst["order_send_ms"] == rows[0]["order_send_ms"] > 0
    assert worst["order_lag_ms"] == rows[1]["order_lag_ms"]
    assert worst["order_wait_ms"] == rows[1]["order_wait_ms"]


def test_overlap_bench_keys(monkeypatch, capsys):
    from tools import overlap_bench as job
    monkeypatch.setenv("BYTEPS_BENCH_PIN", "off")
    real = job._measure
    monkeypatch.setattr(job, "_measure", lambda width, compression: real(
        width=64, rounds=1, compression=compression))
    assert job.main(["--compression", "onebit"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = overlap_bench.run("cpu", "onebit", rounds=1, steps=2, width=64)
    # the engine's step stats are a summary of whatever steps ran
    for d in (want, got):
        d.pop("engine_step_stats")
    assert _keys(want) <= _keys(got)
    assert {"order_msgs", "order_wait_ms"} <= set(got)
    assert got["compression"] == "onebit"
    assert set(got["modes"]) == {"nocomm", "sync", "xb"}


def test_serve_bench_delta_bytes_and_keys(monkeypatch):
    from tools import serve_bench as jsb
    monkeypatch.setattr(serve_bench, "DEVICE", "cpu")
    for numel, keys in ((4096, 4), (1000, 3)):
        want = jsb.delta_check(numel, keys)
        got = serve_bench.delta_check(numel, keys)
        assert got == want and got["ok"]
    kw = dict(seconds=0.5, clients=2, keys=4, numel=4096, replicas=2)
    want = jsb.measure(**kw)
    got = serve_bench.measure(**kw)
    assert set(want) <= set(got)
    assert got["failed_reads"] == 0 and got["pulls"] > 0


def test_async_bench_sync_arm_matches_jax(monkeypatch, capsys):
    import jax

    from byteps_tpu.models.mlp import mnist_mlp
    from tools import async_bench as jab
    steps = 12
    monkeypatch.setenv("BYTEPS_BENCH_PIN", "off")
    monkeypatch.setattr(jab, "STEPS", steps)
    # the JAX tool's figures unrounded: its module-level round() is
    # shadowed by the identity
    monkeypatch.setattr(jab, "round", lambda x, n=None: x, raising=False)
    assert jab.main() == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    x = np.random.RandomState(42).randn(1, async_bench.IN_FEATURES)
    params = mnist_mlp().init(jax.random.PRNGKey(0),
                              x.astype(np.float32))["params"]
    got = async_bench.run("cpu", steps=steps,
                          params0=jax.tree.map(np.asarray, params))
    assert abs(got["loss_sync_exact"] - want["loss_sync"]) \
        <= 1e-5 * abs(want["loss_sync"])
    assert abs(got["loss_init"] - round(want["loss_init"], 4)) < 1e-4
    assert set(want) - {"conditions"} <= set(got)
    assert got["delta_pushes_per_key"] == 2 * steps
    assert "error" not in got


def test_weak_scaling_runs_at_one_and_two(background, monkeypatch):
    from tools import weak_scaling as jws
    monkeypatch.setattr(jws, "run_group",
                        lambda n, **kw: (1.0 + n, [0.9, 1.1 + n]))
    monkeypatch.setattr(jws, "_core_slices", lambda *a, **k: None)
    want = jws.measure_weak_scaling(counts=(1, 2))
    out = _read(background["weak"])
    got = json.loads(out.strip().splitlines()[-1])
    assert _keys(want) - {"pinned/skipped"} <= _keys(got["weak_scaling"])
    cur = got["weak_scaling"]["contended"]
    assert cur["1proc_ms"] > 0 and cur["2proc_ms"] > 0
    assert cur["1proc_order_msgs"] == 0 < cur["2proc_order_msgs"]
    assert set(got["dcn_sweep"]) == {"dcn1_ms", "dcn2_ms"}


def test_fsdp_memory_params_match_jax(background):
    import jax
    import jax.numpy as jnp

    from byteps_tpu.models.llama import Llama, LlamaConfig
    cfg = LlamaConfig(vocab_size=256, hidden_size=512, num_layers=8,
                      num_heads=4, num_kv_heads=4, intermediate_size=2048,
                      max_position=128, dtype=jnp.float32, remat=True)
    shapes = jax.eval_shape(Llama(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64), jnp.int32))
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
    out = _read(background["fsdp"])
    res = [json.loads(ln.split(" ", 1)[1]) for ln in out.splitlines()
           if ln.startswith("FSDP_RESULT ")]
    assert len(res) == 2
    want_keys = {"n_params", "param_bytes_f32", "flat_fsdp",
                 "flat_fsdp/temp_bytes", "flat_fsdp/arg_bytes", "gspmd_fsdp",
                 "gspmd_fsdp/temp_bytes", "gspmd_fsdp/arg_bytes",
                 "temp_ratio_flat_over_gspmd"}
    for r in res:
        assert r["n_params"] == n and r["param_bytes_f32"] == 4 * n
        assert want_keys <= _keys(r)
        # each rank keeps about half the parameters
        for design in ("flat_fsdp", "gspmd_fsdp"):
            assert 0.45 * 4 * n < r[design]["arg_bytes"] < 0.55 * 4 * n
        assert r["flat_fsdp"]["temp_bytes"] is None      # no peak on CPU
    assert res[0]["flat_fsdp"]["loss"] == res[1]["flat_fsdp"]["loss"]
    assert np.isclose(res[0]["flat_fsdp"]["loss"],
                      res[0]["gspmd_fsdp"]["loss"], rtol=1e-5)
