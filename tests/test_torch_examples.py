"""The port's PyTorch examples (byteps_tpu_torch/examples/) on the CPU.

Each of the five runs at a tiny size with ``--device cpu``.
``train_mnist_byteps`` at one rank prints the losses, to the printed 4
decimals, that ``example/pytorch/train_mnist_byteps.py`` prints on the
JAX package (run in process, as tests/test_examples.py runs it).  At two
ranks under the port's bpslaunch, the gradient the optimizer applies
is the numpy mean of the two ranks' own gradients, bit for bit (a sum
of two f32 values halved is exact in any order).
"""

import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest

from byteps_tpu_torch.examples import (benchmark_byteps,
                                       benchmark_byteps_ddp,
                                       benchmark_cross_barrier_byteps,
                                       elastic_benchmark_byteps,
                                       train_mnist_byteps)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = re.compile(r"step +(\d+) +loss (\d+\.\d{4})")

EXAMPLES = {
    "train_mnist_byteps": (train_mnist_byteps, ["--steps", "2"]),
    "benchmark_byteps": (benchmark_byteps,
                         ["--num-iters", "1", "--num-tensors", "2",
                          "--tensor-mb", "0.1", "--compressor", "onebit"]),
    "benchmark_byteps_ddp": (benchmark_byteps_ddp,
                             ["--num-iters", "1", "--accumulate", "2",
                              "--batch", "4"]),
    "benchmark_cross_barrier_byteps": (benchmark_cross_barrier_byteps,
                                       ["--num-iters", "2", "--batch", "4"]),
    "elastic_benchmark_byteps": (elastic_benchmark_byteps, ["--steps", "2"]),
}
EXPECT = {
    "train_mnist_byteps": "loss",
    "benchmark_byteps": "MB/s pushed+pulled",
    "benchmark_byteps_ddp": "examples/s",
    "benchmark_cross_barrier_byteps": "examples/s with cross-barrier",
    "elastic_benchmark_byteps": "phase 2 loss:",
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys):
    mod, argv = EXAMPLES[name]
    mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert EXPECT[name] in out
    if name == "benchmark_byteps":
        import json
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["size"] == 1 and rec["backend"] == "gloo"
        # the codec's plain versions ran on the CPU: the CUDA wrappers
        # count only their own launches
        assert rec["launches"]["onebit_pack"] == 0


def _losses(text):
    return [(int(s), v) for s, v in LOSS.findall(text)]


def test_mnist_losses_match_the_jax_example(capsys):
    old = sys.argv
    sys.argv = ["train_mnist_byteps.py", "--steps", "12"]
    try:
        runpy.run_path(os.path.join(ROOT, "example/pytorch/"
                                    "train_mnist_byteps.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    jax_out = capsys.readouterr().out
    train_mnist_byteps.main(["--steps", "12", "--device", "cpu"])
    port_out = capsys.readouterr().out
    want = _losses(jax_out)
    assert [s for s, _ in want] == [0, 10, 11]
    assert _losses(port_out) == want
    assert float(want[-1][1]) < float(want[0][1])


def test_two_ranks_under_bpslaunch_average_the_gradient(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               BYTEPS_LOCAL_SIZE="2")
    for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
              "DMLC_WORKER_ID", "BYTEPS_LOCAL_RANK"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
         sys.executable, "-m", "byteps_tpu_torch.examples.train_mnist_byteps",
         "--device", "cpu", "--steps", "3", "--dump", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(_losses(r.stdout)) == 2 * 2
    d = [dict(np.load(tmp_path / f"rank{i}.npz")) for i in range(2)]
    names = [k.split("/", 1)[1] for k in d[0] if k.startswith("local/")]
    assert len(names) == 4
    for n in names:
        a, b = d[0][f"local/{n}"], d[1][f"local/{n}"]
        assert not np.array_equal(a, b)          # different data per rank
        want = (a + b) * np.float32(0.5)
        for res in d:
            np.testing.assert_array_equal(res[f"averaged/{n}"], want)
    for res in d:
        assert np.isfinite(res["losses"]).all()
