"""The port's last example entry points (byteps_tpu_torch/examples/), each
at a tiny size with ``--device cpu``.

- ``benchmark_resnet``, ``train_mnist_mlp`` and ``train_parallel_axes``
  (``zero``, ``fsdp``; one rank in process, two gloo ranks under the
  port's bpslaunch) print their lines; ``benchmark_resnet`` with the JAX
  script's keys.
- The TensorFlow and Keras ones run here only (the card's machine has no
  TensorFlow).  ``tensorflow2_mnist`` and ``keras_mnist`` print the
  losses, to the printed 4 decimals, that the JAX package's scripts print
  run in process from the same Keras seed.  The JAX Keras script reads
  ``size()`` as its mesh's 8 devices (the learning rate and the warm-up
  are scaled by it): it is read as one process here, as the port's is.
  Its gradient is an average of 8 equal rows, which may round (ROADMAP
  Queue C standing item 7); the printed losses agreed exactly.
- The gluon modules need mxnet, which no host has: they raise the
  ImportError; the ``_gc`` module's ``compression_params`` go through the
  port's ``mxnet/ops.py`` ``compression_kwargs`` for every
  ``--compressor`` choice, equal to the JAX package's.
"""

import ast
import json
import os
import re
import runpy
import subprocess
import sys

import pytest

from byteps_tpu_torch.examples import (benchmark_resnet, train_mnist_mlp,
                                       train_parallel_axes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = re.compile(r"step +(\d+) +loss (\d+\.\d{4})")
KERAS_LOSS = re.compile(r"accuracy: (\d+\.\d{4}) - loss: (\d+\.\d{4})")


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _jax_json_keys(path):
    """The keys of the dict the JAX script passes to ``json.dumps``."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps of a dict in {path}")


def test_benchmark_resnet_prints_the_jax_keys(capsys):
    benchmark_resnet.main(["--model", "tiny", "--batch", "2", "--size",
                           "32", "--steps", "2", "--device", "cpu"])
    rec = _last_json(capsys.readouterr().out)
    assert list(rec) == _jax_json_keys("example/jax/benchmark_resnet.py")
    assert rec["model"] == "tiny" and rec["n_devices"] == 1
    assert rec["images_per_sec"] > 0 and rec["image_size"] == 32


def test_train_mnist_mlp_loss_falls(capsys):
    train_mnist_mlp.main(["--steps", "12", "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(v) for _, v in LOSS.findall(out)]
    assert out.startswith("devices=1 mesh=(1 dcn x 1 ici)")
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert "examples/s" in out


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_train_parallel_axes_one_rank(mode, capsys):
    train_parallel_axes.main(["--mode", mode, "--steps", "4", "--device",
                              "cpu"])
    rec = _last_json(capsys.readouterr().out)
    assert list(rec) == _jax_json_keys("example/jax/train_parallel_axes.py")
    assert rec["mode"] == mode and rec["n_devices"] == 1
    assert rec["last_loss"] < rec["first_loss"]


def test_train_parallel_axes_other_modes_name_their_tool(capsys):
    assert train_parallel_axes.main(["--mode", "tp", "--device", "cpu"]) == 2
    assert "tools.model_parallel tp" in capsys.readouterr().err


def _bpslaunch(argv, n=2):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               BYTEPS_LOCAL_SIZE=str(n))
    for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
              "DMLC_WORKER_ID", "BYTEPS_LOCAL_RANK"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
         sys.executable, "-m"] + argv,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def test_train_parallel_axes_two_ranks_under_bpslaunch():
    """Both modes at two gloo ranks: one JSON line each (rank 0's), the
    same losses in both modes (FSDP is ZeRO-1 with the parameters
    released between steps), and a loss that falls."""
    recs = {}
    for mode in ("zero", "fsdp"):
        r = _bpslaunch(["byteps_tpu_torch.examples.train_parallel_axes",
                        "--mode", mode, "--steps", "4", "--device", "cpu"])
        assert r.returncode == 0, r.stderr[-3000:]
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        assert len(lines) == 1, r.stdout
        recs[mode] = json.loads(lines[0])
        assert recs[mode]["n_devices"] == 2 and recs[mode]["inner_axis"] == 2
        assert recs[mode]["last_loss"] < recs[mode]["first_loss"]
    assert ((recs["zero"]["first_loss"], recs["zero"]["last_loss"])
            == (recs["fsdp"]["first_loss"], recs["fsdp"]["last_loss"]))


# ---------------------------------------------------------------- gluon

@pytest.mark.parametrize("name", ["train_gluon_mnist_byteps",
                                  "train_gluon_mnist_byteps_gc"])
def test_gluon_examples_need_mxnet(name, monkeypatch):
    import importlib

    from byteps_tpu_torch.core import api
    mod = importlib.import_module(f"byteps_tpu_torch.examples.{name}")
    monkeypatch.setitem(sys.modules, "mxnet", None)
    with pytest.raises(ImportError):
        mod.main(["--steps", "1", "--device", "cpu"])
    assert not api.initialized()                 # touched nothing else


def test_gluon_gc_compression_params_reach_the_engine_kwargs():
    import byteps_tpu.mxnet as jax_mx
    from byteps_tpu.mxnet.ops import compression_kwargs as jax_kwargs

    import byteps_tpu_torch.mxnet as port_mx
    from byteps_tpu_torch.examples import train_gluon_mnist_byteps_gc as gc
    from byteps_tpu_torch.mxnet.ops import compression_kwargs as port_kwargs

    class Param:
        grad_req = "write"

    for choice in gc.COMPRESSORS:
        got = {}
        for mx, kwargs in ((jax_mx, jax_kwargs), (port_mx, port_kwargs)):
            params = {"w": Param()}
            opt = {"learning_rate": 0.05, "momentum": 0.9}
            mx._register_compression_attrs(params, opt,
                                           gc.compression_params(choice))
            attrs = {k: str(v) for k, v in vars(params["w"]).items()
                     if k.startswith("byteps_")}
            name = f"gc_example.{choice}"
            mx.byteps_declare_tensor(name, **attrs)
            got[mx.__name__] = (kwargs(name), sorted(opt))
        assert got["byteps_tpu_torch.mxnet"] == got["byteps_tpu.mxnet"]
        kw, left = got["byteps_tpu_torch.mxnet"]
        assert kw["compressor"] == choice and kw["ef"] == "vanilla"
        assert kw["momentum"] == "nesterov" and kw["mu"] == "0.9"
        assert left == ["learning_rate"]        # momentum moved to the chain


# ------------------------------------------------------ TensorFlow, Keras

def _run_jax_script(path, argv):
    old = sys.argv
    sys.argv = [path] + argv
    try:
        runpy.run_path(os.path.join(ROOT, path), run_name="__main__")
    finally:
        sys.argv = old


def test_tensorflow2_mnist_losses_match_the_jax_example(capsys):
    tf = pytest.importorskip("tensorflow")
    from byteps_tpu_torch.examples import tensorflow2_mnist
    tf.keras.utils.set_random_seed(0)
    _run_jax_script("example/tensorflow/tensorflow2_mnist.py",
                    ["--steps", "12"])
    jax_out = capsys.readouterr().out
    tf.keras.utils.set_random_seed(0)
    tensorflow2_mnist.main(["--steps", "12", "--device", "cpu"])
    got = LOSS.findall(capsys.readouterr().out)
    want = LOSS.findall(jax_out)
    assert len(got) == 3 and got == want
    assert float(got[-1][1]) < float(got[0][1])


def test_keras_mnist_losses_match_the_jax_example(capsys, monkeypatch):
    tf = pytest.importorskip("tensorflow")
    import byteps_tpu.tensorflow as jax_tf
    from byteps_tpu.core import api as jax_api

    from byteps_tpu_torch.examples import keras_mnist
    monkeypatch.setattr(jax_api, "size", lambda: 1)
    monkeypatch.setattr(jax_tf, "size", lambda: 1)
    tf.keras.utils.set_random_seed(0)
    _run_jax_script("example/keras/keras_mnist.py", ["--epochs", "2"])
    jax_out = capsys.readouterr().out
    tf.keras.utils.set_random_seed(0)
    keras_mnist.main(["--epochs", "2", "--device", "cpu"])
    got = KERAS_LOSS.findall(capsys.readouterr().out)
    want = KERAS_LOSS.findall(jax_out)
    assert len(got) == 2 and got == want
    assert float(got[-1][1]) < float(got[0][1])


@pytest.mark.parametrize("name,argv,expect", [
    ("synthetic_benchmark_tf2", ["--num-iters", "1", "--num-tensors", "2",
                                 "--tensor-mb", "0.1"], "MB/s pushed+pulled"),
    ("tensorflow2_mnist_bps_MirroredStrategy", ["--steps", "6"], "loss"),
    ("bench_compiled_boundary", ["--steps", "2"], "boundary_overhead_pct"),
])
def test_tensorflow_examples_run_on_the_cpu(name, argv, expect, capsys):
    pytest.importorskip("tensorflow")
    import importlib
    mod = importlib.import_module(f"byteps_tpu_torch.examples.{name}")
    mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert expect in out
    if name == "bench_compiled_boundary":
        rec = _last_json(out)
        assert list(rec) == [
            "nocomm_jit", "boundary_jit", "ingraph_pyfunc",
            "boundary_overhead_pct", "ingraph_overhead_pct"]
    if name == "tensorflow2_mnist_bps_MirroredStrategy":
        losses = [float(v) for _, v in LOSS.findall(out)]   # steps 0, 5
        assert len(losses) == 2 and losses[-1] < losses[0]
