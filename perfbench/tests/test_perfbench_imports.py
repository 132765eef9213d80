"""What the benchmark loads: the reference nothing of the program, and a
run no module of JAX or of the JAX package (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

BANNED = {"jax", "jaxlib", "flax", "byteps_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_and_the_yardstick_import_nothing_of_the_program(
        repo_root):
    here = os.path.join(repo_root, "perfbench")
    files = [os.path.join(here, "reference", f)
             for f in os.listdir(os.path.join(here, "reference"))
             if f.endswith(".py")]
    files += [os.path.join(here, d, f) for d in ("flops", "metrics", "inputs", "optimizers")
              for f in os.listdir(os.path.join(here, d)) if f.endswith(".py")]
    files += [os.path.join(here, f) for f in ("data.py", "spec.py",
                                               "profile.py", "kernels.py")]
    for path in files:
        tops = set(_imports(path))
        assert not tops & (BANNED | {"byteps_tpu_torch"}), path


def test_a_reference_replay_loads_no_program_module(repo_root):
    code = (
        "import sys\n"
        "from perfbench import spec\n"
        "from perfbench.reference.replay import replay\n"
        "cfg = spec.load_json('configs', 'bert_large')\n"
        "tr = spec.load_json('traffic', 'bert_large.dp4')\n"
        "cfg.update(cfg['rehearse']); tr.update(tr['rehearse'])\n"
        "replay(cfg, tr, 3, 2, 'cpu')\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'byteps_tpu', "
        "'byteps_tpu_torch'}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_a_loaded_jax_module_is_found_by_its_top_level_name():
    from perfbench import spec
    saved = dict(sys.modules)
    try:
        sys.modules["byteps_tpu.core"] = object()
        sys.modules["byteps_tpu_torch_like"] = object()
        assert spec.loaded_banned() == ["byteps_tpu.core"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
