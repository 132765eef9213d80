"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and new entries in a copy of the benchmark, with no line of
the harness's code edited: the harness finds and runs them."""

import json
import os
import shutil

from helpers import rehearse

READER = '''"""Chunks the engine carried a step on rank 0."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    return w["stats"]["chunks"] / w["steps"] if w["steps"] else None
'''


def test_a_new_config_traffic_metric_and_cell_need_only_new_files(
        repo_root, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(repo_root, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(repo_root, "BENCHMARK.json"), root)
    here = root / "perfbench"
    before = {p: p.read_bytes() for p in here.rglob("*.py")}

    cfg = json.loads((here / "configs" / "resnet50.json").read_text())
    cfg.update(name="resnet26", stage_sizes=[2, 2, 2, 2])
    (here / "configs" / "resnet26.json").write_text(json.dumps(cfg))
    traffic = json.loads(
        (here / "traffic" / "resnet50.raw.json").read_text())
    traffic.update(name="resnet26.raw", batch_per_rank=128)
    (here / "traffic" / "resnet26.raw.json").write_text(json.dumps(traffic))
    (here / "limits" / "resnet26.raw.json").write_text(
        (here / "limits" / "resnet50.raw.json").read_text())
    (here / "metrics" / "engine.chunks_per_step.py").write_text(READER)
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "resnet26", "source": "https://arxiv.org/"
                         "abs/1512.03385", "file": "perfbench/configs/"
                         "resnet26.json", "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "resnet26.raw", "config": "resnet26",
                           "traffic": "resnet26.raw", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "engine.chunks_per_step", "unit":
                           "count", "better": "lower", "source":
                           "program_counter", "layer": "engine", "moves":
                           "setup_s", "workloads": ["resnet26.raw"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    rc, last, err = rehearse(str(root), "resnet26.raw", trace=1,
                             program_root=repo_root)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True, last["check"]
    assert "engine.chunks_per_step" in last["rehearsed"]
    assert last["rehearsed"]["engine.chunks_per_step"]["value"] > 0
    assert {p: p.read_bytes() for p in here.rglob("*.py")
            if p in before} == before


def test_a_copy_without_the_program_exits_non_zero(repo_root, tmp_path):
    root = tmp_path / "bare"
    shutil.copytree(os.path.join(repo_root, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(repo_root, "BENCHMARK.json"), root)
    rc, last, _ = rehearse(str(root), "resnet50.onebit")
    assert rc != 0 and last is None
