"""BENCHMARK.json parses and keeps to the benchmark's contract, and
every file it names is there."""

import json
import os
import re

import pytest

from helpers import checkout_with

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _manifest(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(params=["as committed", "with the candidates"])
def root(request, repo_root, tmp_path):
    """The checkout, and a copy whose manifest adds the candidate cells
    (``candidates/``)."""
    if request.param == "as committed":
        return repo_root
    return checkout_with(repo_root, tmp_path / "c", "bert_large.dp4",
                         "resnet50.raw")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_the_manifest_parses_with_the_contracts_keys(root):
    repo_root = root
    m = _manifest(repo_root)
    assert set(m) == KEYS
    assert os.path.getsize(os.path.join(repo_root, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert os.path.isdir(os.path.join(repo_root, p))
    assert 1 <= len(m["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51


def test_configs_cells_and_metrics_keep_to_the_contract(root):
    repo_root = root
    m = _manifest(repo_root)
    configs = {c["name"]: c for c in m["configs"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.isfile(os.path.join(repo_root, c["file"]))
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
    assert len({c["file"] for c in m["configs"]}) == len(configs)
    cells = {w["name"]: w for w in m["workloads"]}
    assert len(cells) == len(m["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in m["workloads"]}
    assert len(pairs) == len(cells)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(cells) // 4)
    assert {w["config"] for w in m["workloads"]} == set(configs)
    e2e = {e["name"]: e for e in m["end_to_end"]}
    layer = {p["name"]: p for p in m["per_layer"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert not set(e2e) & set(layer)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(p["name"]) and UNIT.match(p["unit"])
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(p["layer"]) and p["moves"] in e2e
        for w in p.get("workloads", cells):
            assert w in cells
            assert w in e2e[p["moves"]].get("workloads", cells)
        if p["unit"] == "%" and p["name"].endswith("_roofline"):
            assert p["better"] == "higher"
    for w in cells:
        reported = [e for e in e2e.values() if w in e.get("workloads",
                                                            cells)]
        assert "setup_s" in {e["name"] for e in reported}
        assert len(reported) >= 2
        assert any(w in p.get("workloads", cells)
                   for p in m["per_layer"])


def test_every_cell_has_its_traffic_limits_and_readers(root):
    repo_root = root
    m = _manifest(repo_root)
    here = os.path.join(repo_root, "perfbench")
    for w in m["workloads"]:
        assert os.path.isfile(os.path.join(here, "traffic",
                                           f"{w['traffic']}.json"))
        with open(os.path.join(here, "limits", f"{w['name']}.json")) as f:
            limits = json.load(f)
        assert {"grad_gap", "change_gap"} <= set(limits)
    for c in m["configs"]:
        with open(os.path.join(repo_root, c["file"])) as f:
            cfg = json.load(f)
        for kind in ("builders", "reference", "flops"):
            key = {"builders": "builder"}.get(kind, kind)
            assert os.path.isfile(os.path.join(here, kind,
                                               f"{cfg[key]}.py"))
    for p in m["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics",
                                           f"{p['name']}.py"))
