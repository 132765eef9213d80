"""The four-card tool and the model-parallel worker's card form, on the
CPU.

``tools/multi_card.py`` must refuse to start with fewer than four visible
cards (this host has none) and name the legs it knows.  The worker's
``--spawn`` form runs the CPU tests' cases without JAX (two gloo ranks
here); ``--compare`` must find two runs of it in agreement, see each
control miss its case, and flag a parameter moved by more than the
tolerance (the CPU tests' rtol 2e-4 / atol 2e-5).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from byteps_tpu_torch.tools import multi_card

from . import torch_mp_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m",
                           "byteps_tpu_torch.tools.multi_card", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_refuses_fewer_than_four_cards():
    p = _tool()
    assert p.returncode == 2
    assert "needs 4 visible cards" in p.stderr
    assert "MULTI_CARD" not in p.stdout


def test_unknown_leg_is_refused():
    p = _tool("--legs", "dp_resnet,nope", "--device", "cpu")
    assert p.returncode == 2 and "unknown legs" in p.stderr


def test_legs_are_the_five_in_order():
    assert multi_card.LEGS == ("dp_resnet", "onebit", "model_parallel",
                               "seq_expert", "mp_worker")
    assert set(multi_card.LEG_FNS) == set(multi_card.LEGS)


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_card")
    a, b = str(tmp / "a"), str(tmp / "b")
    W.spawn_card_check("cpu", a, 2)
    W.spawn_card_check("cpu", b, 2)
    return a, b


def test_card_form_runs_the_two_rank_cases(two_runs):
    a, _ = two_runs
    r = np.load(os.path.join(a, "sp_2_0.npz"))
    cases = {k.split("/")[0] for k in r.files} - {"meta"}
    want = {c["name"] for c in W.CARD_CASES if 2 in c["worlds"]}
    assert cases == want
    assert str(r["meta/backend"]) == "gloo"
    for c in want:
        assert np.all(np.isfinite(r[f"{c}/loss"]))


def test_compare_agrees_and_every_control_misses(two_runs):
    a, b = two_runs
    bad, n, missed = W.compare_dirs(a, b)
    assert bad == [] and n > 0
    assert missed == ["tp_1x2_bias_control"]


def test_compare_flags_a_moved_parameter(two_runs, tmp_path):
    a, b = two_runs
    moved = str(tmp_path / "moved")
    shutil.copytree(a, moved)
    path = os.path.join(moved, "sp_2_1.npz")
    r = dict(np.load(path))
    key = next(k for k in r if k.startswith("tp_1x2/param/")
               and r[k].size > 1)
    r[key] = r[key] + 1e-3 * (np.abs(r[key]).max() + 1)
    np.savez(path, **r)
    bad, _, _ = W.compare_dirs(moved, b)
    assert len(bad) == 1 and key in bad[0]
