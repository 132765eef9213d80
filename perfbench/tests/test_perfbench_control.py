"""The control: the reference in fp8, put in the program's place, reads
not correct under each cell's limits, here at the rehearsal sizes on the
CPU (on the card, ``perfbench.calibrate`` reads it at the cell's own
sizes)."""

import os

import pytest

from helpers import checkout_with
from perfbench import spec
from perfbench.reference.compare import numbers, verdict
from perfbench.reference.replay import replay


@pytest.mark.parametrize("workload,overrides", [
    # the rehearsal's ResNet is too shallow and small for fp8 to show:
    # ResNet-50 whole at 16 images (on the card it reads 0.88 at 256)
    ("resnet50.onebit", {"stage_sizes": [3, 4, 6, 3], "width": 64,
                      "image_size": 224, "batch_per_rank": 16}),
    ("bert_large.dp4", {}),
])
def test_the_control_comes_out_not_correct(repo_root, tmp_path, workload,
                                           overrides):
    root = checkout_with(repo_root, tmp_path / "c", "bert_large.dp4")
    c = spec.cell(workload, rehearse=True, root=root,
                  here=os.path.join(root, "perfbench"))
    cfg, tr = dict(c["config"]), dict(c["traffic"])
    for k, v in overrides.items():
        (cfg if k in cfg else tr)[k] = v
    ranks = c["cell"]["chips"]
    ref = replay(cfg, tr, 5, ranks, "cpu")
    low = replay(cfg, tr, 5, ranks, "cpu", precision="fp8")
    ok, shown = verdict(numbers(low, ref), c["limits"])
    assert not ok, shown
    # and the reference against itself is correct
    ok, shown = verdict(numbers(ref, ref), c["limits"])
    assert ok, shown
