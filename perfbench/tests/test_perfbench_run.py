"""A rehearsal of a cell on the CPU: the result line's shape, no metric
written from a CPU run, no module of JAX or the JAX package loaded, and
``correct`` false for each fault of the timed path the cell can have."""

import pytest

from helpers import checkout_with, rehearse

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line_and_no_metric_from_a_cpu_run(repo_root, trace):
    rc, last, err = rehearse(repo_root, "resnet50.onebit", seed=2**33 + 5,
                             trace=trace)
    assert rc == 0, err[-3000:]
    for k in REQUIRED:
        assert k in last
    assert ("breakdown" in last) == bool(trace)
    assert list(last)[-1] == "check"
    assert last["correct"] is True
    # a CPU run measures no device: nothing under a metric's name
    assert last["metrics"] == {}
    assert last["device"]["platform"] == "cpu"
    assert last["rehearsed"]
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
    lines = err.strip().splitlines()
    assert [ln.split()[1] for ln in lines[-len(last["check"]):]] == \
        list(last["check"])


@pytest.mark.parametrize("workload,plant", [
    ("resnet50.onebit", "unchanged_state"),
    ("resnet50.onebit", "half_batch"),
    ("resnet50.onebit", "lost_answer"),
    ("bert_large.dp4", "no_exchange"),
])
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(
        repo_root, tmp_path, workload, plant):
    root = checkout_with(repo_root, tmp_path / "c", "bert_large.dp4")
    rc, last, err = rehearse(root, workload, seed=11, plant=plant,
                             program_root=repo_root)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["check"]


def test_a_sound_rehearsal_at_four_ranks_is_correct(repo_root, tmp_path):
    """The candidate cell ``bert_large.dp4`` (``candidates/``), four
    ranks over gloo through the launcher."""
    root = checkout_with(repo_root, tmp_path / "c", "bert_large.dp4")
    rc, last, err = rehearse(root, "bert_large.dp4", seed=2**40 + 3,
                             trace=1, program_root=repo_root)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True, last["check"]
    assert last["device"]["count"] == 4
    assert {"order.lag_ms", "engine.dispatches_per_step"} <= set(
        last["rehearsed"])


def test_a_run_without_the_card_exits_non_zero_and_prints_nothing(
        repo_root):
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "resnet50.onebit", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=repo_root, capture_output=True,
                       text=True, timeout=120, start_new_session=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr
