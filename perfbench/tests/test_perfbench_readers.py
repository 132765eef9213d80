"""The host path's per-layer readers on a synthetic reading: each takes
its ``engine.stats`` key a window step on rank 0, and reads nothing
where the key is absent (a program without the counter) or the window
has no step."""

import os

import pytest

from perfbench import spec

READERS = {
    "engine.enqueue_ms": "enqueue_ms",
    "engine.queue_ms": "queue_ms",
    "engine.dispatch_ms": "dispatch_ms",
    "codec.dispatch_ms": "codec_dispatch_ms",
    "engine.sync_ms": "sync_ms",
    "engine.assemble_ms": "assemble_ms",
    "plugin.wait_ms": "wait_ms",
    "plugin.update_ms": "update_ms",
}


def _ctx(stats, steps):
    rank = {"window": {"steps": steps, "stats": stats}}
    return {"ranks": [rank, {"window": {"steps": steps, "stats": {}}}]}


@pytest.fixture
def here(repo_root):
    return os.path.join(repo_root, "perfbench")


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_takes_its_key_a_step(here, name):
    read = spec.load_module("metrics", name, here).read
    key = READERS[name]
    stats = {k: 1000.0 for k in READERS.values()}
    stats[key] = 250.0
    assert read(_ctx(stats, 4)) == pytest.approx(62.5)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_nothing_without_its_key_or_a_step(here, name):
    read = spec.load_module("metrics", name, here).read
    key = READERS[name]
    others = {k: 1.0 for k in READERS.values() if k != key}
    assert read(_ctx({"dispatches": 10, **others}, 4)) is None
    assert read(_ctx({key: 5.0}, 0)) is None
