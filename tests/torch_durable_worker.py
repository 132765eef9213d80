"""Writer process of ``tests/test_torch_durability.py``'s kill test: a
port ``KVStore`` on the CPU, durable under ``argv[1]`` (``fsync=always``),
takes token-stamped pushes from two workers in a loop until it is
killed.  Before each push it prints ``WILL <key> <worker> <seq>
<version> <crc>``, the state the push will leave (the sum replayed in
numpy, which adds as the store's reducer does); after the store
acknowledges it prints ``ACK <key> <worker> <seq>``."""

from __future__ import annotations

import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

KEYS = {"a": (8,), "b": (3, 5)}


def crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr, np.float32).tobytes())


def main() -> int:
    import dataclasses

    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.server import wal
    from byteps_tpu_torch.server.kv_store import KVStore

    cfg = dataclasses.replace(get_config(), wal_fsync="always")
    store = KVStore(device="cpu")
    wal.attach(store, sys.argv[1], cfg=cfg)
    rng = np.random.default_rng(int(sys.argv[2]))
    host = {}
    for k, shape in KEYS.items():
        host[k] = rng.standard_normal(shape).astype(np.float32)
        store.init_key(k, host[k])
    versions = {k: 0 for k in KEYS}
    seqs = {0: 0, 1: 0}
    print("READY", flush=True)
    i = 0
    while True:
        key = sorted(KEYS)[i % 2]
        worker = (i // 2) % 2
        i += 1
        seqs[worker] += 1
        delta = rng.standard_normal(KEYS[key]).astype(np.float32)
        after = host[key] + delta
        print("WILL", key, worker, seqs[worker], versions[key] + 1,
              crc(after), flush=True)
        v = store.push_delta(key, delta, worker_id=worker, seq=seqs[worker])
        host[key], versions[key] = after, v
        print("ACK", key, worker, seqs[worker], flush=True)


if __name__ == "__main__":
    sys.exit(main())
