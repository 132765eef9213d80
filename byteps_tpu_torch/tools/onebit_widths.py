"""Onebit pack, unpack and unpack_sum at each tile width, on one NVIDIA card.

    python -m byteps_tpu_torch.tools.onebit_widths

Run from the repository root: it times with ``chip_smoke.py``'s
``device_ms`` and takes the chunk sizes of its ResNet-50 slice
(``resnet_chunks``).  At each chunk size, and for each tile width ``vw``
of ``onebit_kernels.VECTOR_WIDTHS`` forced in turn, pack, unpack and
unpack_sum (at R = 1 on the pack's own words, and at R = 4 on
``chip_smoke.merge_inputs``) are checked in their bits against their
plain versions and timed with CUDA events (inputs rotating over
``chip_smoke.ROTATE_BYTES``).  It prints one line per size, then the
per-ResNet-step sum (2 packs, 3 unpacks and 1 unpack_sum at R = 1 per
chunk; unpack_sum at R = 4 on its own) of each fixed width and of
``launch_geometry``'s choice, so that the choice can be held against the
alternatives on the same card in one call.  The last line of standard
output is one JSON summary.
"""

from __future__ import annotations

import json
import subprocess

import torch

KERNELS = ("onebit_pack", "onebit_unpack", "onebit_unpack_sum",
           "onebit_unpack_sum R=4")
CALLS = {"onebit_pack": 2, "onebit_unpack": 3, "onebit_unpack_sum": 1}
MERGE_R = 4


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("onebit_widths: needs an NVIDIA card")
    from chip_smoke import (ROTATE_BYTES, device_ms, merge_inputs,
                            resnet_chunks, same_bits)

    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.common.partitioner import chunk_bounds
    from byteps_tpu_torch.models import resnet
    from byteps_tpu_torch.ops import onebit_kernels as ok

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    chunks = resnet_chunks(torch, resnet, Config(), chunk_bounds)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    chosen = ok.launch_geometry
    us = {}                        # (numel, vw) -> {kernel: us per call}
    try:
        for n in sorted(set(chunks)):
            L = ok.padded_lanes(n)
            count = -(-ROTATE_BYTES // (4 * n))
            xs = list(torch.randn(count, n, generator=gen, device=dev))
            w0, s0 = ok.onebit_pack_plain(xs[0])
            mwords, mscales = (torch.from_numpy(a).to(dev)
                               for a in merge_inputs(MERGE_R, L, n))
            rand_words = list(torch.randint(
                -2**31, 2**31 - 1, (count, MERGE_R, L), generator=gen,
                device=dev, dtype=torch.int32))
            for vw in ok.VECTOR_WIDTHS:
                ok.launch_geometry = (
                    lambda L, kernel, vw=vw: (vw, L // (4 * vw)))
                w, s = ok.onebit_pack(xs[0])
                torch.testing.assert_close(s, s0, rtol=1e-6, atol=0)
                if not (torch.equal(w, w0) and torch.equal(
                        ok.onebit_unpack(w, s[1:], n),
                        ok.onebit_unpack_plain(w0, s[1], n)) and same_bits(
                        ok.onebit_unpack_sum(w[None], s[1:], n),
                        ok.onebit_unpack_sum_plain(w0[None], s[1:], n))
                        and same_bits(
                        ok.onebit_unpack_sum(mwords, mscales, n),
                        ok.onebit_unpack_sum_plain(mwords, mscales, n))):
                    raise RuntimeError(f"vw={vw} differs at numel={n}")
                packed = [ok.onebit_pack(x) for x in xs]

                def merge(w, s):
                    return ok.onebit_unpack_sum(w, s, n)

                us[n, vw] = {k: device_ms(torch, fn, args) * 1e3
                             for k, (fn, args) in {
                    "onebit_pack": (ok.onebit_pack, [(x,) for x in xs]),
                    "onebit_unpack": (
                        lambda w, s: ok.onebit_unpack(w, s, n),
                        [(w, s[1:]) for w, s in packed]),
                    "onebit_unpack_sum": (
                        merge, [(w[None], s[1:]) for w, s in packed]),
                    "onebit_unpack_sum R=4": (
                        merge, [(m, mscales) for m in rand_words]),
                }.items()}
                del packed
            ok.launch_geometry = chosen
            picks = [chosen(L, k)[0] for k in CALLS]
            print(f"numel {n} ({chunks.count(n)} chunks, {L} words; "
                  f"launch_geometry's vw: pack {picks[0]}, unpack "
                  f"{picks[1]}, unpack_sum {picks[2]}): " + "; ".join(
                      f"vw {vw} " + ", ".join(
                          f"{k[7:]} {us[n, vw][k]:.2f} us" for k in KERNELS)
                      for vw in ok.VECTOR_WIDTHS), flush=True)
            del xs, rand_words
    finally:
        ok.launch_geometry = chosen

    def per_step(width_of, kernels):
        return sum(calls * us[n, width_of(n, k)][k]
                   for n in chunks for k, calls in kernels.items())

    steps = {f"vw {vw}": per_step(lambda n, k, vw=vw: vw, CALLS)
             for vw in ok.VECTOR_WIDTHS}
    steps["launch_geometry"] = per_step(
        lambda n, k: chosen(ok.padded_lanes(n), k)[0], CALLS)
    merges = {k[7:]: {f"vw {vw}": sum(us[n, vw][k] for n in chunks)
                      for vw in ok.VECTOR_WIDTHS} for k in KERNELS[2:]}
    print("per ResNet step (2 packs, 3 unpacks and 1 unpack_sum per "
          "chunk): " + ", ".join(f"{k} {v:.2f} us" for k, v in steps.items()),
          flush=True)
    for k, v in merges.items():
        print(f"per ResNet step, {k} alone (1 per chunk): " + ", ".join(
            f"{w} {t:.2f} us" for w, t in v.items()), flush=True)
    print(json.dumps({"card": card.splitlines()[0], "per_step_us": steps,
                      "unpack_sum_per_step_us": merges,
                      "us": {f"{n}/{vw}": v for (n, vw), v in us.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
