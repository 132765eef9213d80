"""Onebit pack and unpack at each tile width, on one NVIDIA card.

    python -m byteps_tpu_torch.tools.onebit_widths

Run from the repository root: it times with ``chip_smoke.py``'s
``device_ms`` and takes the chunk sizes of its ResNet-50 slice
(``resnet_chunks``).  At each chunk size, and for each tile width ``vw``
of ``onebit_kernels.VECTOR_WIDTHS`` forced in turn, pack and unpack are
checked bit-exact against their plain versions and timed with CUDA events
(inputs rotating over ``chip_smoke.ROTATE_BYTES``).  It prints one line
per size, then the per-ResNet-step sum (2 packs and 3 unpacks per chunk)
of each fixed width and of ``launch_geometry``'s choice, so that the
choice can be held against the alternatives on the same card in one
call.  The last line of standard output is one JSON summary.
"""

from __future__ import annotations

import json
import subprocess

import torch


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("onebit_widths: needs an NVIDIA card")
    from chip_smoke import ROTATE_BYTES, device_ms, resnet_chunks

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
    us = {}                                  # (numel, vw) -> (pack, unpack)
    try:
        for n in sorted(set(chunks)):
            L = ok.padded_lanes(n)
            count = -(-ROTATE_BYTES // (4 * n))
            xs = list(torch.randn(count, n, generator=gen, device=dev))
            w0, s0 = ok.onebit_pack_plain(xs[0])
            for vw in ok.VECTOR_WIDTHS:
                ok.launch_geometry = (
                    lambda L, kernel, vw=vw: (vw, L // (4 * vw)))
                w, s = ok.onebit_pack(xs[0])
                torch.testing.assert_close(s, s0, rtol=1e-6, atol=0)
                if not (torch.equal(w, w0) and torch.equal(
                        ok.onebit_unpack(w, s[1:], n),
                        ok.onebit_unpack_plain(w0, s[1], n))):
                    raise RuntimeError(f"vw={vw} differs at numel={n}")
                packed = [ok.onebit_pack(x) for x in xs]
                us[n, vw] = (
                    device_ms(torch, ok.onebit_pack, [(x,) for x in xs]) * 1e3,
                    device_ms(torch, lambda w, s: ok.onebit_unpack(w, s, n),
                              [(w, s[1:]) for w, s in packed]) * 1e3)
                del packed
            ok.launch_geometry = chosen
            picks = [chosen(L, k)[0] for k in ("onebit_pack", "onebit_unpack")]
            print(f"numel {n} ({chunks.count(n)} chunks, {L} words; "
                  f"launch_geometry's vw: pack {picks[0]}, unpack "
                  f"{picks[1]}): " + ", ".join(
                      f"vw {vw} pack {us[n, vw][0]:.2f} us, unpack "
                      f"{us[n, vw][1]:.2f} us" for vw in ok.VECTOR_WIDTHS),
                  flush=True)
            del xs
    finally:
        ok.launch_geometry = chosen

    def per_step(width_of):
        return sum(2 * us[n, width_of(n, "onebit_pack")][0]
                   + 3 * us[n, width_of(n, "onebit_unpack")][1]
                   for n in chunks)

    steps = {f"vw {vw}": per_step(lambda n, k, vw=vw: vw)
             for vw in ok.VECTOR_WIDTHS}
    steps["launch_geometry"] = per_step(
        lambda n, k: chosen(ok.padded_lanes(n), k)[0])
    print("per ResNet step (2 packs and 3 unpacks per chunk): " + ", ".join(
        f"{k} {v:.2f} us" for k, v in steps.items()), flush=True)
    print(json.dumps({"card": card.splitlines()[0], "per_step_us": steps,
                      "us": {f"{n}/{vw}": v for (n, vw), v in us.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
