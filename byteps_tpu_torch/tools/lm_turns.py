"""Phase 7 of ``chip_smoke.py`` (the Llama and GPT slices, three arms each)
run from several checkouts in turns, in one call, so that two commits
are compared on one card under the same drift:

    git archive PARENT | tar -x -C _checkout/parent
    python -m byteps_tpu_torch.tools.lm_turns \\
        --tree parent=_checkout/parent --tree change=. \\
        --order parent,change,change,parent

Each turn is a fresh interpreter in that checkout's directory (its own
kernels, built there); it prints each arm's median line of the two
slices, and the run fails if a turn fails.
"""

import argparse
import subprocess
import sys
import time

TURN = r'''
import sys, dataclasses
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
import byteps_tpu_torch as bps
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.core import api
from byteps_tpu_torch.models import gpt, llama
from importlib import import_module
fa = import_module("byteps_tpu_torch.ops.flash_attention")
torch.backends.cuda.matmul.allow_tf32 = False
km = {k: 0.0 for k in cs.FLASH_KERNELS}
cs.lm_slice_phase(torch, bps, api, fa, Config, "gpt slice", gpt.GPT,
                  gpt.gpt_small(), 1, 8192, km)
cs.lm_slice_phase(torch, bps, api, fa, Config, "llama slice", llama.Llama,
                  dataclasses.replace(llama.llama3_8b(), num_layers=4), 2,
                  4096, km)
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout to run from")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, one turn each")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    rc = 0
    for name in args.order.split(","):
        t0 = time.time()
        r = subprocess.run([sys.executable, "-c", TURN], cwd=trees[name],
                           capture_output=True, text=True)
        print(f"== {name} rc={r.returncode} {time.time() - t0:.1f} s",
              flush=True)
        for line in r.stdout.splitlines():
            if ": median" in line:
                print(line[:200], flush=True)
        if r.returncode:
            print(r.stdout[-2000:], r.stderr[-3000:], flush=True)
            rc = r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
