#!/usr/bin/env python3
"""Device busy ms of the PROD serve and train steps (B=20 x N=10000, the
default route, random weights from chip_smoke.SEED) of one or more trees of
this repository on one CUDA card (an H100), in turns.

    python3 scripts/prod_busy.py build/parent . . build/parent

Each TREE (a checkout, e.g. `git archive` of a commit unpacked under the
git-ignored build/) runs in a process of its own, from its own directory
with its own chip_smoke.py and package, in the order given: it builds its
kernels into its own build/kernels/, sets up the steps as chip_smoke.py's
phase 17 does (`optin_setup` with no opt-ins), warms each step up, then
takes REPS profiled steps of each (`chip_smoke.device_busy_ms`: the device
time of every device operation of one step under torch.profiler) and
prints one JSON line: the tree, the card, each step's busy ms (every rep
and the median) and its host-clock median (`timed_steps`). Exits non-zero
without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPS = 7

CHILD = """
import json, statistics, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from stratanet2_tpu_torch.config import default_config
from stratanet2_tpu_torch.learning.train import make_optimizer
from stratanet2_tpu_torch.ops import _build
import copy
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
device = torch.device("cuda", 0)
st = cs.optin_setup(torch, default_config(), device, {})
m = copy.deepcopy(st["train_model"])
opt, sched = make_optimizer(st["cfg"], m, cs.STEPS_PER_EPOCH)
steps = {"serve": lambda: st["serve"](st["model"], st["cloud"], st["xyz"]),
         "train": lambda: st["train"](m, opt, sched, *st["batch"])}
out = {"tree": sys.argv[1], "card": sys.argv[2]}
for name, fn in steps.items():
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    busy = [cs.device_busy_ms(torch, fn)[1] for _ in range(int(sys.argv[3]))]
    out[f"{name}_busy_ms"] = busy
    out[f"{name}_busy_ms_median"] = statistics.median(busy)
    out[f"{name}_step_ms_median"] = cs.timed_steps(torch, fn, 10)[0]
print(json.dumps(out), flush=True)
"""


def main() -> int:
    import torch

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("prod_busy: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    for tree in sys.argv[1:]:
        root = Path(tree).resolve()
        run = subprocess.run([sys.executable, "-c", CHILD, tree, card, str(REPS)], cwd=root,
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
