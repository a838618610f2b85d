"""Same-call A/B of the flagship and raw-PCM training steps between two
trees of this repository on one card.

Each turn runs, in a fresh process from the tree's own root, that tree's
``chip_smoke.phase_training`` and ``chip_smoke.phase_raw_pcm`` (its
profiler window switched off) at ``--steps`` timed steps, and prints one
``RESULT`` line: the tree, the raw-PCM step's mean, median and every
step, the frontend's time (dequantize, normalise, frame, log-mel kernel)
as the phase takes it (5 calls) and five more means of 40 calls each with
their median, and the flagship step's mean, median and every step.  The turns go earlier, this, this,
earlier, so drift over the call falls on both sides alike::

    git archive <rev> | tar -x -C build/parent
    python3 -m rnntransducer_tpu_torch.tools.step_ab build/parent . --steps 8

Both trees need a ``chip_smoke.py`` with those two phases; the kernels are
built in each tree's own ``build/kernels``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

_TURN = r"""
import json, sys, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from rnntransducer_tpu_torch.config import base_config
cs.TIMED_STEPS = cs.RAW_PCM_STEPS = {steps}
cs.phase_profile_step = lambda *a: None
cs.build.build_all(cs.KERNELS)
params = cs.random_flax_params(base_config().model, torch.Generator().manual_seed(cs.SEED))
_, raw = cs.phase_raw_pcm(params)
_, flag = cs.phase_training(params)
audio = base_config().data.audio
wav, lengths = cs._pcm(cs.TRAIN_B, seed=cs.SEED + 2)
q, scale = cs.quantize_pcm(wav, lengths)
batch = {{"wav": torch.from_numpy(q).to(cs.DEVICE),
         "wav_scale": torch.from_numpy(scale).to(cs.DEVICE),
         "wav_lengths": torch.from_numpy(lengths).to(cs.DEVICE)}}
frontend = [cs._sync_time(lambda: cs.device_frontend(
    audio, cs.dequantize_wav(batch), batch["wav_lengths"]), 40) for _ in range(5)]
print("RESULT " + json.dumps({{"tree": {tree!r}, "raw_ms": raw["step_ms"],
      "raw_each": raw["step_ms_each"], "raw_median": float(np.median(raw["step_ms_each"])),
      "frontend_ms": raw["frontend_ms"], "frontend_40": frontend,
      "frontend_median": float(np.median(frontend)), "flagship_ms": flag["step_ms"],
      "flagship_each": flag["step_ms_each"],
      "flagship_median": float(np.median(flag["step_ms_each"]))}}), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="root of the earlier tree")
    ap.add_argument("this", help="root of the tree under test")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in (args.earlier, args.this, args.this, args.earlier):
        code = _TURN.format(steps=args.steps, tree=tree)
        got = subprocess.run([sys.executable, "-c", code], cwd=os.path.abspath(tree),
                             capture_output=True, text=True)
        lines = [l for l in got.stdout.splitlines() if l.startswith("RESULT ")]
        if got.returncode != 0 or not lines:
            print(got.stdout[-4000:], got.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
