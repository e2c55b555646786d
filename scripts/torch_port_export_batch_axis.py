"""The flagship's AOT artifact at batch 64 with a dynamic batch axis (what
``Predictor.export`` writes) against the same program traced at a fixed
batch, and against the live Predictor, on the card: answers compared,
then each timed in turns.

    PYTHONPATH=. python3 scripts/torch_port_export_batch_axis.py [ROUNDS]

Prints the card line, the largest difference between the two artifacts'
probabilities, then one JSON line: for each of "dynamic", "fixed" and
"live", the median over ROUNDS (default 6) rounds of
``chip_smoke.predictor_ms`` (device ms of one forward on an uploaded
batch, call ms of one Predictor call with upload and fetch), the order
of the three turned round by round.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile

import numpy as np
import torch

import chip_smoke
from ta3n_tpu_torch.serve import Predictor, _Program

BATCH = chip_smoke.SERVE_BATCH


def fixed_artifact(pred: Predictor, dynamic_dir: str, out: str) -> str:
    """``pred``'s program traced at the fixed batch, beside a copy of the
    dynamic artifact's meta.json."""
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(dynamic_dir, "meta.json"), out)
    program = _Program(pred._members_on_cpu(), pred.top_k).eval()
    cfg = pred.cfg
    x = torch.zeros(BATCH, cfg.val_segments * cfg.sample_new_length,
                    cfg.input_feature_dim)
    with torch.no_grad():
        program(x)
        exported = torch.export.export(program, (x,))
    torch.export.save(exported, os.path.join(out, "predict.pt2"))
    return out


def main(argv) -> int:
    rounds = int(argv[0]) if argv else 6
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    model = chip_smoke.flagship_model(torch.Generator().manual_seed(4))
    live = Predictor(chip_smoke.FLAGSHIP, model, batch_size=BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        dyn_dir = live.export(os.path.join(tmp, "dynamic"))
        fix_dir = fixed_artifact(live, dyn_dir, os.path.join(tmp, "fixed"))
        preds = {"dynamic": Predictor.from_exported(dyn_dir),
                 "fixed": Predictor.from_exported(fix_dir),
                 "live": live}
        x = np.random.default_rng(4).random(
            (BATCH, 5, chip_smoke.FLAGSHIP.input_feature_dim), np.float32)
        diff = float(np.abs(preds["dynamic"](x)[0]
                            - preds["fixed"](x)[0]).max())
        print(chip_smoke.card_line())
        print(f"max |dynamic - fixed| probabilities: {diff:.3e}")
        if diff > 1e-6:
            raise AssertionError("the two artifacts differ")
        got = {k: [] for k in preds}
        names = list(preds)
        for r in range(rounds):
            order = names[r % 3:] + names[:r % 3]
            for name in order if r % 2 == 0 else order[::-1]:
                got[name].append(chip_smoke.predictor_ms(preds[name], x))
    print(json.dumps({
        name: {"device_ms": statistics.median(d for d, _ in v),
               "call_ms": statistics.median(c for _, c in v)}
        for name, v in got.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
