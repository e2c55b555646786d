"""Device times of the port's TRN kernels on the card: K1 (infer) at the
serve batch 64, K1 (train) and K2 at the train batch 202, at the flagship
widths (D=512, H=256) and the given numbers of frames.

    PYTHONPATH=. python3 scripts/torch_port_trn_times.py [S ...]

It times the tree it is run from (the ``ta3n_tpu_torch`` and
``chip_smoke.py`` on ``PYTHONPATH``), so two trees are compared by running
it from each root in turns in one call (A, B, B, A), e.g. a parent
unpacked into build/parent:

    cd build/parent && PYTHONPATH=. python3 ../../scripts/torch_port_trn_times.py

Prints the card line, then one JSON line per S: median device ms of 41
runs (``chip_smoke.time_pair``).  S defaults to 5.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke
from ta3n_tpu_torch.ops import trn_fused


def times(s: int) -> dict:
    gen = torch.Generator().manual_seed(0)
    out = {"S": s}
    with torch.no_grad():
        x, w, bi = chip_smoke.trn_inputs(64, s, 512, 256, gen)
        with torch.inference_mode():
            out["k1_infer_b64"] = chip_smoke.time_pair({
                "k": lambda: trn_fused.trn_multiscale_infer(x, w, bi, s)})["k"]
        x, w, bi = chip_smoke.trn_inputs(202, s, 512, 256, gen, signed=True)
        g = torch.randn((202, s - 1, 256), generator=gen).cuda()
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
        out["k1_train_b202"] = chip_smoke.time_pair({
            "k": lambda: trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)})["k"]
        out["k2_b202"] = chip_smoke.time_pair({
            "k": lambda: trn_fused.trn_multiscale_bwd(x, w, masks, g, s)})["k"]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line())
    for s in [int(a) for a in sys.argv[1:]] or [5]:
        print(json.dumps(times(s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
