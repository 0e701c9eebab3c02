#!/usr/bin/env python3
"""Read the eager main path of one checkout on the card, for comparing two
checkouts in one call (parent, change, change, parent).

  python3 scripts/eager_path_ab.py ROOT [--forwards N]

ROOT is the root of a checkout (this one, or an older commit unpacked with
`git archive` into a git-ignored directory); its chip_smoke.py and port are
imported from there. Prints one JSON line: the median, min and max wall
time of N full-width UNet forwards (42 frames at 576x576, bf16 random
weights of seed 0, chip_smoke's `unet_forward` inputs, each forward ended
by a synchronize, after chip_smoke's own warm-up and timed forward), then
chip_smoke's Basic render (`main_path`, 4 steps) with its launch counts
and the SHA-256 of its uint8 anchors and frames.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--forwards", type=int, default=10)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    import chip_smoke as c
    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec
    from stable_virtual_camera_tpu_torch.models.io import random_bundle

    if not torch.cuda.is_available():
        print("eager_path_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    bundle = random_bundle(SevaSpec(), ClipVisionSpec(), dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(c.SEED))
    up = c.check_unet(bundle, torch.Generator(device="cuda").manual_seed(c.SEED))
    x, t_idx, ctx, dense = up["inputs"]
    walls = []
    with torch.inference_mode():
        for _ in range(args.forwards):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bundle.unet(x, t_idx, ctx, dense, c.T)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    out: dict = {}
    counts = c.run_main_path(bundle, {}, out)
    digest = hashlib.sha256(out["anchors"].tobytes() + out["frames"].tobytes()).hexdigest()
    print(json.dumps({"root": root, "forward_s": {"median": statistics.median(walls), "min": min(walls),
                                                  "max": max(walls), "n": len(walls)},
                      "main_path_launches": counts, "main_path_sha256": digest,
                      "unet_forward_out_sha256": hashlib.sha256(
                          up["out"].float().cpu().numpy().tobytes()).hexdigest()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
