#!/usr/bin/env python3
"""Fingerprint the fp32 K1-dKV and K1-dQ (csrc/flash_attention_bwd_fp32.cu)
of one checkout on the card, to show that two checkouts' backward pairs give
the same bits, and time them, in one call (parent, change, change, parent).

  python3 scripts/fp32_bwd_fingerprint.py ROOT [--reps N]

ROOT is the root of a checkout (this one, or an older commit unpacked with
`git archive` into a git-ignored directory); its port is imported from
there. At each of chip_smoke.py's training shapes the inputs are drawn
from a CUDA generator of seed 0 (K1's packed-qkv views and an incoming
gradient, fp32); lse and o come from the plain fp32 forward and D from
`attention_delta`, so they do not depend on the checkout's forward kernel.
Prints one JSON line: the SHA-256 of every dk, dv and dq in order, and each
kernel's summed milliseconds (CUDA events over N launches after a warm-up).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    import chip_smoke as c
    from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
        attention_delta,
        flash_attention_bwd_dkv_cuda,
        flash_attention_bwd_dq_cuda,
        flash_attention_plain,
    )

    if not torch.cuda.is_available():
        print("fp32_bwd_fingerprint: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    digest = hashlib.sha256()
    ms = {"dkv": 0.0, "dq": 0.0}
    for L, B, H in c.K1_TRAIN_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = torch.randn((B, L, 3, H, 64), generator=gen, device="cuda").permute(2, 0, 3, 1, 4).unbind(0)
        do = torch.randn((B, L, H, 64), generator=gen, device="cuda").transpose(1, 2)
        o, lse = flash_attention_plain(q, k, v, return_lse=True)
        delta = attention_delta(o, do)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
        dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
        for t in (dk, dv, dq):
            digest.update(t.contiguous().cpu().numpy().tobytes())
        ms["dkv"] += c.cuda_ms(lambda: flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta), args.reps)
        ms["dq"] += c.cuda_ms(lambda: flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta), args.reps)
        del q, k, v, do, o, lse, delta, dk, dv, dq
        torch.cuda.empty_cache()
    print(json.dumps({"root": args.root, "nvidia_smi": smi, "sha256": digest.hexdigest(), "ms": ms,
                      "shapes": c.K1_TRAIN_SHAPES}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
