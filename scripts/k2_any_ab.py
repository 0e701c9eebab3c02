#!/usr/bin/env python3
"""Read K2's two entries of one checkout on the card at the 576x576 render's
time-mix shapes, so that two checkouts can be compared in one call (parent,
change, change, parent).

  python3 scripts/k2_any_ab.py ROOT [--reps N]

ROOT is the root of a checkout (this one, or an older commit unpacked with
`git archive` into a git-ignored directory); its port and its chip_smoke.py
are imported from there. At each (S, H) of chip_smoke.py's K2_SHAPES (T =
21, b = 2, head dim 64) the inputs are the UNet's views of one (b*T, 3, H,
64, S) projection drawn from a CUDA generator of seed 0:

- K2's other entry (csrc/time_attention_any.cu) in fp32: its relative L2 to
  `time_attention_plain`, its warm time (CUDA events over N launches on one
  projection, after a warm-up), its cold time (CUDA events while rotating
  over at least chip_smoke.K2_COLD_BYTES of projections) and torch.profiler's
  device time over that rotation;
- the Hopper K2 (csrc/time_attention.cu) on the bf16 projections: the
  SHA-256 of its outputs at every shape and its cold device time.

Prints one JSON line with the card's name and power limit, the rows and
their sums.
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
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    import chip_smoke as c
    from stable_virtual_camera_tpu_torch.ops.time_attention import (
        time_attention_any_cuda,
        time_attention_cuda,
        time_attention_plain,
    )

    if not torch.cuda.is_available():
        print("k2_any_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    T, b = 21, 2
    digest = hashlib.sha256()
    rows = []
    for S, H in c.K2_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)

        def projection():
            return torch.randn((b * T, 3, H, 64, S), generator=gen, device="cuda")

        projections = [projection()]
        q, k, v = projections[0].unbind(1)
        out = time_attention_any_cuda(q, k, v, T)
        ref = time_attention_plain(q, k, v, T)
        row = {"S": S, "H": H, "rel_l2": ((out - ref).norm() / ref.norm()).item(),
               "ms": c.cuda_ms(lambda: time_attention_any_cuda(q, k, v, T), args.reps)}
        del out, ref
        n = -(-int(c.K2_COLD_BYTES) // (3 * q.numel() * 4))
        projections += [projection() for _ in range(n - 1)]
        fp32_cold = c.rotating(lambda qi, ki, vi, oi: time_attention_any_cuda(qi, ki, vi, T, out=oi),
                               [(*p.unbind(1), torch.empty_like(q, memory_format=torch.contiguous_format))
                                for p in projections])
        row["cold_ms"] = c.cuda_ms(fp32_cold, args.reps)
        row["device_us"] = c.device_us(fp32_cold, args.reps)[0]
        bf16 = [p.to(torch.bfloat16).unbind(1) for p in projections]
        del projections, fp32_cold
        digest.update(time_attention_cuda(*bf16[0], T).cpu().view(torch.int16).numpy().tobytes())
        hopper_cold = c.rotating(lambda qi, ki, vi, oi: time_attention_cuda(qi, ki, vi, T, out=oi),
                                 [(*qkv, torch.empty_like(qkv[0], memory_format=torch.contiguous_format))
                                  for qkv in bf16])
        row["hopper_device_us"] = c.device_us(hopper_cold, args.reps)[0]
        rows.append(row)
        del q, k, v, bf16, hopper_cold
        torch.cuda.empty_cache()
    sums = {key: sum(r[key] for r in rows) for key in ("ms", "cold_ms", "device_us", "hopper_device_us")}
    print(json.dumps({"root": args.root, "nvidia_smi": smi, "any_fp32": sums, "max_rel_l2": max(r["rel_l2"] for r in rows),
                      "hopper_bf16_sha256": digest.hexdigest(), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
