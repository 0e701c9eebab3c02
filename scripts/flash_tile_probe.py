#!/usr/bin/env python3
"""Probe the Hopper forward tile shared by K1, K3 and K4
(stable_virtual_camera_tpu_torch/csrc/flash_fwd_sm90.cuh) on one NVIDIA GPU.
Run from the repository root:

    python3 scripts/flash_tile_probe.py            # ptxas report + checks
    python3 scripts/flash_tile_probe.py --time     # + times at the render shapes

1. `ptxas`: compiles the three forward sources with `-Xptxas -v` into
   build/ptxas/ and prints each kernel's registers, shared memory and
   spills as ptxas reports them.
2. `check`: K1 (with its log-sum-exp), K3 and K4 against their plain
   versions at small and ragged shapes, at the bars of chip_smoke.py
   (max 2e-2, mean 2e-3; LSE 1e-2).
3. `time` (with --time): at the self-attention shapes of a 576x576 render,
   K1 against SDPA on the same views, with TFLOP/s; then the SM clock and
   power that nvidia-smi reads while K1 runs at (27216, 2, 10) for 3 s.
Prints one JSON line per part; exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHECK_SHAPES = [(128, 1, 1), (64, 1, 1), (100, 2, 3), (1100, 1, 2), (1296, 3, 1), (27216, 1, 1)]
TIME_SHAPES = [(5184, 42, 5), (1296, 42, 10), (27216, 2, 10), (6804, 2, 20), (1701, 2, 20)]
MAX_ABS, MEAN_ABS, LSE_ABS = 2e-2, 2e-3, 1e-2
SOURCES = ("flash_attention", "flash_attention_blhd", "flash_attention_packed")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report() -> dict:
    """Compile the three forward sources with -Xptxas -v, all at once, into
    build/ptxas/; returns each one's return code and the ptxas lines that
    report registers, spills, warnings and errors."""
    from stable_virtual_camera_tpu_torch import _kernels

    out_dir = _kernels.BUILD_DIR.parent / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {
        name: subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out_dir / f"{name}.so"),
             str(_kernels.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SOURCES
    }
    report = {}
    for name, p in procs.items():
        text, _ = p.communicate()
        report[name] = {"rc": p.returncode,
                        "lines": [ln.strip() for ln in text.splitlines()
                                  if "Compiling entry" not in ln and "Function properties" not in ln]}
    return report


def clocks_under_load(gen, seconds: float = 3.0) -> dict:
    """nvidia-smi's SM clock and power draw, sampled every 100 ms while K1
    runs back to back at (27216, 2, 10)."""
    import time

    import torch

    from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu

    L, B, H = 27216, 2, 10
    q, k, v = torch.randn((B, L, 3, H, 64), generator=gen, device="cuda").to(torch.bfloat16).permute(
        2, 0, 3, 1, 4).unbind(0)
    fu.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    t0, calls = time.perf_counter(), 0
    try:
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fu.flash_attention_cuda(q, k, v)
            calls += 20
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    wall = time.perf_counter() - t0
    samples = [[float(x) for x in ln.split(",")] for ln in out.strip().splitlines() if ln.count(",") == 1]
    samples = samples[2:] or samples  # the first reads may precede the load
    clocks = sorted(s[0] for s in samples)
    return {"shape": [L, B, H], "calls": calls, "ms_per_call": wall * 1e3 / calls,
            "sm_mhz_median": clocks[len(clocks) // 2] if clocks else None,
            "sm_mhz_min_max": [clocks[0], clocks[-1]] if clocks else None,
            "power_w_median": sorted(s[1] for s in samples)[len(samples) // 2] if samples else None,
            "samples": len(samples)}


def check(gen) -> tuple[bool, list]:
    import torch

    from stable_virtual_camera_tpu_torch.ops import flash_attention as fa
    from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as fap
    from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu

    rows, ok = [], True
    for L, B, H in CHECK_SHAPES:
        qkv = torch.randn((B, L, 3 * H * 64), generator=gen, device="cuda").to(torch.bfloat16)
        q3, k3, v3 = qkv.chunk(3, dim=-1)
        bhld = [t.view(B, L, H, 64).transpose(1, 2) for t in (q3, k3, v3)]
        ref, lse_ref = fu.flash_attention_plain(*bhld, return_lse=True)
        ref = ref.float()
        o1, lse = fu.flash_attention_cuda(*bhld, return_lse=True)
        outs = {"k1": o1.float(),
                "k3": fa.flash_attention_cuda(*(t.view(B, L, H, 64) for t in (q3, k3, v3))).float().transpose(1, 2),
                "k4": fap.flash_attention_packed_cuda(q3, k3, v3, H).float().view(B, L, H, 64).transpose(1, 2)}
        torch.cuda.synchronize()
        row = {"L": L, "B": B, "H": H, "lse_max_abs": (lse - lse_ref).abs().max().item()}
        good = row["lse_max_abs"] <= LSE_ABS
        for name, out in outs.items():
            d = (out - ref).abs()
            row[name] = {"max_abs": d.max().item(), "mean_abs": d.mean().item(),
                         "finite": bool(torch.isfinite(out).all())}
            good = good and row[name]["finite"] and row[name]["max_abs"] <= MAX_ABS and row[name]["mean_abs"] <= MEAN_ABS
        row["ok"] = good
        ok = ok and good
        rows.append(row)
    return ok, rows


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_shapes(gen) -> list:
    import torch

    from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu

    rows = []
    for L, B, H in TIME_SHAPES:
        flops = 4.0 * L * L * 64 * H * B
        qkv = torch.randn((B, L, 3, H, 64), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        row = {"L": L, "B": B, "H": H,
               "k1_ms": cuda_ms(lambda: fu.flash_attention_cuda(q, k, v), 10),
               "sdpa_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 10)}
        for key in [name for name in row if name.endswith("_ms")]:
            row[key.replace("_ms", "_tflops")] = flops / (row[key] * 1e-3) / 1e12
        rows.append(row)
        del qkv, q, k, v
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true", help="also time the tile at the render shapes")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_tile_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"part": "device", "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    emit({"part": "ptxas", **ptxas_report()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok, rows = check(gen)
    emit({"part": "check", "ok": ok, "shapes": rows})
    if ok and args.time:
        emit({"part": "time", "shapes": time_shapes(gen)})
        emit({"part": "clocks", **clocks_under_load(gen)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
