#!/usr/bin/env python3
"""Probe the Hopper flash-attention kernels on one NVIDIA GPU: the forward
tile of K1, K3 and K4 (stable_virtual_camera_tpu_torch/csrc/flash_fwd_sm90.cuh)
and K1's backward pair K1-dKV, K1-dQ (csrc/flash_attention_bwd.cu). Run from
the repository root:

    python3 scripts/flash_tile_probe.py            # ptxas report + checks
    python3 scripts/flash_tile_probe.py --time     # + times against SDPA

`ptxas`: each kernel's registers, shared memory and spills (-Xptxas -v),
K2's temporal attention (csrc/time_attention.cu, one entry per key-frame
ceiling) and K5's LayerNorm (csrc/layer_norm.cu) included.
`check`: K1 (with its log-sum-exp), K3, K4 and then K1-dKV, K1-dQ against
their plain versions at small and ragged shapes, at chip_smoke.py's bars.
`time`: K1 against SDPA at the render shapes, the backward pair and D
against SDPA's backward at the training shapes, and the SM clock and power
while K1 runs for 3 s. One JSON line per part; non-zero exit if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHECK_SHAPES = [(128, 1, 1), (64, 1, 1), (100, 2, 3), (1100, 1, 2), (1296, 3, 1), (27216, 1, 1)]
TIME_SHAPES = [(5184, 42, 5), (1296, 42, 10), (27216, 2, 10), (6804, 2, 20), (1701, 2, 20)]
TRAIN_SHAPES = [(L, B // 2, H) for L, B, H in TIME_SHAPES]
MAX_ABS, MEAN_ABS, LSE_ABS, BWD_REL_L2 = 2e-2, 2e-3, 1e-2, 2e-2
# the sources whose ptxas report is printed: the flash kernels, K2's
# temporal attention (csrc/time_attention.cu) and K5's LayerNorm
# (csrc/layer_norm.cu), which share csrc/sm90.cuh
SOURCES = ("flash_attention", "flash_attention_blhd", "flash_attention_packed", "flash_attention_bwd",
           "time_attention", "layer_norm")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def packed_qkv(gen, L: int, B: int, H: int, grad: bool = False):
    """K1's (B, H, L, 64) views of a packed (B, L, 3, H, 64) projection and,
    with `grad`, an incoming gradient in K1's output layout."""
    import torch

    q, k, v = torch.randn((B, L, 3, H, 64), generator=gen, device="cuda").to(torch.bfloat16).permute(
        2, 0, 3, 1, 4).unbind(0)
    if not grad:
        return q, k, v
    return q, k, v, torch.randn((B, L, H, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)


def ptxas_report() -> dict:
    """Compile SOURCES with -Xptxas -v, all at once, into
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
        lines = []
        for ln in text.splitlines():
            kernel = re.findall(r"flash_[a-z_]*_kernel|time_attn_kernelILi\d+EE|layer_norm_kernelI\w+?EE", ln) if "Compiling entry" in ln else None
            if kernel:
                lines.append(f"entry {kernel[-1]}")
            elif "Function properties" not in ln and "Compiling entry" not in ln:
                lines.append(re.sub(r"'_Z\w+'", "", ln.strip()))
        report[name] = {"rc": p.returncode, "lines": lines}
    return report


def clocks_under_load(gen, seconds: float = 3.0) -> dict:
    """nvidia-smi's SM clock and power draw, sampled every 100 ms while K1
    runs back to back at (27216, 2, 10)."""
    import time

    import torch

    from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu

    L, B, H = 27216, 2, 10
    q, k, v = packed_qkv(gen, L, B, H)
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
        do = torch.randn((B, L, H, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
        delta = fu.attention_delta(o1, do)
        dk, dv = fu.flash_attention_bwd_dkv_cuda(*bhld, do, lse, delta)
        grads = (fu.flash_attention_bwd_dq_cuda(*bhld, do, lse, delta), dk, dv)
        refs = fu.flash_attention_bwd_plain(*bhld, o1, lse, do)
        row["bwd_rel_l2"] = {n: ((g.float() - r.float()).norm() / r.float().norm()).item()
                             for n, g, r in zip(("dq", "dk", "dv"), grads, refs)}
        good = good and all(torch.isfinite(g).all() for g in grads) and max(row["bwd_rel_l2"].values()) <= BWD_REL_L2
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


def time_kernels(gen) -> dict:
    """At the self-attention shapes of a 576x576 render, K1 against SDPA on
    the same views; at those of a training chunk, K1-dKV, K1-dQ and the D
    reduction against SDPA's backward (which does its own preprocessing).
    TFLOP/s: 4 L^2 64 B H in K1, 8 in K1-dKV, 6 in K1-dQ."""
    import torch

    from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu

    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd, bwd = [], []
    for L, B, H in TIME_SHAPES:
        q, k, v = packed_qkv(gen, L, B, H)
        row = {"L": L, "B": B, "H": H, "k1_ms": cuda_ms(lambda: fu.flash_attention_cuda(q, k, v), 10),
               "sdpa_ms": cuda_ms(lambda: sdpa(q, k, v), 10)}
        fwd.append({**row, **{f"{n}_tflops": 4.0 * L * L * 64 * B * H / row[f"{n}_ms"] / 1e9 for n in ("k1", "sdpa")}})
    for L, B, H in TRAIN_SHAPES:
        q, k, v, do = packed_qkv(gen, L, B, H, grad=True)
        o, lse = fu.flash_attention_cuda(q, k, v, return_lse=True)
        delta = fu.attention_delta(o, do)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves)
        row = {"L": L, "B": B, "H": H,
               "dkv_ms": cuda_ms(lambda: fu.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta), 10),
               "dq_ms": cuda_ms(lambda: fu.flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta), 10),
               "delta_ms": cuda_ms(lambda: fu.attention_delta(o, do), 10),
               "sdpa_bwd_ms": cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 10)}
        row["pair_and_delta_ms"] = row["dkv_ms"] + row["dq_ms"] + row["delta_ms"]
        for part, products in (("dkv", 8.0), ("dq", 6.0)):
            row[f"{part}_tflops"] = products * L * L * 64 * B * H / row[f"{part}_ms"] / 1e9
        bwd.append(row)
    torch.cuda.empty_cache()
    return {"fwd": fwd, "bwd": bwd}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true", help="also time the kernels against SDPA")
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
        emit({"part": "time", **time_kernels(gen)})
        emit({"part": "clocks", **clocks_under_load(gen)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
