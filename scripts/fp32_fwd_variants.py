#!/usr/bin/env python3
"""Time versions of the fp32 flash forward (the fp32 entry of K1, K3 and K4,
stable_virtual_camera_tpu_torch/csrc/flash_attention_fp32.cu) side by side
on one NVIDIA GPU. Run from the repository root:

    python3 scripts/fp32_fwd_variants.py [VARIANT.cu ...] [--reps N] [--rounds N]

A variant is a source with the same C entry point
(`svc_flash_attention_fp32_fwd`), kept in a git-ignored directory such as
build/variants/; it is built with the port's nvcc flags, `-I` the port's
csrc/ and `-Xptxas -v` into build/variants/. Every version (the shipped
one first) runs at chip_smoke.py's 576x576 render shapes on K1's
packed-qkv views, through `flash_attention_cuda` with the version's entry
point swapped into `_kernels.FLASH_ATTENTION_FP32`. Each is held against
the plain fp32 version (relative L2, max abs; the bars of chip_smoke.py)
and a second launch must give the same bits; then all are timed with CUDA
events in turns (the versions in order, then reversed, `--rounds` times),
SDPA's memory-efficient backend on the same views among them. One JSON
line per version: ptxas's registers, spills and warnings, the errors, ms per shape
(every reading) and the summed median; exit 1 if a version fails its
check.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the shapes, bars and timing helpers)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build(sources: list[Path]) -> dict[str, dict]:
    """Compile each source, all at once, into build/variants/<stem>.so;
    returns each one's library path and ptxas's registers, spills and
    warnings (a source that fails to build is reported and left out)."""
    from stable_virtual_camera_tpu_torch import _kernels

    out_dir = _kernels.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        lib = out_dir / f"{src.stem}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-Xptxas", "-v", "-o", str(lib),
               str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            emit({"version": name, "ok": False, "nvcc": text[-4000:]})
            continue
        usage = {"warnings": [ln.strip() for ln in text.splitlines() if "warning" in ln.lower()]}
        for ln in text.splitlines():
            if "spill stores" in ln:
                nums = [int(n) for n in re.findall(r"(\d+) bytes", ln)]
                usage.update(stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
            elif "Used" in ln and "registers" in ln:
                usage["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
        out[name] = {"library": lib, "ptxas": usage}
    return out


def entry(lib: Path):
    """The version's entry point and error-string function, typed as
    `_kernels.FLASH_ATTENTION_FP32` types its own."""
    from stable_virtual_camera_tpu_torch import _kernels

    so = ctypes.CDLL(str(lib))
    fn = so.svc_flash_attention_fp32_fwd
    fn.argtypes, fn.restype = _kernels.FLASH_ATTENTION_FP32.argtypes, ctypes.c_int
    err = so.svc_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", type=Path, help="sources with the same C entry point")
    ap.add_argument("--reps", type=int, default=3, help="launches an event reading averages")
    ap.add_argument("--rounds", type=int, default=1, help="passes of the versions in order and reversed")
    args = ap.parse_args()
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.ops.flash_upstream import flash_attention_cuda, flash_attention_plain

    if not torch.cuda.is_available():
        print("fp32_fwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"part": "device", "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    kernel = _kernels.FLASH_ATTENTION_FP32
    versions = build([kernel.source, *args.variants])
    if kernel.source.stem not in versions:
        return 1
    for v in versions.values():
        v["fn"] = entry(v["library"])
    shipped = kernel.source.stem

    def use(name):
        kernel._load()
        kernel._fn, kernel._err = versions[name]["fn"]

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    inputs = []
    for L, B, H in chip_smoke.K1_SHAPES:
        q, k, v = torch.randn((B, L, 3, H, 64), generator=gen, device="cuda").permute(2, 0, 3, 1, 4).unbind(0)
        inputs.append((q, k, v))

    ok = len(versions) == 1 + len(args.variants)
    for name, ver in versions.items():
        use(name)
        ver["errors"] = []
        for (L, B, H), (q, k, v) in zip(chip_smoke.K1_SHAPES, inputs):
            out, lse = flash_attention_cuda(q, k, v, return_lse=True)
            out2, lse2 = flash_attention_cuda(q, k, v, return_lse=True)
            ref, lse_ref = flash_attention_plain(q, k, v, return_lse=True)
            row = {"L": L, "rel_l2": ((out - ref).norm() / ref.norm()).item(),
                   "max_abs_err": (out - ref).abs().max().item(),
                   "lse_max_abs_err": (lse - lse_ref).abs().max().item(),
                   "repeat_bit_equal": torch.equal(out, out2) and torch.equal(lse, lse2)}
            row["ok"] = (row["rel_l2"] <= chip_smoke.FP32_FWD_REL_L2 and row["repeat_bit_equal"]
                         and row["max_abs_err"] <= chip_smoke.FP32_FWD_MAX_ABS
                         and row["lse_max_abs_err"] <= chip_smoke.FP32_LSE_MAX_ABS)
            ok &= row["ok"]
            ver["errors"].append(row)
            del out, out2, lse, lse2, ref, lse_ref
        torch.cuda.empty_cache()

    def sdpa(q, k, v):
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v)

    order = [*versions, "sdpa"]
    ms: dict[str, list[list[float]]] = {name: [[] for _ in inputs] for name in order}
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            if name != "sdpa":
                use(name)
            fn = sdpa if name == "sdpa" else flash_attention_cuda
            for i, (q, k, v) in enumerate(inputs):
                ms[name][i].append(chip_smoke.cuda_ms(lambda: fn(q, k, v), args.reps))
    use(shipped)

    bound_ms = sum(chip_smoke.bound(3 * 4.0 * L * L * 64 * H * B, 4 * B * H * L * 64 * 4,
                                    chip_smoke.PEAK_TF32_FLOPS)[0] for L, B, H in chip_smoke.K1_SHAPES)
    for name in order:
        med = [sorted(r)[len(r) // 2] for r in ms[name]]
        ver = versions.get(name, {})
        emit({"version": name, "shipped": name == shipped, "ptxas": ver.get("ptxas"),
              "ok": all(r["ok"] for r in ver["errors"]) if ver else None, "errors": ver.get("errors"),
              "shapes": [list(s) for s in chip_smoke.K1_SHAPES], "ms": ms[name], "sum_median_ms": sum(med),
              "tf32x3_bound_ms": bound_ms, "bound_share": bound_ms / sum(med)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
