#!/usr/bin/env python3
"""Time versions of K2's other entry (stable_virtual_camera_tpu_torch/csrc/
time_attention_any.cu) side by side on one NVIDIA GPU. Run from the
repository root:

    python3 scripts/k2_any_variants.py [VARIANT.cu ...] [--reps N] [--rounds N]

A variant is a source with the same C entry point
(`svc_time_attention_any_fwd`), kept in a git-ignored directory such as
build/variants/; it is built with the port's nvcc flags, `-I` the port's
csrc/ and `-Xptxas -v` into build/variants/. Every version (the shipped one
first) runs at chip_smoke.py's fp32 576x576 render shapes (K2_SHAPES, T =
21, b = 2, head dim 64) on the UNet's views of a (b*T, 3, H, 64, S)
projection, through `time_attention_any_cuda` with the version's entry
point swapped into `_kernels.TIME_ATTENTION_ANY`. Each is held against the
plain version (relative L2 at chip_smoke.K2_ANY_REL_L2) and a second launch
must give the same bits; then all are timed in turns (the versions in
order, then reversed, `--rounds` times) by torch.profiler's device time
while rotating over at least chip_smoke.K2_COLD_BYTES of projections, as
chip_smoke.py reads K2 cold. One JSON line per version: ptxas's registers
and spills of its fp32 instantiation at 21 key frames (and the most
registers and the spilled bytes over all instantiations), the errors, device
us per shape (every reading) and the summed median against the bytes bound;
exit 1 if a version fails its check.
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

# ptxas's name of the fp32 instantiation at 21 key frames
FP32_T21 = "time_any_kernelIfLi21E"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build(sources: list[Path]) -> dict[str, dict]:
    """Compile each source, all at once, into build/variants/<stem>.so;
    returns each one's library path and ptxas's registers and spills of
    FP32_T21, the most registers and the spilled bytes of all its kernels
    (a source that fails to build is reported and left out)."""
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
        usage, current = {"max_registers": 0, "spill_bytes": 0}, False
        for ln in text.splitlines():
            if "Compiling entry" in ln:
                current = FP32_T21 in ln
            elif "spill stores" in ln:
                nums = [int(n) for n in re.findall(r"(\d+) bytes", ln)]
                usage["spill_bytes"] += nums[1] + nums[2]
                if current:
                    usage.update(stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
            elif "Used" in ln and "registers" in ln:
                regs = int(re.search(r"Used (\d+) registers", ln).group(1))
                usage["max_registers"] = max(usage["max_registers"], regs)
                if current:
                    usage["registers"] = regs
        out[name] = {"library": lib, "ptxas": usage}
    return out


def entry(lib: Path):
    """The version's entry point and error-string function, typed as
    `_kernels.TIME_ATTENTION_ANY` types its own."""
    from stable_virtual_camera_tpu_torch import _kernels

    so = ctypes.CDLL(str(lib))
    fn = so.svc_time_attention_any_fwd
    fn.argtypes, fn.restype = _kernels.TIME_ATTENTION_ANY.argtypes, ctypes.c_int
    err = so.svc_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", type=Path, help="sources with the same C entry point")
    ap.add_argument("--reps", type=int, default=20, help="launches a profiler window sums")
    ap.add_argument("--rounds", type=int, default=1, help="passes of the versions in order and reversed")
    args = ap.parse_args()
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.ops.time_attention import time_attention_any_cuda, time_attention_plain

    if not torch.cuda.is_available():
        print("k2_any_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"part": "device", "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    kernel = _kernels.TIME_ATTENTION_ANY
    versions = build([kernel.source, *args.variants])
    if kernel.source.stem not in versions:
        return 1
    for v in versions.values():
        v["fn"] = entry(v["library"])
    shipped = kernel.source.stem

    def use(name):
        kernel._load()
        kernel._fn, kernel._err = versions[name]["fn"]

    T, b = chip_smoke.T, 2
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    rotations = []  # per shape: (q, k, v, out) over at least K2_COLD_BYTES of projections
    for S, H in chip_smoke.K2_SHAPES:
        n = -(-int(chip_smoke.K2_COLD_BYTES) // (3 * b * T * H * 64 * S * 4))
        rotations.append([(*torch.randn((b * T, 3, H, 64, S), generator=gen, device="cuda").unbind(1),
                           torch.empty((b * T, H, 64, S), device="cuda")) for _ in range(n)])

    ok = len(versions) == 1 + len(args.variants)
    for name, ver in versions.items():
        use(name)
        ver["errors"] = []
        for (S, H), rot in zip(chip_smoke.K2_SHAPES, rotations):
            q, k, v, _ = rot[0]
            out, out2 = time_attention_any_cuda(q, k, v, T), time_attention_any_cuda(q, k, v, T)
            ref = time_attention_plain(q, k, v, T)
            row = {"S": S, "rel_l2": ((out - ref).norm() / ref.norm()).item(),
                   "repeat_bit_equal": torch.equal(out, out2)}
            row["ok"] = row["rel_l2"] <= chip_smoke.K2_ANY_REL_L2 and row["repeat_bit_equal"]
            ok &= row["ok"]
            ver["errors"].append(row)
            del out, out2, ref
        torch.cuda.empty_cache()

    us: dict[str, list[list[float]]] = {name: [[] for _ in rotations] for name in versions}
    for _ in range(args.rounds):
        for name in list(versions) + list(versions)[::-1]:
            use(name)
            for i, rot in enumerate(rotations):
                cold = chip_smoke.rotating(lambda qi, ki, vi, oi: time_attention_any_cuda(qi, ki, vi, T, out=oi), rot)
                us[name][i].append(chip_smoke.device_us(cold, args.reps)[0])
    use(shipped)

    bound_ms = sum(chip_smoke.bound(4.0 * T * T * 64 * b * S * H, 4 * b * T * H * 64 * S * 4,
                                    chip_smoke.PEAK_FP32_FLOPS)[0] for S, H in chip_smoke.K2_SHAPES)
    for name, ver in versions.items():
        med = [sorted(r)[len(r) // 2] for r in us[name]]
        emit({"version": name, "shipped": name == shipped, "ptxas": ver["ptxas"],
              "ok": all(r["ok"] for r in ver["errors"]), "errors": ver["errors"],
              "shapes": [list(s) for s in chip_smoke.K2_SHAPES], "device_us": us[name],
              "sum_median_ms": sum(med) * 1e-3, "bound_ms": bound_ms, "bound_share": bound_ms / (sum(med) * 1e-3)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
