#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stable_virtual_camera_tpu_torch) on one
NVIDIA GPU. Run from the repository root: `python3 chip_smoke.py`.

It builds the hand-written kernels from csrc/ with nvcc and then runs:
  1. the device line (torch's name for the card, nvidia-smi's name and
     power limit);
  2. K1 (flash attention) against its plain version at every self-attention
     shape of a 576x576 render, on the packed-qkv views the UNet passes;
  3. K2 (temporal attention) against its plain version at every time-mix
     shape of a 576x576 render (T=21, b=2);
  4. one full-width SevaUNet forward (bf16 random weights, 42 frames,
     576x576) through the kernels and through the plain versions;
  5. the main path: HeadlessRenderer.render in Basic mode at full width
     (SevaSpec(), ClipVisionSpec(), SD2.1 VAE, bf16 random weights) on one
     seeded 576x576 image along the `orbit` preset, both passes, with the
     kernels' launch counts read around it;
  6. a `kernels` summary line, then the final `ok` line.
Every phase prints one JSON line. Cuts against a real render are printed in
phase 5. Any failed phase exits non-zero without the final line; so does a
machine with no CUDA device, or a directory without the port.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

SEED = 0
DEVICE = "cuda"
RES = 576  # image side; latents are RES / 8
T = 21  # frames per chunk
NUM_STEPS = 4  # cut from the released 50
NUM_TARGETS = 20
# (L, B, H) self-attention shapes at 576x576: per-frame ds1/ds2 and joint
# (T*h*w tokens) ds2/ds4/ds8
K1_SHAPES = [(5184, 42, 5), (1296, 42, 10), (27216, 2, 10), (6804, 2, 20), (1701, 2, 20)]
# (S, H) time-mix shapes at 576x576 (ds1, ds2, ds4, ds8)
K2_SHAPES = [(5184, 5), (1296, 10), (324, 20), (81, 20)]
K1_MAX_ABS, K1_MEAN_ABS = 2e-2, 2e-3
K2_MAX_ABS = 8e-3  # one bf16 ulp at 1
UNET_REL_L2 = 3e-2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn()` over `reps` back-to-back calls, after one
    warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_k1(gen) -> dict:
    import torch

    from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
        flash_attention_cuda,
        flash_attention_plain,
    )

    rows, worst = [], 0.0
    ms = plain_ms = 0.0
    for L, B, H in K1_SHAPES:
        # the UNet's layout: (B, H, L, 64) views of a packed (B, L, 3, H, 64) projection
        qkv = torch.randn((B, L, 3, H, 64), generator=gen, device=DEVICE).to(torch.bfloat16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        out = flash_attention_cuda(q, k, v).float()
        ref = flash_attention_plain(q, k, v).float()
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        row = {
            "L": L, "B": B, "H": H,
            "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
            "finite": bool(torch.isfinite(out).all()),
            "ms": cuda_ms(lambda: flash_attention_cuda(q, k, v), 10),
            "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v), 2),
        }
        row["tflops"] = 4.0 * L * L * 64 * H * B / (row["ms"] * 1e-3) / 1e12
        rows.append(row)
        worst = max(worst, row["max_abs_err"])
        ms += row["ms"]
        plain_ms += row["plain_ms"]
        del qkv, q, k, v, out, ref, diff
        torch.cuda.empty_cache()
    ok = all(r["finite"] and r["max_abs_err"] <= K1_MAX_ABS and r["mean_abs_err"] <= K1_MEAN_ABS for r in rows)
    emit({"phase": "k1_flash_attention", "ok": ok, "bar": {"max_abs": K1_MAX_ABS, "mean_abs": K1_MEAN_ABS},
          "shapes": rows})
    if not ok:
        raise AssertionError("K1 disagrees with its plain version")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def check_k2(gen) -> dict:
    import torch

    from stable_virtual_camera_tpu_torch.ops.time_attention import (
        time_attention_cuda,
        time_attention_plain,
    )

    rows, worst = [], 0.0
    ms = plain_ms = 0.0
    b = 2
    for S, H in K2_SHAPES:
        # the UNet's layout: (b*T, H, 64, S) views of a (b*T, 3, H, 64, S) projection
        qkv = torch.randn((b * T, 3, H, 64, S), generator=gen, device=DEVICE).to(torch.bfloat16)
        q, k, v = qkv.unbind(1)
        out = time_attention_cuda(q, k, v, T).float()
        ref = time_attention_plain(q, k, v, T).float()
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        row = {
            "S": S, "H": H, "T": T, "b": b,
            "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
            "finite": bool(torch.isfinite(out).all()),
            "ms": cuda_ms(lambda: time_attention_cuda(q, k, v, T), 10),
            "plain_ms": cuda_ms(lambda: time_attention_plain(q, k, v, T), 3),
        }
        rows.append(row)
        worst = max(worst, row["max_abs_err"])
        ms += row["ms"]
        plain_ms += row["plain_ms"]
    ok = all(r["finite"] and r["max_abs_err"] <= K2_MAX_ABS for r in rows)
    emit({"phase": "k2_time_attention", "ok": ok, "bar": {"max_abs": K2_MAX_ABS}, "shapes": rows})
    if not ok:
        raise AssertionError("K2 disagrees with its plain version")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def check_unet(bundle, gen) -> None:
    """One full-width forward through the kernels and through the plain
    versions (the kernel wrappers swapped for their plain twins)."""
    import torch

    from stable_virtual_camera_tpu_torch.models import unet as unet_mod
    from stable_virtual_camera_tpu_torch.ops.flash_upstream import flash_attention_plain
    from stable_virtual_camera_tpu_torch.ops.time_attention import time_attention_plain

    h = RES // 8
    n = 2 * T
    x = torch.randn((n, h, h, 11), generator=gen, device=DEVICE)
    t_idx = torch.full((n,), 500, device=DEVICE)
    ctx = torch.randn((n, 1, bundle.spec.context_dim), generator=gen, device=DEVICE)
    dense = torch.randn((n, h, h, 6), generator=gen, device=DEVICE)

    def forward():
        with torch.inference_mode():
            out = bundle.unet(x, t_idx, ctx, dense, T)
        torch.cuda.synchronize()
        return out

    forward()  # warm-up (cuDNN algorithm selection)
    t0 = time.perf_counter()
    out_k = forward()
    kernel_s = time.perf_counter() - t0
    saved = unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds
    unet_mod.flash_attention_upstream_bhld = flash_attention_plain
    unet_mod.time_attention_bhds = time_attention_plain
    try:
        t0 = time.perf_counter()
        out_p = forward()
        plain_s = time.perf_counter() - t0
    finally:
        unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds = saved
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    finite = bool(torch.isfinite(out_k).all() and torch.isfinite(out_p).all())
    ok = finite and rel <= UNET_REL_L2
    emit({"phase": "unet_forward", "ok": ok, "frames": n, "latent": [h, h], "rel_l2": rel,
          "bar": UNET_REL_L2, "finite": finite, "kernels_s": kernel_s, "plain_s": plain_s,
          "out_std": out_k.std().item()})
    if not ok:
        raise AssertionError("UNet forward through the kernels disagrees with the plain path")


def run_main_path(bundle) -> dict:
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer, preprocess_basic

    img = np.random.default_rng(SEED).integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    renderer = HeadlessRenderer(bundle, work_dir=None)
    pre = preprocess_basic(img, RES)
    plan = renderer.prepare(pre, seed=SEED, preset_traj="orbit", num_frames=NUM_TARGETS,
                            num_steps=NUM_STEPS)
    emit({"phase": "main_path_plan", "cuts": {
        "num_steps": f"{NUM_STEPS} (released default 50)",
        "num_targets": NUM_TARGETS,
        "weights": "random bf16 (flax-default init, seed 0), full width",
        "outputs": "kept in memory, no PNG/mp4 writes",
    }, "T": plan["version"].T, "anchors": len(plan["image_cond"]["prior_indices"]),
        "first_pass_chunks": plan["first_pass_chunks"], "second_pass_chunks": plan["second_pass_chunks"]})

    torch.cuda.synchronize()
    _kernels.reset_counts()
    t0 = time.perf_counter()
    gen = renderer.run(plan)
    anchors = next(gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    frames = next(gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _kernels.counts()

    ok = (
        frames.dtype == np.uint8
        and frames.shape == (NUM_TARGETS, RES, RES, 3)
        and anchors.shape[1:] == (RES, RES, 3)
        and float(frames.std()) > 0.0
        and all(c > 0 for c in counts.values())
    )
    emit({"phase": "main_path", "ok": ok, "frames": list(frames.shape), "dtype": str(frames.dtype),
          "anchor_frames": list(anchors.shape), "frame_std": float(frames.std()),
          "first_pass_s": t1 - t0, "second_pass_s": t2 - t1, "launches": counts})
    if not ok:
        raise AssertionError("main path output or kernel launch counts are wrong")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from stable_virtual_camera_tpu_torch import _kernels
        from stable_virtual_camera_tpu_torch.config import SevaSpec
        from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec
        from stable_virtual_camera_tpu_torch.models.io import random_bundle
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from the repository root",
              file=sys.stderr)
        return 2

    # fp32 comparisons stay fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)

    t0 = time.perf_counter()
    _kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [k.library().name for k in _kernels.KERNELS.values()]})

    failures: list[str] = []
    results: dict = {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for key, fn in (("flash_attention", check_k1), ("time_attention", check_k2)):
        try:
            results[key] = fn(gen)
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failures.append(key)

    counts = {}
    try:
        t0 = time.perf_counter()
        bundle = random_bundle(SevaSpec(), ClipVisionSpec(), dtype=torch.bfloat16, device=DEVICE,
                               generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        torch.cuda.synchronize()
        emit({"phase": "weights", "seconds": time.perf_counter() - t0,
              "unet_params": sum(p.numel() for p in bundle.unet.parameters())})
        for key, fn in (("unet_forward", lambda: check_unet(bundle, gen)),
                        ("main_path", lambda: run_main_path(bundle))):
            try:
                out = fn()
                if key == "main_path":
                    counts = out
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                failures.append(key)
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        failures.append("weights")

    replaces = {
        "flash_attention": "stable_virtual_camera_tpu/ops/flash_upstream.py:74",
        "time_attention": "stable_virtual_camera_tpu/ops/time_attention.py:134",
    }
    emit({"kernels": [
        {
            "name": k.name,
            "route": "cuda",
            "source": f"stable_virtual_camera_tpu_torch/csrc/{k.name}.cu",
            "replaces": replaces[k.name],
            "launches": counts.get(k.name, 0),
            "max_abs_err": results.get(k.name, {}).get("max_abs_err"),
            "ms": results.get(k.name, {}).get("ms"),
            "plain_ms": results.get(k.name, {}).get("plain_ms"),
        }
        for k in _kernels.KERNELS.values()
    ]})
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
