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
  4. `k1_bwd` and `k1_lse`: K1-dKV and K1-dQ against the plain backward, and
     K1's log-sum-exp against the plain one, at every self-attention shape
     of a 576x576 training chunk (T=21, b=1);
  5. `k3_flash_attention` and `k4_flash_packed`: K3 ((B, L, H, 64) layout)
     and K4 (packed (B, L, W) layout) against their plain versions at the
     self-attention shapes of a 576x576 render they take, on the split-qkv
     views the UNet's generic path passes;
  6. one full-width SevaUNet forward (bf16 random weights, 42 frames,
     576x576) through the kernels and through the plain versions, then
     `unet_forward_backends`: the same with attention="flash" (K3) and
     "packed" (K4);
  7. the render path: HeadlessRenderer.render in Basic mode at full width
     (SevaSpec(), ClipVisionSpec(), SD2.1 VAE, bf16 random weights) on one
     seeded 576x576 image along the `orbit` preset, both passes, with the
     kernels' launch counts read around it;
  8. `cli_path`: the demo CLI (apps/cli.main) at full width with
     --random_model full, three renders with their outputs written to a
     temporary directory: img2trajvid on the golden scene with the
     trajectory prior and attention="flash", img2trajvid_s-prob from a
     seeded 576x576 PNG along the orbit with attention="packed", and
     single-pass img2img on the golden scene with the default attention;
  9. `train_grad`: one full-width loss and backward (T=21, 576x576) through
     the kernels, with per-block and whole-network rematerialisation, and
     through the plain versions, with peak memory;
 10. `train_profile`: the device time of one train step by kernel class;
 11. the training path, `train_path`: the train CLI's loop
     (apps/train_cli.train) at full width on an in-memory scene, then one
     LoRA step, with checkpoint round trips and the kernels' launch counts
     read around it;
 12. `k5_layer_norm`: K5 (LayerNorm with one-pass fp32 statistics) against
     its plain version at the probe's shape (42*5184, 320) bf16 and at
     widths 640 and 1280 with ragged row counts, with torch's layer_norm as
     the one-call yardstick, then the probe's own loop (32 dependent
     LayerNorms) with its launch count;
 13. `global_align_synthetic`: the port's global alignment on the card (500
     Adam steps, cosine schedule) over a known scene built here (8 images,
     384x512 maps, 56 edges, each with its own scale), with the recovery
     bars of the JAX package's test at noise 0, then torch.profiler over 5
     steps at 56 edges and at 6 (three images, the Advanced path's size);
 14. `dust3r_forward`: the DUSt3R stereo network at full width
     (Dust3rSpec(), seeded random fp32 weights) on one batch of 512x384
     pairs: parameters, seconds per pair, peak memory, output ranges;
 15. `advanced_path`: the GUI's Advanced mode at full width: three seeded
     512x384 PNGs through NativeDust3rPipeline (6 pairs, 500 alignment
     steps) and preprocess_advanced (768x576), a keyframe trajectory
     through the recovered poses (20 targets), and HeadlessRenderer's two
     passes, with K1/K2 launch counts read around the render and the peak
     memory of a chunk's VAE decode at 768x576;
 16. `k1_k2_path_shapes`: K1 and K2 against their plain versions at every
     shape the two render paths gave them (noted around each render) that
     phases 2 and 3 did not hold: the first passes' shorter chunks and all
     of the Advanced path's 768x576 shapes;
then a `kernels` summary line and the final `ok` line.
Every phase prints one JSON line. Cuts against a real render, the CLI, a
real fine-tune and the Advanced mode are printed in phases 7, 8, 11 and 15. Any failed phase exits
non-zero without the final line; so does a machine with no CUDA device, or a
directory without the port.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
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
# the shapes K4 takes (W = 64 H, W % 128 == 0); the 5-head level goes to K3
K4_SHAPES = [(L, B, H) for L, B, H in K1_SHAPES if (64 * H) % 128 == 0]
# (S, H) time-mix shapes at 576x576 (ds1, ds2, ds4, ds8)
K2_SHAPES = [(5184, 5), (1296, 10), (324, 20), (81, 20)]
K1_MAX_ABS, K1_MEAN_ABS = 2e-2, 2e-3
# K2 keeps fp32 throughout and rounds only its output: one bf16 step at the
# output's magnitude (8e-3 while |o| < 2, as at T=21; a T=3 chunk reaches 4)
K2_BF16_STEPS = 1.0
UNET_REL_L2 = 3e-2
# training: T=21 frames of one scene, (L, B, H) of every self-attention
TRAIN_T = 21
K1_TRAIN_SHAPES = [(5184, 21, 5), (1296, 21, 10), (27216, 1, 10), (6804, 1, 20), (1701, 1, 20)]
K1_LSE_MAX_ABS = 1e-2
K1_BWD_REL_L2 = 2e-2  # P and dS rounded to bf16 for the products, bf16 outputs
TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2 = 1e-2, 5e-2
REMAT_LOSS_REL, REMAT_GRAD_REL_L2 = 1e-6, 1e-3
TRAIN_STEPS, TRAIN_INPUTS, TRAIN_LR, LORA_RANK = 4, 3, 1e-3, 16
# the kernels of the training path (K3's backward is a plain recompute and
# K4 has none, so the backends other than "upstream" do not train here)
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "time_attention")
# K5's probe shape: LayerNorm over (42 * 5184, 320) bf16 rows, then the
# UNet's other widths with ragged row counts; the probe's loop length
LN_SHAPES = [(42 * 5184, 320), (42 * 1296 + 7, 640), (42 * 324 + 5, 1280)]
LN_PROBE_ITERS = 32
# Advanced mode: DUSt3R at 512x384, 500 alignment steps, render at 768x576
ADV_W, ADV_H, ADV_IMAGES, ADV_SHORTER = 512, 384, 3, 576
ALIGN_STEPS = 500
# the synthetic alignment scene: 8 images of 384x512, every ordered pair
SCENE_N, SCENE_H, SCENE_W = 8, 384, 512
REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "assets", "golden_scene")
# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take for this work, and which
    of the two rates bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sum_bounds(rows: list[dict], prefix: str = "") -> tuple[float, str]:
    """The summed bound of several calls, and the rate that bounds most of it."""
    ms = sum(r[prefix + "bound_ms"] for r in rows)
    ops = sum(r[prefix + "bound_ms"] for r in rows if r[prefix + "bound_by"] == "operations")
    return ms, ("operations" if ops >= ms / 2 else "bytes")


def k1_row(gen, L: int, B: int, H: int) -> dict:
    """K1 against its plain version at one (L, B, H), with times, SDPA as
    the one-call yardstick, and the bound."""
    import torch

    from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
        flash_attention_cuda,
        flash_attention_plain,
    )

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
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 10),
    }
    flops = 4.0 * L * L * 64 * H * B
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    row["bound_ms"], row["bound_by"] = bound(flops, 4 * B * H * L * 64 * 2)
    del qkv, q, k, v, out, ref, diff
    torch.cuda.empty_cache()
    return row


def k1_ok(row: dict) -> bool:
    return row["finite"] and row["max_abs_err"] <= K1_MAX_ABS and row["mean_abs_err"] <= K1_MEAN_ABS


def k2_ok(row: dict) -> bool:
    return row["finite"] and row["max_bf16_steps"] <= K2_BF16_STEPS


def summary(rows: list[dict]) -> dict:
    """The sums over several shapes that the `kernels` line carries."""
    bound_ms, bound_by = sum_bounds(rows)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms")},
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_k1(gen) -> dict:
    rows = [k1_row(gen, *shape) for shape in K1_SHAPES]
    ok = all(k1_ok(r) for r in rows)
    emit({"phase": "k1_flash_attention", "ok": ok, "bar": {"max_abs": K1_MAX_ABS, "mean_abs": K1_MEAN_ABS},
          "shapes": rows})
    if not ok:
        raise AssertionError("K1 disagrees with its plain version")
    return {**summary(rows), "library": "torch.nn.functional.scaled_dot_product_attention on the same views"}


def k2_row(gen, S: int, H: int, num_frames: int = T, b: int = 2) -> dict:
    """K2 against its plain version at one (S, H, T, b), with times, SDPA
    on permuted views as the one-call yardstick, and the bound."""
    import torch

    from stable_virtual_camera_tpu_torch.ops.time_attention import (
        time_attention_cuda,
        time_attention_plain,
    )

    # the UNet's layout: (b*T, H, 64, S) views of a (b*T, 3, H, 64, S) projection
    qkv = torch.randn((b * num_frames, 3, H, 64, S), generator=gen, device=DEVICE).to(torch.bfloat16)
    q, k, v = qkv.unbind(1)
    out = time_attention_cuda(q, k, v, num_frames).float()
    ref = time_attention_plain(q, k, v, num_frames).float()
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    row = {
        "S": S, "H": H, "T": num_frames, "b": b,
        "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
        "max_bf16_steps": bf16_steps(out, ref),
        "finite": bool(torch.isfinite(out).all()),
        "ms": cuda_ms(lambda: time_attention_cuda(q, k, v, num_frames), 10),
        "plain_ms": cuda_ms(lambda: time_attention_plain(q, k, v, num_frames), 3),
        "library_ms": cuda_ms(lambda: time_sdpa(q, k, v, num_frames), 10),
    }
    # q, k, v read once, o written once; 4 T^2 64 fp32 FLOP per (scene,
    # position, head)
    row["bound_ms"], row["bound_by"] = bound(4.0 * num_frames * num_frames * 64 * b * S * H,
                                             4 * b * num_frames * H * 64 * S * 2)
    return row


def check_k2(gen) -> dict:
    rows = [k2_row(gen, S, H) for S, H in K2_SHAPES]
    ok = all(k2_ok(r) for r in rows)
    emit({"phase": "k2_time_attention", "ok": ok, "bar": {"bf16_steps": K2_BF16_STEPS}, "shapes": rows})
    if not ok:
        raise AssertionError("K2 disagrees with its plain version")
    return {**summary(rows),
            "library": "scaled_dot_product_attention on (b, S, H, T, 64) permuted views; their "
                       "head dim is strided, so the call includes the copy it makes"}


def time_sdpa(q, k, v, num_frames: int):
    """K2's function as one PyTorch call: SDPA over the frame axis on
    permuted views of the (b*T, H, 64, S) operands."""
    import torch

    BT, H, D, S = q.shape

    def view(t):
        return t.view(BT // num_frames, num_frames, H, D, S).permute(0, 4, 2, 1, 3)

    return torch.nn.functional.scaled_dot_product_attention(view(q), view(k), view(v))


def check_layout_kernel(gen, name: str) -> dict:
    """K3 ("blhd") or K4 ("packed") against its plain version on the
    split-qkv views of a (B, L, 3 W) projection, with SDPA on (B, H, L, 64)
    views of the same tensors as the one-call yardstick."""
    import torch

    from stable_virtual_camera_tpu_torch.ops import flash_attention as fa
    from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as fap

    rows, worst = [], 0.0
    for L, B, H in (K1_SHAPES if name == "blhd" else K4_SHAPES):
        qkv = torch.randn((B, L, 3 * H * 64), generator=gen, device=DEVICE).to(torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        if name == "blhd":
            q, k, v = (t.view(B, L, H, 64) for t in (q, k, v))
            kernel, plain = (lambda: fa.flash_attention_cuda(q, k, v)), (lambda: fa.flash_attention_plain(q, k, v))
            bhld = [t.transpose(1, 2) for t in (q, k, v)]
        else:
            kernel = lambda: fap.flash_attention_packed_cuda(q, k, v, H)  # noqa: E731
            plain = lambda: fap.flash_attention_packed_plain(q, k, v, H)  # noqa: E731
            bhld = [t.view(B, L, H, 64).transpose(1, 2) for t in (q, k, v)]
        out = kernel().float()
        ref = plain().float()
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        row = {
            "L": L, "B": B, "H": H,
            "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
            "finite": bool(torch.isfinite(out).all()),
            "ms": cuda_ms(kernel, 10),
            "plain_ms": cuda_ms(plain, 2),
            "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*bhld), 10),
        }
        flops = 4.0 * L * L * 64 * H * B
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        row["bound_ms"], row["bound_by"] = bound(flops, 4 * B * H * L * 64 * 2)
        rows.append(row)
        worst = max(worst, row["max_abs_err"])
        del qkv, q, k, v, bhld, out, ref, diff
        torch.cuda.empty_cache()
    ok = all(r["finite"] and r["max_abs_err"] <= K1_MAX_ABS and r["mean_abs_err"] <= K1_MEAN_ABS for r in rows)
    phase = "k3_flash_attention" if name == "blhd" else "k4_flash_packed"
    emit({"phase": phase, "ok": ok, "bar": {"max_abs": K1_MAX_ABS, "mean_abs": K1_MEAN_ABS},
          "shapes": rows})
    if not ok:
        raise AssertionError(f"{phase}: the kernel disagrees with its plain version")
    bound_ms, bound_by = sum_bounds(rows)
    return {"max_abs_err": worst, "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(r["library_ms"] for r in rows),
            "library": "torch.nn.functional.scaled_dot_product_attention on (B, H, L, 64) views "
                       "of the same split-qkv tensors"}


def check_k1_bwd(gen) -> dict:
    """K1's LSE and K1-dKV / K1-dQ against the plain versions at the
    training shapes, with the SDPA backward as the one-call yardstick."""
    import torch

    from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
        flash_attention_bwd_dkv_cuda,
        flash_attention_bwd_dq_cuda,
        flash_attention_bwd_plain,
        flash_attention_cuda,
        flash_attention_plain,
    )

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    rows = []
    for L, B, H in K1_TRAIN_SHAPES:
        qkv = torch.randn((B, L, 3, H, 64), generator=gen, device=DEVICE).to(torch.bfloat16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        do = torch.randn((B, L, H, 64), generator=gen, device=DEVICE).to(torch.bfloat16).transpose(1, 2)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)
        _, lse_ref = flash_attention_plain(q, k, v, return_lse=True)
        delta = (o.float() * do.float()).sum(-1)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
        dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
        pq, pk, pv = flash_attention_bwd_plain(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        row = {
            "L": L, "B": B, "H": H,
            "lse_max_abs_err": (lse - lse_ref).abs().max().item(),
            "rel_l2": {"dq": rel(dq, pq), "dk": rel(dk, pk), "dv": rel(dv, pv)},
            "max_abs_err": {"dq": (dq.float() - pq.float()).abs().max().item(),
                            "dkv": max((dk.float() - pk.float()).abs().max().item(),
                                       (dv.float() - pv.float()).abs().max().item())},
            "finite": bool(all(torch.isfinite(t).all() for t in (dq, dk, dv, lse))),
            "fwd_lse_ms": cuda_ms(lambda: flash_attention_cuda(q, k, v, return_lse=True), 5),
            "dkv_ms": cuda_ms(lambda: flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta), 5),
            "dq_ms": cuda_ms(lambda: flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta), 5),
            "plain_ms": cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do), 1),
        }
        del pq, pk, pv, dq, dk, dv
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        row["sdpa_bwd_ms"] = cuda_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 5)
        del out, leaves
        n = 64 * B * H
        row["tflops"] = 14.0 * L * L * n / ((row["dkv_ms"] + row["dq_ms"]) * 1e-3) / 1e12
        # K1-dKV: S, dP, dV, dK products; reads q k v dO lse D, writes dk dv.
        # K1-dQ: S, dP, dQ; reads the same, writes dq.
        row["dkv_bound_ms"], row["dkv_bound_by"] = bound(8.0 * L * L * n,
                                                         (6 * L * 64 * 2 + 2 * L * 4) * B * H)
        row["dq_bound_ms"], row["dq_bound_by"] = bound(6.0 * L * L * n,
                                                       (5 * L * 64 * 2 + 2 * L * 4) * B * H)
        rows.append(row)
        del qkv, q, k, v, do, o, lse, lse_ref, delta
        torch.cuda.empty_cache()
    lse_ok = all(r["finite"] and r["lse_max_abs_err"] <= K1_LSE_MAX_ABS for r in rows)
    emit({"phase": "k1_lse", "ok": lse_ok, "bar": {"max_abs": K1_LSE_MAX_ABS},
          "shapes": [{k: r[k] for k in ("L", "B", "H", "lse_max_abs_err", "fwd_lse_ms")} for r in rows]})
    bwd_ok = all(r["finite"] and max(r["rel_l2"].values()) <= K1_BWD_REL_L2 for r in rows)
    emit({"phase": "k1_bwd", "ok": bwd_ok, "bar": {"rel_l2": K1_BWD_REL_L2},
          "shapes": [{k: v for k, v in r.items() if k != "fwd_lse_ms"} for r in rows]})
    if not (lse_ok and bwd_ok):
        raise AssertionError("K1's LSE or its backward kernels disagree with the plain versions")
    plain_ms = sum(r["plain_ms"] for r in rows)
    sdpa_ms = sum(r["sdpa_bwd_ms"] for r in rows)
    common = {"plain_ms": plain_ms, "library_ms": sdpa_ms,
              "plain_and_library_cover": "K1-dKV and K1-dQ together (the plain backward and the "
                                         "SDPA backward each compute dq, dk and dv)"}
    out = {}
    for name, part in (("flash_attention_bwd_dkv", "dkv"), ("flash_attention_bwd_dq", "dq")):
        bound_ms, bound_by = sum_bounds(rows, f"{part}_")
        out[name] = {"max_abs_err": max(r["max_abs_err"][part] for r in rows),
                     "ms": sum(r[f"{part}_ms"] for r in rows),
                     "bound_ms": bound_ms, "bound_by": bound_by, **common}
    return out


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
    return {"inputs": (x, t_idx, ctx, dense), "kernels_s": kernel_s, "out": out_k}


def set_attention(unet, name: str) -> None:
    """Switch every self-attention of `unet` to the backend `name` (the
    weights do not depend on it)."""
    from stable_virtual_camera_tpu_torch.models.unet import SelfAttention

    for m in unet.modules():
        if isinstance(m, SelfAttention):
            m.attention = name


def check_unet_backends(bundle, upstream: dict) -> None:
    """The full-width forward of `check_unet` with attention="flash" (K3)
    and "packed" (K4), each through the kernels and through the plain
    versions of K3, K4 and K2, beside the upstream (K1) forward's time."""
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.models import unet as unet_mod
    from stable_virtual_camera_tpu_torch.ops import flash_attention as fa
    from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as fap
    from stable_virtual_camera_tpu_torch.ops.time_attention import time_attention_plain

    x, t_idx, ctx, dense = upstream["inputs"]

    def forward():
        with torch.inference_mode():
            out = bundle.unet(x, t_idx, ctx, dense, T)
        torch.cuda.synchronize()
        return out

    rows, ok = {}, True
    try:
        for name in ("flash", "packed"):
            set_attention(bundle.unet, name)
            forward()  # warm-up
            _kernels.reset_counts()
            t0 = time.perf_counter()
            out_k = forward()
            kernel_s = time.perf_counter() - t0
            launches = _kernels.counts()
            saved = fa.flash_attention, fap.flash_attention_packed, unet_mod.time_attention_bhds
            fa.flash_attention = fa.flash_attention_plain
            fap.flash_attention_packed = fap.flash_attention_packed_plain
            unet_mod.time_attention_bhds = time_attention_plain
            try:
                t0 = time.perf_counter()
                out_p = forward()
                plain_s = time.perf_counter() - t0
            finally:
                fa.flash_attention, fap.flash_attention_packed, unet_mod.time_attention_bhds = saved
            rel = ((out_k - out_p).norm() / out_p.norm()).item()
            finite = bool(torch.isfinite(out_k).all() and torch.isfinite(out_p).all())
            want = ["flash_attention_blhd"] + (["flash_attention_packed"] if name == "packed" else [])
            routed = launches["flash_attention"] == 0 and all(launches[k] > 0 for k in want)
            rows[name] = {"rel_l2": rel, "finite": finite, "kernels_s": kernel_s, "plain_s": plain_s,
                          "rel_l2_vs_upstream": ((out_k - upstream["out"]).norm()
                                                 / upstream["out"].norm()).item(),
                          "launches": launches}
            ok = ok and finite and rel <= UNET_REL_L2 and routed
            del out_k, out_p
    finally:
        set_attention(bundle.unet, "upstream")
    emit({"phase": "unet_forward_backends", "ok": ok, "frames": 2 * T, "bar": UNET_REL_L2,
          "upstream_kernels_s": upstream["kernels_s"], **rows})
    if not ok:
        raise AssertionError("a UNet attention backend disagrees with its plain path or missed its kernel")


@contextlib.contextmanager
def recording_shapes(shapes: dict):
    """Note the shape of every call the UNet makes to K1, as (L, B, H), and
    to K2, as (S, H, T, b), in `shapes`; the calls go on to the kernels."""
    from stable_virtual_camera_tpu_torch.models import unet as unet_mod

    k1, k2 = unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds

    def k1_noted(q, k, v):
        B, H, L, _ = q.shape
        shapes.setdefault("flash_attention", set()).add((L, B, H))
        return k1(q, k, v)

    def k2_noted(q, k, v, num_frames):
        BT, H, _, S = q.shape
        shapes.setdefault("time_attention", set()).add((S, H, num_frames, BT // num_frames))
        return k2(q, k, v, num_frames)

    unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds = k1_noted, k2_noted
    try:
        yield shapes
    finally:
        unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds = k1, k2


def check_path_shapes(gen, recorded: dict) -> dict:
    """K1 and K2 against their plain versions, at the bars of their phases,
    at every shape a render path gave them that those phases did not hold
    already: the first passes' shorter chunks, and every shape of the
    Advanced path at 768x576. Returns each kernel's sums per path."""
    held = {"flash_attention": set(K1_SHAPES), "time_attention": {(S, H, T, 2) for S, H in K2_SHAPES}}
    row_of = {"flash_attention": k1_row, "time_attention": k2_row}
    ok_of = {"flash_attention": k1_ok, "time_attention": k2_ok}
    rows: dict = {}
    for path, shapes in recorded.items():
        for name in ("flash_attention", "time_attention"):
            todo = sorted(shapes.get(name, set()) - held[name], reverse=True)
            rows.setdefault(name, {})[path] = [row_of[name](gen, *shape) for shape in todo]
    ok = all(ok_of[name](r) for name, by_path in rows.items() for rs in by_path.values() for r in rs)
    emit({"phase": "k1_k2_path_shapes", "ok": ok,
          "bar": {"flash_attention": {"max_abs": K1_MAX_ABS, "mean_abs": K1_MEAN_ABS},
                  "time_attention": {"bf16_steps": K2_BF16_STEPS}},
          "recorded": {path: {name: sorted(map(list, shapes.get(name, ())), reverse=True)
                              for name in ("flash_attention", "time_attention")}
                       for path, shapes in recorded.items()},
          "shapes": rows})
    if not ok:
        raise AssertionError("K1 or K2 disagrees with its plain version at a render path's shape")
    return {name: {path: {"shapes": len(rs), **summary(rs)} for path, rs in by_path.items() if rs}
            for name, by_path in rows.items()}


def run_main_path(bundle, shapes: dict) -> dict:
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
    with recording_shapes(shapes):
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
        and counts["flash_attention"] > 0 and counts["time_attention"] > 0
        and counts["flash_attention_blhd"] == 0 and counts["flash_attention_packed"] == 0
    )
    emit({"phase": "main_path", "ok": ok, "frames": list(frames.shape), "dtype": str(frames.dtype),
          "anchor_frames": list(anchors.shape), "frame_std": float(frames.std()),
          "first_pass_s": t1 - t0, "second_pass_s": t2 - t1, "launches": counts})
    if not ok:
        raise AssertionError("main path output or kernel launch counts are wrong")
    return counts


def run_cli_path() -> dict:
    """The demo CLI at full width: three renders through apps.cli.main, each
    with its own --random_model full bundle, outputs in a temporary
    directory, launch counts read around each. Returns the counts summed
    over the three runs."""
    import cv2
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps import cli
    from stable_virtual_camera_tpu_torch.engine.runner import SceneEngine

    marks: list[float] = []

    class TimedEngine(SceneEngine):
        """SceneEngine that notes the wall time at each pass's end."""

        def run_one_scene(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for out in super().run_one_scene(*args, **kwargs):
                torch.cuda.synchronize()
                marks.append(time.perf_counter() - t0)
                yield out

    runs = [
        # (name, task, scene dir or None for the seeded PNG, kwargs, targets, inputs,
        #  kernels that must run, kernels that must not)
        ("img2trajvid_flash", "img2trajvid", GOLDEN,
         dict(use_traj_prior=True, attention="flash"), 2, 1,
         ("flash_attention_blhd", "time_attention"), ("flash_attention", "flash_attention_packed")),
        ("img2trajvid_s-prob_packed", "img2trajvid_s-prob", None,
         dict(use_traj_prior=True, attention="packed", traj_prior="orbit", num_targets=NUM_TARGETS),
         NUM_TARGETS, 1, ("flash_attention_packed", "flash_attention_blhd", "time_attention"),
         ("flash_attention",)),
        ("img2img_single_pass", "img2img", GOLDEN, dict(use_traj_prior=False), 2, 1,
         ("flash_attention", "time_attention"), ("flash_attention_blhd", "flash_attention_packed")),
    ]
    total: dict[str, int] = {}
    results, ok = {}, True
    saved_engine = cli.SceneEngine
    cli.SceneEngine = TimedEngine
    try:
        with tempfile.TemporaryDirectory() as tmp:
            png_dir = os.path.join(tmp, "s-prob")
            os.makedirs(png_dir)
            img = np.random.default_rng(SEED).integers(0, 256, (RES, RES, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(png_dir, "seeded.png"), img)
            for name, task, data, kw, n_targets, n_inputs, must, must_not in runs:
                marks.clear()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                _kernels.reset_counts()
                t0 = time.perf_counter()
                (out_dir,) = cli.main(data or png_dir, task=task, random_model="full",
                                      work_dir=os.path.join(tmp, "work"), num_steps=NUM_STEPS,
                                      device=DEVICE, sampler_verbose=False, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _kernels.counts()
                for k, c in counts.items():
                    total[k] = total.get(k, 0) + c
                pngs = sorted(f for f in os.listdir(os.path.join(out_dir, "samples-rgb")) if f.endswith(".png"))
                frames = np.stack([cv2.imread(os.path.join(out_dir, "samples-rgb", f))[..., ::-1]
                                   for f in pngs]) if pngs else np.zeros((0,))
                with open(os.path.join(out_dir, "transforms.json")) as f:
                    n_frames = len(json.load(f)["frames"])
                run_ok = (
                    os.path.exists(os.path.join(out_dir, "samples-rgb.mp4"))
                    and len(pngs) == n_targets
                    and n_frames == n_inputs + n_targets
                    and frames.shape[1:] == (RES, RES, 3)
                    and float(frames.std()) > 0.0
                    and all(counts[k] > 0 for k in must)
                    and all(counts[k] == 0 for k in must_not)
                )
                ok = ok and run_ok
                passes = (
                    {"first_pass_s": marks[0], "second_pass_s": marks[1] - marks[0]}
                    if len(marks) == 2 else {"single_pass_s": marks[0] if marks else None}
                )
                results[name] = {"ok": run_ok, "task": task, **{k: v for k, v in kw.items()},
                                 **passes, "main_wall_s": wall, "targets": len(pngs),
                                 "transforms_frames": n_frames, "frames": list(frames.shape),
                                 "frame_std": float(frames.std()) if frames.size else 0.0,
                                 "launches": counts}
    finally:
        cli.SceneEngine = saved_engine
    emit({"phase": "cli_path", "ok": ok, "runs": results, "cuts": {
        "num_steps": f"{NUM_STEPS} (CLI default 50)",
        "weights": "--random_model full: random bf16 (flax-default init, seed 0), full width",
        "scenes": "assets/golden_scene (one input, two 64x64 targets, upscaled to 576x576); "
                  f"one seeded {RES}x{RES} PNG with num_targets={NUM_TARGETS}",
        "main_wall_s": "includes building the run's random bundle",
    }})
    if not ok:
        raise AssertionError("the CLI path's outputs or launch counts are wrong")
    return total


def bf16_steps(out, ref):
    """|out - ref| in units of one bf16 step (the spacing of bf16 values at
    |ref|, at least 2^-17, so that the fp32 rounding of two sum orders near
    zero does not count as a step)."""
    import torch

    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0**-10))) - 7)
    return ((out - ref).abs() / step).max().item()


def check_k5_layer_norm(gen) -> dict:
    """K5 against its plain version at the probe's shape and at the UNet's
    wider widths with ragged rows, with F.layer_norm as the one-call
    yardstick; then the probe's loop (benchmark/ln_probe.py `make`: 32
    dependent LayerNorms, h <- LN(h) + 1e-3 h) with its launches counted."""
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.ops.layer_norm import ln_fused, ln_reduce

    rows = []
    for R, C in LN_SHAPES:
        x = torch.randn((R, C), generator=gen, device=DEVICE).to(torch.bfloat16)
        g = (1.0 + 0.1 * torch.randn((C,), generator=gen, device=DEVICE)).to(torch.bfloat16)
        b = (0.1 * torch.randn((C,), generator=gen, device=DEVICE)).to(torch.bfloat16)
        out = ln_fused(x, g, b).float()
        ref = ln_reduce(x, g, b).float()
        torch.cuda.synchronize()
        row = {"rows": R, "C": C, "max_abs_err": (out - ref).abs().max().item(),
               "max_bf16_steps": bf16_steps(out, ref), "finite": bool(torch.isfinite(out).all()),
               "ms": cuda_ms(lambda: ln_fused(x, g, b), 50),
               "plain_ms": cuda_ms(lambda: ln_reduce(x, g, b), 20),
               "library_ms": cuda_ms(lambda: torch.nn.functional.layer_norm(x, (C,), g, b), 50)}
        # x read and y written once, gamma and beta read once; ~8 fp32
        # operations an element (sum, square-sum, subtract, two multiplies, add)
        row["bound_ms"], row["bound_by"] = bound(8.0 * R * C, 2 * R * C * 2 + 2 * C * 2, PEAK_FP32_FLOPS)
        row["gb_per_s"] = (2 * R * C * 2) / (row["ms"] * 1e-3) / 1e9
        rows.append(row)
        del x, out, ref
    # the probe's loop at its shape, on the port's kernel
    R, C = LN_SHAPES[0]
    h = torch.randn((R, C), generator=gen, device=DEVICE).to(torch.bfloat16)
    g = torch.ones((C,), device=DEVICE, dtype=torch.bfloat16)
    b = torch.zeros((C,), device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LN_PROBE_ITERS):
        h = ln_fused(h, g, b) + h * 1e-3
    end.record()
    torch.cuda.synchronize()
    counts = _kernels.counts()
    probe = {"iterations": LN_PROBE_ITERS, "ms_per_iteration": start.elapsed_time(end) / LN_PROBE_ITERS,
             "finite": bool(torch.isfinite(h).all()), "launches": counts}
    ok = (all(r["finite"] and r["max_bf16_steps"] <= 1.0 for r in rows) and probe["finite"]
          and counts["layer_norm"] == LN_PROBE_ITERS)
    emit({"phase": "k5_layer_norm", "ok": ok, "bar": {"bf16_steps": 1.0}, "dtype": "bfloat16",
          "shapes": rows, "probe_loop": probe,
          "library": "torch.nn.functional.layer_norm (two-pass variance, bf16 in and out)"})
    if not ok:
        raise AssertionError("K5 disagrees with its plain version or missed its launches")
    first = rows[0]
    return {"result": {k: first[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms")} | {"shape": [first["rows"], first["C"]],
                                                               "library": "torch.nn.functional.layer_norm"},
            "counts": counts}


def lookat_c2w(pos):
    """OpenCV-convention c2w (+z forward) at `pos` looking at the origin."""
    import numpy as np

    pos = np.asarray(pos, np.float64)
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    c2w[:3, 3] = pos
    return c2w


def synthetic_scene(N: int, H: int, W: int, seed: int = SEED):
    """A known scene in the stereo network's output contract (the
    construction of tests/test_global_alignment.py, scaled to H x W): cameras
    on an arc looking at the origin, smooth per-image depth, and for every
    ordered pair (i, j) both pointmaps in camera i's frame at a random
    per-edge scale, with confidences in [1, 10]. Returns (EdgePreds, c2ws,
    focal, world points)."""
    import numpy as np

    from stable_virtual_camera_tpu_torch.core.global_alignment import EdgePreds

    rng = np.random.default_rng(seed)
    f = 40.0 * W / 32  # the test's field of view
    c2ws = np.stack([lookat_c2w((4 * np.sin(t), 0.7 * np.sin(2 * t), -4 * np.cos(t)))
                     for t in np.linspace(-0.5, 0.5, N)])
    uu, vv = np.meshgrid(np.arange(W) + 0.5 - W / 2, np.arange(H) + 0.5 - H / 2)
    dirs = np.stack([uu / f, vv / f, np.ones_like(uu)], -1)
    depth = 3.0 + 0.5 * np.sin(np.linspace(0, 2 * np.pi, W)[None, :] + np.linspace(0, np.pi, H)[:, None])
    world = np.stack([np.einsum("ab,hwb->hwa", c2ws[n, :3, :3], (depth + 0.1 * n)[..., None] * dirs)
                      + c2ws[n, :3, 3] for n in range(N)])
    w2cs = np.linalg.inv(c2ws)
    pairs = [(i, j) for i in range(N) for j in range(N) if i != j]
    pts1, pts2 = np.empty((2, len(pairs), H, W, 3), np.float32)
    for e, (i, j) in enumerate(pairs):
        kappa = rng.uniform(0.5, 2.0)
        pts1[e] = kappa * (world[i] @ w2cs[i, :3, :3].T + w2cs[i, :3, 3])
        pts2[e] = kappa * (world[j] @ w2cs[i, :3, :3].T + w2cs[i, :3, 3])
    conf = rng.uniform(1.0, 10.0, (2, len(pairs), H, W)).astype(np.float32)
    edges = EdgePreds(i_idx=np.array([i for i, _ in pairs]), j_idx=np.array([j for _, j in pairs]),
                      pts1=pts1, conf1=conf[0], pts2=pts2, conf2=conf[1])
    return edges, c2ws, f, world


def scene_errors(scene, c2ws_gt, f_gt, world_gt) -> dict:
    """Recovery errors after the similarity that best maps the recovered
    camera centers onto the true ones (tests/test_global_alignment.py)."""
    import numpy as np

    from stable_virtual_camera_tpu_torch.core.global_alignment import weighted_umeyama

    rec = scene.c2ws.astype(np.float64)
    s, R, t = weighted_umeyama(rec[:, :3, 3], c2ws_gt[:, :3, 3], np.ones(len(rec)))
    centers = s * rec[:, :3, 3] @ R.T + t
    rots = np.einsum("ab,nbc->nac", R, rec[:, :3, :3])
    angles = [np.degrees(np.arccos(np.clip((np.trace(rots[n].T @ c2ws_gt[n, :3, :3]) - 1) / 2, -1, 1)))
              for n in range(len(rec))]
    pts = scene.pts3d.astype(np.float64) @ R.T * s + t
    return {"center_max_abs_err": float(np.abs(centers - c2ws_gt[:, :3, 3]).max()),
            "rotation_max_deg": float(max(angles)),
            "focal_max_rel_err": float(np.abs(scene.Ks[:, 0, 0] / f_gt - 1).max()),
            "point_median_err": float(np.median(np.linalg.norm(pts - world_gt, axis=-1)))}


def profile_alignment_steps(params: dict, data: dict, steps: int = 5) -> dict:
    """torch.profiler over `steps` alignment steps (loss, backward, Adam):
    device time and kernel launches a step, wall time a step, and the
    kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stable_virtual_camera_tpu_torch.core import global_alignment as ga

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ga.refine(params, data, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.count, (getattr(e, "self_device_time_total", None)
                                 or getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[2])
    busy = sum(ms for _, _, ms in kernels)
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": busy / steps if busy else "not measured",
            "launches_per_step": sum(n for _, n, _ in kernels) / steps,
            "top_kernels": [{"name": name[:90], "calls": n, "device_ms": ms} for name, n, ms in kernels[:5]]}


def check_global_align_synthetic() -> None:
    """The port's aligner (the steps of global_align) on the card over a
    known 8-image scene at 384x512: first and last step's loss, ms per step,
    and recovery at the JAX package's noise-0 bars (centers 0.02, rotations
    1 degree, focal 1%, median point error 0.02); then a profile of a few
    steps at 56 edges and at the Advanced path's 6."""
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch.core import global_alignment as ga

    t0 = time.perf_counter()
    edges, c2ws, f, world = synthetic_scene(SCENE_N, SCENE_H, SCENE_W)
    build_s = time.perf_counter() - t0
    # the first alignment in a process pays a one-time cost (~10 s on an
    # H100) that later ones do not; a 3-step run on a tiny scene takes it
    t0 = time.perf_counter()
    ga.refine(*ga.alignment_problem(synthetic_scene(2, 16, 16)[0], True, DEVICE), 3)
    torch.cuda.synchronize()
    first_use_s = time.perf_counter() - t0
    # global_align's three steps, each timed: host init and upload, the
    # Adam loop on the card, the scene back on the host
    t0 = time.perf_counter()
    params, data = ga.alignment_problem(edges, True, DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with torch.no_grad():
        first = ga._loss_fn(params, data).item()  # the loss of the first step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = ga.refine(params, data, ALIGN_STEPS, lr=0.01, schedule="cosine")
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = ga.aligned_scene(edges, params, data, last)
    finish_s = time.perf_counter() - t0
    err = scene_errors(scene, c2ws, f, world)
    # where a step's time goes, here and at the Advanced path's 6 edges
    profiles = {f"{len(edges.i_idx)}_edges": profile_alignment_steps(params, data)}
    del params, data
    small = synthetic_scene(ADV_IMAGES, SCENE_H, SCENE_W)[0]
    small_problem = ga.alignment_problem(small, True, DEVICE)
    ga.refine(*small_problem, 3)  # warm-up
    profiles[f"{len(small.i_idx)}_edges"] = profile_alignment_steps(*small_problem)
    ok = (np.isfinite(scene.final_loss) and err["center_max_abs_err"] <= 0.02
          and err["rotation_max_deg"] < 1.0 and err["focal_max_rel_err"] <= 0.01
          and err["point_median_err"] < 0.02)
    emit({"phase": "global_align_synthetic", "ok": ok, "images": SCENE_N, "edges": len(edges.i_idx),
          "map_hw": [SCENE_H, SCENE_W], "steps": ALIGN_STEPS, "schedule": "cosine", "lr": 0.01,
          "loss_first_step": first, "loss_last_step": scene.final_loss,
          "ms_per_step": refine_s * 1e3 / ALIGN_STEPS, "init_s": init_s, "refine_s": refine_s,
          "first_use_s": first_use_s,
          "finish_s": finish_s, "scene_build_s": build_s, "profile": profiles,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **err,
          "bar": {"center_max_abs_err": 0.02, "rotation_max_deg": 1.0, "focal_max_rel_err": 0.01,
                  "point_median_err": 0.02}})
    if not ok:
        raise AssertionError("global alignment did not recover the synthetic scene")


def check_dust3r_forward():
    """The DUSt3R network at full width (seeded random fp32 weights) on one
    batch of 512x384 pairs (all ordered pairs of three images, as the
    Advanced path batches them). Returns the pipeline for advanced_path."""
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch.apps.preprocessor import NativeDust3rPipeline

    t0 = time.perf_counter()
    pipe = NativeDust3rPipeline(generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_pairs = ADV_IMAGES * (ADV_IMAGES - 1)
    rng = np.random.default_rng(SEED)
    a, b = (torch.from_numpy(rng.uniform(-1, 1, (n_pairs, ADV_H, ADV_W, 3)).astype(np.float32)).to(DEVICE)
            for _ in range(2))
    with torch.inference_mode():
        pipe.model(a, b)  # warm-up (cuDNN algorithm selection for this batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = pipe.model(a, b)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    stats = {}
    for pred, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view")):
        norm = out[pred][key].norm(dim=-1)
        conf = out[pred]["conf"]
        stats[pred] = {"pts_norm_min": norm.min().item(), "pts_norm_median": norm.median().item(),
                       "pts_norm_max": norm.max().item(), "conf_min": conf.min().item(),
                       "conf_median": conf.median().item(), "conf_max": conf.max().item(),
                       "conf_above_3": (conf > 3).float().mean().item(),
                       "finite": bool(torch.isfinite(out[pred][key]).all() and torch.isfinite(conf).all())}
    ok = (all(v["finite"] and v["conf_min"] >= 1.0 for v in stats.values())
          and out["pred1"]["pts3d"].shape == (n_pairs, ADV_H, ADV_W, 3))
    emit({"phase": "dust3r_forward", "ok": ok, "spec": "Dust3rSpec() (ViT-L encoder, 2x12-block decoders, DPT)",
          "params": sum(p.numel() for p in pipe.model.parameters()), "dtype": "float32 (TF32 off)",
          "pairs": n_pairs, "image_hw": [ADV_H, ADV_W], "build_s": build_s, "forward_s": fwd_s,
          "s_per_pair": fwd_s / n_pairs, "peak_gb": peak, **stats,
          "weights": "random fp32, flax-default init (lecun-normal kernels, zero biases), seed 0"})
    if not ok:
        raise AssertionError("the DUSt3R forward is not finite or its confidences fall below 1")
    return pipe


def run_advanced_path(bundle, pipe, shapes: dict) -> dict:
    """The GUI's Advanced mode at full width on the card: DUSt3R and global
    alignment through preprocess_advanced, a keyframe trajectory through
    the recovered poses, and both render passes, with the kernels' launch
    counts read around the render."""
    import numpy as np
    import PIL.Image
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps import preprocessor
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer, preprocess_advanced
    from stable_virtual_camera_tpu_torch.apps.trajectory import CameraTrajectoryCore

    marks: dict[str, float] = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            marks[name] = marks.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    rng = np.random.default_rng(SEED)
    saved_align = preprocessor.global_align
    preprocessor.global_align = timed("align_s", saved_align)
    pipe.pairwise = timed("dust3r_s", pipe.pairwise)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            paths = []
            for i in range(ADV_IMAGES):
                paths.append(os.path.join(tmp, f"view{i}.png"))
                PIL.Image.fromarray(rng.integers(0, 256, (ADV_H, ADV_W, 3), dtype=np.uint8)).save(paths[-1])
            t0 = time.perf_counter()
            pre = preprocess_advanced(paths, pipe, shorter=ADV_SHORTER)
            preprocess_s = time.perf_counter() - t0
    finally:
        preprocessor.global_align = saved_align
        del pipe.pairwise
    W, H = pre["input_wh"]
    fovs = 2 * np.arctan(0.5 / pre["input_Ks"][:, 1, 1])
    core = CameraTrajectoryCore()
    core.default_fov = float(fovs[0])
    core.set_keyframes_from_poses(pre["input_c2ws"], fovs, aspect=W / H)
    traj = core.get_camera_traj_list((W, H), num_frames=NUM_TARGETS)

    renderer = HeadlessRenderer(bundle, work_dir=None)
    plan = renderer.prepare(pre, seed=SEED, camera_traj_list=traj, num_steps=NUM_STEPS)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    with recording_shapes(shapes):
        t0 = time.perf_counter()
        gen = renderer.run(plan)
        anchors = next(gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frames = next(gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = _kernels.counts()

    # a chunk's VAE decode at this size: the plan's batches, and one batch
    decode_t = plan["options"].decoding_t
    z = torch.randn((T, H // 8, W // 8, 4), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                    device=DEVICE)
    decode = {}
    for label, chunk in ((f"batches_of_{decode_t}", decode_t), ("one_batch_of_21", 0)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t3 = time.perf_counter()
        try:
            bundle.vae.decode(z, chunk, uint8=True)
            torch.cuda.synchronize()
            decode[label] = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                             "peak_above_resident_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                             "s": time.perf_counter() - t3}
        except torch.cuda.OutOfMemoryError:
            decode[label] = "out of memory"
    del z
    torch.cuda.empty_cache()

    finite = bool(np.isfinite(pre["input_c2ws"]).all() and np.isfinite(pre["input_Ks"]).all())
    ok = (
        finite and (W, H) == (768, 576)
        and frames.dtype == np.uint8 and frames.shape == (NUM_TARGETS, H, W, 3)
        and anchors.shape[1:] == (H, W, 3) and float(frames.std()) > 0.0
        and counts["flash_attention"] > 0 and counts["time_attention"] > 0
    )
    emit({"phase": "advanced_path", "ok": ok, "input_wh": [W, H], "inputs": ADV_IMAGES,
          "points_per_image": [len(p) for p in pre["points"]], "scene_scale": pre["scene_scale"],
          "fov_deg": np.degrees(fovs).tolist(), "poses_finite": finite,
          "preprocess_s": preprocess_s, "dust3r_s": marks.get("dust3r_s"), "align_s": marks.get("align_s"),
          "T": plan["version"].T, "anchors": len(plan["image_cond"]["prior_indices"]),
          "first_pass_chunks": plan["first_pass_chunks"], "second_pass_chunks": plan["second_pass_chunks"],
          "decoding_t": decode_t, "first_pass_s": t1 - t0, "second_pass_s": t2 - t1,
          "frames": list(frames.shape), "frame_std": float(frames.std()), "launches": counts,
          "vae_decode_21_frames": decode,
          "cuts": {
              "num_steps": f"{NUM_STEPS} (released default 50)",
              "num_targets": f"{NUM_TARGETS} along a keyframe spline through the recovered poses",
              "images": f"{ADV_IMAGES} seeded random {ADV_W}x{ADV_H} PNGs",
              "dust3r_weights": "random fp32 (flax-default init, seed 0), full width; TF32 off",
              "align": f"{ALIGN_STEPS} steps, cosine, lr 0.01 (the preprocessor's defaults)",
              "seva_weights": "random bf16 (flax-default init, seed 0), full width",
              "outputs": "kept in memory, no PNG/mp4 writes",
          }})
    if not ok:
        raise AssertionError("the Advanced path's outputs or kernel launch counts are wrong")
    return counts


def plain_attention_functions():
    """K1 and K2 with their plain forward and backward, as autograd
    Functions on CUDA tensors: the reference the kernels' gradients are
    held against."""
    import torch

    from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
        flash_attention_bwd_plain,
        flash_attention_plain,
    )
    from stable_virtual_camera_tpu_torch.ops.time_attention import (
        time_attention_bwd_plain,
        time_attention_plain,
    )

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = flash_attention_plain(q, k, v, return_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            return flash_attention_bwd_plain(*ctx.saved_tensors, do)

    class PlainTime(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, num_frames):
            ctx.save_for_backward(q, k, v)
            ctx.num_frames = num_frames
            return time_attention_plain(q, k, v, num_frames)

        @staticmethod
        def backward(ctx, do):
            return (*time_attention_bwd_plain(*ctx.saved_tensors, do, ctx.num_frames), None)

    return PlainFlash.apply, PlainTime.apply


def train_inputs(bundle, gen):
    """A full-width training batch (T=21 frames of one scene, 576x576) and
    a fixed draw (timestep 500, seeded noise)."""
    import torch

    from stable_virtual_camera_tpu_torch.training.train_step import synthetic_batch

    h = RES // 8
    batch = synthetic_batch(bundle.spec, TRAIN_T, h, h, gen)
    t_idx = torch.tensor(500, device=DEVICE)
    eps = torch.randn(tuple(batch.latents.shape), generator=gen, device=DEVICE)
    return batch, lambda shape: (t_idx, eps)


def check_train_grad(bundle, gen) -> dict:
    """One full-width loss and backward: through the kernels, with
    per-block and with whole-network rematerialisation, and through the
    plain versions of K1/K2 (forward and backward) on the same batch and
    draw. Bars: loss and global gradient against the plain path, remat
    against no remat, and nonzero gradients on every attention qkv weight."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.models import unet as unet_mod
    from stable_virtual_camera_tpu_torch.training.train_step import make_loss_fn

    unet = bundle.unet
    batch, draw = train_inputs(bundle, gen)

    def run(loss_of_batch):
        unet.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = loss_of_batch()
        loss.backward()
        torch.cuda.synchronize()
        out = {"loss": loss.item(), "s": time.perf_counter() - t0,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        grads = {n: p.grad for n, p in unet.named_parameters() if p.grad is not None}
        unet.zero_grad(set_to_none=True)
        return out, grads

    def gnorm(grads):
        return torch.stack([g.float().norm() for g in grads.values()]).norm().item()

    def gdiff(a, b):
        return torch.stack([(a[n].float() - b[n].float()).norm() for n in b]).norm().item() / gnorm(b)

    loss_fn = make_loss_fn(unet, TRAIN_T)
    run(lambda: loss_fn(batch, draw))  # warm-up
    # whole-network checkpoint first: its peak is near the plain backward's,
    # with no gradients of another run held beside it
    whole, _ = run(lambda: checkpoint(loss_fn, batch, draw, use_reentrant=False))
    _kernels.reset_counts()
    kern, g_kern = run(lambda: loss_fn(batch, draw))
    kern["launches"] = _kernels.counts()
    qkv = [n for n in g_kern if n.endswith("attn1.qkv.weight")]
    qkv_nonzero = len(qkv) > 0 and all(g_kern[n].abs().max().item() > 0 for n in qkv)
    n_attn = sum(1 for n, _ in unet.named_parameters() if n.endswith("attn1.qkv.weight"))
    remat, g_remat = run(lambda: make_loss_fn(unet, TRAIN_T, remat=True)(batch, draw))
    remat["grad_rel_l2"] = gdiff(g_remat, g_kern)
    del g_remat
    # the plain path holds 2 GB score chunks on top of the activations: it
    # runs with per-block remat, which changes no number (checked above)
    saved = unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds
    unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds = plain_attention_functions()
    try:
        plain, g_plain = run(lambda: make_loss_fn(unet, TRAIN_T, remat=True)(batch, draw))
    finally:
        unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds = saved
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    grad_rel = gdiff(g_kern, g_plain)
    ok = (
        loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2 and qkv_nonzero
        and len(qkv) == n_attn and all(kern["launches"][k] > 0 for k in TRAIN_KERNELS)
        and abs(remat["loss"] - kern["loss"]) <= REMAT_LOSS_REL * abs(kern["loss"])
        and remat["grad_rel_l2"] <= REMAT_GRAD_REL_L2
        and all(torch.isfinite(g).all() for g in g_kern.values())
    )
    emit({"phase": "train_grad", "ok": ok, "frames": TRAIN_T, "latent": [RES // 8, RES // 8],
          "bar": {"loss_rel": TRAIN_LOSS_REL, "grad_rel_l2": TRAIN_GRAD_REL_L2,
                  "remat_loss_rel": REMAT_LOSS_REL, "remat_grad_rel_l2": REMAT_GRAD_REL_L2},
          "loss_rel": loss_rel, "grad_rel_l2": grad_rel, "grad_norm": gnorm(g_kern),
          "qkv_weights_with_grad": f"{len(qkv)}/{n_attn}", "kernels": kern,
          "remat_per_block": remat, "remat_whole_network": whole, "plain": plain})
    if not ok:
        raise AssertionError("the backward through the kernels disagrees with the plain one")
    return {"peak_gb": {"remat_off": kern["peak_gb"], "remat_per_block": remat["peak_gb"],
                        "remat_whole_network": whole["peak_gb"]}}


_KERNEL_CLASSES = [
    ("K1 flash attention", r"flash_fwd_kernel"),
    ("K1-dKV", r"flash_bwd_dkv_kernel"),
    ("K1-dQ", r"flash_bwd_dq_kernel"),
    ("K2 temporal attention", r"time_attn_kernel"),
    ("convolution (cuDNN)", r"conv|Conv|cudnn|dgrad|wgrad|fprop|implicit"),
    ("GEMM (cuBLAS)", r"gemm|Gemm|cutlass|xmma|nvjet|sm90_|sm80_"),
    ("optimizer", r"multi_tensor|adam|Adam|foreach"),
    ("reductions", r"reduce|Reduce|norm"),
    ("elementwise and copies", r"elementwise|Elementwise|vectorized|CatArray|copy|fill|index|Memcpy|Memset"),
]


def profile_train_step(bundle, gen) -> None:
    """Device time of one full-width train step (loss, backward, AdamW) by
    kernel class, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stable_virtual_camera_tpu_torch.training.optim import AdamW
    from stable_virtual_camera_tpu_torch.training.train_step import make_train_step

    batch, draw = train_inputs(bundle, gen)
    step = make_train_step(bundle.unet, AdamW(bundle.unet.parameters(), TRAIN_LR), TRAIN_T)
    step(batch, draw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, draw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        cls = next((c for c, rx in _KERNEL_CLASSES if re.search(rx, e.key)), "other")
        classes[cls] = classes.get(cls, 0.0) + us / 1e3
    busy = sum(classes.values())
    emit({"phase": "train_profile", "ok": True, "step_wall_s": wall, "device_busy_ms": busy,
          "idle_share": (1 - busy / (wall * 1e3)) if busy else "not measured",
          "device_ms_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1]))})


def orbit_scene(n: int = 24):
    """An in-memory scene: n seeded 576x576 images on a circular orbit
    around the origin, looking at it, with pixel intrinsics."""
    import numpy as np

    from stable_virtual_camera_tpu_torch.core.trajectories import get_lookat_w2cs
    from stable_virtual_camera_tpu_torch.data import Dataset, DirectParser

    rng = np.random.default_rng(SEED)
    theta = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    positions = np.stack([2.0 * np.cos(theta), np.full(n, -0.3), 2.0 * np.sin(theta)], -1)
    c2ws = np.linalg.inv(get_lookat_w2cs(positions, np.zeros(3), np.array([0.0, -1.0, 0.0])))
    K = np.array([[500.0, 0.0, RES / 2], [0.0, 500.0, RES / 2], [0.0, 0.0, 1.0]])
    imgs = [im for im in rng.integers(0, 256, (n, RES, RES, 3), dtype=np.uint8)]
    return Dataset(DirectParser(imgs, c2ws[:, :3].astype(np.float32), np.repeat(K[None], n, 0)))


def run_train_path(bundle) -> dict:
    """The train CLI's loop at full width on the card, then one LoRA step;
    each run's checkpoint restored and held against the live state."""
    import math

    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps.train_cli import train
    from stable_virtual_camera_tpu_torch.training.checkpoint import restore_train_state

    dataset = orbit_scene()
    cli = dict(num_input_frames=TRAIN_INPUTS, image_size=(RES, RES), weight_decay=1e-2, grad_accum=1,
               remat=True, lora_alpha=None, lora_pattern=None, save_merged=False,
               ckpt_every=500, log_every=1, resume=False, seed=SEED, prefetch=2, encoding_t=0)
    unet = bundle.unet
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_counts()
        full = train(bundle, dataset, work_dir=f"{tmp}/full", num_steps=TRAIN_STEPS, lr=TRAIN_LR,
                     warmup_steps=1, ema_decay=0.999, lora_rank=None, **cli)
        torch.cuda.synchronize()
        counts = _kernels.counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        changed = sum(int(not torch.equal(p, before[n])) for n, p in unet.named_parameters())
        del before
        t0 = time.perf_counter()
        params, opt_state, step, ema = restore_train_state(full["ckpt_path"])
        restore_s = time.perf_counter() - t0
        live = dict(unet.named_parameters())
        restored_equal = (
            step == TRAIN_STEPS
            and all(torch.equal(t, live[n].detach().cpu()) for n, t in params.items())
            and all(torch.equal(t, full["ema_params"][n].cpu()) for n, t in ema.items())
            and opt_state["schedule"]["last_epoch"] == TRAIN_STEPS
        )
        del params, opt_state, ema, live
        ckpt_gb = os.path.getsize(full["ckpt_path"]) / 1e9

        lora = train(bundle, dataset, work_dir=f"{tmp}/lora", num_steps=1, lr=TRAIN_LR,
                     warmup_steps=0, ema_decay=None, lora_rank=LORA_RANK, **cli)
        adapters, _, lora_step, _ = restore_train_state(lora["ckpt_path"])
        lora_restored = lora_step == 1 and all(
            torch.equal(adapters[p][k], t.detach().cpu()) for p, ab in lora["lora"].items()
            for k, t in ab.items())
        b_moved = all(ab["b"].abs().max().item() > 0 for ab in lora["lora"].values())
    losses = full["losses"] + lora["losses"]
    ok = (
        all(math.isfinite(x) for x in losses)
        and changed > 0 and restored_equal and lora_restored and b_moved
        and all(counts[k] > 0 for k in TRAIN_KERNELS)
    )
    emit({"phase": "train_path", "ok": ok, "losses": full["losses"], "lora_loss": lora["losses"],
          "s_per_step_2_to_4": sum(full["step_seconds"][1:]) / (TRAIN_STEPS - 1),
          "step_seconds": full["step_seconds"], "lora_step_s": lora["step_seconds"],
          "peak_gb_cli_loop": peak_gb, "params_changed": f"{changed}/{len(dict(unet.named_parameters()))}",
          "checkpoint_gb": ckpt_gb, "checkpoint_restore_s": restore_s,
          "restored_equal": restored_equal, "lora_restored_equal": lora_restored,
          "lora_adapters": len(lora["lora"]), "lora_b_moved": b_moved, "launches": counts,
          "cuts": {
              "num_steps": f"{TRAIN_STEPS} (CLI default 1000), then 1 LoRA rank-{LORA_RANK} step",
              "lr": f"{TRAIN_LR} (CLI default 1e-5: bf16 weights lose 1e-5 updates below one ulp)",
              "warmup_steps": "1 (CLI default 100); 0 for the LoRA step so its one update moves",
              "ema_decay": "0.999 (CLI default none)",
              "remat": "True (CLI default False): without it the T=21 backward's activations "
                       "and the AdamW, EMA and gradient state do not fit in 80 GB",
              "scene": "24 seeded random 576x576 images on an orbit, in memory (DirectParser)",
              "weights": "random bf16 (flax-default init, seed 0), full width",
          }})
    if not ok:
        raise AssertionError("the training path failed its checks")
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

    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    emit({"phase": "device", "kind": device_name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)

    t0 = time.perf_counter()
    _kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted({k.library().name for k in _kernels.KERNELS.values()})})

    failures: list[str] = []
    results: dict = {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for key, fn in (("flash_attention", check_k1), ("time_attention", check_k2),
                    ("k1_bwd", check_k1_bwd),
                    ("flash_attention_blhd", lambda g: check_layout_kernel(g, "blhd")),
                    ("flash_attention_packed", lambda g: check_layout_kernel(g, "packed"))):
        try:
            out = fn(gen)
            if key == "k1_bwd":
                results.update(out)
            else:
                results[key] = out
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failures.append(key)

    counts: dict[str, dict] = {"render": {}, "advanced": {}, "cli": {}, "train": {}, "k5": {}}
    try:
        k5 = check_k5_layer_norm(gen)
        results["layer_norm"] = k5["result"]
        counts["k5"] = k5["counts"]
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        failures.append("k5_layer_norm")
    try:
        check_global_align_synthetic()
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        failures.append("global_align_synthetic")
    pipe = None
    try:
        pipe = check_dust3r_forward()
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        failures.append("dust3r_forward")
    upstream: dict = {}
    recorded: dict[str, dict] = {"render": {}, "advanced": {}}
    try:
        t0 = time.perf_counter()
        bundle = random_bundle(SevaSpec(), ClipVisionSpec(), dtype=torch.bfloat16, device=DEVICE,
                               generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        torch.cuda.synchronize()
        emit({"phase": "weights", "seconds": time.perf_counter() - t0,
              "unet_params": sum(p.numel() for p in bundle.unet.parameters())})
        for key, fn in (("unet_forward", lambda: upstream.update(check_unet(bundle, gen))),
                        ("unet_forward_backends", lambda: check_unet_backends(bundle, upstream)),
                        ("main_path", lambda: run_main_path(bundle, recorded["render"])),
                        ("advanced_path", lambda: run_advanced_path(bundle, pipe, recorded["advanced"])),
                        ("k1_k2_path_shapes", lambda: check_path_shapes(gen, recorded)),
                        ("cli_path", run_cli_path),
                        ("train_grad", lambda: check_train_grad(bundle, gen)),
                        ("train_profile", lambda: profile_train_step(bundle, gen)),
                        ("train_path", lambda: run_train_path(bundle))):
            try:
                out = fn()
                if key == "main_path":
                    counts["render"] = out
                elif key == "advanced_path":
                    counts["advanced"] = out
                    pipe = None  # free the DUSt3R weights
                elif key == "k1_k2_path_shapes":
                    for kernel, by_path in out.items():
                        r = results.setdefault(kernel, {})
                        r["path_shapes"] = by_path
                        r["max_abs_err"] = max([r.get("max_abs_err", 0.0)]
                                               + [p["max_abs_err"] for p in by_path.values()])
                elif key == "cli_path":
                    counts["cli"] = out
                elif key == "train_path":
                    counts["train"] = out
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                failures.append(key)
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        failures.append("weights")

    upstream = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    replaces = {
        "flash_attention": "stable_virtual_camera_tpu/ops/flash_upstream.py:74",
        "flash_attention_bwd_dkv": "stable_virtual_camera_tpu/ops/flash_upstream.py:74 under grad: "
                                   f"{upstream}:1121 (_flash_attention_bwd_dkv)",
        "flash_attention_bwd_dq": "stable_virtual_camera_tpu/ops/flash_upstream.py:74 under grad: "
                                  f"{upstream}:1456 (_flash_attention_bwd_dq)",
        "time_attention": "stable_virtual_camera_tpu/ops/time_attention.py:134",
        "flash_attention_blhd": "stable_virtual_camera_tpu/ops/flash_attention.py:122",
        "flash_attention_packed": "stable_virtual_camera_tpu/ops/flash_attention_packed.py:156",
        "layer_norm": "benchmark/ln_probe.py:50",
    }
    # the render paths (Basic and Advanced) launch K1 and K2, the training
    # path K1, K1-dKV, K1-dQ and K2, the CLI path K1 to K4, the probe's loop
    # K5; a kernel's `launches` is the count on the path that measures it
    # here (render shapes for K1 and K2, training shapes for the backward
    # pair, the CLI for K3 and K4, the probe's shape for K5). K1's and K2's
    # times are sums over the shapes of their own phases; `path_shapes`
    # holds the sums over the other shapes of each render path, and
    # `max_abs_err` the worst over both
    home = {"flash_attention": "render", "time_attention": "render",
            "flash_attention_bwd_dkv": "train", "flash_attention_bwd_dq": "train",
            "flash_attention_blhd": "cli", "flash_attention_packed": "cli", "layer_norm": "k5"}
    rows = []
    for k in _kernels.KERNELS.values():
        r = results.get(k.name, {})
        rows.append({
            "name": k.name,
            "route": "cuda",
            "source": f"stable_virtual_camera_tpu_torch/csrc/{k.source.name}",
            "replaces": replaces[k.name],
            "launches": counts[home[k.name]].get(k.name, 0),
            "launches_by_path": {path: c.get(k.name, 0) for path, c in counts.items()},
            **{key: r.get(key) for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
            **{key: r[key] for key in ("library", "plain_and_library_cover", "path_shapes") if key in r},
        })
    emit({"kernels": rows})
    missing = [f"{k}@{path}" for path, ks in (
                   ("render", ("flash_attention", "time_attention")),
                   ("advanced", ("flash_attention", "time_attention")),
                   ("k5", ("layer_norm",)),
                   ("cli", ("flash_attention", "time_attention", "flash_attention_blhd",
                            "flash_attention_packed")),
                   ("train", TRAIN_KERNELS))
               for k in ks if counts[path].get(k, 0) == 0]
    if missing and not failures:
        failures.append(f"kernels not launched on their path: {missing}")
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
