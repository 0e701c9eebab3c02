#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stable_virtual_camera_tpu_torch) on one
NVIDIA GPU. Run from the repository root: `python3 chip_smoke.py`.

It builds the hand-written kernels from csrc/ with nvcc and then runs:
  1. the device line (torch's name for the card, nvidia-smi's name and
     power limit);
  2. K1 (flash attention) against its plain version at every self-attention
     shape of a 576x576 render, on the packed-qkv views the UNet passes;
  3. K2 (temporal attention) against its plain version at every time-mix
     shape of a 576x576 render (T=21, b=2), with SDPA on permuted views as
     the one-call yardstick, each timed warm (back to back on one
     projection), cold (rotating over projections larger than the L2
     together) and by its device time in torch.profiler, with the bound
     share from the cold device time; a repeated launch at (5184, 5, 21, 2)
     that must give the same bits;
  4. `k1_bwd` and `k1_lse`: K1-dKV and K1-dQ against the plain backward, and
     K1's log-sum-exp against the plain one, at every self-attention shape
     of a 576x576 training chunk (T=21, b=1), with each kernel's TFLOP/s,
     the plain D reduction's time, the pair + D against SDPA's backward, and
     two more launches at L = 1701 that must give the same bits;
  5. `k3_flash_attention` and `k4_flash_packed`: K3 ((B, L, H, 64) layout)
     and K4 (packed (B, L, W) layout) against their plain versions at the
     self-attention shapes of a 576x576 render they take, on the split-qkv
     views the UNet's generic path passes; then `fp32_flash_attention`: the
     fp32 entry of K1, K3 and K4 (csrc/flash_attention_fp32.cu) in each
     layout at those shapes, and `fp32_flash_bwd`: the fp32 entries of
     K1-dKV and K1-dQ at the training shapes, all in 3xTF32 on the tensor
     cores, against the plain fp32 versions (relative L2 1e-5 and max abs
     1e-4, K1's log-sum-exp 1e-5; 1e-4), with SDPA's memory-efficient
     backend, forward and backward, as the yardstick, FFMA and 3xTF32
     bounds, repeated launches that must give the same bits, and ptxas's
     registers and spills;
  6. one full-width SevaUNet forward (bf16 random weights, 42 frames,
     576x576) through the kernels and through the plain versions, with a
     torch.profiler window over one forward (device time by kernel class,
     K1's share), then `unet_forward_backends`: the same with
     attention="flash" (K3) and "packed" (K4), then `f1_fp32_routes`: the
     demo CLI's tiny fp32 bundle rendering the golden scene through K2's
     entry for head dim 16 (time_attention_any), within one uint8 step of
     the same render on the "plain" backend; one fp32 full-width forward on
     a 21-frame scene launching the fp32 K1 14 times and that K2 entry 16
     times, within 1e-5 of the "plain" backend and 2.5e-2 of the bf16
     network, and the same forward on "flash" and "packed"; one fp32 loss
     and backward (T=21, per-block remat) through the fp32 kernels against
     the plain attention (loss 1e-5, gradient 1e-4); then
     `k2_any_time_attention`: that K2 entry against its plain version at
     the fp32 render's time-mix shapes (warm, cold and by device time) and
     the tiny CLI's (fp32 and bf16), a bit-equal repeat, and ptxas's
     registers and spills of each of its instantiations;
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
     the one-call yardstick, each timed warm (back to back on one input),
     cold (rotating over inputs larger than the L2 together) and by its
     device time in torch.profiler, with the bound share from the cold
     device time; a repeated launch at width 1280 that must give the same
     bits; then the probe's own loop (32 dependent LayerNorms) with its
     launch count;
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
     of the Advanced path's 768x576 shapes (K2 in phase 3's readings);
 17. `checkpoint_path`, after `cli_path`: the bundle of --random_model full
     written as the released files (model/vae/clip.safetensors) through the
     port's inverse key maps and safetensors writer, converted by
     apps.convert_weights into the cache, loaded back from both layouts by
     models/io.load_bundle (bit-equal to the bundle), then the CLI's
     img2img run of phase 8 with --checkpoint_dir on the cache, its frames
     within one uint8 step of phase 8's and K1/K2 launch counts read around
     it; with the write, convert and load seconds and the files' bytes;
 18. `quant_ops`: the W8A8 products (ops/quant.py) at full-width shapes:
     FF proj_gate and proj_out and the fused qkv at 42*5184 rows, to_v at 6
     rows (padded), the ResBlock 3x3 conv at (42, 72, 72, 320), the
     Downsample and the rearranged Upsample at 1280 channels; torch._int_mm
     on the card bit-equal to the integer product on the CPU (float64 on a
     subset of rows, exact), each op within fp32 rounding of its dequantized
     fp32 form, with ms, TOPS, the bound and bf16's ms at the same shape, and
     the quantize pass's GB/s; plus _int_mm's rule on this torch (rows,
     operand layouts);
 19. `quant_path`: the Basic render of phase 7 under --quant w8a8 and
     w8a8-static (calibration timed apart, K1/K2 launch counts, a second
     static render bit-identical), the latents' rel L2 and the frames' PSNR
     against the bf16 render, and one UNet forward (42 frames, 576x576) per
     mode with device time by class and peak memory;
 20. `server_path`: apps/server.py on 127.0.0.1 (port 0) over the bundle of
     phase 8's --random_model full: warmup_buckets at T=21, two img2img jobs
     over HTTP whose frames must equal phase 8's run (c), a third job
     aborted while it runs, then a w8a8-static service, warmed, whose one
     job calibrates once, inside the job;
 21. `gui_path`, after `advanced_path`: the Gradio app (apps/gradio_app.py)
     at full width on stand-in gradio and viser modules (the card's machine
     has neither): (a) Basic preprocess and render with phase 7's arguments,
     the first pass streamed before the second pass's first step, both
     passes' progress reaching its total, the PNGs bit-equal to phase 7's
     frames; (b) Advanced: three seeded 512x384 PNGs through the app's
     DUSt3R preprocess, the scene view, the editor's orbit preset and "Set
     camera trajectory", the render's frame count that trajectory's and its
     PNGs bit-equal to HeadlessRenderer on it, which runs with the engine's
     stage timer (JAX's stage names, host seconds with no synchronize, the
     report printed); (c) a Basic render in a thread aborted after its first
     progress tick, ending within one step;
     K1/K2 launches over (a) and (b), and the host time the app adds to the
     renderer;
 22. `profile_trace`: utils/profiling.trace around one 42-frame forward,
     utils/trace_analysis on the Chrome trace it wrote, K1's and K2's class
     totals within 2% of torch.profiler's key_averages over the same window;
 23. `lpips`: models/lpips with synthetic weights on two of (a)'s frames,
     fp32 on the card against the CPU score (1e-4 relative), ms per pair;
24. `export_path`, after `server_path`: apps.export_artifacts on the
     --random_model full bundle exports the bucket T=21 at 576x576 and
     NUM_STEPS steps (torch.export, the kernels as custom ops), the server's
     loader attaches it (export and load seconds, the file's bytes against
     the weights'); one seeded chunk sampled through the live step and
     through the artifact, latents bit-equal, K1 and K2 launched as often
     on both with the same K2 copy modes, the bucket called once a step;
     then (c)'s img2img job served over HTTP through the artifact, its
     frames equal to (c)'s;
 25. `parallel_path`, after `export_path`: the mesh (parallel/) on the one
     card, every rank a thread on cuda:0 with its own stream: (a) a seeded
     T=21 chunk on a 1-rank view mesh, latents bit-equal to the unsharded
     chunk's with the same K1/K2 launches; (b) on a 3-rank view mesh,
     latents within the bounds stated before the first run, frames' PSNR,
     K1 and K2 launches against n per joint layer and one per time-mix per
     rank, both walls and device profiles, the ring merges' and
     all-to-alls' device time; (c) the CLI's render_one_scene on one
     device, on a (2, 1) mesh (bit-equal), on a (2, 3) mesh and with
     chunk_batch=2 (PSNR bar), the second pass in 2 groups;
 26. `stream_path`: parallel_path's 30-target s-prob render (3 second-pass
     chunks) through the CLI with the engine's streamed frame writes on and
     the conditioning prefetch window of 3, and with the writes off and a
     window of 1, each with --engine_timing (per-pass seconds, final_save,
     the second pass's flush, conditioning and sample stages, host seconds
     with no synchronize), then streamed without the timer at windows 3
     and 1; the device's idle gap between consecutive second-pass chunks
     from CUDA events in all four; every PNG byte-equal across the four
     renders;
 27. `tp_path`: parallel_path's seeded chunk on (data, view, model) =
     (1, 1, 2) and, where memory allows, (1, 3, 2) meshes of thread ranks
     on cuda:0 (tensor parallelism): latents against the unsharded chunk,
     the model ranks bit-equal, each rank's share of the UNet's bytes, K1
     and K2 launches, seconds against the unsharded chunk, the device's
     idle share; then on (1, 1, 2) under w8a8 and w8a8-static: the chunk
     against the unsharded chunk in the same mode (below W8A8's own gap to
     the exact chunk), the model ranks bit-equal, an input-sharded
     QuantLinear and QuantConv bit-equal to the unsharded layers, a rank's
     share of the int8 weights;
 28. `film_cache`: the same chunk through the engine's sample_latents (on
     its FiLM cache) and through the Euler loop on the bundle's network
     (no cache): latents (relative L2, or one bf16 step), seconds, peak
     memory and the cache's bytes;
 29. `align_sharded`, after `global_align_synthetic`: its 56-edge scene
     refined on an ALIGN_MESH (data, view) mesh of thread ranks on cuda:0
     (14 edges a rank, one flat fp32 all-reduce of the gradients a step)
     against the unsharded refinement at the same steps: loss, camera
     centers and focal at the JAX package's sharded bars, ms a step;
 30. `ring_bwd`: the view-sharded joint attention's backward
     (parallel/ring_attention.ring_backward) at each joint site of the
     train step split over SHARDED_VIEW ranks: every rank's (q, k, v, o,
     global lse, dO) made once on cuda:0, then the kernel route (K1-dKV
     and K1-dQ on each (query shard, key shard) block) and the plain route
     on those same tensors, dq, dk and dv of every rank at K1_BWD_REL_L2,
     SHARDED_VIEW^2 launches of each kernel counted from zero, and the
     ms of each route;
 31. `sharded_train`, after `train_path`: (a) the sharded train step
     (frames over SHARDED_VIEW view ranks on cuda:0, one replica a rank,
     remat) two steps from the unsharded step's weights and draws: loss
     and gradient against the unsharded step's, the replicas bit-equal,
     K1/K1-dKV/K1-dQ/K2 launches against the counts predicted from the
     UNet's attention layers, step seconds against the unsharded step,
     peak memory; (b) the FSDP step on FSDP_MESH: loss and params after
     one step against the unsharded step's, each rank's persistent bytes
     against the whole state's; (c) apps/train_cli.main --mesh_view
     CLI_MESH_VIEW on train_path's scene written as a reconfusion scene,
     two steps, its checkpoint read back and resumed for a third, and the
     CLI's refusals (--lora_rank with a mesh, T % mesh_view);
then the script's total seconds, a `kernels` summary line (the eleven
kernels) and the final `ok` line.
Every phase prints one JSON line. Cuts against a real render, the CLI, a
real fine-tune, the Advanced mode, the released checkpoints and the GUI
are printed in phases 7, 8, 11, 15, 17 and 21. Any failed phase exits
non-zero without the final line; so does a machine with no CUDA device, or a
directory without the port.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import itertools
import json
import math
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
# K2's timing: launches an event reading averages, launches a profiler
# window sums, the bytes of q, k and v a cold reading rotates over (at least
# two projections wherever one is under 200 MB, so no launch reads the
# projection the launch before it read), and the shape whose launch is
# repeated for identical bits
K2_REPS, K2_PROFILED = 20, 20
K2_COLD_BYTES = 200e6
K2_REPEAT_SHAPE = (5184, 5, 21, 2)
UNET_REL_L2 = 3e-2
# the fp32 network against the bf16 one through the kernels, on one
# 21-frame scene: 1.26e-2 read on an H100 (PERF.md), held to twice that
FP32_REL_L2 = 2.5e-2
# the fp32 entries of K1/K3/K4 and K1-dKV/K1-dQ and K2's entry for any head
# dim and dtype, against their plain fp32 versions with TF32 off: the
# forward and the backward pair compute every product as three TF32
# products (3xTF32, ~2^-20 relative), K2's other entry as an fp32 FFMA, so
# only the order and rounding of the sums differs (one TF32 product would
# give ~1e-3); K1's fp32 log-sum-exp as tests/test_torch_cuda.py holds it;
# FP32_REPS launches an event reading averages
FP32_FWD_REL_L2, FP32_FWD_MAX_ABS, FP32_BWD_REL_L2, K2_ANY_REL_L2 = 1e-5, 1e-4, 1e-4, 1e-5
FP32_LSE_MAX_ABS = 1e-5
FP32_REPS = 3
# f1_fp32_routes: the full-width fp32 forward through the kernels against
# its "plain" backend, and the fp32 loss and gradient likewise; the
# forward's launches (7 per-frame and 7 joint K1 sites, 16 time-mixes) and
# the kernels of the fp32 training path
FP32_PLAIN_REL_L2, FP32_TRAIN_LOSS_REL, FP32_TRAIN_GRAD_REL_L2 = 1e-5, 1e-5, 1e-4
FP32_FORWARD_LAUNCHES = {"flash_attention_fp32": 14, "time_attention_any": 16}
FP32_TRAIN_KERNELS = ("flash_attention_fp32", "flash_attention_bwd_dkv_fp32", "flash_attention_bwd_dq_fp32",
                      "time_attention_any")
# training: T=21 frames of one scene, (L, B, H) of every self-attention
TRAIN_T = 21
K1_TRAIN_SHAPES = [(5184, 21, 5), (1296, 21, 10), (27216, 1, 10), (6804, 1, 20), (1701, 1, 20)]
K1_LSE_MAX_ABS = 1e-2
K1_BWD_REL_L2 = 2e-2  # P and dS rounded to bf16 for the products, bf16 outputs
# the training shape where the backward pair is launched twice more on the
# same inputs and must give the same bits (L = 1701: 4 L is not a multiple of
# 16, the row stride a TMA map of lse or D would need)
K1_BWD_DETERMINISM_SHAPE = (1701, 1, 20)
# the joint (T*h*w-token) sites among them: one sequence a chunk
JOINT_TRAIN_SHAPES = [s for s in K1_TRAIN_SHAPES if s[1] == 1]
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
# K5's timing: launches an event reading averages, launches a profiler window
# sums, the x bytes a cold reading rotates over (twice the 50 MB L2), the
# ratio of event to device time above which a burst measured the host, and
# the width whose launch is repeated for identical bits
LN_REPS, LN_PROFILED = 50, 20
LN_COLD_BYTES = 100e6
LN_HOST_BOUND = 1.2
LN_REPEAT_WIDTH = 1280
# Advanced mode: DUSt3R at 512x384, 500 alignment steps, render at 768x576
ADV_W, ADV_H, ADV_IMAGES, ADV_SHORTER = 512, 384, 3, 576
ALIGN_STEPS = 500
# the GUI's Advanced render: the editor's orbit preset over this many seconds
ADV_PRESET_S = 0.5
# profile_trace: K1's and K2's device time in the trace against key_averages
TRACE_CLASS_REL = 0.02
# lpips: the card's fp32 score against the CPU's, and the pairs timed
LPIPS_REL, LPIPS_REPS = 1e-4, 10
# the synthetic alignment scene: 8 images of 384x512, every ordered pair
SCENE_N, SCENE_H, SCENE_W = 8, 384, 512
# parallel_path: ranks of the view mesh in (b) (7 frames each at T=21); the
# 3-rank chunk's latents against the unsharded chunk's, stated before the
# first run: the ring merges three bf16-rounded K1 partials in fp32 where K1
# rounds once, and the per-rank products and convs run at other batch
# sizes, so bf16-level differences pass through 4 steps: relative L2 at
# most 2e-2 and max abs at most 0.1 of the unsharded latents' max abs;
# (c)'s orbit targets (3 second-pass chunks at T=21, so data=2 pads one)
# and its mesh. (c)'s frames: bit-equal where no computation changes (a
# (2, 1) mesh); where the batch around a chunk changes (the (2, 3) mesh,
# chunk_batch=2) cuDNN's convs and the GroupNorm reductions round
# otherwise, and the random bf16 network carries that to ~1e-2 of a
# forward (scripts/batch_variance.py, PERF.md), so those are held to a PSNR
PARALLEL_VIEW = 3
PARALLEL_REL_L2, PARALLEL_MAX_ABS_REL = 2e-2, 1e-1
PARALLEL_TARGETS, PARALLEL_MESH, PARALLEL_FRAME_PSNR_DB = 30, (2, 3), 40.0
# tp_path: the (data, view, model) meshes of the tensor-parallel chunk (the
# second where memory allows), and a rank's share of the UNet's bytes at
# model=2 (its half of every sharded kernel, the one-dimensional leaves
# whole); its latents are held to parallel_path's PARALLEL_REL_L2
TP_MESHES = [(1, 1, 2), (1, 3, 2)]
TP_BYTES_SHARE = 0.51
# tp_path under W8A8: the sharded chunk's distance to the exact chunk at
# most this many times the unsharded W8A8 chunk's (see tp_w8a8)
TP_W8A8_GAP_RATIO = 1.5
# film_cache: the cached chunk against the uncached one: relative L2, or
# else one bf16 step at the latents' magnitude (max abs)
FILM_REL_L2 = 1e-3
# sharded_train: (a) the view ranks of the sharded step (7 frames each at
# T=21), held to train_grad's bars against the unsharded step (loss rel
# TRAIN_LOSS_REL, gradient rel L2 TRAIN_GRAD_REL_L2); (b) the FSDP mesh,
# its params after one step within FSDP_PARAM_REL of the unsharded step's
# (the difference's L2 against the update's), a rank's persistent bytes at
# most FSDP_BYTES_SHARE of the whole state's; (c) the train CLI's
# --mesh_view; every collective of these phases and of align_sharded waits
# at most MESH_TIMEOUT seconds, so a deadlock shows quickly
SHARDED_VIEW, FSDP_MESH, CLI_MESH_VIEW = 3, (2, 1), 3
FSDP_PARAM_REL, FSDP_BYTES_SHARE = 5e-2, 0.51
MESH_TIMEOUT = 120.0
# align_sharded: the synthetic scene's edges over the "data" axis of this
# mesh, held to the unsharded refinement at the JAX package's bars, with the
# pointmap noise of the JAX package's sharded test (a noise-free scene's
# loss falls toward 0, where a relative bar on it reads fp32 rounding)
ALIGN_MESH, ALIGN_NOISE = (4, 1), 0.005
ALIGN_LOSS_RTOL, ALIGN_CENTER_ATOL, ALIGN_FOCAL_RTOL = 1e-3, 5e-3, 1e-3
REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "assets", "golden_scene")
# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # the tensor cores; an fp32-accurate product takes three (3xTF32)
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
    """The sums over several shapes that the `kernels` line carries; where
    the rows hold cold and device readings (K2), their sums too, with the
    bound share of the summed cold device time."""
    bound_ms, bound_by = sum_bounds(rows)
    out = {"max_abs_err": max(r["max_abs_err"] for r in rows),
           **{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms")},
           "bound_ms": bound_ms, "bound_by": bound_by}
    cold = ("cold_ms", "library_cold_ms", "device_us", "library_device_us")
    if all(k in r for r in rows for k in cold):
        out |= {k: sum(r[k] for r in rows) for k in cold}
        out["bound_share"] = bound_ms * 1e3 / out["device_us"]
    return out


def check_k1(gen) -> dict:
    rows = [k1_row(gen, *shape) for shape in K1_SHAPES]
    ok = all(k1_ok(r) for r in rows)
    emit({"phase": "k1_flash_attention", "ok": ok, "bar": {"max_abs": K1_MAX_ABS, "mean_abs": K1_MEAN_ABS},
          "shapes": rows})
    if not ok:
        raise AssertionError("K1 disagrees with its plain version")
    return {**summary(rows), "library": "torch.nn.functional.scaled_dot_product_attention on the same views"}


def k2_row(gen, S: int, H: int, num_frames: int = T, b: int = 2) -> dict:
    """K2 against its plain version at one (S, H, T, b), on the UNet's views
    of a (b*T, 3, H, 64, S) projection, timed with SDPA on permuted views as
    the one-call yardstick in three readings each: warm (`ms`, `library_ms`:
    back to back on one projection, which stays in L2 where it fits), cold
    (`cold_ms`, `library_cold_ms`: rotating over `cold_inputs` distinct
    projections, and for K2 outputs, together at least K2_COLD_BYTES, so no
    launch reads what the launch before it read) and the device time per
    launch from torch.profiler over the cold rotation (`device_us`,
    `library_device_us`). The bound share and GB/s are from the cold device
    time; a cold event reading more than LN_HOST_BOUND times it measured
    the host (`host_bound`). At K2_REPEAT_SHAPE one launch is repeated on
    the same inputs and must give the same bits (`repeat_identical`)."""
    import torch

    from stable_virtual_camera_tpu_torch.ops.time_attention import (
        time_attention_cuda,
        time_attention_plain,
    )

    def projection():
        qkv = torch.randn((b * num_frames, 3, H, 64, S), generator=gen, device=DEVICE).to(torch.bfloat16)
        return qkv.unbind(1)

    q, k, v = projection()
    out = time_attention_cuda(q, k, v, num_frames).float()
    ref = time_attention_plain(q, k, v, num_frames).float()
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    row = {
        "S": S, "H": H, "T": num_frames, "b": b,
        "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
        "max_bf16_steps": bf16_steps(out, ref),
        "finite": bool(torch.isfinite(out).all()),
    }
    del out, ref, diff
    # q, k, v read once, o written once; 4 T^2 64 fp32 FLOP per (scene,
    # position, head), on the CUDA cores
    nbytes = 4 * b * num_frames * H * 64 * S * 2
    row["bound_ms"], row["bound_by"] = bound(4.0 * num_frames * num_frames * 64 * b * S * H, nbytes,
                                             PEAK_FP32_FLOPS)
    n = -(-int(K2_COLD_BYTES) // (nbytes * 3 // 4))
    inputs = [(q, k, v)] + [projection() for _ in range(n - 1)]
    k2_cold = rotating(lambda qi, ki, vi, oi: time_attention_cuda(qi, ki, vi, num_frames, out=oi),
                       [(*qkv, torch.empty_like(qkv[0], memory_format=torch.contiguous_format))
                        for qkv in inputs])
    lib_cold = rotating(lambda qi, ki, vi: time_sdpa(qi, ki, vi, num_frames), inputs)
    row |= {"cold_inputs": n,
            "ms": cuda_ms(lambda: time_attention_cuda(q, k, v, num_frames), K2_REPS),
            "cold_ms": cuda_ms(k2_cold, K2_REPS),
            "plain_ms": cuda_ms(lambda: time_attention_plain(q, k, v, num_frames), 3),
            "library_ms": cuda_ms(lambda: time_sdpa(q, k, v, num_frames), K2_REPS),
            "library_cold_ms": cuda_ms(lib_cold, K2_REPS)}
    row["device_us"], row["kernel_classes"] = device_us(k2_cold, K2_PROFILED)
    row["library_device_us"], row["library_kernel_classes"] = device_us(lib_cold, K2_PROFILED)
    row["bound_share"] = row["bound_ms"] * 1e3 / row["device_us"]
    row["library_bound_share"] = row["bound_ms"] * 1e3 / row["library_device_us"]
    row["gb_per_s"] = nbytes / (row["device_us"] * 1e-6) / 1e9
    row["host_bound"] = row["cold_ms"] * 1e3 > LN_HOST_BOUND * row["device_us"]
    row["library_host_bound"] = row["library_cold_ms"] * 1e3 > LN_HOST_BOUND * row["library_device_us"]
    if (S, H, num_frames, b) == K2_REPEAT_SHAPE:
        row["repeat_identical"] = bool(torch.equal(time_attention_cuda(q, k, v, num_frames),
                                                   time_attention_cuda(q, k, v, num_frames)))
    del inputs, k2_cold, lib_cold, q, k, v
    torch.cuda.empty_cache()
    return row


def check_k2(gen) -> dict:
    rows = [k2_row(gen, S, H) for S, H in K2_SHAPES]
    ok = (all(k2_ok(r) and r.get("repeat_identical", True) for r in rows)
          and any("repeat_identical" in r for r in rows))
    host_bound = [[r["S"], r["H"], r["T"]] for r in rows if r["host_bound"]]
    emit({"phase": "k2_time_attention", "ok": ok, "bar": {"bf16_steps": K2_BF16_STEPS}, "shapes": rows,
          "host_bound": (f"K2's cold event reading exceeds its device time by more than "
                         f"{LN_HOST_BOUND - 1:.0%} at {host_bound}: the burst measured the host; "
                         f"bound_share uses the device time") if host_bound else None})
    if not ok:
        raise AssertionError("K2 disagrees with its plain version or a repeated launch differs")
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
        attention_delta,
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
        delta = attention_delta(o, do)
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
            # the plain D = rowsum(o dO) that the pair reads (SDPA's backward
            # computes its own)
            "delta_ms": cuda_ms(lambda: attention_delta(o, do), 5),
            "plain_ms": cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do), 1),
        }
        if (L, B, H) == K1_BWD_DETERMINISM_SHAPE:
            # two more launches of each kernel on the same inputs: the same bits
            dk2, dv2 = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
            dq2 = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
            row["bit_identical"] = all(torch.equal(a, b) for a, b in ((dk, dk2), (dv, dv2), (dq, dq2)))
            del dk2, dv2, dq2
        del pq, pk, pv, dq, dk, dv
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        row["sdpa_bwd_ms"] = cuda_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 5)
        del out, leaves
        n = 64 * B * H
        row["pair_and_delta_ms"] = row["dkv_ms"] + row["dq_ms"] + row["delta_ms"]
        row["tflops"] = 14.0 * L * L * n / ((row["dkv_ms"] + row["dq_ms"]) * 1e-3) / 1e12
        row["dkv_tflops"] = 8.0 * L * L * n / (row["dkv_ms"] * 1e-3) / 1e12
        row["dq_tflops"] = 6.0 * L * L * n / (row["dq_ms"] * 1e-3) / 1e12
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
    bwd_ok = bwd_ok and all(r.get("bit_identical", True) for r in rows)
    sums = {key: sum(r[key] for r in rows)
            for key in ("dkv_ms", "dq_ms", "delta_ms", "pair_and_delta_ms", "sdpa_bwd_ms")}
    sums["pair_and_delta_over_sdpa_bwd"] = sums["pair_and_delta_ms"] / sums["sdpa_bwd_ms"]
    emit({"phase": "k1_bwd", "ok": bwd_ok, "bar": {"rel_l2": K1_BWD_REL_L2, "bit_identical": True},
          "sums": sums, "shapes": [{k: v for k, v in r.items() if k != "fwd_lse_ms"} for r in rows]})
    if not (lse_ok and bwd_ok):
        raise AssertionError("K1's LSE or its backward kernels disagree with the plain versions, "
                             "or two launches differ")
    plain_ms = sum(r["plain_ms"] for r in rows)
    common = {"plain_ms": plain_ms, "library_ms": sums["sdpa_bwd_ms"],
              "delta_ms": sums["delta_ms"],
              "plain_and_library_cover": "K1-dKV and K1-dQ together with the plain D reduction "
                                         "(the plain backward and the SDPA backward each compute "
                                         "dq, dk and dv with their own preprocessing)"}
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
    # device time of one forward through the kernels, by kernel class: K1's
    # measured share of a render's UNet forward
    prof = device_time_by_class(forward)
    if not prof["kernel_ms_sum"]:  # the profiler saw no device time: CUDA events around K1
        prof["device_ms_by_class"]["K1 flash attention"] = k1_event_ms(forward)
    k1_ms = prof["device_ms_by_class"].get("K1 flash attention", 0.0)
    prof["k1_share_of_device_time"] = k1_ms / prof["kernel_ms_sum"] if prof["kernel_ms_sum"] else None
    prof["k1_share_of_wall"] = k1_ms / (prof["wall_s"] * 1e3)
    emit({"phase": "unet_forward", "ok": ok, "frames": n, "latent": [h, h], "rel_l2": rel,
          "bar": UNET_REL_L2, "finite": finite, "kernels_s": kernel_s, "plain_s": plain_s,
          "out_std": out_k.std().item(), "profile": prof})
    if not ok:
        raise AssertionError("UNet forward through the kernels disagrees with the plain path")
    return {"inputs": (x, t_idx, ctx, dense), "kernels_s": kernel_s, "out": out_k}


def k1_event_ms(forward) -> float:
    """K1's device time in one `forward()`, from CUDA events around each of
    the UNet's calls to it."""
    import torch

    from stable_virtual_camera_tpu_torch.models import unet as unet_mod

    k1, events = unet_mod.flash_attention_upstream_bhld, []

    def timed(q, k, v):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = k1(q, k, v)
        end.record()
        events.append((start, end))
        return out

    unet_mod.flash_attention_upstream_bhld = timed
    try:
        forward()
    finally:
        unet_mod.flash_attention_upstream_bhld = k1
    return sum(s.elapsed_time(e) for s, e in events)


def fp32_flash_row(gen, layout: str, L: int, B: int, H: int) -> dict:
    """The fp32 entry of K1 ("k1": (B, H, L, 64) views of a packed
    (B, L, 3, H, 64) projection, with its log-sum-exp), K3 ("k3": (B, L, H,
    64) chunks of a (B, L, 3 H 64) one) or K4 ("k4": its packed (B, L, H 64)
    chunks) against the plain fp32 version, a second launch that must give
    the same bits, and SDPA's memory-efficient backend (the one that takes
    fp32) on (B, H, L, 64) views of the same tensors as the one-call
    yardstick. The bound is the smaller of the FLOP at the FFMA rate and
    three times the FLOP at the TF32 rate (3xTF32), or the bytes."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from stable_virtual_camera_tpu_torch.ops import flash_attention as fa
    from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as fap
    from stable_virtual_camera_tpu_torch.ops.flash_upstream import flash_attention_cuda, flash_attention_plain

    if layout == "k1":
        qkv = torch.randn((B, L, 3, H, 64), generator=gen, device=DEVICE)
        q, k, v = bhld = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        kernel, plain = (lambda: flash_attention_cuda(q, k, v)), (lambda: flash_attention_plain(q, k, v))
    else:
        qkv = torch.randn((B, L, 3 * H * 64), generator=gen, device=DEVICE)
        q, k, v = qkv.chunk(3, dim=-1)
        bhld = [t.view(B, L, H, 64).transpose(1, 2) for t in (q, k, v)]
        if layout == "k3":
            q, k, v = (t.view(B, L, H, 64) for t in (q, k, v))
            kernel, plain = (lambda: fa.flash_attention_cuda(q, k, v)), (lambda: fa.flash_attention_plain(q, k, v))
        else:
            kernel = lambda: fap.flash_attention_packed_cuda(q, k, v, H)  # noqa: E731
            plain = lambda: fap.flash_attention_packed_plain(q, k, v, H)  # noqa: E731

    def library():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(*bhld)

    if layout == "k1":
        (out, lse), (out2, lse2) = (flash_attention_cuda(q, k, v, return_lse=True) for _ in range(2))
        ref, lse_ref = flash_attention_plain(q, k, v, return_lse=True)
        extra = {"lse_max_abs_err": (lse - lse_ref).abs().max().item()}
        repeat = torch.equal(out, out2) and torch.equal(lse, lse2)
        del lse, lse2, lse_ref
    else:
        out, out2, ref = kernel(), kernel(), plain()
        extra, repeat = {}, torch.equal(out, out2)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    row = {"layout": layout, "L": L, "B": B, "H": H,
           "rel_l2": ((out - ref).norm() / ref.norm()).item(), "max_abs_err": diff.max().item(), **extra,
           "repeat_bit_equal": repeat, "finite": bool(torch.isfinite(out).all()),
           "ms": cuda_ms(kernel, FP32_REPS), "plain_ms": cuda_ms(plain, 1), "library_ms": cuda_ms(library, FP32_REPS)}
    flops, nbytes = 4.0 * L * L * 64 * H * B, 4 * B * H * L * 64 * 4
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    ffma, tf32x3 = bound(flops, nbytes, PEAK_FP32_FLOPS), bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    row["ffma_bound_ms"], row["tf32x3_bound_ms"] = ffma[0], tf32x3[0]
    row["bound_ms"], row["bound_by"] = min(ffma, tf32x3)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    del qkv, q, k, v, bhld, out, out2, ref, diff
    torch.cuda.empty_cache()
    return row


def fp32_sums(rows: list[dict]) -> dict:
    bound_ms, bound_by = sum_bounds(rows)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            **{key: sum(r[key] for r in rows) for key in ("ms", "plain_ms", "library_ms")},
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_fp32_flash(gen) -> dict:
    """`fp32_flash_attention`: the fp32 entry of K1, K3 and K4
    (csrc/flash_attention_fp32.cu, 3xTF32 on the tensor cores) in each
    route's layout at the 576x576 render's self-attention shapes (K4: the
    ones it takes), against the plain fp32 versions at FP32_FWD_REL_L2 and
    FP32_FWD_MAX_ABS (K1's log-sum-exp at FP32_LSE_MAX_ABS), each with a
    second launch that must give the same bits; ptxas's registers and
    spills of the kernel."""
    ptxas = start_ptxas("flash_attention_fp32")
    rows = {layout: [fp32_flash_row(gen, layout, *shape) for shape in (K4_SHAPES if layout == "k4" else K1_SHAPES)]
            for layout in ("k1", "k3", "k4")}
    ok = all(r["finite"] and r["repeat_bit_equal"] and r["rel_l2"] <= FP32_FWD_REL_L2
             and r["max_abs_err"] <= FP32_FWD_MAX_ABS and r.get("lse_max_abs_err", 0.0) <= FP32_LSE_MAX_ABS
             for rs in rows.values() for r in rs)
    sums = {}
    for layout, rs in rows.items():
        sm = fp32_sums(rs) | {key: sum(r[key] for r in rs) for key in ("ffma_bound_ms", "tf32x3_bound_ms")}
        sums[layout] = sm | {"bound_share": sm["bound_ms"] / sm["ms"]}
    usage = read_ptxas(ptxas, ("flash_fwd_fp32_kernel",))
    emit({"phase": "fp32_flash_attention", "ok": ok,
          "bar": {"rel_l2": FP32_FWD_REL_L2, "max_abs": FP32_FWD_MAX_ABS, "lse_max_abs": FP32_LSE_MAX_ABS},
          "sums": sums, "shapes": rows, "ptxas": usage,
          "library": "F.scaled_dot_product_attention with SDPBackend.EFFICIENT_ATTENTION (the flash "
                     "backend takes no fp32) on (B, H, L, 64) views of the same tensors"})
    if not ok:
        raise AssertionError("the fp32 flash forward disagrees with its plain version")
    k1 = sums["k1"]
    return {**k1, "by_layout": sums, "bound_ffma_ms": k1["ffma_bound_ms"], "bound_tf32x3_ms": k1["tf32x3_bound_ms"],
            "ptxas": usage.get("flash_fwd_fp32_kernel"),
            "library": "SDPA, memory-efficient backend, fp32, on the same views"}


def start_ptxas(source: str) -> subprocess.Popen:
    """Start compiling csrc/<source>.cu with -Xptxas -v into build/ptxas/,
    for `read_ptxas`."""
    from stable_virtual_camera_tpu_torch import _kernels

    out_dir = _kernels.BUILD_DIR.parent / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                             str(out_dir / f"{source}.so"), str(_kernels.CSRC / f"{source}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc


def read_ptxas(proc: subprocess.Popen, kernels: tuple[str, ...]) -> dict:
    """The compiler's return code and each of `kernels`' registers, stack
    and spill bytes from a `start_ptxas` run."""
    text, _ = proc.communicate()
    out: dict = {"rc": proc.returncode}
    name = None
    for ln in text.splitlines():
        if "Compiling entry" in ln:
            name = next((k for k in kernels if k in ln), None)
        elif name and "spill stores" in ln:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", ln)]
            out[name] = {"stack_bytes": nums[0], "spill_store_bytes": nums[1], "spill_load_bytes": nums[2]}
        elif name and "Used" in ln and "registers" in ln:
            out.setdefault(name, {})["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def check_fp32_flash_bwd(gen) -> dict:
    """`fp32_flash_bwd`: the fp32 entries of K1-dKV and K1-dQ
    (csrc/flash_attention_bwd_fp32.cu, 3xTF32 on the tensor cores) at the
    training shapes, on K1's fp32 output and log-sum-exp, against the plain
    fp32 backward at FP32_BWD_REL_L2, with SDPA's memory-efficient backward
    (dq, dk, dv) as the one-call yardstick. Each kernel's bound is the
    smaller of its FLOP at the FFMA rate and three times its FLOP at the
    TF32 rate (or its bytes); a second launch of each must give the same
    bits; ptxas's registers and spills of both kernels."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
        attention_delta,
        flash_attention_bwd_dkv_cuda,
        flash_attention_bwd_dq_cuda,
        flash_attention_bwd_plain,
        flash_attention_cuda,
    )

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    ptxas = start_ptxas("flash_attention_bwd_fp32")
    rows = []
    for L, B, H in K1_TRAIN_SHAPES:
        qkv = torch.randn((B, L, 3, H, 64), generator=gen, device=DEVICE)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        do = torch.randn((B, L, H, 64), generator=gen, device=DEVICE).transpose(1, 2)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)
        delta = attention_delta(o, do)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
        dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
        dk2, dv2 = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
        dq2 = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
        pq, pk, pv = flash_attention_bwd_plain(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        row = {"L": L, "B": B, "H": H,
               "repeat_bit_equal": all(torch.equal(a, b) for a, b in ((dk, dk2), (dv, dv2), (dq, dq2))),
               "rel_l2": {"dq": rel(dq, pq), "dk": rel(dk, pk), "dv": rel(dv, pv)},
               "max_abs_err": {"dq": (dq - pq).abs().max().item(),
                               "dkv": max((dk - pk).abs().max().item(), (dv - pv).abs().max().item())},
               "finite": bool(all(torch.isfinite(t).all() for t in (dq, dk, dv))),
               "dkv_ms": cuda_ms(lambda: flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta), 2),
               "dq_ms": cuda_ms(lambda: flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta), 2),
               "delta_ms": cuda_ms(lambda: attention_delta(o, do), 2),
               "plain_ms": cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do), 1)}
        del pq, pk, pv, dq, dk, dv, dq2, dk2, dv2
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            out = torch.nn.functional.scaled_dot_product_attention(*leaves)
            row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 2)
        del out, leaves
        n = 64 * B * H
        row["dkv_tflops"] = 8.0 * L * L * n / (row["dkv_ms"] * 1e-3) / 1e12
        row["dq_tflops"] = 6.0 * L * L * n / (row["dq_ms"] * 1e-3) / 1e12
        for part, flops, nbytes in (("dkv", 8.0 * L * L * n, (6 * L * 64 * 4 + 2 * L * 4) * B * H),
                                    ("dq", 6.0 * L * L * n, (5 * L * 64 * 4 + 2 * L * 4) * B * H)):
            ffma = bound(flops, nbytes, PEAK_FP32_FLOPS)
            tf32x3 = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
            row[f"{part}_ffma_bound_ms"], row[f"{part}_tf32x3_bound_ms"] = ffma[0], tf32x3[0]
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = min(ffma, tf32x3)
            row[f"{part}_bound_share"] = row[f"{part}_bound_ms"] / row[f"{part}_ms"]
        rows.append(row)
        del qkv, q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    ok = all(r["finite"] and r["repeat_bit_equal"] and max(r["rel_l2"].values()) <= FP32_BWD_REL_L2 for r in rows)
    sums = {key: sum(r[key] for r in rows)
            for key in ("dkv_ms", "dq_ms", "delta_ms", "plain_ms", "library_ms", "dkv_ffma_bound_ms",
                        "dkv_tf32x3_bound_ms", "dq_ffma_bound_ms", "dq_tf32x3_bound_ms")}
    sums["pair_ms"] = sums["dkv_ms"] + sums["dq_ms"]
    usage = read_ptxas(ptxas, ("flash_bwd_dkv_fp32_kernel", "flash_bwd_dq_fp32_kernel"))
    emit({"phase": "fp32_flash_bwd", "ok": ok, "bar": {"rel_l2": FP32_BWD_REL_L2}, "sums": sums, "shapes": rows,
          "ptxas": usage,
          "library": "the backward of F.scaled_dot_product_attention with SDPBackend.EFFICIENT_ATTENTION, fp32"})
    if not ok:
        raise AssertionError("the fp32 backward kernels disagree with the plain backward")
    common = {"plain_ms": sums["plain_ms"], "library_ms": sums["library_ms"], "delta_ms": sums["delta_ms"],
              "plain_and_library_cover": "K1-dKV and K1-dQ together with the plain D reduction (the plain "
                                         "backward and SDPA's each compute dq, dk and dv)"}
    out = {}
    for name, part in (("flash_attention_bwd_dkv_fp32", "dkv"), ("flash_attention_bwd_dq_fp32", "dq")):
        bound_ms, bound_by = sum_bounds(rows, f"{part}_")
        out[name] = {"max_abs_err": max(r["max_abs_err"][part] for r in rows), "ms": sums[f"{part}_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / sums[f"{part}_ms"],
                     "bound_ffma_ms": sums[f"{part}_ffma_bound_ms"],
                     "bound_tf32x3_ms": sums[f"{part}_tf32x3_bound_ms"],
                     "ptxas": usage.get(f"flash_bwd_{part}_fp32_kernel"), **common}
    return out


def k2_any_row(gen, S: int, H: int, D: int, num_frames: int, b: int, dtype, cold: bool = False) -> dict:
    """K2's entry for any head dim and dtype (csrc/time_attention_any.cu)
    against its plain version at one (S, H, D, T, b), on the UNet's views of
    a (b*T, 3, H, D, S) projection, with SDPA on permuted views as the
    one-call yardstick, warm (`ms`, `library_ms`: back to back on one
    projection) and, with `cold`, as `k2_row` reads K2: rotating over at
    least K2_COLD_BYTES of projections (`cold_ms`, `library_cold_ms`) and by
    torch.profiler's device time over that rotation (`device_us`,
    `library_device_us`). `bound_share` and `gb_per_s` are from the cold
    device time where it was read, else from the warm time; the copy mode
    the plan took is `copy`."""
    import torch

    from stable_virtual_camera_tpu_torch.ops.time_attention import (
        _any_plan,
        time_attention_any_cuda,
        time_attention_plain,
    )

    def projection():
        return torch.randn((b * num_frames, 3, H, D, S), generator=gen, device=DEVICE).to(dtype).unbind(1)

    q, k, v = projection()
    out = time_attention_any_cuda(q, k, v, num_frames).float()
    ref = time_attention_plain(q, k, v, num_frames).float()
    torch.cuda.synchronize()
    row = {"S": S, "H": H, "D": D, "T": num_frames, "b": b, "dtype": str(dtype).replace("torch.", ""),
           "copy": _any_plan(q, k, v, num_frames).copy,
           "rel_l2": ((out - ref).norm() / ref.norm()).item(), "max_abs_err": (out - ref).abs().max().item(),
           "max_bf16_steps": bf16_steps(out, ref), "finite": bool(torch.isfinite(out).all()),
           "ms": cuda_ms(lambda: time_attention_any_cuda(q, k, v, num_frames), K2_REPS),
           "plain_ms": cuda_ms(lambda: time_attention_plain(q, k, v, num_frames), 3),
           "library_ms": cuda_ms(lambda: time_sdpa(q, k, v, num_frames), K2_REPS)}
    del out, ref
    nbytes = 4 * b * num_frames * H * D * S * q.element_size()
    row["bound_ms"], row["bound_by"] = bound(4.0 * num_frames * num_frames * D * b * S * H, nbytes, PEAK_FP32_FLOPS)
    seconds = row["ms"] * 1e-3
    if cold:
        n = -(-int(K2_COLD_BYTES) // (nbytes * 3 // 4))
        inputs = [(q, k, v)] + [projection() for _ in range(n - 1)]
        any_cold = rotating(lambda qi, ki, vi, oi: time_attention_any_cuda(qi, ki, vi, num_frames, out=oi),
                            [(*qkv, torch.empty_like(qkv[0], memory_format=torch.contiguous_format))
                             for qkv in inputs])
        lib_cold = rotating(lambda qi, ki, vi: time_sdpa(qi, ki, vi, num_frames), inputs)
        row |= {"cold_inputs": n, "cold_ms": cuda_ms(any_cold, K2_REPS),
                "library_cold_ms": cuda_ms(lib_cold, K2_REPS)}
        row["device_us"], row["kernel_classes"] = device_us(any_cold, K2_PROFILED)
        row["library_device_us"], row["library_kernel_classes"] = device_us(lib_cold, K2_PROFILED)
        row["library_bound_share"] = row["bound_ms"] * 1e3 / row["library_device_us"]
        row["host_bound"] = row["cold_ms"] * 1e3 > LN_HOST_BOUND * row["device_us"]
        seconds = row["device_us"] * 1e-6
        del inputs, any_cold, lib_cold
    row["gb_per_s"] = nbytes / seconds / 1e9
    row["bound_share"] = row["bound_ms"] * 1e-3 / seconds
    del q, k, v
    torch.cuda.empty_cache()
    return row


def k2_any_ok(row: dict) -> bool:
    bar = row["rel_l2"] <= K2_ANY_REL_L2 if row["dtype"] == "float32" else row["max_bf16_steps"] <= K2_BF16_STEPS
    return row["finite"] and bar


# csrc/time_attention_any.cu's instantiations as ptxas names them: the
# element type's mangled name and the key-frame ceiling
K2_ANY_INSTANCES = {f"time_any_kernelI{code}Li{tc}E": f"{name} Tc={tc}"
                    for code, name in (("f", "float32"), ("13__nv_bfloat16", "bfloat16"), ("6__half", "float16"))
                    for tc in (4, 8, 16, 21, 24, 32)}


def check_time_any(gen, tiny_shapes) -> dict:
    """`k2_any_time_attention`: K2's entry for any head dim and dtype at the
    fp32 render's time-mix shapes (576x576, T=21, b=2, head dim 64; warm,
    cold and by device time, the bound share from the cold device time) and
    at the tiny fp32 CLI's (`tiny_shapes`, noted in f1_fp32_routes: head dim
    16), in fp32 at K2_ANY_REL_L2, and at the tiny CLI's in bf16 at one bf16
    step; a second launch at K2_REPEAT_SHAPE in fp32 must give the same
    bits; SDPA on permuted views as the yardstick, its backend named by its
    kernels in one profiled call; ptxas's registers and spills of each of
    the kernel's instantiations."""
    import torch

    from stable_virtual_camera_tpu_torch.ops.time_attention import time_attention_any_cuda

    ptxas = start_ptxas("time_attention_any")
    render = [k2_any_row(gen, S, H, 64, T, 2, torch.float32, cold=True) for S, H in K2_SHAPES]
    tiny = [k2_any_row(gen, S, H, D, t, b, dt) for dt in (torch.float32, torch.bfloat16)
            for S, H, D, t, b in sorted(tiny_shapes, reverse=True)]
    S, H, t, b = K2_REPEAT_SHAPE
    q = torch.randn((b * t, 3, H, 64, S), generator=gen, device=DEVICE).unbind(1)
    repeat_bit_equal = bool(torch.equal(time_attention_any_cuda(*q, t), time_attention_any_cuda(*q, t)))
    del q
    ok = all(k2_any_ok(r) for r in render + tiny) and bool(tiny) and repeat_bit_equal
    q = torch.randn((2 * T, 5, 64, 5184), generator=gen, device=DEVICE)
    backend = list(device_time_by_class(lambda: (time_sdpa(q, q, q, T), torch.cuda.synchronize()),
                                        top=3)["top_kernels_ms"])
    del q
    found = read_ptxas(ptxas, tuple(K2_ANY_INSTANCES))
    usage = {"rc": found["rc"], **{K2_ANY_INSTANCES[k]: found[k] for k in K2_ANY_INSTANCES if k in found}}
    instances = [u for key, u in usage.items() if key != "rc"]
    usage["max_registers"] = max((u.get("registers", 0) for u in instances), default=None)
    usage["spill_bytes"] = sum(u.get("spill_store_bytes", 0) + u.get("spill_load_bytes", 0) for u in instances)
    render_sum = summary(render)
    emit({"phase": "k2_any_time_attention", "ok": ok,
          "bar": {"fp32_rel_l2": K2_ANY_REL_L2, "bf16_steps": K2_BF16_STEPS},
          "render_fp32": render_sum, "tiny_cli": rows_sum(tiny), "repeat_bit_equal": repeat_bit_equal,
          "ptxas": usage, "shapes": {"render": render, "tiny": tiny}, "library_kernels_at_5184": backend})
    if not ok:
        raise AssertionError("K2's entry for any head dim disagrees with its plain version or a repeat differs")
    return {**render_sum, "tiny_cli": rows_sum(tiny), "ptxas": usage,
            "library": "scaled_dot_product_attention on (b, S, H, T, D) permuted views (their head dim is "
                       f"strided); kernels at (5184, 5, 64): {backend}"}


def rows_sum(rows: list[dict]) -> dict:
    return fp32_sums(rows) if rows else {}


def check_fp32_routes(bundle, upstream: dict, gen, tiny_shapes: set) -> dict:
    """`f1_fp32_routes`: fp32 models on the card run the kernels' fp32
    entries, as JAX's fp32 models run its Pallas kernels. (a) The demo CLI
    with --random_model True (the tiny fp32 bundle, head dim 16) renders
    the golden scene in two passes, launching K2's other entry
    (time_attention_any) and no bf16 kernel, its frames within one uint8
    step of the same render with attention="plain"; its K2 shapes go into
    `tiny_shapes`. (b) The full-width SevaSpec() bundle in fp32 runs one
    forward on one 21-frame scene at 576x576: FP32_FORWARD_LAUNCHES (fp32
    K1 at its 14 sites, K2's other entry at its 16), within FP32_REL_L2 of
    the bf16 network through the kernels and FP32_PLAIN_REL_L2 of the same
    forward with attention="plain"; (c) the same forward with "flash" (K3's
    fp32 entry) and "packed" (K4's), each within FP32_PLAIN_REL_L2 of
    "plain"; (d) one fp32 loss and backward (T=21, per-block remat) through
    the kernels against the plain forward and backward of K1 and K2: loss
    within FP32_TRAIN_LOSS_REL, gradient within FP32_TRAIN_GRAD_REL_L2.
    Returns the launch counts by path."""
    import cv2
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps import cli
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.models import unet as unet_mod
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec
    from stable_virtual_camera_tpu_torch.models.io import random_bundle
    from stable_virtual_camera_tpu_torch.training.train_step import make_loss_fn

    bf16_kernels = ("flash_attention", "time_attention", "flash_attention_blhd", "flash_attention_packed")
    frames, tiny = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for attention in (None, "plain"):
            _kernels.reset_counts()
            t0 = time.perf_counter()
            shapes: dict = {}
            with recording_shapes(shapes):
                (out_dir,) = cli.main(GOLDEN, task="img2trajvid", use_traj_prior=True, random_model=True,
                                      device=DEVICE, work_dir=os.path.join(tmp, str(attention)), num_steps=2,
                                      guider_types=[1, 2], cfg=[2.0, 2.0], sampler_verbose=False,
                                      attention=attention)
            torch.cuda.synchronize()
            tiny[str(attention)] = {"seconds": time.perf_counter() - t0, "launches": _kernels.counts()}
            if attention is None:
                tiny_shapes.update(shapes.get("time_attention_dims", ()))
            frames_dir = os.path.join(out_dir, "samples-rgb")
            frames[str(attention)] = [cv2.imread(os.path.join(frames_dir, f)) for f in sorted(os.listdir(frames_dir))
                                      if f.endswith(".png")]
    kern, plain = frames["None"], frames["plain"]
    steps = max((int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) for a, b in zip(kern, plain)),
                default=-1)
    tiny_launches = tiny["None"]["launches"]
    tiny_ok = (bool(kern) and len(kern) == len(plain) and all(f is not None and f.shape == (64, 64, 3) for f in kern)
               and 0 <= steps <= 1 and tiny_launches["time_attention_any"] > 0
               and not any(tiny_launches[k] for k in bf16_kernels)
               and not any(tiny["plain"]["launches"].values()) and bool(tiny_shapes))

    fp32 = random_bundle(SevaSpec(), ClipVisionSpec(), device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    x, t_idx, ctx, dense = (t[:T] for t in upstream["inputs"])
    forwards, launches = {}, {}
    with torch.inference_mode():
        for attention in ("upstream", "plain", "flash", "packed"):
            set_attention(fp32.unet, attention)
            torch.cuda.synchronize()
            _kernels.reset_counts()
            t0 = time.perf_counter()
            forwards[attention] = fp32.unet(x, t_idx, ctx, dense, T)
            torch.cuda.synchronize()
            launches[attention] = {"seconds": time.perf_counter() - t0, **_kernels.counts()}
        out16 = bundle.unet(x, t_idx, ctx, dense, T).float()
    set_attention(fp32.unet, "upstream")
    dtype = next(fp32.unet.parameters()).dtype
    ref = forwards["plain"]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    fwd = {name: {"rel_l2_vs_plain": rel(out, ref), "finite": bool(torch.isfinite(out).all()),
                  "seconds": launches[name].pop("seconds"), "launches": launches[name]}
           for name, out in forwards.items()}
    rel16 = rel(out16, forwards["upstream"])
    del forwards, out16, ref
    torch.cuda.empty_cache()
    up = fwd["upstream"]["launches"]
    fwd_ok = (dtype == torch.float32 and rel16 <= FP32_REL_L2 and fwd["plain"]["finite"]
              and all(up[k] == n for k, n in FP32_FORWARD_LAUNCHES.items())
              and not any(up[k] for k in bf16_kernels) and not any(fwd["plain"]["launches"].values())
              and all(fwd[n]["finite"] and fwd[n]["rel_l2_vs_plain"] <= FP32_PLAIN_REL_L2
                      and fwd[n]["launches"]["flash_attention_fp32"] > 0
                      and not any(fwd[n]["launches"][k] for k in bf16_kernels)
                      for n in ("upstream", "flash", "packed")))

    # (d) the fp32 loss and backward, per-block remat
    unet = fp32.unet
    batch, draw = train_inputs(fp32, gen)
    loss_fn = make_loss_fn(unet, TRAIN_T, remat=True)

    def run():
        unet.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = loss_fn(batch, draw)
        loss.backward()
        torch.cuda.synchronize()
        out = {"loss": loss.item(), "s": time.perf_counter() - t0,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        grads = {n: p.grad for n, p in unet.named_parameters() if p.grad is not None}
        unet.zero_grad(set_to_none=True)
        return out, grads

    _kernels.reset_counts()
    train_k, g_k = run()
    train_k["launches"] = _kernels.counts()
    saved = unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds
    unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds = plain_attention_functions()
    try:
        _kernels.reset_counts()
        train_p, g_p = run()
        train_p["launches"] = _kernels.counts()
    finally:
        unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds = saved
    norm = torch.stack([g.norm() for g in g_p.values()]).norm()
    grad_rel = (torch.stack([(g_k[n] - g_p[n]).norm() for n in g_p]).norm() / norm).item()
    loss_rel = abs(train_k["loss"] - train_p["loss"]) / abs(train_p["loss"])
    train_launches = train_k["launches"]
    train_ok = (loss_rel <= FP32_TRAIN_LOSS_REL and grad_rel <= FP32_TRAIN_GRAD_REL_L2 and set(g_k) == set(g_p)
                and all(torch.isfinite(g).all() for g in g_k.values())
                and all(train_launches[k] > 0 for k in FP32_TRAIN_KERNELS)
                and not any(train_launches[k] for k in TRAIN_KERNELS)
                and not any(train_p["launches"].values()))
    del fp32, unet, batch, g_k, g_p, loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    ok = tiny_ok and fwd_ok and train_ok
    emit({"phase": "f1_fp32_routes", "ok": ok,
          "tiny_cli": {"ok": tiny_ok, "frames": len(kern), "max_uint8_steps_vs_plain": steps, "bar_uint8_steps": 1,
                       "k2_shapes": sorted(map(list, tiny_shapes)), **tiny},
          "full_width_fp32_forward": {"ok": fwd_ok, "dtype": str(dtype), "frames": T,
                                      "rel_l2_bf16_kernels_vs_fp32_kernels": rel16, "bar_bf16": FP32_REL_L2,
                                      "bar_vs_plain": FP32_PLAIN_REL_L2,
                                      "launches_expected": FP32_FORWARD_LAUNCHES, "backends": fwd},
          "fp32_loss_backward": {"ok": train_ok, "frames": TRAIN_T, "remat": "per block", "loss_rel": loss_rel,
                                 "grad_rel_l2": grad_rel,
                                 "bar": {"loss_rel": FP32_TRAIN_LOSS_REL, "grad_rel_l2": FP32_TRAIN_GRAD_REL_L2},
                                 "kernels": train_k, "plain": train_p}})
    if not ok:
        raise AssertionError("an fp32 path missed its kernels, failed or left its bar")
    return {"fp32_tiny_cli": tiny_launches, "fp32_forward": up, "fp32_flash": fwd["flash"]["launches"],
            "fp32_packed": fwd["packed"]["launches"], "fp32_train": train_launches}


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
    to K2, as (S, H, T, b) and with its head dim as (S, H, D, T, b), in
    `shapes`; the calls go on to the kernels."""
    from stable_virtual_camera_tpu_torch.models import unet as unet_mod

    k1, k2 = unet_mod.flash_attention_upstream_bhld, unet_mod.time_attention_bhds

    def k1_noted(q, k, v):
        B, H, L, _ = q.shape
        shapes.setdefault("flash_attention", set()).add((L, B, H))
        return k1(q, k, v)

    def k2_noted(q, k, v, num_frames):
        BT, H, D, S = q.shape
        shapes.setdefault("time_attention", set()).add((S, H, num_frames, BT // num_frames))
        shapes.setdefault("time_attention_dims", set()).add((S, H, D, num_frames, BT // num_frames))
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


def run_main_path(bundle, shapes: dict, out: dict) -> dict:
    """The Basic render at full width; its uint8 anchors and frames go into
    `out` (gui_path holds the app's render against them)."""
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
    out.update(anchors=anchors, frames=frames)

    ok = (
        frames.dtype == np.uint8
        and frames.shape == (NUM_TARGETS, RES, RES, 3)
        and anchors.shape[1:] == (RES, RES, 3)
        and float(frames.std()) > 0.0
        and counts["flash_attention"] > 0 and counts["time_attention"] > 0
        and counts["flash_attention_blhd"] == 0 and counts["flash_attention_packed"] == 0
    )
    # the digest scripts/eager_path_ab.py prints for any checkout, so one
    # run can be held against another's bits
    digest = hashlib.sha256(anchors.tobytes() + frames.tobytes()).hexdigest()
    emit({"phase": "main_path", "ok": ok, "frames": list(frames.shape), "dtype": str(frames.dtype),
          "anchor_frames": list(anchors.shape), "frame_std": float(frames.std()), "frames_sha256": digest,
          "first_pass_s": t1 - t0, "second_pass_s": t2 - t1, "launches": counts})
    if not ok:
        raise AssertionError("main path output or kernel launch counts are wrong")
    return counts


def run_cli_path(frames_by_run: dict) -> dict:
    """The demo CLI at full width: three renders through apps.cli.main, each
    with its own --random_model full bundle, outputs in a temporary
    directory, launch counts read around each. Returns the counts summed
    over the three runs; each run's frames go into `frames_by_run`."""
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
                frames_by_run[name] = frames
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


def run_checkpoint_path(reference_frames) -> dict:
    """`checkpoint_path`: the full-width bf16 bundle that --random_model full
    builds, written as the released files (model/vae/clip.safetensors,
    through the port's inverse key maps and safetensors writer), converted
    by apps.convert_weights, loaded back from both layouts (each bit-equal
    to the bundle), then cli_path's img2img run (c) again with
    --checkpoint_dir on the converted cache, its frames within one uint8
    step of run (c)'s and K1/K2 launched. Returns the render's counts."""
    import cv2
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps import cli, convert_weights
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.models import convert
    from stable_virtual_camera_tpu_torch.models import io as mio
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec

    spec, clip_spec = SevaSpec(), ClipVisionSpec()
    bundle = mio.random_bundle(spec, clip_spec, dtype=torch.bfloat16, device=DEVICE,
                               generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    ref = {"unet": bundle.unet, "vae": bundle.vae.module, "clip": bundle.clip.module}
    inverse = {"unet": lambda sd: convert.seva_to_released(sd, spec), "vae": convert.vae_to_released,
               "clip": lambda sd: convert.clip_to_open_clip(sd, clip_spec)}
    seconds: dict = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        return out

    def equal(loaded) -> bool:
        got = {"unet": loaded.unet, "vae": loaded.vae.module, "clip": loaded.clip.module}
        for name, module in ref.items():
            a, b = module.state_dict(), got[name].state_dict()
            if a.keys() != b.keys() or not all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                                               for k in a):
                return False
        return True

    with tempfile.TemporaryDirectory() as tmp:
        released, cache = os.path.join(tmp, "released"), os.path.join(tmp, "converted")
        os.makedirs(released)
        files = {name: os.path.join(released, f"{'model' if name == 'unet' else name}.safetensors")
                 for name in ref}
        for name, module in ref.items():
            timed(f"write_{name}", lambda: mio.write_safetensors(inverse[name](module.state_dict()),
                                                                 files[name]))
        manifest = timed("convert", lambda: convert_weights.main(**files, out=cache, device=DEVICE))
        sizes = {f"released_{k}": os.path.getsize(p) for k, p in files.items()}
        sizes.update({f"converted_{k}": os.path.getsize(mio.cache_file(cache, k)) for k in ref})
        loads = {}
        for layout, directory in (("released", released), ("converted", cache)):
            loaded = timed(f"load_bundle_{layout}", lambda: mio.load_bundle(directory, device=DEVICE))
            loads[layout] = equal(loaded)
            del loaded
        del bundle, ref
        torch.cuda.empty_cache()
        _kernels.reset_counts()
        (out_dir,) = timed("cli_render", lambda: cli.main(
            GOLDEN, task="img2img", checkpoint_dir=cache, work_dir=os.path.join(tmp, "work"),
            num_steps=NUM_STEPS, device=DEVICE, sampler_verbose=False, use_traj_prior=False))
        counts = _kernels.counts()
        pngs = sorted(f for f in os.listdir(os.path.join(out_dir, "samples-rgb")) if f.endswith(".png"))
        frames = np.stack([cv2.imread(os.path.join(out_dir, "samples-rgb", f))[..., ::-1] for f in pngs])
    diff = int(np.abs(frames.astype(np.int16) - reference_frames.astype(np.int16)).max()) \
        if frames.shape == reference_frames.shape else None
    ok = (all(loads.values()) and diff is not None and diff <= 1
          and counts["flash_attention"] > 0 and counts["time_attention"] > 0)
    emit({"phase": "checkpoint_path", "ok": ok, "dtype": "bfloat16", "seconds": seconds,
          "bytes": sizes, "params": manifest["totals"], "bit_equal_loads": loads,
          "frames": list(frames.shape), "max_uint8_diff_vs_cli_img2img": diff, "bar_uint8": 1,
          "launches": counts, "cuts": {
              "weights": "random bf16 (flax-default init, seed 0), full width: the released "
                         "files are not in the repository",
              "num_steps": f"{NUM_STEPS} (CLI default 50)"}})
    if not ok:
        raise AssertionError("the checkpoint path's loads, frames or launch counts are wrong")
    return counts


def bf16_steps(out, ref):
    """|out - ref| in units of one bf16 step (the spacing of bf16 values at
    |ref|, at least 2^-17, so that the fp32 rounding of two sum orders near
    zero does not count as a step)."""
    import torch

    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0**-10))) - 7)
    return ((out - ref).abs() / step).max().item()


def device_us(fn, launches: int) -> tuple[float, list[str]]:
    """torch.profiler over `launches` calls of `fn` after one warm-up call:
    the device time of the kernels one call runs (us), and their classes.
    Each kernel counts at its mean time times the launches of it a call
    makes, ceil(its records / `launches`): late in a long process the
    profiler was seen to drop a quarter of a window's kernel records, which
    a sum over `launches` would read as a faster kernel. A window with no
    kernel record is taken again, up to twice; if the third is empty too
    (seen once, late in a whole run), CUDA events over `launches` calls
    give the time instead, and the classes say so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stable_virtual_camera_tpu_torch.utils.trace_analysis import categorize

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        us, classes = 0.0, set()
        for e in prof.key_averages():
            total = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
            if e.device_type != DeviceType.CUDA or not e.count or not total:
                continue
            us += total / e.count * math.ceil(e.count / launches)
            classes.add(categorize(e.key))
        if us > 0:
            return us, sorted(classes)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / launches, ["no profiler records: CUDA events"]


def rotating(fn, args: list):
    """A call of `fn` on the next of `args` each time, round and round."""
    it = itertools.cycle(args)
    return lambda: fn(*next(it))


def k5_row(gen, R: int, C: int) -> dict:
    """K5 against its plain version at (R, C) bf16, timed with F.layer_norm
    as the one-call yardstick in three readings each: warm (`ms`,
    `library_ms`: back to back on one x, which stays in L2 where it fits),
    cold (`cold_ms`, `library_cold_ms`: rotating over distinct inputs, and
    for K5 outputs, whose x bytes together exceed LN_COLD_BYTES, so no
    launch finds its x in L2) and the device time per launch from
    torch.profiler (`device_us` cold, `device_warm_us` warm). The bound
    share and GB/s are from the cold device time; a cold event reading more
    than LN_HOST_BOUND times it measured the host (`host_bound`)."""
    import torch
    import torch.nn.functional as F

    from stable_virtual_camera_tpu_torch.ops.layer_norm import ln_fused, ln_fused_cuda, ln_reduce

    def bf16(shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen, device=DEVICE)).to(torch.bfloat16)

    x, g, b = bf16((R, C)), bf16((C,), 0.1, 1.0), bf16((C,), 0.1)
    out = ln_fused(x, g, b).float()
    ref = ln_reduce(x, g, b).float()
    torch.cuda.synchronize()
    nbytes = 2 * R * C * 2 + 2 * C * 2  # x read and y written once, gamma and beta read once
    row = {"rows": R, "C": C, "max_abs_err": (out - ref).abs().max().item(),
           "max_bf16_steps": bf16_steps(out, ref), "finite": bool(torch.isfinite(out).all())}
    del out, ref
    # ~8 fp32 operations an element (sum, square-sum, subtract, two multiplies, add)
    row["bound_ms"], row["bound_by"] = bound(8.0 * R * C, nbytes, PEAK_FP32_FLOPS)
    n = -(-int(LN_COLD_BYTES) // (R * C * 2))
    xs = [x] + [bf16((R, C)) for _ in range(n - 1)]
    k5_cold = rotating(lambda xi, yi: ln_fused_cuda(xi, g, b, out=yi), [(xi, torch.empty_like(xi)) for xi in xs])
    lib_cold = rotating(lambda xi: F.layer_norm(xi, (C,), g, b), [(xi,) for xi in xs])
    k5_warm = lambda: ln_fused(x, g, b)  # noqa: E731
    lib_warm = lambda: F.layer_norm(x, (C,), g, b)  # noqa: E731
    row |= {"cold_inputs": n,
            "ms": cuda_ms(k5_warm, LN_REPS), "cold_ms": cuda_ms(k5_cold, LN_REPS),
            "plain_ms": cuda_ms(lambda: ln_reduce(x, g, b), 20),
            "library_ms": cuda_ms(lib_warm, LN_REPS), "library_cold_ms": cuda_ms(lib_cold, LN_REPS)}
    row["device_us"], row["kernel_classes"] = device_us(k5_cold, LN_PROFILED)
    row["device_warm_us"], _ = device_us(k5_warm, LN_PROFILED)
    row["library_device_us"], row["library_kernel_classes"] = device_us(lib_cold, LN_PROFILED)
    row["library_device_warm_us"], _ = device_us(lib_warm, LN_PROFILED)
    row["bound_share"] = row["bound_ms"] * 1e3 / row["device_us"]
    row["library_bound_share"] = row["bound_ms"] * 1e3 / row["library_device_us"]
    row["gb_per_s"] = nbytes / (row["device_us"] * 1e-6) / 1e9
    row["host_bound"] = row["cold_ms"] * 1e3 > LN_HOST_BOUND * row["device_us"]
    row["library_host_bound"] = row["library_cold_ms"] * 1e3 > LN_HOST_BOUND * row["library_device_us"]
    if C == LN_REPEAT_WIDTH:  # one launch repeated on the same inputs gives the same bits
        row["repeat_identical"] = bool(torch.equal(ln_fused(x, g, b), ln_fused(x, g, b)))
    return row


def check_k5_layer_norm(gen) -> dict:
    """K5 against its plain version at the probe's shape and at the UNet's
    wider widths with ragged rows (`k5_row`: warm, cold and device
    readings of K5 and F.layer_norm); then the probe's loop
    (benchmark/ln_probe.py `make`: 32 dependent LayerNorms, h <- LN(h) +
    1e-3 h) with its launches counted."""
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.ops.layer_norm import ln_fused

    rows = [k5_row(gen, R, C) for R, C in LN_SHAPES]
    torch.cuda.empty_cache()
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
    ok = (all(r["finite"] and r["max_bf16_steps"] <= 1.0 and r.get("repeat_identical", True) for r in rows)
          and any("repeat_identical" in r for r in rows)
          and probe["finite"] and counts["layer_norm"] == LN_PROBE_ITERS)
    host_bound = [[r["rows"], r["C"]] for r in rows if r["host_bound"]]
    emit({"phase": "k5_layer_norm", "ok": ok, "bar": {"bf16_steps": 1.0}, "dtype": "bfloat16",
          "shapes": rows, "probe_loop": probe,
          "host_bound": (f"K5's cold event reading exceeds its device time by more than "
                         f"{LN_HOST_BOUND - 1:.0%} at {host_bound}: the burst measured the host; "
                         f"bound_share uses the device time") if host_bound else None,
          "library": "torch.nn.functional.layer_norm (two-pass variance, bf16 in and out)"})
    if not ok:
        raise AssertionError("K5 disagrees with its plain version, repeats differ, or it missed its launches")
    first = rows[0]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "cold_ms",
            "library_cold_ms", "device_us", "library_device_us", "bound_share")
    return {"result": {k: first[k] for k in keys} | {"shape": [first["rows"], first["C"]],
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


def synthetic_scene(N: int, H: int, W: int, seed: int = SEED, noise: float = 0.0):
    """A known scene in the stereo network's output contract (the
    construction of tests/test_global_alignment.py, scaled to H x W): cameras
    on an arc looking at the origin, smooth per-image depth, and for every
    ordered pair (i, j) both pointmaps in camera i's frame at a random
    per-edge scale, with `noise` times unit-normal noise added to them, with
    confidences in [1, 10]. Returns (EdgePreds, c2ws, focal, world points)."""
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
    if noise:
        pts1 += (noise * rng.normal(size=pts1.shape)).astype(np.float32)
        pts2 += (noise * rng.normal(size=pts2.shape)).astype(np.float32)
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



# W8A8 (ops/quant.py) at full width: (name, kind, x shape, C_out, k, stride)
QUANT_OPS = [
    ("proj_gate", "dense", (42 * 5184, 320), 2560, 1, 1),
    ("proj_out", "dense", (42 * 5184, 1280), 320, 1, 1),
    ("qkv", "dense", (42 * 5184, 320), 960, 1, 1),
    ("to_v", "dense", (6, 1024), 320, 1, 1),
    ("in_conv", "conv", (42, 72, 72, 320), 320, 3, 1),
    ("downsample", "conv", (42, 72, 72, 320), 320, 3, 2),
    ("upsample", "upsample", (42, 9, 9, 1280), 1280, 3, 1),
]
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate of one H100 SXM (data sheet)
QUANT_CHECK_ROWS = 512  # rows of each _int_mm result held against the CPU product
QUANT_REPS = 10
QUANT_MODES = ("0", "w8a8", "w8a8-static")


def int_mm_rule() -> dict:
    """What torch._int_mm takes on this card: row counts around 16, and
    the second operand column-major (w.t() of an (N, K) tensor) or row-major."""
    import torch

    out = {}
    g = torch.Generator(device=DEVICE).manual_seed(SEED)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=DEVICE, dtype=torch.int8)

    for name, (m, k, n, col_major) in {"M16": (16, 64, 64, True), "M17": (17, 64, 64, True),
                                       "K12": (32, 12, 64, True), "N12": (32, 64, 12, True),
                                       "row_major_b": (32, 64, 64, False)}.items():
        a, w = i8(m, k), i8(n, k)
        b = w.t() if col_major else w.t().contiguous()
        try:
            acc = torch._int_mm(a, b)
            out[name] = "ok" if torch.equal(acc.cpu().double(), a.cpu().double() @ w.cpu().double().t()) \
                else "WRONG"
        except RuntimeError as e:
            out[name] = str(e).splitlines()[0][:120]
    return out


def quant_op_row(gen, name, kind, xshape, c_out, k, stride) -> dict:
    """One W8A8 op at a full-width shape: the int8 product bit-equal to the
    CPU's, the op within fp32 rounding of its dequantized form, and times."""
    import torch
    import torch.nn.functional as F

    from stable_virtual_camera_tpu_torch.ops import quant as tq
    from stable_virtual_camera_tpu_torch.ops.resize import (
        conv_nhwc,
        rearranged_upsample_weight,
        upsample_2x_conv3x3,
    )

    x = torch.randn(xshape, generator=gen, device=DEVICE).to(torch.bfloat16)
    c_in = xshape[-1]
    pad = k // 2
    if kind == "dense":
        w = (torch.randn((c_out, c_in), generator=gen, device=DEVICE) * c_in ** -0.5).to(torch.bfloat16)
        b = torch.zeros(c_out, device=DEVICE, dtype=torch.bfloat16)
        op = lambda out_dtype=None: tq.quantized_dense(x, w, b, out_dtype=out_dtype)  # noqa: E731
        plain = lambda: F.linear(x, w, b)  # noqa: E731
        xq, sx = tq.quantize_rowwise(x)
        wq, sw = tq.quantize_colwise(w)
        cols = xq
        quantize = lambda: tq.quantize_rowwise(x)  # noqa: E731
        M, K, N = xshape[0], c_in, c_out
    else:
        w = (torch.randn((c_out, c_in, 3, 3), generator=gen, device=DEVICE) * (9 * c_in) ** -0.5)
        w = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        b = torch.zeros(c_out, device=DEVICE, dtype=torch.bfloat16)
        if kind == "upsample":
            w2 = rearranged_upsample_weight(w)
            op = lambda out_dtype=None: tq.quantized_conv(x, w2, None, 1, 1, out_dtype=out_dtype)  # noqa: E731
            plain = lambda: upsample_2x_conv3x3(x, w, b)  # noqa: E731
            wk = w2
        else:
            op = lambda out_dtype=None: tq.quantized_conv(x, w, b, stride, pad, out_dtype=out_dtype)  # noqa: E731
            plain = lambda: conv_nhwc(x, w, b, stride, pad)  # noqa: E731
            wk = w
        xq, sx = tq.quantize_persample(x)
        wq, sw = tq.quantize_conv_kernel(wk)
        cols = tq.im2col_nhwc(xq, 3, stride, pad)
        quantize = lambda: tq.quantize_persample(x)  # noqa: E731
        wq = tq.conv_matrix(wq.contiguous(memory_format=torch.channels_last))
        M, K, N = cols.shape[0], cols.shape[1], wq.shape[0]
    acc = tq.int8_matmul(cols, wq)
    rows = torch.arange(M, device=DEVICE)
    if M > QUANT_CHECK_ROWS:
        rows = torch.cat([rows[: QUANT_CHECK_ROWS // 2], rows[-QUANT_CHECK_ROWS // 2:]])
    cpu_ref = cols[rows].cpu().double() @ wq.cpu().double().t()
    bit_equal = bool(torch.equal(acc[rows].cpu().double(), cpu_ref))
    del acc
    # the op in fp32 against the fp32 GEMM (TF32 off) of the dequantized
    # operands: each row of the columns scaled by its token's or sample's scale
    got = op(torch.float32).reshape(M, N)
    sx_rows = sx.reshape(-1).repeat_interleave(M // sx.numel())[:, None]
    ref = (cols.float() * sx_rows) @ (wq.float() * sw.reshape(-1, 1)).t()
    if kind != "upsample":
        ref = ref + b.float()
    fp32_bar = 4 * 2.0 ** -24 * K ** 0.5
    rel = ((got - ref).norm() / ref.norm()).item()
    del got, ref
    ms = cuda_ms(op, QUANT_REPS)
    mm_ms = cuda_ms(lambda: tq.int8_matmul(cols, wq), QUANT_REPS)
    q_ms = cuda_ms(quantize, QUANT_REPS)
    plain_ms = cuda_ms(plain, QUANT_REPS)
    out_elems = M * N if kind != "upsample" else M * c_out * 4
    nbytes = 2 * x.numel() + w.numel() * 2 + 2 * out_elems
    bound_ms, bound_by = bound(2.0 * M * K * N, nbytes, PEAK_INT8_OPS)
    bf16_bound_ms, _ = bound(2.0 * M * K * N, nbytes)
    return {"name": name, "kind": kind, "x": list(xshape), "M": M, "K": K, "N": N,
            "int_mm_bit_equal_to_cpu": bit_equal, "rows_checked": int(rows.numel()),
            "rel_vs_dequantized_fp32": rel, "fp32_bar": fp32_bar,
            "ms": ms, "int_mm_ms": mm_ms, "int_mm_tops": 2.0 * M * K * N / mm_ms / 1e9,
            "bf16_ms": plain_ms, "bf16_tflops": 2.0 * M * K * N / plain_ms / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by, "bf16_bound_ms": bf16_bound_ms,
            "quantize_ms": q_ms, "quantize_gbs": (2 * x.numel() + x.numel()) / q_ms / 1e6,
            "ok": bit_equal and rel <= fp32_bar}


def check_quant_ops(gen) -> None:
    import torch

    rule = int_mm_rule()
    rows = []
    for spec in QUANT_OPS:
        rows.append(quant_op_row(gen, *spec))
        torch.cuda.empty_cache()
    ok = all(r["ok"] for r in rows) and rule["M17"] == "ok"
    emit({"phase": "quant_ops", "ok": ok, "int_mm_rule": rule, "ops": rows,
          "bound": "int8 at 1979 TOPS (bf16: 989 TFLOP/s) or x, w and the bf16 output at 3.35 TB/s"})
    if not ok:
        raise AssertionError("a W8A8 op disagrees with the CPU product or its dequantized form")


def psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def basic_render(bundle) -> tuple:
    """Phase 7's Basic render: (frames, decoded latents by chunk, seconds,
    K1/K2 launch counts)."""
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer, preprocess_basic

    img = np.random.default_rng(SEED).integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    renderer = HeadlessRenderer(bundle, work_dir=None)
    plan = renderer.prepare(preprocess_basic(img, RES), seed=SEED, preset_traj="orbit",
                            num_frames=NUM_TARGETS, num_steps=NUM_STEPS)
    latents = []
    decode = bundle.vae.decode

    def recording(z, *a, **k):
        latents.append(torch.as_tensor(z).float().cpu())
        return decode(z, *a, **k)

    bundle.vae.decode = recording
    try:
        torch.cuda.synchronize()
        _kernels.reset_counts()
        t0 = time.perf_counter()
        gen = renderer.run(plan)
        next(gen)
        frames = next(gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _kernels.counts()
    finally:
        del bundle.vae.decode
    return frames, latents, seconds, counts


def check_quant_path(bundle, upstream: dict) -> dict:
    """The Basic render under w8a8 and w8a8-static against the bf16 one, and
    one forward per mode. Leaves the bundle exact, without quant state."""
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch.engine import runner as runner_mod

    unet = bundle.unet
    calib = []
    ensure = runner_mod.ensure_quant_calibrated

    def timed_calibration(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ran = ensure(*a, **k)
        torch.cuda.synchronize()
        if ran:
            calib.append(time.perf_counter() - t0)
        return ran

    renders, counts, forwards = {}, {}, {}
    runner_mod.ensure_quant_calibrated = timed_calibration
    try:
        for mode in ("0", "w8a8", "w8a8-static", "w8a8-static"):
            unet.set_quant(mode)
            key = mode if mode not in renders else mode + "_again"
            frames, latents, seconds, c = basic_render(bundle)
            renders[key] = {"frames": frames, "latents": latents, "s": seconds}
            counts[key] = c
        x, t_idx, ctx, dense = upstream["inputs"]
        for mode in QUANT_MODES:
            unet.set_quant(mode)

            def forward():
                with torch.inference_mode():
                    out = unet(x, t_idx, ctx, dense, T)
                torch.cuda.synchronize()
                return out

            forward()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = forward()
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            prof = device_time_by_class(forward, top=8)
            forwards[mode] = {"wall_s": wall, "peak_gb_above_weights_and_inputs": peak,
                              "finite": bool(torch.isfinite(out).all()), "profile": prof}
            del out
    finally:
        runner_mod.ensure_quant_calibrated = ensure
        unet.set_quant("0")
        unet.clear_quant_state()
        gc.collect()
        torch.cuda.empty_cache()
    ref = renders["0"]
    modes = {}
    for key in ("w8a8", "w8a8-static"):
        r = renders[key]
        lat = torch.cat([z.flatten() for z in r["latents"]])
        lat_ref = torch.cat([z.flatten() for z in ref["latents"]])
        modes[key] = {"render_s": r["s"], "launches": counts[key],
                      "finite": bool(np.isfinite(r["frames"]).all()) and bool(torch.isfinite(lat).all()),
                      "latent_rel_l2_vs_bf16": ((lat - lat_ref).norm() / lat_ref.norm()).item(),
                      "psnr_vs_bf16_db": psnr(r["frames"], ref["frames"])}
    identical = bool(np.array_equal(renders["w8a8-static"]["frames"], renders["w8a8-static_again"]["frames"]))
    launched = all(counts[k]["flash_attention"] > 0 and counts[k]["time_attention"] > 0
                   for k in ("w8a8", "w8a8-static", "w8a8-static_again"))
    ok = (launched and identical and len(calib) == 1 and all(m["finite"] for m in modes.values())
          and all(f["finite"] for f in forwards.values()))
    emit({"phase": "quant_path", "ok": ok, "bf16_render_s": ref["s"], "modes": modes,
          "calibration_s": calib, "static_again_render_s": renders["w8a8-static_again"]["s"],
          "static_repeat_bit_identical": identical, "forward_42_frames": forwards,
          "cuts": {"num_steps": f"{NUM_STEPS} (released default 50)",
                   "weights": "random bf16, full width: rel L2 and PSNR are findings, not bars"}})
    if not ok:
        raise AssertionError("the quantized render path is wrong (launches, repeat, calibration or values)")
    return {"w8a8": counts["w8a8"], "static": counts["w8a8-static"]}


def request(conn, method, path, body=None):
    """One /v1 call over `conn`: (status, JSON body)."""
    conn.request(method, path, body=json.dumps(body) if body else None)
    r = conn.getresponse()
    return r.status, json.loads(r.read() or b"{}")


def wait(conn, jid, pred, timeout):
    """Poll a job's record until `pred` holds or `timeout` seconds pass."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        rec = request(conn, "GET", f"/v1/jobs/{jid}")[1]
        if pred(rec):
            return rec
        time.sleep(0.02)
    return request(conn, "GET", f"/v1/jobs/{jid}")[1]


def frames_of(out_dir):
    """A scene's samples-rgb PNGs as one uint8 RGB array."""
    import cv2
    import numpy as np

    pngs = sorted(f for f in os.listdir(os.path.join(out_dir, "samples-rgb")) if f.endswith(".png"))
    return np.stack([cv2.imread(os.path.join(out_dir, "samples-rgb", f))[..., ::-1] for f in pngs])


IMG2IMG_JOB = {"data_path": GOLDEN, "task": "img2img", "use_traj_prior": False,
               "num_steps": NUM_STEPS, "sampler_verbose": False}
FINAL = ("done", "error", "aborted")


def check_server_path(cli_frames: dict) -> dict:
    """apps/server.py over HTTP on the full-width bundle of cli_path."""
    import http.client
    import threading

    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps import cli, server
    from stable_virtual_camera_tpu_torch.config import VersionConfig
    from stable_virtual_camera_tpu_torch.engine import runner as runner_mod

    img2img, final = IMG2IMG_JOB, FINAL
    result: dict = {}
    calls = []
    ensure = runner_mod.ensure_quant_calibrated

    def counting(*a, **k):
        ran = ensure(*a, **k)
        calls.append(ran)
        return ran

    counts: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for quant in ("0", "w8a8-static"):
            bundle, _ = cli._build_bundle(None, "full", DEVICE, quant=quant)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.warmup_buckets(bundle, VersionConfig(T=T), num_steps=NUM_STEPS)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            svc = server.RenderService(server.engine_runner(
                bundle, VersionConfig, cli._default_options, os.path.join(tmp, f"work_{quant}")))
            httpd = server.build_http_server(svc, "127.0.0.1", 0)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            conn = http.client.HTTPConnection(*httpd.server_address)
            runner_mod.ensure_quant_calibrated = counting
            try:
                entry = {"warmup_s": warm_s, "calibrated_after_warmup": bundle.unet.quant_calibrated}
                jobs = []
                _kernels.reset_counts()
                for _ in range(2 if quant == "0" else 1):
                    t0 = time.perf_counter()
                    code, out = request(conn, "POST", "/v1/jobs", img2img)
                    rec = wait(conn, out["id"], lambda r: r["status"] in final, 600)
                    jobs.append({"status": rec["status"], "error": rec["error"],
                                 "s": time.perf_counter() - t0, "outputs": rec["outputs"]})
                counts["server" if quant == "0" else "server_static"] = _kernels.counts()
                for j in jobs:
                    j["frames"] = frames_of(j["outputs"][0]) if j["status"] == "done" else None
                if quant == "0":
                    ref = cli_frames["img2img_single_pass"]
                    entry["identical_to_cli_c"] = [j["frames"] is not None and np.array_equal(j["frames"], ref)
                                                   for j in jobs]
                    long = dict(img2img, task="img2trajvid", use_traj_prior=True, num_steps=50)
                    code, out = request(conn, "POST", "/v1/jobs", long)
                    rec = wait(conn, out["id"], lambda r: r["progress"].get("step", 0) >= 1
                               or r["status"] in final, 600)
                    step_at_abort = rec["progress"].get("step")
                    abort_code = request(conn, "DELETE", f"/v1/jobs/{out['id']}")[0]
                    rec = wait(conn, out["id"], lambda r: r["status"] in final, 600)
                    entry["abort"] = {"http": abort_code, "status": rec["status"],
                                      "step_at_abort": step_at_abort, "progress": rec["progress"]}
                else:
                    entry["calibrations_in_job"] = sum(calls)
                    entry["calibrated_after_job"] = bundle.unet.quant_calibrated
                    entry["frames_finite"] = all(j["frames"] is not None and np.isfinite(j["frames"]).all()
                                                 and j["frames"].shape[1:] == (RES, RES, 3) for j in jobs)
                entry["jobs"] = [{k: v for k, v in j.items() if k not in ("frames", "outputs")} for j in jobs]
                result[quant] = entry
            finally:
                runner_mod.ensure_quant_calibrated = ensure
                conn.close()
                httpd.shutdown()
                httpd.server_close()
                svc.shutdown()
                del bundle, svc, httpd, thread
                gc.collect()
                torch.cuda.empty_cache()
    bf, st = result["0"], result["w8a8-static"]
    ok = (all(j["status"] == "done" for j in bf["jobs"] + st["jobs"]) and all(bf["identical_to_cli_c"])
          and bf["abort"]["status"] == "aborted" and not st["calibrated_after_warmup"]
          and st["calibrations_in_job"] == 1 and st["calibrated_after_job"] and st["frames_finite"])
    emit({"phase": "server_path", "ok": ok, "bf16": bf, "w8a8_static": st, "cuts": {
        "num_steps": f"{NUM_STEPS} (server default 50); the aborted job asks for 50",
        "weights": "--random_model full: random bf16 (flax-default init, seed 0), full width"}})
    if not ok:
        raise AssertionError("the HTTP service's jobs, frames, abort or calibration are wrong")
    return counts


def seeded_chunk(context_dim: int, h: int):
    """One T-frame chunk's conditioning at latent h x h from a numpy
    generator seeded with SEED: frame 0 the input view, normal Plucker maps
    and CLIP embeddings, CFG scales from 1.2 to 2.5."""
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch.sampling.sampler import ChunkConditioning

    gen = np.random.default_rng(SEED)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)

    mask = np.zeros((T, 1, 1, 1), np.float32)
    mask[0] = 1.0
    lat = gen.standard_normal((T, h, h, 4)).astype(np.float32)
    plucker = gen.standard_normal((T, h, h, 6)).astype(np.float32)
    emb = gen.standard_normal((T, 1, context_dim)).astype(np.float32)
    replace_c = np.concatenate([lat, np.ones((T, h, h, 1), np.float32)], -1) * mask
    mask_map = np.broadcast_to(mask, (T, h, h, 1))
    return ChunkConditioning(
        crossattn=dev(np.concatenate([np.zeros_like(emb), emb])),
        concat=dev(np.concatenate([np.concatenate([0 * mask_map, plucker], -1),
                                   np.concatenate([mask_map, plucker], -1)])),
        dense=dev(np.concatenate([plucker, plucker])), replace=dev(np.concatenate([0 * replace_c, replace_c])),
        scale=dev(np.linspace(1.2, 2.5, T)))


def run_export_path(cli_frames: dict) -> dict:
    """`export_path`: models/export.py on the full-width bf16 bundle of
    --random_model full (seed 0). apps.export_artifacts exports the bucket
    T=21 at 576x576 (latent 72x72) and NUM_STEPS steps into a temporary
    directory, the server's loader attaches it; then one chunk (seeded
    conditioning, the port's noise draws) is sampled through the live step
    and through the artifact: latents bit-equal, K1 and K2 launched as often
    on both and K2 given the same copy modes, the bucket called once a
    step. Last, cli_path's img2img job (c) is served over HTTP by a service
    with the artifact attached, its frames equal to (c)'s. Returns the
    launch counts of the artifact's chunk and of the served job."""
    import http.client
    import threading

    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps import cli, export_artifacts, server
    from stable_virtual_camera_tpu_torch.config import VersionConfig
    from stable_virtual_camera_tpu_torch.engine.runner import sample_latents
    from stable_virtual_camera_tpu_torch.models import export
    from stable_virtual_camera_tpu_torch.ops import time_attention as ta
    from stable_virtual_camera_tpu_torch.sampling.sampler import euler_edm_sample, torch_noise

    h = RES // 8
    bundle, _ = cli._build_bundle(None, "full", DEVICE)
    spec = bundle.spec
    weight_bytes = sum(t.nbytes for t in export.unet_state(bundle.unet).values())
    seconds: dict = {}
    exporter = export.export_denoise_buckets

    def timed_export(*a, **k):
        t0 = time.perf_counter()
        try:
            return exporter(*a, **k)
        finally:
            seconds["export_s"] = time.perf_counter() - t0

    plans: list = []
    k2_plan = ta._k2_plan

    def noted_plan(q, k, v, num_frames, out=None):
        plan = k2_plan(q, k, v, num_frames, out)
        plans.append((tuple(q.shape), q.stride(), plan.copy))
        return plan

    cond = seeded_chunk(spec.context_dim, h)
    shape = (T, h, h, 4)
    plan = bundle.plan(NUM_STEPS)

    def draw(step):
        return torch_noise(SEED, 0, 0, step, shape, DEVICE)

    runs: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "artifacts")
        export.export_denoise_buckets = timed_export
        try:
            export_artifacts.main(out_dir, random_model="full", T=T, num_steps=NUM_STEPS, device=DEVICE)
        finally:
            export.export_denoise_buckets = exporter
        manifest = json.load(open(os.path.join(out_dir, export.MANIFEST)))
        file_bytes = sum(os.path.getsize(os.path.join(out_dir, e["file"])) for e in manifest["buckets"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.attach_artifacts(bundle, out_dir)
        seconds["load_s"] = time.perf_counter() - t0
        artifact = bundle.artifacts[(T, h, h, NUM_STEPS)]
        program = artifact.program
        ta._k2_plan = noted_plan
        try:
            for name, fn in (
                ("live", lambda: euler_edm_sample(bundle.network, draw(None), plan, cond, T, step_noise=draw)),
                ("artifact", lambda: sample_latents(bundle, draw(None), plan, cond, draw)),
            ):
                plans.clear()
                calls = artifact.calls
                torch.cuda.synchronize()
                _kernels.reset_counts()
                t0 = time.perf_counter()
                x = fn()
                torch.cuda.synchronize()
                runs[name] = {"x": x, "s": time.perf_counter() - t0, "launches": _kernels.counts(),
                              "k2_plans": list(plans), "bucket_calls": artifact.calls - calls}
        finally:
            ta._k2_plan = k2_plan
        live, aot = runs["live"], runs["artifact"]
        bit_equal = bool(torch.equal(live["x"], aot["x"]))
        max_abs = float((live["x"] - aot["x"]).abs().max())

        svc = server.RenderService(server.engine_runner(
            bundle, VersionConfig, cli._default_options, os.path.join(tmp, "work")))
        httpd = server.build_http_server(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        conn = http.client.HTTPConnection(*httpd.server_address)
        try:
            calls = artifact.calls
            _kernels.reset_counts()
            t0 = time.perf_counter()
            code, out = request(conn, "POST", "/v1/jobs", IMG2IMG_JOB)
            rec = wait(conn, out["id"], lambda r: r["status"] in FINAL, 600)
            job = {"status": rec["status"], "error": rec["error"], "s": time.perf_counter() - t0,
                   "bucket_calls": artifact.calls - calls, "launches": _kernels.counts()}
            frames = frames_of(rec["outputs"][0]) if rec["status"] == "done" else None
            job["identical_to_cli_c"] = frames is not None and np.array_equal(frames, cli_frames["img2img_single_pass"])
        finally:
            conn.close()
            httpd.shutdown()
            httpd.server_close()
            svc.shutdown()
    nodes = [n for n in program.graph.nodes if n.op == "call_function"]
    kernel_ops = {}
    for n in nodes:
        if str(n.target).startswith("svc."):
            kernel_ops[str(n.target)] = kernel_ops.get(str(n.target), 0) + 1
    k1_k2 = ("flash_attention", "time_attention")
    ok = (bit_equal and aot["bucket_calls"] == NUM_STEPS and live["bucket_calls"] == 0
          and all(aot["launches"][k] == live["launches"][k] > 0 for k in k1_k2)
          and aot["launches"] == live["launches"] and aot["k2_plans"] == live["k2_plans"]
          and not program.graph_signature.parameters and not program.graph_signature.buffers
          and file_bytes < 0.01 * weight_bytes
          and job["status"] == "done" and job["identical_to_cli_c"] and job["bucket_calls"] == NUM_STEPS
          and all(job["launches"][k] > 0 for k in k1_k2))
    emit({"phase": "export_path", "ok": ok, "bucket": [T, h, h, NUM_STEPS], **seconds,
          "file_bytes": file_bytes, "weight_bytes": weight_bytes, "file_over_weights": file_bytes / weight_bytes,
          "graph_nodes": len(nodes), "kernel_ops": kernel_ops,
          "lifted_constants_bytes": sum(c.nbytes for c in program.constants.values()),
          "latents_bit_equal": bit_equal, "latents_max_abs_diff": max_abs,
          "chunk_s": {"live": live["s"], "artifact": aot["s"]},
          "bucket_calls": {"live": live["bucket_calls"], "artifact": aot["bucket_calls"]},
          "launches": {"live": live["launches"], "artifact": aot["launches"]},
          "k2_copy_modes": sorted({p[2] for p in live["k2_plans"]}),
          "k2_plans_equal": aot["k2_plans"] == live["k2_plans"], "served_job": job,
          "manifest": {k: v for k, v in manifest.items() if k != "param_fingerprint"}, "cuts": {
              "num_steps": f"{NUM_STEPS} (released default 50): the bucket is (T, h, w, steps)",
              "weights": "--random_model full: random bf16 (flax-default init, seed 0), full width",
              "chunk": "seeded conditioning (frame 0 the input), the port's noise draws"}})
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the exported step differs from the live step, or its bucket was not used")
    return {"export": aot["launches"], "export_server": job["launches"]}


class _OneRankExchange:
    """One rank's device work of an all-to-all, on one stream: the n - 1
    pieces it takes copied into buffers of its own, as
    parallel/comm.Comm._take copies them (the waits between ranks left out)."""

    def __init__(self, size: int):
        self.size = size

    def all_to_all(self, pieces):
        import torch

        return [pieces[0]] + [torch.empty(p.shape, dtype=p.dtype, device=p.device).copy_(p) for p in pieces[1:]]


def run_parallel_path(bundle) -> dict:
    """`parallel_path`: the mesh (parallel/) on the one card, its ranks threads
    on repeated cuda:0, each on its own stream, over the full-width bf16
    bundle. (a) one seeded T=21 chunk (export_path's conditioning, the
    port's noise) on a 1-rank view mesh: latents bit-equal to the
    unsharded chunk's, the same K1 and K2 launches. (b) the chunk on a
    PARALLEL_VIEW-rank view mesh: latents against the unsharded ones
    (PARALLEL_REL_L2, PARALLEL_MAX_ABS_REL), the decoded frames' PSNR, K1's
    launches against n per joint layer per rank and K2's against one per
    time-mix per rank, both walls (warm) and both chunks' device time by
    class (torch.profiler, all streams); the ring merges' device time (each
    merge shape of the run timed alone, times its count) and the
    frames<->positions all-to-alls' (one rank's packing, copies and
    unpacking of each exchange shape of the run, timed alone by CUDA
    events, times its count). (c) the CLI's
    render_one_scene (img2trajvid_s-prob, the orbit, PARALLEL_TARGETS
    targets: 3 second-pass chunks) on one device, on a (2, 1) mesh (frames
    bit-equal: the fan-out, padding and order change no computation), on a
    PARALLEL_MESH (data, view) mesh and with chunk_batch=2 (PSNR against
    one device at least PARALLEL_FRAME_PSNR_DB: bf16 conv and GroupNorm
    results depend on the batch, scripts/batch_variance.py), the second
    pass in 2 groups. All ranks share one card, so the walls show the
    machinery's cost, not a speed-up. Returns the launch counts by path."""
    import threading

    import cv2
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps import cli
    from stable_virtual_camera_tpu_torch.config import VersionConfig
    from stable_virtual_camera_tpu_torch.engine import runner
    from stable_virtual_camera_tpu_torch.models import unet as unet_mod
    from stable_virtual_camera_tpu_torch.parallel import ring_attention as pring
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh
    from stable_virtual_camera_tpu_torch.parallel.sharding import make_sharded_sampler
    from stable_virtual_camera_tpu_torch.sampling.sampler import euler_edm_sample, torch_noise

    h = RES // 8
    n = PARALLEL_VIEW
    cond = seeded_chunk(bundle.spec.context_dim, h)
    plan = bundle.plan(NUM_STEPS)
    shape = (T, h, h, 4)

    def draw(step):
        return torch_noise(SEED, 0, 0, step, shape, DEVICE)

    meshes = {v: make_mesh(1, v, devices=[DEVICE] * v) for v in (1, n)}

    # the card's memory after each run: the ranks' streams each keep their
    # own cached blocks, and a new rank thread's library handles need free
    # memory outside that cache (parallel/comm.HANDLE_HEADROOM)
    def memory():
        free = torch.cuda.mem_get_info()[0]
        return {"allocated_gb": torch.cuda.memory_allocated() / 1e9, "reserved_gb": torch.cuda.memory_reserved() / 1e9,
                "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9, "free_gb": free / 1e9}

    torch.cuda.reset_peak_memory_stats()
    memory_at = {"start": memory()}

    def synced(fn):
        def run():
            x = fn()
            torch.cuda.synchronize()
            return x
        return run

    paths = {
        "unsharded": synced(lambda: euler_edm_sample(bundle.network, draw(None), plan, cond, T, step_noise=draw)),
        **{f"view{v}": synced(lambda m=m: make_sharded_sampler(bundle.network, m, T)(draw(None), plan, cond, draw))
           for v, m in meshes.items()},
    }

    # the warm-up of the n-rank chunk notes every joint-layer call, ring
    # merge shape and frames<->positions exchange shape it runs
    noted: dict = {"joint": 0, "merge": {}, "exchange": {}}
    lock = threading.Lock()
    originals = {"ring": unet_mod.ring_sdpa_packed, "merge": pring.merge_partials,
                 "f2p": unet_mod.frames_to_positions, "p2f": unet_mod.positions_to_frames}

    def note(kind, key):
        with lock:
            noted[kind][key] = noted[kind].get(key, 0) + 1

    def noting_ring(*a, **k):
        with lock:
            noted["joint"] += 1
        return originals["ring"](*a, **k)

    def noting_merge(acc, lse, o_i, lse_i):
        note("merge", tuple(acc.shape))
        return originals["merge"](acc, lse, o_i, lse_i)

    def noting_exchange(name):
        def wrapper(t, frames, group, axis):
            note("exchange", (name, tuple(t.shape), frames, axis))
            return originals[name](t, frames, group, axis)
        return wrapper

    runs = {}
    for name, fn in paths.items():
        if name == f"view{n}":
            unet_mod.ring_sdpa_packed, pring.merge_partials = noting_ring, noting_merge
            unet_mod.frames_to_positions = noting_exchange("f2p")
            unet_mod.positions_to_frames = noting_exchange("p2f")
        try:
            fn()  # warm: the rank streams' allocator pools, cuDNN's plans at T / n frames
        finally:
            unet_mod.ring_sdpa_packed, pring.merge_partials = originals["ring"], originals["merge"]
            unet_mod.frames_to_positions, unet_mod.positions_to_frames = originals["f2p"], originals["p2f"]
        _kernels.reset_counts()
        t0 = time.perf_counter()
        x = fn()
        runs[name] = {"x": x, "s": time.perf_counter() - t0, "launches": _kernels.counts()}
        memory_at[name] = memory()
    profiles = {name: device_time_by_class(paths[name]) for name in ("unsharded", f"view{n}")}

    # the machinery's device time: each ring merge shape alone on one stream,
    # each exchange shape on the mesh (all ranks' copies), times its count
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    merge_ms = 0.0
    for acc_shape, count in noted["merge"].items():
        acc = torch.randn(acc_shape, generator=gen, device=DEVICE)
        lse = torch.randn(acc_shape[:-1], generator=gen, device=DEVICE)
        o_i = torch.randn(acc_shape, generator=gen, device=DEVICE).to(torch.bfloat16)
        merge_ms += cuda_ms(lambda: originals["merge"](acc, lse, o_i, lse), 10) * count
    exchange_ms = 0.0
    for (name, t_shape, frames, axis), count in noted["exchange"].items():
        t = torch.randn(t_shape, generator=gen, device=DEVICE).to(torch.bfloat16)
        one_rank = _OneRankExchange(n)
        exchange_ms += cuda_ms(lambda fn=originals[name], t=t, frames=frames, axis=axis:
                               fn(t, frames, one_rank, axis), 10) * count

    u, one, many = runs["unsharded"], runs["view1"], runs[f"view{n}"]
    k1_k2 = ("flash_attention", "time_attention")
    a_ok = bool(torch.equal(one["x"], u["x"])) and all(one["launches"][k] == u["launches"][k] > 0 for k in k1_k2)
    diff = (many["x"] - u["x"]).float()
    rel = (diff.norm() / u["x"].float().norm()).item()
    max_abs = diff.abs().max().item()
    scale = u["x"].float().abs().max().item()
    frames_u = bundle.vae.decode(u["x"], None, uint8=True)
    frames_n = bundle.vae.decode(many["x"], None, uint8=True)
    # K1: one launch a per-frame layer per rank, n a joint layer per rank;
    # the unsharded chunk runs each layer once. K2: one a time-mix per rank
    joint_layers = noted["joint"] // n
    k1_expected = n * (u["launches"]["flash_attention"] - joint_layers) + n * n * joint_layers
    k2_expected = n * u["launches"]["time_attention"]
    b_ok = (rel <= PARALLEL_REL_L2 and max_abs <= PARALLEL_MAX_ABS_REL * scale
            and bool(torch.isfinite(many["x"]).all())
            and many["launches"]["flash_attention"] == k1_expected
            and many["launches"]["time_attention"] == k2_expected)

    # (c) the CLI's render function: one device, two meshes, chunk_batch=2
    groups = {"n": 0}
    sample_many = runner.sample_many

    def counted_many(*a, **k):
        groups["n"] += 1
        return sample_many(*a, **k)

    renders = {}
    runner.sample_many = counted_many
    try:
        with tempfile.TemporaryDirectory() as tmp:
            scene_dir = os.path.join(tmp, "scene")
            os.makedirs(scene_dir)
            img = np.random.default_rng(SEED).integers(0, 256, (RES, RES, 3), dtype=np.uint8)
            scene = os.path.join(scene_dir, "seeded.png")
            cv2.imwrite(scene, img)
            for name, mesh_shape, extra in (("single", None, {}), ("data2_view1", (2, 1), {}),
                                            ("mesh", PARALLEL_MESH, {}), ("chunk_batch", None, {"chunk_batch": 2})):
                version = VersionConfig()
                options = cli._default_options()
                options.update(dict(num_steps=NUM_STEPS, traj_prior="orbit", num_targets=PARALLEL_TARGETS,
                                    sampler_verbose=False, **extra))
                bundle.mesh = None if mesh_shape is None else make_mesh(
                    *mesh_shape, devices=[DEVICE] * (mesh_shape[0] * mesh_shape[1]))
                groups["n"] = 0
                torch.cuda.empty_cache()  # the last render's rank streams' cached blocks
                torch.cuda.synchronize()
                _kernels.reset_counts()
                t0 = time.perf_counter()
                out_dir = cli.render_one_scene(bundle, version, options, "img2trajvid_s-prob", scene,
                                               os.path.join(tmp, name), use_traj_prior=True, seed=SEED)
                torch.cuda.synchronize()
                renders[name] = {"s": time.perf_counter() - t0, "launches": _kernels.counts(),
                                 "groups": groups["n"], "T": version.T,
                                 "frames": read_pngs(os.path.join(out_dir, "samples-rgb"))}
                memory_at[f"cli_{name}"] = memory()
    finally:
        bundle.mesh = None
        runner.sample_many = sample_many

    def frame_diff(a, b):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        return {"equal": bool(np.array_equal(a, b)), "max_step": int(d.max()), "differing": int((d > 0).sum()),
                "above_one": int((d > 1).sum()), "values": int(d.size), "psnr_db": psnr(a, b)}

    single = renders["single"]["frames"]
    c_diffs = {k: frame_diff(renders[k]["frames"], single) for k in ("data2_view1", "mesh", "chunk_batch")}
    c_ok = (single.shape == (PARALLEL_TARGETS, RES, RES, 3) and float(single.std()) > 0
            and c_diffs["data2_view1"]["equal"]
            and all(c_diffs[k]["psnr_db"] >= PARALLEL_FRAME_PSNR_DB for k in ("mesh", "chunk_batch"))
            and renders["single"]["groups"] == 0
            and all(renders[k]["groups"] == 2 for k in c_diffs)
            and all(renders[k]["launches"][kk] > 0 for k in renders for kk in k1_k2))
    ok = a_ok and b_ok and c_ok
    emit({"phase": "parallel_path", "ok": ok,
          "a_one_rank": {"ok": a_ok, "latents_bit_equal": bool(torch.equal(one["x"], u["x"])),
                         "launches": {k: [one["launches"][k], u["launches"][k]] for k in k1_k2},
                         "chunk_s": {"view1": one["s"], "unsharded": u["s"]}},
          "b_view": {"ok": b_ok, "ranks": n, "frames_a_rank": T // n, "rel_l2": rel, "rel_l2_bar": PARALLEL_REL_L2,
                     "max_abs": max_abs, "max_abs_bar": PARALLEL_MAX_ABS_REL * scale, "latent_max_abs": scale,
                     "frames_psnr_db": psnr(frames_n, frames_u),
                     "frames_max_step": int(np.abs(frames_n.astype(np.int16) - frames_u.astype(np.int16)).max()),
                     "launches": {k: many["launches"][k] for k in k1_k2},
                     "unsharded_launches": {k: u["launches"][k] for k in k1_k2},
                     "joint_layers_per_chunk": joint_layers, "k1_expected": k1_expected, "k2_expected": k2_expected,
                     "chunk_s": {f"view{n}": many["s"], "unsharded": u["s"]},
                     "profile": profiles,
                     "ring_merge_device_ms": merge_ms, "merges": sum(noted["merge"].values()),
                     "all_to_all_device_ms": exchange_ms, "all_to_all_calls": sum(noted["exchange"].values())},
          "c_cli": {"ok": c_ok, "mesh": list(PARALLEL_MESH), "T": renders["single"]["T"],
                    "frames": list(single.shape), "diff_to_single": c_diffs, "psnr_bar_db": PARALLEL_FRAME_PSNR_DB,
                    "groups": {k: r["groups"] for k, r in renders.items()},
                    "render_s": {k: r["s"] for k, r in renders.items()},
                    "launches": {k: {kk: r["launches"][kk] for kk in k1_k2} for k, r in renders.items()}},
          "cuts": {"num_steps": f"{NUM_STEPS} (released default 50)",
                   "weights": "random bf16 (flax-default init, seed 0), full width",
                   "devices": "every rank on cuda:0 (one card), each on its own stream"},
          "memory": memory_at})
    del runs, meshes, profiles
    gc.collect()
    torch.cuda.empty_cache()  # the rank streams' cached blocks, before the training phases
    if not ok:
        raise AssertionError("the mesh's sampling disagrees with one device's, or its launches are wrong")
    return {"parallel_view1": one["launches"], f"parallel_view{n}": many["launches"],
            "parallel_cli": renders["mesh"]["launches"], "parallel_chunk_batch": renders["chunk_batch"]["launches"]}


def run_stream_path() -> dict:
    """`stream_path`: parallel_path's CLI render (img2trajvid_s-prob from
    one seeded 576x576 PNG, the orbit prior, PARALLEL_TARGETS targets: 3
    second-pass chunks) through apps.cli.main with attention="flash" and
    --random_model full, four times: with the engine's `stream_save` on
    (PNGs written by writer threads while the render goes on, each
    second-pass chunk flushed by one ordered worker while the next one
    samples) and the conditioning prefetch window of 3 chunks (the
    default), and with `stream_save` off and a window of 1, each with
    --engine_timing (host seconds a stage: no stage synchronizes the device,
    so the timed render is the untimed one); then streamed without the
    timer with windows of 3 and 1. In all four, CUDA events around each
    second-pass chunk's dispatch give the device's idle gap between
    consecutive chunks (from the event after chunk k's decode to the one
    before chunk k + 1's first step: 0 when the host dispatched chunk k + 1
    before the device finished chunk k). Every PNG byte-equal across the
    four runs; the timed runs' per-pass seconds and the engine's
    `final_save`, `first_pass_save`, `second_pass_flush`,
    `second_pass_flush_join`, `second_pass_conditioning` and
    `second_pass_sample` host stage seconds and calls. Returns the streamed
    run's launch counts."""
    import cv2
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps import cli
    from stable_virtual_camera_tpu_torch.engine import runner
    from stable_virtual_camera_tpu_torch.engine.runner import SceneEngine
    from stable_virtual_camera_tpu_torch.utils.profiling import StageTimer

    marks: list[float] = []
    timers: list = []
    chunk_events: list = []

    class TimedEngine(SceneEngine):
        """SceneEngine that notes the wall time at each pass's end."""

        def run_one_scene(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for out in super().run_one_scene(*args, **kwargs):
                torch.cuda.synchronize()
                marks.append(time.perf_counter() - t0)
                yield out

    class KeptTimer(StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    sample_chunk = runner.sample_chunk

    def evented_chunk(*args, **kwargs):
        """A second-pass chunk between two CUDA events on its stream."""
        if kwargs.get("pass_id") != 2:
            return sample_chunk(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = sample_chunk(*args, **kwargs)
        end.record()
        chunk_events.append((start, end))
        return out

    def files(root):
        out = {}
        for d, _, names in os.walk(root):
            for n in names:
                if n.endswith(".png"):
                    with open(os.path.join(d, n), "rb") as f:
                        out[os.path.relpath(os.path.join(d, n), root)] = f.read()
        return out

    stages = ("final_save", "first_pass_save", "second_pass_flush", "second_pass_flush_join",
              "second_pass_conditioning", "second_pass_sample")
    runs = {}
    saved = cli.SceneEngine, cli.StageTimer, runner.sample_chunk
    cli.SceneEngine, cli.StageTimer, runner.sample_chunk = TimedEngine, KeptTimer, evented_chunk
    try:
        with tempfile.TemporaryDirectory() as tmp:
            png_dir = os.path.join(tmp, "scene")
            os.makedirs(png_dir)
            img = np.random.default_rng(SEED).integers(0, 256, (RES, RES, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(png_dir, "seeded.png"), img)
            for name, stream, window, timing in (("streamed", True, 3, True), ("synchronous", False, 1, True),
                                                 ("window_3", True, 3, False), ("window_1", True, 1, False)):
                marks.clear()
                timers.clear()
                chunk_events.clear()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                _kernels.reset_counts()
                (out_dir,) = cli.main(png_dir, task="img2trajvid_s-prob", random_model="full",
                                      use_traj_prior=True, traj_prior="orbit", num_targets=PARALLEL_TARGETS,
                                      attention="flash", work_dir=os.path.join(tmp, name), num_steps=NUM_STEPS,
                                      device=DEVICE, sampler_verbose=False, engine_timing=timing,
                                      stream_save=stream, prefetch_chunks=window)
                torch.cuda.synchronize()
                run = {"files": files(out_dir), "launches": _kernels.counts(), "prefetch_chunks": window,
                       "stream_save": stream, "first_pass_s": marks[0], "second_pass_s": marks[1] - marks[0]}
                if timing:
                    timer = timers[0]
                    run["stages_s"] = {k: [timer.totals.get(k, 0.0), timer.counts.get(k, 0)] for k in stages}
                run["chunk_device_ms"] = [s.elapsed_time(e) for s, e in chunk_events]
                run["idle_gap_ms"] = [max(0.0, a[1].elapsed_time(b[0]))
                                      for a, b in zip(chunk_events, chunk_events[1:])]
                runs[name] = run
    finally:
        cli.SceneEngine, cli.StageTimer, runner.sample_chunk = saved
    on = runs["streamed"]
    same = all(r["files"] == on["files"] for r in runs.values())
    n_final = len([k for k in on["files"] if k.startswith("samples-rgb" + os.sep)])
    chunks = on["stages_s"]["second_pass_flush"][1]
    ok = (same and n_final == PARALLEL_TARGETS and chunks > 1
          and all(len(r["idle_gap_ms"]) == chunks - 1 for r in runs.values())
          and all(on["launches"][k] > 0 for k in ("flash_attention_blhd", "time_attention")))
    emit({"phase": "stream_path", "ok": ok, "pngs_byte_equal": same, "pngs": len(on["files"]),
          "final_pngs": n_final, "second_pass_flushes": chunks,
          "runs": {k: {kk: v for kk, v in r.items() if kk != "files"} for k, r in runs.items()},
          "cuts": {"num_steps": f"{NUM_STEPS} (CLI default 50)",
                   "scene": f"one seeded 576x576 PNG, the orbit prior, {PARALLEL_TARGETS} targets",
                   "timing": "--engine_timing reports host seconds a stage with no device synchronize (a "
                             "stage's device work shows in the stage that waits for it); stages_s holds "
                             "[seconds, calls]; idle_gap_ms is read in every run"}})
    if not ok:
        raise AssertionError("the stream or window renders' PNGs differ, or a chunk gap went unread")
    return on["launches"]


def run_tp_path(bundle) -> dict:
    """`tp_path`: tensor parallelism over a "model" mesh axis
    (parallel/tensor_parallel.py) on the one card, every rank a thread on
    cuda:0 with its own stream, over the full-width bf16 bundle: the seeded
    T=21 chunk of parallel_path (576x576, NUM_STEPS steps) on a
    (data, view, model) = (1, 1, 2) mesh and on (1, 3, 2), against the
    unsharded chunk. Checks: latents' relative L2 to the unsharded chunk's
    at most PARALLEL_REL_L2; the two model ranks' latents bit-equal; each
    rank's shard module at most TP_BYTES_SHARE of the UNet's bytes. Prints
    K1 and K2 launches (every rank runs attention at full heads), the
    chunk's seconds (warm) against the unsharded chunk's and the (1, 1, 2)
    chunk's device time by class and idle share (torch.profiler). Returns
    the launch counts by mesh."""
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.engine.runner import sample_latents
    from stable_virtual_camera_tpu_torch.parallel.comm import run_ranks
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh_tp
    from stable_virtual_camera_tpu_torch.parallel.sharding import sample_shard
    from stable_virtual_camera_tpu_torch.sampling.sampler import euler_edm_sample, torch_noise

    h = RES // 8
    cond = seeded_chunk(bundle.spec.context_dim, h)
    plan = bundle.plan(NUM_STEPS)
    shape = (T, h, h, 4)

    def draw(step):
        return torch_noise(SEED, 0, 0, step, shape, DEVICE)

    def timed(fn):
        torch.cuda.synchronize()
        _kernels.reset_counts()
        t0 = time.perf_counter()
        x = fn()
        torch.cuda.synchronize()
        return x, time.perf_counter() - t0, _kernels.counts()

    def unsharded():
        return euler_edm_sample(bundle.network, draw(None), plan, cond, T, step_noise=draw)

    timed(unsharded)  # warm
    x_u, s_u, launches_u = timed(unsharded)
    unet_bytes = sum(p.numel() * p.element_size() for p in bundle.unet.parameters())
    k1_k2 = ("flash_attention", "time_attention")
    results, counts, ok = {}, {}, True
    for mesh_shape in TP_MESHES:
        n_view, n_model = mesh_shape[1], mesh_shape[2]
        name = "tp_" + "x".join(map(str, mesh_shape))
        try:
            torch.cuda.reset_peak_memory_stats()
            mesh = make_mesh_tp(*mesh_shape, devices=[DEVICE] * (n_view * n_model))
            bundle.mesh = mesh
            bundle.replicate()  # every model rank's shard module, once
            share = max(sum(p.numel() * p.element_size() for p in bundle.unet_shard(DEVICE, m, n_model).parameters())
                        / unet_bytes for m in range(n_model))

            def every_rank():  # each rank's own latents, to compare the model ranks
                return run_ranks(mesh, lambda ctx: sample_shard(
                    bundle.network, [draw(None)], plan, [cond], T, [draw], ctx.comm if n_view > 1 else None,
                    device=ctx.device, model_comm=ctx.model_comm), rows=[0])

            outs, s_first, _ = timed(every_rank)
            same = all(torch.equal(outs[v * n_model + m], outs[v * n_model]) for v in range(n_view)
                       for m in range(1, n_model))
            x, s, launches = timed(lambda: sample_latents(bundle, draw(None), plan, cond, draw))
            rel = ((x - x_u).float().norm() / x_u.float().norm()).item()
            profile = device_time_by_class(lambda: (sample_latents(bundle, draw(None), plan, cond, draw),
                                                    torch.cuda.synchronize())) if mesh_shape == TP_MESHES[0] else None
            mesh_ok = (rel <= PARALLEL_REL_L2 and same and share <= TP_BYTES_SHARE
                       and bool(torch.isfinite(x).all()) and all(launches[k] > 0 for k in k1_k2))
            ok = ok and mesh_ok
            counts[name] = launches
            results[name] = {"ok": mesh_ok, "mesh": list(mesh_shape), "rel_l2": rel, "rel_l2_bar": PARALLEL_REL_L2,
                             "model_ranks_bit_equal": same, "rank_unet_bytes_share": share,
                             "bytes_share_bar": TP_BYTES_SHARE,
                             "launches": {k: launches[k] for k in k1_k2},
                             "launches_per_rank": {k: launches[k] / (n_view * n_model) for k in k1_k2},
                             "chunk_s": s, "first_chunk_s": s_first, "vs_unsharded": s / s_u, "profile": profile,
                             "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
            del outs, x
        except torch.OutOfMemoryError as e:
            # the larger mesh only where memory allows: say what the card gave
            if mesh_shape == TP_MESHES[0]:
                raise
            results[name] = {"ok": None, "mesh": list(mesh_shape), "skipped": f"out of memory: {e}"[:300]}
        finally:
            bundle.mesh = None
            bundle._shards.clear()
            gc.collect()
            torch.cuda.empty_cache()
    quant, quant_counts = tp_w8a8(bundle, cond, plan, draw, timed, x_u)
    ok = ok and all(r["ok"] for r in quant.values())
    counts.update(quant_counts)
    emit({"phase": "tp_path", "ok": ok, "meshes": results,
          "unsharded": {"chunk_s": s_u, "launches": {k: launches_u[k] for k in k1_k2}},
          "unet_bytes": unet_bytes, "w8a8": quant,
          "cuts": {"num_steps": f"{NUM_STEPS} (released default 50)",
                   "weights": "random bf16 (flax-default init, seed 0), full width",
                   "devices": "every rank on cuda:0 (one card), each on its own stream"}})
    if not ok:
        raise AssertionError("the tensor-parallel chunk disagrees with the unsharded chunk, or its ranks differ")
    return counts


def input_sharded_layers(unet) -> dict:
    """The first QuantLinear and the first QuantConv whose input dimension
    the sharding rule cuts at n = 2, by name."""
    from stable_virtual_camera_tpu_torch.models.unet import QuantConv, QuantLinear
    from stable_virtual_camera_tpu_torch.parallel.param_sharding import tree_shardings

    cuts = tree_shardings(unet, 2)
    found = {}
    for name, m in unet.named_modules():
        for kind in (QuantLinear, QuantConv):
            if type(m) is kind and kind not in found and (cuts.get(name + ".weight") or (None,))[0] == 1:
                found[kind] = name
    return {kind.__name__: name for kind, name in found.items()}


def tp_w8a8(bundle, cond, plan, draw, timed, x_exact) -> tuple[dict, dict]:
    """tp_path's W8A8 part: under "w8a8" and "w8a8-static" (calibrated on
    the unsharded UNet, as the engine does), the seeded chunk on
    TP_MESHES[0] against the unsharded chunk in the same mode, with the
    model ranks bit-equal; one input-sharded QuantLinear and one
    input-sharded QuantConv at full width, each bit-equal on both ranks to
    the unsharded layer on the input it saw in the unsharded chunk; a
    rank's share of the int8 weights the quantized layers multiply with;
    the chunk's seconds against the unsharded one's.

    The latents' bar: every W8A8 layer is bit-equal under the model axis,
    but the exact layers round otherwise on shards than whole (partial
    sums where the rule cuts the input; cuBLAS and cuDNN choices at
    another output width), as in mode "0", where the chunk moves by ~1e-2
    (PARALLEL_REL_L2 above); W8A8's rounding to int8 is discontinuous, so
    those last-bit differences grow through the quantized layers over the
    steps to the size of W8A8's own error. So the sharded W8A8 chunk is
    held to that error: its distance to `x_exact` (the unsharded exact
    chunk) within TP_W8A8_GAP_RATIO of the unsharded W8A8 chunk's; its
    distance to the unsharded W8A8 chunk is printed beside
    PARALLEL_REL_L2. Returns (results by mode, launch counts
    by path)."""
    import torch

    from stable_virtual_camera_tpu_torch.engine.runner import ensure_quant_calibrated
    from stable_virtual_camera_tpu_torch.parallel import tensor_parallel as tp
    from stable_virtual_camera_tpu_torch.parallel.comm import run_ranks
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh_tp
    from stable_virtual_camera_tpu_torch.parallel.sharding import sample_shard
    from stable_virtual_camera_tpu_torch.sampling.sampler import euler_edm_sample

    unet = bundle.unet
    layers = input_sharded_layers(unet)
    n_model = TP_MESHES[0][2]
    results, counts = {}, {}
    for mode in ("w8a8", "w8a8-static"):
        name = f"tp_{mode}_" + "x".join(map(str, TP_MESHES[0]))
        saved = {}
        hooks = [unet.get_submodule(path).register_forward_pre_hook(
            lambda m, args, _k=kind: saved.setdefault(_k, args[0].detach().clone())) for kind, path in layers.items()]
        try:
            unet.set_quant(mode)
            t0 = time.perf_counter()
            ensure_quant_calibrated(bundle, (T, RES // 8, RES // 8, 4), plan, cond)
            calib_s = time.perf_counter() - t0
            x_u, s_u, _ = timed(lambda: euler_edm_sample(bundle.network, draw(None), plan, cond, T, step_noise=draw))
            for h in hooks:
                h.remove()
            hooks = []
            mesh = make_mesh_tp(*TP_MESHES[0], devices=[DEVICE] * n_model)
            bundle.mesh = mesh
            bundle.replicate()
            outs, s, launches = timed(lambda: run_ranks(mesh, lambda ctx: sample_shard(
                bundle.network, [draw(None)], plan, [cond], T, [draw], None, device=ctx.device,
                model_comm=ctx.model_comm), rows=[0]))
            same = all(torch.equal(o, outs[0]) for o in outs[1:])
            rel = ((outs[0][0] - x_u).float().norm() / x_u.float().norm()).item()
            gap = ((x_u - x_exact).float().norm() / x_exact.float().norm()).item()
            gap_tp = ((outs[0][0] - x_exact).float().norm() / x_exact.float().norm()).item()
            shards = [bundle.unet_shard(DEVICE, m, n_model) for m in range(n_model)]
            with torch.inference_mode():
                ref = {kind: unet.get_submodule(path)(saved[kind]) for kind, path in layers.items()}

                def rank(ctx):
                    with tp.model_group(ctx.model_comm):
                        return {kind: shards[ctx.model].get_submodule(path)(saved[kind])
                                for kind, path in layers.items()}

                per_rank = run_ranks(mesh, rank)
            layer_equal = {kind: all(torch.equal(r[kind], ref[kind]) for r in per_rank) for kind in layers}
            whole = sum(m.quant_weight().numel() for m in unet.modules() if hasattr(m, "quant_weight"))
            share = max(sum(m.quant_weight().numel() for m in sh.modules() if hasattr(m, "quant_weight")) / whole
                        for sh in shards)
            mode_ok = (same and gap_tp <= TP_W8A8_GAP_RATIO * gap and all(layer_equal.values()) and len(layer_equal) == 2
                       and bool(torch.isfinite(outs[0]).all())
                       and all(launches[k] > 0 for k in ("flash_attention", "time_attention")))
            counts[name] = launches
            results[mode] = {"ok": mode_ok, "mesh": list(TP_MESHES[0]), "rel_l2": rel,
                             "within_parallel_rel_l2": rel <= PARALLEL_REL_L2,
                             "unsharded_vs_exact_rel_l2": gap, "sharded_vs_exact_rel_l2": gap_tp,
                             "sharded_vs_exact_bar": TP_W8A8_GAP_RATIO * gap,
                             "model_ranks_bit_equal": same, "input_sharded_layers": layers,
                             "layers_bit_equal": layer_equal,
                             "layer_inputs": {k: list(v.shape) for k, v in saved.items()},
                             "rank_int8_weight_share": share, "int8_weights_whole": whole,
                             "chunk_s": s, "unsharded_chunk_s": s_u, "vs_unsharded": s / s_u,
                             "calibration_s": calib_s if mode == "w8a8-static" else None,
                             "launches": {k: launches[k] for k in ("flash_attention", "time_attention")}}
            del outs, x_u, ref, per_rank, shards
        finally:
            for h in hooks:
                h.remove()
            bundle.mesh = None
            bundle._shards.clear()
            unet.set_quant("0")
            unet.clear_quant_state()
            saved.clear()
            gc.collect()
            torch.cuda.empty_cache()
    return results, counts


def run_film_cache(bundle) -> dict:
    """`film_cache`: the seeded T=21 chunk of parallel_path through the
    engine's sample_latents, which samples it on its FiLM cache (each
    ResBlock's resize and dense_proj of the Plucker map once a chunk at
    half the CFG batch), and through the same Euler loop on the bundle's
    network with no cache (the maps once a step): latents' relative L2 at
    most FILM_REL_L2 and max abs difference against one bf16 step at the
    latents' magnitude (the card's 3x3 convs round by batch size, and the
    cache runs the 1x1 dense_proj at T, not 2T: which of the two bars held
    is printed); seconds each way (warm) and the peak memory of each, with
    the cache's bytes computed from its shapes. Returns the cached run's
    launch counts."""
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.engine.runner import sample_latents
    from stable_virtual_camera_tpu_torch.sampling.sampler import euler_edm_sample, torch_noise

    h = RES // 8
    cond = seeded_chunk(bundle.spec.context_dim, h)
    plan = bundle.plan(NUM_STEPS)
    shape = (T, h, h, 4)

    def draw(step):
        return torch_noise(SEED, 0, 0, step, shape, DEVICE)

    paths = {"off": lambda: euler_edm_sample(bundle.network, draw(None), plan, cond, T, step_noise=draw),
             "on": lambda: sample_latents(bundle, draw(None), plan, cond, draw)}
    runs = {}
    for name in ("off", "on", "off", "on"):  # the first two warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_counts()
        t0 = time.perf_counter()
        x = paths[name]()
        torch.cuda.synchronize()
        runs[name] = {"x": x, "s": time.perf_counter() - t0, "launches": _kernels.counts(),
                      "peak_above_start_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    with torch.inference_mode():
        films = bundle.unet.film(cond.dense[:T])
    cache_bytes = sum(f.numel() * f.element_size() for f in films.values())
    del films
    off, on = runs["off"], runs["on"]
    diff = (on["x"] - off["x"]).float()
    rel = (diff.norm() / off["x"].float().norm()).item()
    max_abs = diff.abs().max().item()
    scale = off["x"].float().abs().max().item()
    bf16_step = 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0
    held = [bar for bar, good in (("rel_l2", rel <= FILM_REL_L2), ("one_bf16_step", max_abs <= bf16_step)) if good]
    k1_k2 = ("flash_attention", "time_attention")
    ok = bool(held) and bool(torch.isfinite(on["x"]).all()) and all(on["launches"][k] > 0 for k in k1_k2)
    emit({"phase": "film_cache", "ok": ok, "bars_held": held, "rel_l2": rel, "rel_l2_bar": FILM_REL_L2,
          "max_abs": max_abs, "one_bf16_step": bf16_step, "latent_max_abs": scale,
          "bit_equal": bool(torch.equal(on["x"], off["x"])),
          "chunk_s": {"off": off["s"], "on": on["s"]}, "on_vs_off": on["s"] / off["s"],
          "peak_above_start_gb": {"off": off["peak_above_start_gb"], "on": on["peak_above_start_gb"]},
          "cache_bytes_from_shapes": cache_bytes,
          "launches": {k: {kk: r["launches"][kk] for kk in k1_k2} for k, r in runs.items()},
          "cuts": {"num_steps": f"{NUM_STEPS} (released default 50)",
                   "weights": "random bf16 (flax-default init, seed 0), full width"}})
    if not ok:
        raise AssertionError("the FiLM-cached chunk disagrees with the uncached one beyond both bars")
    return on["launches"]


# ---------------------------------------------------------------------------
# The GUI demo (apps/gradio_app.py) on stand-ins for gradio and viser, which
# the card's machine does not have: the widget and scene surface the port's
# apps/ui_manifest.py pins, recording events instead of serving a page
# ---------------------------------------------------------------------------


class _Widget:
    """A gradio widget: its arguments, its value and the events wired to it."""

    def __init__(self, *args, **kw):
        self.args, self.value, self.label = args, kw.get("value"), kw.get("label")
        self.events: list[tuple] = []

    def click(self, fn, inputs=None, outputs=None, **kw):
        self.events.append((fn, list(inputs or []), list(outputs or [])))


class _Blocks:
    def __init__(self, *a, **kw):
        self.loads: list[tuple] = []
        self.unloads: list = []

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def load(self, fn, inputs=None, outputs=None, **kw):
        self.loads.append((fn, list(inputs or []), list(outputs or [])))

    def unload(self, fn, **kw):
        self.unloads.append(fn)

    def queue(self, **kw):
        return self

    def launch(self, **kw):
        raise RuntimeError("the stand-in serves no page")


class _Progress:
    def __init__(self, *a, **kw):
        self.descs: list[str] = []

    def __call__(self, *a, desc: str = "", **kw):
        self.descs.append(desc)


class _Node:
    """A viser scene node or GUI handle."""

    def __init__(self, name, *args, **kw):
        self.name, self.kw = name, kw
        self.value = kw.get("initial_value")
        self.visible, self.disabled = kw.get("visible", True), kw.get("disabled", False)
        self.callbacks: list = []

    def on_click(self, fn):
        self.callbacks.append(fn)
        return fn

    on_update = on_click

    def remove(self):
        self.removed = True

    def fire(self, event=None):
        for fn in self.callbacks:
            fn(event)


class _Scene:
    def __init__(self):
        self.nodes: dict[str, _Node] = {}

    def reset(self):
        self.nodes.clear()

    def _add(self, name, **kw):
        self.nodes[name] = _Node(name, **kw)
        return self.nodes[name]

    add_camera_frustum = add_point_cloud = add_spline_catmull_rom = _add


class _Gui:
    def __init__(self):
        self.widgets: list[_Node] = []

    def _add(self, label, *args, **kw):
        self.widgets.append(_Node(label, *args, **kw))
        return self.widgets[-1]

    add_button = add_checkbox = add_dropdown = add_number = add_slider = _add

    def add_folder(self, label, **kw):
        return contextlib.nullcontext()


class _ViserServer:
    def __init__(self, *a, **kw):
        self.scene, self.gui = _Scene(), _Gui()

    def get_host(self):
        return "localhost"

    def get_port(self):
        return 8080

    def get_clients(self):
        return {}

    def stop(self):
        self.stopped = True


@contextlib.contextmanager
def ui_standins():
    """`gradio` and `viser` stand-ins in sys.modules for the block; yields
    the gradio one (its `widgets`, and `infos`, the gr.Info messages)."""
    import types

    gr = types.ModuleType("gradio")
    gr.widgets, gr.infos = [], []

    def factory(kind):
        def make(*args, **kw):
            w = _Widget(*args, **kw)
            w.kind = kind
            gr.widgets.append(w)
            return w
        return make

    for kind in ("State", "HTML", "Number", "Dropdown", "Slider", "Button", "Image", "File", "Video"):
        setattr(gr, kind, factory(kind))
    gr.Blocks, gr.Tab, gr.Progress = _Blocks, _Blocks, _Progress
    gr.Error = type("Error", (Exception,), {})
    gr.Info = gr.infos.append
    gr.Request = object
    viser = types.ModuleType("viser")
    viser.ViserServer = _ViserServer
    viser.Icon = types.SimpleNamespace(PICK="pick", PLUS="plus", TRASH="trash", PLAYER_PLAY="play",
                                       CAMERA_CHECK="camera-check", CHECK="check")
    saved = {name: sys.modules.get(name) for name in ("gradio", "viser")}
    sys.modules.update(gradio=gr, viser=viser)
    try:
        yield gr
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def read_pngs(directory: str):
    import numpy as np
    import PIL.Image

    names = sorted(n for n in os.listdir(directory) if n.endswith(".png"))
    return np.stack([np.asarray(PIL.Image.open(os.path.join(directory, n)).convert("RGB")) for n in names])


def run_gui_path(bundle, pipe, main_frames: dict, out: dict) -> dict:
    """The Gradio app (build_app) at full width on the stand-ins: (a) Basic
    preprocess and render with main_path's arguments, its PNGs bit-equal to
    main_path's frames; (b) Advanced: DUSt3R preprocess, scene view, the
    editor's orbit preset and "Set camera trajectory", the render's PNGs
    bit-equal to HeadlessRenderer on that trajectory, run with the engine's
    stage timer (host seconds a stage, its report printed); (c) a Basic render in
    a thread aborted after its first progress tick. K1/K2 launches are
    counted over the app's renders (a) and (b); the app's host time is each
    handler's wall minus the renderer's (prepare + engine) wall."""
    import threading
    import types

    import numpy as np
    import PIL.Image
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer
    from stable_virtual_camera_tpu_torch.utils.profiling import StageTimer

    render_s, plans = [0.0], []

    with ui_standins() as gr, tempfile.TemporaryDirectory() as tmp:
        from stable_virtual_camera_tpu_torch.apps.gradio_app import build_app

        renderer = HeadlessRenderer(bundle, work_dir=os.path.join(tmp, "renders"))
        prepare, run = renderer.prepare, renderer.run

        def timed_prepare(*a, **kw):
            t0 = time.perf_counter()
            plans.append(prepare(*a, **kw))
            render_s[0] += time.perf_counter() - t0
            return plans[-1]

        def timed_run(*a, **kw):
            gen = run(*a, **kw)
            while True:
                t0 = time.perf_counter()
                item = next(gen, None)
                torch.cuda.synchronize()
                render_s[0] += time.perf_counter() - t0
                if item is None:
                    return
                yield item

        renderer.prepare, renderer.run = timed_prepare, timed_run
        app = build_app(bundle, renderer=renderer, num_steps=NUM_STEPS, dust3r=pipe)
        start_session, _, (session_w, html_w) = app.loads[0]
        session_w.value, html_w.value = start_session(types.SimpleNamespace(session_hash="smoke"))
        server = app.svc_sessions["servers"]["smoke"]

        def widget(kind, label):
            return next(w for w in gr.widgets if w.kind == kind and (w.label == label or w.args[:1] == (label,)))

        def button(text, fn_name):
            return next(w for w in gr.widgets if w.kind == "Button" and w.args[:1] == (text,)
                        and w.events and w.events[0][0].__name__ == fn_name)

        def press(btn):
            fn, inputs, outputs = btn.events[0]
            result = fn(*[w.value for w in inputs])
            if outputs:
                outputs[0].value = result
            return result

        def render(btn, progress):
            """Drain a render handler: (yields, handler wall, second-pass
            ticks seen at the first yield)."""
            fn, inputs, _ = btn.events[0]
            render_s[0], yields, second_at_first = 0.0, [], None
            t0 = time.perf_counter()
            for item in fn(*[w.value for w in inputs], progress=progress):
                if not yields:
                    second_at_first = sum(d.startswith("Second") for d in progress.descs)
                yields.append(item)
            return yields, time.perf_counter() - t0, second_at_first

        def reached(progress, plan):
            last = {p: [d for d in progress.descs if d.startswith(p)] for p in ("First", "Second")}
            return all(ds and ds[-1].endswith(f" {n}/{n} steps") for ds, n in (
                (last["First"], plan["first_pass_steps"]), (last["Second"], plan["second_pass_steps"])))

        # (a) Basic, with main_path's arguments (orbit ignores the zoom widget)
        widget("Image", "Input image").value = np.random.default_rng(SEED).integers(
            0, 256, (RES, RES, 3), dtype=np.uint8)
        widget("Number", "Seed").value = SEED
        widget("Slider", "#frames").value = NUM_TARGETS
        press(button("Preprocess", "do_preprocess_basic"))
        editor_a = app.svc_sessions["gui_states"].get("smoke") is not None
        prog_a = _Progress()
        torch.cuda.synchronize()
        _kernels.reset_counts()
        yields_a, handler_a, second_at_first_a = render(button("Render video", "do_render"), prog_a)
        counts = _kernels.counts()
        plan_a, render_a = plans[-1], render_s[0]
        first, final = yields_a[-1]
        anchors_png = read_pngs(os.path.join(os.path.dirname(first), "samples-rgb"))
        frames_png = read_pngs(os.path.join(os.path.dirname(final), "samples-rgb"))
        out["frames"] = frames_png
        basic_ok = (
            editor_a and len(yields_a) == 2 and yields_a[0] == (first, None) and second_at_first_a == 0
            and reached(prog_a, plan_a)
            and np.array_equal(anchors_png, main_frames["anchors"])
            and np.array_equal(frames_png, main_frames["frames"])
        )

        # (b) Advanced: DUSt3R, scene view, the editor's orbit preset
        paths, rng = [], np.random.default_rng(SEED)
        for i in range(ADV_IMAGES):
            paths.append(os.path.join(tmp, f"view{i}.png"))
            PIL.Image.fromarray(rng.integers(0, 256, (ADV_H, ADV_W, 3), dtype=np.uint8)).save(paths[-1])
        widget("File", "Input images").value = [types.SimpleNamespace(name=p) for p in paths]
        n_widgets = len(server.gui.widgets)
        t0 = time.perf_counter()
        pre_b = press(button("Preprocess (DUSt3R)", "do_preprocess_advanced"))
        preprocess_b = time.perf_counter() - t0
        nodes = sorted(server.scene.nodes)
        editor = server.gui.widgets[n_widgets:]  # the widgets of the editor this preprocess defined

        def editor_widget(label, index=0):
            return [w for w in editor if w.name == label][index]

        editor_widget("Options").value = "orbit"
        editor_widget("Duration (sec)").value = ADV_PRESET_S
        editor_widget("Submit").fire()
        editor_widget("Set camera trajectory").fire()
        traj = app.svc_sessions["gui_states"]["smoke"].camera_traj_list
        prog_b = _Progress()
        torch.cuda.synchronize()
        _kernels.reset_counts()
        yields_b, handler_b, second_at_first_b = render(button("Render video", "do_render_advanced"), prog_b)
        counts = {k: counts[k] + v for k, v in _kernels.counts().items()}
        plan_b, render_b = plans[-1], render_s[0]
        first_b, final_b = yields_b[-1]
        direct = HeadlessRenderer(bundle, work_dir=None)
        direct_plan = direct.prepare(pre_b, seed=SEED, chunk_strategy="interp-gt", cfg=4.0, camera_scale=2.0,
                                     num_steps=NUM_STEPS, camera_traj_list=traj)
        # the reference render runs with the engine's stage timer (host
        # seconds a stage, no device synchronize): the frames must not change
        timer = StageTimer()
        anchors_b, frames_b = list(direct.run(direct_plan, timer=timer))
        print("[engine timing] (the Advanced reference render)\n" + timer.report(), flush=True)
        timing_ok = (
            {"prepare_images", "first_pass_sample", "second_pass_sample", "final_save"} <= set(timer.totals)
            and timer.counts["first_pass_sample"] == direct_plan["first_pass_chunks"]
            and timer.counts["second_pass_sample"] == direct_plan["second_pass_chunks"]
        )
        frames_b_png = read_pngs(os.path.join(os.path.dirname(final_b), "samples-rgb"))
        W, H = pre_b["input_wh"]
        advanced_ok = (
            (W, H) == (768, 576) and any(n.startswith("/scene_assets/cameras/") for n in nodes)
            and "/scene_assets/points" in nodes and traj is not None
            and len(frames_b_png) == len(traj) and second_at_first_b == 0 and reached(prog_b, plan_b)
            and np.array_equal(read_pngs(os.path.join(os.path.dirname(first_b), "samples-rgb")), anchors_b)
            and np.array_equal(frames_b_png, frames_b) and timing_ok
        )

        # (c) abort a Basic render after its first progress tick (the session's
        # scene is the Advanced one now: preprocess the Basic image again)
        press(button("Preprocess", "do_preprocess_basic"))
        ticked, ticks_at_press = threading.Event(), []

        class AbortProgress(_Progress):
            def __call__(self, *a, desc: str = "", **kw):
                super().__call__(desc=desc)
                ticked.set()

        prog_c, result = AbortProgress(), {}
        fn, inputs, _ = button("Render video", "do_render").events[0]

        def drain():
            try:
                result["yields"] = list(fn(*[w.value for w in inputs], progress=prog_c))
            finally:
                ticked.set()  # a render that fails before its first tick ends the wait too

        infos_before = len(gr.infos)
        worker = threading.Thread(target=drain)
        t0 = time.perf_counter()
        worker.start()
        ticked.wait(timeout=300)
        ticks_at_press.append(len(prog_c.descs))
        t_press = time.perf_counter()
        press(next(w for w in gr.widgets if w.kind == "Button" and w.args[:1] == ("Abort",)))
        worker.join(timeout=300)
        plan_c = plans[-1]
        abort_ok = (
            not worker.is_alive() and result.get("yields") == [] and ticks_at_press == [1]
            and len(prog_c.descs) <= 2 < plan_c["first_pass_steps"] + plan_c["second_pass_steps"]
            and gr.infos[infos_before:] == ["Render aborted."]
        )
        abort = {"ticks_at_press": ticks_at_press[0], "ticks": len(prog_c.descs),
                 "steps_planned": plan_c["first_pass_steps"] + plan_c["second_pass_steps"],
                 "press_to_end_s": time.perf_counter() - t_press, "render_s": time.perf_counter() - t0}

    ok = basic_ok and advanced_ok and abort_ok and counts["flash_attention"] > 0 and counts["time_attention"] > 0
    emit({"phase": "gui_path", "ok": ok, "basic_ok": basic_ok, "advanced_ok": advanced_ok,
          "abort_ok": abort_ok, "launches": counts,
          "basic": {"handler_s": handler_a, "render_s": render_a, "app_host_s": handler_a - render_a,
                    "first_pass_chunks": plan_a["first_pass_chunks"],
                    "second_pass_chunks": plan_a["second_pass_chunks"],
                    "second_pass_ticks_at_first_yield": second_at_first_a,
                    "frames_equal_main_path": bool(np.array_equal(frames_png, main_frames["frames"]))},
          "advanced": {"input_wh": [W, H], "preprocess_s": preprocess_b, "scene_nodes": len(nodes),
                       "trajectory_frames": len(traj or []), "handler_s": handler_b, "render_s": render_b,
                       "app_host_s": handler_b - render_b, "first_pass_chunks": plan_b["first_pass_chunks"],
                       "second_pass_chunks": plan_b["second_pass_chunks"],
                       "frames_equal_renderer": bool(np.array_equal(frames_b_png, frames_b)),
                       "engine_timing_ok": timing_ok,
                       "engine_timing_s": {k: [v, timer.counts[k]] for k, v in timer.totals.items()}},
          "abort": abort,
          "host_time": "app_host_s is host time: the handler's wall minus the renderer's "
                       "(prepare + engine, each engine yield synchronized) wall",
          "cuts": {"num_steps": f"{NUM_STEPS} (the app's default 50)",
                   "basic_frames": f"{NUM_TARGETS} (the #frames widget's default 80)",
                   "advanced": f"{ADV_IMAGES} seeded {ADV_W}x{ADV_H} PNGs, the editor's orbit preset "
                               f"over {ADV_PRESET_S} s",
                   "ui": "gradio and viser stand-ins (the packages are absent): events are called, "
                         "no page is served"}})
    if not ok:
        raise AssertionError("the GUI's renders, streaming, progress, abort or launch counts are wrong")
    return counts


def check_profile_trace(bundle, upstream: dict) -> None:
    """utils/profiling.trace around one full-width 42-frame UNet forward,
    then utils/trace_analysis on the trace it wrote; K1's and K2's class
    totals held to torch.profiler's key_averages over the same window."""
    import torch

    from stable_virtual_camera_tpu_torch.utils import profiling, trace_analysis

    x, t_idx, ctx, dense = upstream["inputs"]

    def forward():
        with torch.inference_mode():
            bundle.unet(x, t_idx, ctx, dense, T)
        torch.cuda.synchronize()

    forward()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiling.trace(tmp) as prof:
            with profiling.span("unet_forward"):
                forward()
        traced_s = time.perf_counter() - t0
        by_trace = trace_analysis.class_totals(tmp)
        events = trace_analysis.load_trace(tmp)
        device = trace_analysis.device_events(events)
        pids = {e["pid"] for e in device}
        gpu_process = [{e["name"]: e.get("args")} for e in events
                       if e.get("ph") == "M" and e.get("pid") in pids and e.get("name", "").startswith("process")]
        n_events = len(device)
        summary = trace_analysis.summarize(tmp, top=5)
        top = trace_analysis.top_fusion_details(tmp, top=3)
    _, by_name = profiler_classes(prof)
    by_name.pop("unet_forward", None)  # the annotation's range, not a kernel
    by_prof, longest = {}, {}
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        cls = trace_analysis.categorize(name)
        by_prof[cls] = by_prof.get(cls, 0.0) + ms
        longest.setdefault(cls, name[:240])
    rel = {}
    for cls in ("K1 flash attention", "K2 temporal attention"):
        a, b = by_trace.get(cls, 0.0), by_prof.get(cls, 0.0)
        rel[cls] = abs(a - b) / b if b else None
    ok = all(r is not None and r <= TRACE_CLASS_REL for r in rel.values())
    emit({"phase": "profile_trace", "ok": ok, "device_events": n_events, "gpu_process": gpu_process,
          "traced_wall_s": traced_s,
          "trace_ms_by_class": by_trace, "key_averages_ms_by_class": by_prof, "k1_k2_rel": rel,
          "bar": TRACE_CLASS_REL, "longest_kernel_by_class": longest,
          "summarize": summary.splitlines(), "top_fusion_details": top.splitlines()})
    if not ok:
        raise AssertionError("the trace's K1/K2 class totals disagree with torch.profiler's")


def check_lpips(frames) -> None:
    """models/lpips on two 576x576 frames of the GUI's render, synthetic
    weights, fp32 on the card (TF32 off) against the CPU score."""
    import torch

    from stable_virtual_camera_tpu_torch.models.lpips import lpips_apply_fn, synthetic_lpips_params

    a, b = (f.astype("float32") / 255.0 for f in frames[:2])
    params = synthetic_lpips_params(seed=SEED)
    card = lpips_apply_fn(params, device=DEVICE)
    score = card(a, b)  # warm-up (cuDNN algorithm selection)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LPIPS_REPS):
        score = card(a, b)  # float() waits for the device
    ms = (time.perf_counter() - t0) * 1e3 / LPIPS_REPS
    t0 = time.perf_counter()
    cpu_score = lpips_apply_fn(params, device="cpu")(a, b)
    cpu_s = time.perf_counter() - t0
    rel = abs(score - cpu_score) / abs(cpu_score)
    # random heads may be negative, so the score's sign is not checked
    ok = math.isfinite(score) and score != 0.0 and rel <= LPIPS_REL
    emit({"phase": "lpips", "ok": ok, "score": score, "cpu_score": cpu_score, "rel": rel, "bar": LPIPS_REL,
          "ms_per_pair": ms, "cpu_s_per_pair": cpu_s, "image_hw": list(frames.shape[1:3]),
          "weights": f"synthetic (flax-default init, seed {SEED}), fp32; TF32 off",
          "timing": f"host clock over {LPIPS_REPS} pairs after one warm-up, each pair copied to the "
                    "card and its score read back"})
    if not ok:
        raise AssertionError("LPIPS on the card disagrees with the CPU")


def profiler_classes(prof) -> tuple[dict[str, float], dict[str, float]]:
    """(device ms by kernel class, device ms by kernel name) from a
    torch.profiler window's key_averages, classed by
    utils/trace_analysis.categorize."""
    from torch.autograd import DeviceType

    from stable_virtual_camera_tpu_torch.utils.trace_analysis import categorize

    classes: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        cls = categorize(e.key)
        classes[cls] = classes.get(cls, 0.0) + us / 1e3
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    return classes, kernels


def busy_intervals(prof) -> tuple[float, dict[int, float]]:
    """(ms during which at least one kernel, copy or set ran on the device,
    {stream: the same on that stream}) from a torch.profiler window's
    device events: the union of their intervals, so kernels that overlap on
    several streams count once."""
    from torch.autograd import DeviceType

    by_stream: dict[int, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            by_stream.setdefault(e.device_resource_id, []).append((e.time_range.start, e.time_range.end))

    def union_us(spans) -> float:
        total, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    every = [span for spans in by_stream.values() for span in spans]
    return union_us(every) / 1e3, {k: union_us(v) / 1e3 for k, v in sorted(by_stream.items())}


def device_time_by_class(fn, top: int = 0) -> dict:
    """torch.profiler over one call of `fn` (which ends in a synchronize):
    wall time, device time by kernel class (ms), their sum, the device's
    busy time (the union of its kernels' intervals over every stream, and
    each stream's own) and the idle share (1 - busy / wall); with `top`,
    the names (cut to 90 characters) and ms of the longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    classes, by_name = profiler_classes(prof)
    kernels: dict[str, float] = {}
    for name, ms in by_name.items():
        kernels[name[:90]] = kernels.get(name[:90], 0.0) + ms
    busy, streams = busy_intervals(prof)
    out = {"wall_s": wall, "kernel_ms_sum": sum(classes.values()), "device_busy_ms": busy,
           "busy_ms_by_stream": {str(k): v for k, v in streams.items()},
           "idle_share": (1 - busy / (wall * 1e3)) if busy else "not measured",
           "device_ms_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1]))}
    if top:
        out["top_kernels_ms"] = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:top])
    return out


def profile_train_step(bundle, gen) -> None:
    """Device time of one full-width train step (loss, backward, AdamW) by
    kernel class, from torch.profiler."""
    import torch

    from stable_virtual_camera_tpu_torch.training.optim import AdamW
    from stable_virtual_camera_tpu_torch.training.train_step import make_train_step

    batch, draw = train_inputs(bundle, gen)
    step = make_train_step(bundle.unet, AdamW(bundle.unet.parameters(), TRAIN_LR), TRAIN_T)
    step(batch, draw)
    torch.cuda.synchronize()

    def one_step():
        step(batch, draw)
        torch.cuda.synchronize()

    prof = device_time_by_class(one_step, top=12)
    emit({"phase": "train_profile", "ok": True, "step_wall_s": prof.pop("wall_s"), **prof})


def orbit_views(n: int = 24):
    """n seeded 576x576 RGB images on a circular orbit around the origin,
    looking at it: (images, OpenCV c2ws (n, 4, 4), pixel intrinsics K)."""
    import numpy as np

    from stable_virtual_camera_tpu_torch.core.trajectories import get_lookat_w2cs

    rng = np.random.default_rng(SEED)
    theta = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    positions = np.stack([2.0 * np.cos(theta), np.full(n, -0.3), 2.0 * np.sin(theta)], -1)
    c2ws = np.linalg.inv(get_lookat_w2cs(positions, np.zeros(3), np.array([0.0, -1.0, 0.0])))
    K = np.array([[500.0, 0.0, RES / 2], [0.0, 500.0, RES / 2], [0.0, 0.0, 1.0]])
    imgs = [im for im in rng.integers(0, 256, (n, RES, RES, 3), dtype=np.uint8)]
    return imgs, c2ws, K


def orbit_scene(n: int = 24):
    """The orbit of `orbit_views` as an in-memory scene."""
    import numpy as np

    from stable_virtual_camera_tpu_torch.data import Dataset, DirectParser

    imgs, c2ws, K = orbit_views(n)
    return Dataset(DirectParser(imgs, c2ws[:, :3].astype(np.float32), np.repeat(K[None], n, 0)))


def run_train_path(bundle) -> dict:
    """The train CLI's loop at full width on the card, then one LoRA step;
    each run's checkpoint restored and held against the live state."""
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


def check_align_sharded() -> None:
    """`align_sharded`: the 56-edge synthetic scene of
    global_align_synthetic (with ALIGN_NOISE on its pointmaps) refined
    unsharded and with its edges over the
    "data" axis of an ALIGN_MESH mesh of thread ranks on cuda:0, the same
    steps and schedule: final loss, camera centers and focal against the
    unsharded run at the JAX package's bars, ms a step for each."""
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch.core import global_alignment as ga
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh

    edges, c2ws, f, world = synthetic_scene(SCENE_N, SCENE_H, SCENE_W, noise=ALIGN_NOISE)
    mesh = make_mesh(*ALIGN_MESH, devices=[DEVICE] * (ALIGN_MESH[0] * ALIGN_MESH[1]), timeout=MESH_TIMEOUT)
    runs = {}
    for name, kw in (("unsharded", {"device": DEVICE}), ("sharded", {"mesh": mesh})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = ga.global_align(edges, niter=ALIGN_STEPS, lr=0.01, **kw)
        torch.cuda.synchronize()
        runs[name + "_s"] = time.perf_counter() - t0
    ref, out = runs["unsharded"], runs["sharded"]
    loss_rel = abs(out.final_loss - ref.final_loss) / abs(ref.final_loss)
    center_err = float(np.abs(out.c2ws[:, :3, 3] - ref.c2ws[:, :3, 3]).max())
    focal_rel = float(abs(out.Ks[0, 0, 0] / ref.Ks[0, 0, 0] - 1))
    err = scene_errors(out, c2ws, f, world)
    ok = (np.isfinite(out.final_loss) and loss_rel <= ALIGN_LOSS_RTOL and center_err <= ALIGN_CENTER_ATOL
          and focal_rel <= ALIGN_FOCAL_RTOL)
    emit({"phase": "align_sharded", "ok": ok, "mesh": dict(zip(("data", "view"), ALIGN_MESH)),
          "edges": len(edges.i_idx), "edges_a_rank": len(edges.i_idx) // ALIGN_MESH[0], "steps": ALIGN_STEPS,
          "pointmap_noise": ALIGN_NOISE,
          "loss": out.final_loss, "loss_unsharded": ref.final_loss, "loss_rel": loss_rel,
          "center_max_abs_diff": center_err, "focal_rel_diff": focal_rel,
          "ms_per_step": runs["sharded_s"] * 1e3 / ALIGN_STEPS,
          "ms_per_step_unsharded": runs["unsharded_s"] * 1e3 / ALIGN_STEPS,
          "includes": "host init, the refinement, the scene back on the host",
          "recovery": err,
          "bar": {"loss_rtol": ALIGN_LOSS_RTOL, "center_atol": ALIGN_CENTER_ATOL,
                  "focal_rtol": ALIGN_FOCAL_RTOL}})
    if not ok:
        raise AssertionError("the edge-sharded alignment disagrees with the unsharded one")


def check_ring_backward(gen) -> dict:
    """`ring_bwd` (see the module docstring): returns the kernel route's
    launch counts."""
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.ops.flash_upstream import flash_attention_cuda
    from stable_virtual_camera_tpu_torch.parallel.ring_attention import ring_backward

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    n = SHARDED_VIEW
    rows, counts = [], {}
    for L, B, H in JOINT_TRAIN_SHAPES:
        W, Ll = H * 64, L // n
        # each rank's q, k, v as the UNet hands them to the ring: strided
        # (B, H, L/n, 64) views of its packed projection; o (contiguous) and
        # the fp32 lse of the whole sequence's attention, cut by rank; dO a
        # (B, H, L/n, 64) view of a (B, L/n, H*64) gradient
        qkv = torch.randn((B, L, 3 * W), generator=gen, device=DEVICE).to(torch.bfloat16)
        q, k, v = (t.view(B, L, H, 64).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)
        saved, grads = [], []
        for r in range(n):
            part = qkv[:, r * Ll:(r + 1) * Ll].clone()
            q_r, k_r, v_r = (t.view(B, Ll, H, 64).transpose(1, 2) for t in part.chunk(3, dim=-1))
            saved.append((q_r, k_r, v_r, o[:, :, r * Ll:(r + 1) * Ll].contiguous(),
                          lse[:, :, r * Ll:(r + 1) * Ll].contiguous()))
            do = torch.randn((B, Ll, W), generator=gen, device=DEVICE).to(torch.bfloat16)
            grads.append((do.view(B, Ll, H, 64).transpose(1, 2),))
        del qkv, q, k, v, o, lse
        torch.cuda.synchronize()
        _kernels.reset_counts()
        kern = ring_backward(saved, grads, kernel=True)
        torch.cuda.synchronize()
        launched = {key: _kernels.counts()[key] for key in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")}
        for key, c in launched.items():
            counts[key] = counts.get(key, 0) + c
        plain = ring_backward(saved, grads, kernel=False)
        torch.cuda.synchronize()
        errs = {name: max(rel(kern[r][i], plain[r][i]) for r in range(n))
                for i, name in enumerate(("dq", "dk", "dv"))}
        rows.append({
            "L": L, "B": B, "H": H, "rank_rows": Ll, "rel_l2_worst_rank": errs,
            "max_abs_err": max((kern[r][i].float() - plain[r][i].float()).abs().max().item()
                               for r in range(n) for i in range(3)),
            "finite": bool(all(torch.isfinite(t).all() for g in kern for t in g)),
            "launches": launched,
            "ms": cuda_ms(lambda: ring_backward(saved, grads, kernel=True), 3),
            "plain_ms": cuda_ms(lambda: ring_backward(saved, grads, kernel=False), 1),
        })
        del saved, grads, kern, plain
        torch.cuda.empty_cache()
    ok = all(r["finite"] and max(r["rel_l2_worst_rank"].values()) <= K1_BWD_REL_L2
             and all(c == n * n for c in r["launches"].values()) for r in rows)
    emit({"phase": "ring_bwd", "ok": ok, "ranks": n,
          "bar": {"rel_l2": K1_BWD_REL_L2, "launches_each": n * n}, "shapes": rows,
          "inputs": "every rank's q, k, v, o, global lse and dO made once; both routes read the same tensors"})
    if not ok:
        raise AssertionError("the ring's kernel backward disagrees with its plain backward, or its "
                             "launches are not one K1-dKV and one K1-dQ a block")
    return counts


def attention_sites(unet, h: int) -> dict:
    """The attention layers of one SevaUNet forward at latent side h: the
    per-frame self-attentions that take K1 (L = h*w >= 1024), the joint
    (T*h*w-token) ones and the time-mixes (K2), from the UNet's stages."""
    from stable_virtual_camera_tpu_torch.models.unet import FLASH_MIN_LEN

    sites = {"per_frame_k1": 0, "joint": 0, "time_mix": 0}

    def count(name, side):
        m = getattr(unet, name)
        sites["time_mix"] += m.depth
        if m.unflatten:
            sites["joint"] += m.depth
        elif side * side >= FLASH_MIN_LEN:
            sites["per_frame_k1"] += m.depth

    side = h
    for _name, attn, is_down in unet._encoder:
        if is_down:
            side = (side + 1) // 2
        elif attn is not None:
            count(attn, side)
    count("middle_block_1", side)
    for _name, attn, up in unet._decoder:
        if attn is not None:
            count(attn, side)
        if up is not None:
            side *= 2
    return sites


def predicted_step_launches(sites: dict, n_view: int = 1, n_data: int = 1) -> dict:
    """K1, K1-dKV, K1-dQ and K2 launches of one train step with remat on
    (n_data, n_view) ranks: each rank runs the per-frame layers on its
    frames twice (forward and recompute) and their backward once; a joint
    layer is a ring of n_view^2 K1 blocks forward (its recompute replays
    the exchange) and n_view^2 K1-dKV and K1-dQ blocks backward (one K1 and
    its backward pair unsharded); K2 runs twice a time-mix a rank. FSDP's
    data ranks each run the whole step (JAX replicates the batch)."""
    n = n_view
    per, joint, mix = sites["per_frame_k1"], sites["joint"], sites["time_mix"]
    bwd = n * per + n * n * joint
    return {k: n_data * v for k, v in {"flash_attention": 2 * n * per + n * n * joint * (2 if n == 1 else 1),
                                       "flash_attention_bwd_dkv": bwd, "flash_attention_bwd_dq": bwd,
                                       "time_attention": 2 * n * mix}.items()}


def write_orbit_scene(root: str) -> str:
    """train_path's in-memory orbit scene written as a reconfusion scene
    directory (PNGs, OpenGL transforms, one train/test split) for the train
    CLI's --data_path."""
    import cv2
    import numpy as np

    imgs, c2ws, K = orbit_views()
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    frames = []
    for i, image in enumerate(imgs):
        name = f"images/frame_{i:03d}.png"
        cv2.imwrite(os.path.join(root, name), np.ascontiguousarray(image[..., ::-1]))
        c2w = c2ws[i].copy()
        c2w[:, [1, 2]] *= -1  # OpenCV -> OpenGL
        frames.append({"file_path": f"./{name}", "transform_matrix": c2w.tolist(), "fl_x": float(K[0, 0]),
                       "fl_y": float(K[1, 1]), "cx": float(K[0, 2]), "cy": float(K[1, 2]), "w": RES, "h": RES})
    with open(os.path.join(root, "transforms.json"), "w") as fh:
        json.dump({"frames": frames}, fh)
    n = len(frames)
    with open(os.path.join(root, f"train_test_split_{TRAIN_INPUTS}.json"), "w") as fh:
        json.dump({"train_ids": list(range(n - 4)), "test_ids": list(range(n - 4, n))}, fh)
    return root


def run_sharded_train(bundle, gen) -> dict:
    """`sharded_train`: (a) the view-sharded step, (b) the FSDP step, (c)
    the train CLI on a view mesh (see the module docstring), all on thread
    ranks on cuda:0 at full width (bf16, T=21, 576x576, remat); the UNet's
    weights are put back as they were. Returns the launch counts by path."""
    import numpy as np
    import torch

    from stable_virtual_camera_tpu_torch import _kernels
    from stable_virtual_camera_tpu_torch.apps import train_cli
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh
    from stable_virtual_camera_tpu_torch.training.checkpoint import restore_train_state
    from stable_virtual_camera_tpu_torch.training.optim import AdamW
    from stable_virtual_camera_tpu_torch.training.train_step import (
        make_fsdp_train_step,
        make_loss_fn,
        make_sharded_train_step,
        make_train_step,
    )

    unet = bundle.unet
    # train_path's LoRA step leaves the base weights frozen; the full
    # fine-tune trains them all (their flags are put back at the end)
    trainable = {n: p.requires_grad for n, p in unet.named_parameters()}
    unet.requires_grad_(True)
    batch, _ = train_inputs(bundle, gen)
    eps = [torch.randn(tuple(batch.latents.shape), generator=gen, device=DEVICE) for _ in range(2)]
    draws = [lambda shape, t=t, e=e: (torch.tensor(t, device=DEVICE), e) for t, e in zip((500, 700), eps)]
    sites = attention_sites(unet, RES // 8)
    names = [n for n, _ in unet.named_parameters()]
    unet_bytes = sum(p.numel() * p.element_size() for p in unet.parameters())
    start = {n: p.detach().clone() for n, p in unet.named_parameters()}

    def restore():
        unet.zero_grad(set_to_none=True)
        with torch.no_grad():
            for n, p in unet.named_parameters():
                p.copy_(start[n])

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def rel_l2(a: dict, b: dict, base: dict | None = None) -> float:
        num = torch.stack([(a[n].float() - b[n].float()).norm() for n in b]).norm()
        den = torch.stack([(b[n].float() - (0 if base is None else base[n].float())).norm() for n in b]).norm()
        return (num / den).item()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def launches(counts):
        return {k: counts[k] for k in TRAIN_KERNELS}

    # the unsharded step from `start`: step 1 by hand (its gradient kept),
    # step 2 timed with its launches
    restore()
    opt = AdamW(unet.parameters(), TRAIN_LR)
    loss1 = make_loss_fn(unet, TRAIN_T, remat=True)(batch, draws[0])
    loss1.backward()
    g_ref = {n: p.grad.detach().clone() for n, p in unet.named_parameters() if p.grad is not None}
    opt.step()
    p1_ref = {n: p.detach().clone() for n, p in unet.named_parameters()}
    step = make_train_step(unet, opt, TRAIN_T, remat=True)
    _kernels.reset_counts()
    loss2, unsharded_s = timed(lambda: step(batch, draws[1]).item())
    unsharded_counts = launches(_kernels.counts())
    p2_ref = {n: p.detach().clone() for n, p in unet.named_parameters()}
    ref = {"loss": [loss1.item(), loss2], "step_s": unsharded_s, "launches": unsharded_counts}
    del opt, step, loss1
    free()

    # (a) the view-sharded step
    restore()
    opt = AdamW(unet.parameters(), TRAIN_LR)
    mesh = make_mesh(1, SHARDED_VIEW, devices=[DEVICE] * SHARDED_VIEW, timeout=MESH_TIMEOUT)
    step = make_sharded_train_step(unet, opt, TRAIN_T, mesh, remat=True)
    torch.cuda.reset_peak_memory_stats()
    s1, first_s = timed(lambda: step.loss_and_grads(batch, draws[0]).item())
    grad_rel = rel_l2({n: p.grad for n, p in unet.named_parameters() if n in g_ref}, g_ref)
    step.apply()
    _kernels.reset_counts()
    s2, sharded_s = timed(lambda: step(batch, draws[1]).item())
    counts = {"sharded_train": _kernels.counts()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    own = dict(unet.named_parameters())
    replicas_equal = all(torch.equal(own[n], r.params[n]) for r in step.replicas[1:] for n in names)
    params_rel = rel_l2({n: p.detach() for n, p in own.items()}, p2_ref, start)
    del step, opt, own, g_ref, p2_ref
    free()
    predicted = predicted_step_launches(sites, SHARDED_VIEW)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip((s1, s2), ref["loss"]))
    a_ok = (loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2 and replicas_equal
            and launches(counts["sharded_train"]) == predicted
            and unsharded_counts == predicted_step_launches(sites))
    sharded = {"ok": a_ok, "mesh": {"data": 1, "view": SHARDED_VIEW}, "loss": [s1, s2], "loss_rel": loss_rel,
               "grad_rel_l2": grad_rel, "replicas_bit_equal": replicas_equal,
               "params_after_2_steps_rel_l2_of_update": params_rel,
               "launches_step_2": launches(counts["sharded_train"]), "predicted": predicted,
               "first_step_s_with_replication": first_s, "step_s": sharded_s,
               "step_s_over_unsharded": sharded_s / unsharded_s, "peak_gb": peak_gb}

    # (b) FSDP: every leaf over "data", one step against the unsharded step 1
    restore()
    opt = AdamW(unet.parameters(), TRAIN_LR)
    mesh = make_mesh(*FSDP_MESH, devices=[DEVICE] * (FSDP_MESH[0] * FSDP_MESH[1]), timeout=MESH_TIMEOUT)
    fstep, finit = make_fsdp_train_step(unet, opt, TRAIN_T, mesh, remat=True)
    state = finit()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    f1, fsdp_s = timed(lambda: fstep(state, batch, draws[0]).item())
    counts["fsdp_train"] = _kernels.counts()
    fsdp_peak = torch.cuda.max_memory_allocated() / 1e9
    whole = state.params()
    fsdp_rel = rel_l2(whole, p1_ref, start)
    fsdp_equal = all(torch.equal(whole[n], p1_ref[n]) for n in names)
    shares = [state.persistent_bytes(r) / (3 * unet_bytes) for r in range(mesh.size)]
    del state, fstep, finit, opt, whole, p1_ref
    free()
    f_predicted = predicted_step_launches(sites, FSDP_MESH[1], FSDP_MESH[0])
    f_loss_rel = abs(f1 - ref["loss"][0]) / abs(ref["loss"][0])
    b_ok = (f_loss_rel <= TRAIN_LOSS_REL and fsdp_rel <= FSDP_PARAM_REL and max(shares) <= FSDP_BYTES_SHARE
            and launches(counts["fsdp_train"]) == f_predicted)
    fsdp = {"ok": b_ok, "mesh": dict(zip(("data", "view"), FSDP_MESH)), "loss": f1, "loss_rel": f_loss_rel,
            "params_rel_l2_of_update": fsdp_rel, "params_bit_equal": fsdp_equal,
            "persistent_share_by_rank": shares, "whole_state_bytes": 3 * unet_bytes,
            "launches": launches(counts["fsdp_train"]), "predicted": f_predicted, "step_s": fsdp_s,
            "step_s_over_unsharded": fsdp_s / unsharded_s, "peak_gb": fsdp_peak,
            "gathered_during_a_step": "each rank's whole weights and their whole gradient"}
    restore()
    del start
    for n, p in unet.named_parameters():
        p.requires_grad_(trainable[n])
    free()

    # (c) the train CLI on a (1, CLI_MESH_VIEW) mesh: two steps, the
    # checkpoint read back, then resumed for a third
    refusals = {}
    # the CLI draws its own random weights: keep them, to hold its
    # checkpoint against the weights it trained
    made = []
    make = train_cli.random_model_bundle
    train_cli.random_model_bundle = lambda device: made.append(make(device)) or made[-1]
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_orbit_scene(os.path.join(tmp, "scene"))
        kw = dict(data_path=scene, random_model=True, num_input_frames=TRAIN_INPUTS, lr=TRAIN_LR,
                  warmup_steps=1, remat=True, log_every=1, seed=SEED, device=DEVICE,
                  mesh_timeout=MESH_TIMEOUT)
        for name, extra in (("lora_rank", {"mesh_view": CLI_MESH_VIEW, "lora_rank": LORA_RANK}),
                            ("t_mod_mesh_view", {"mesh_view": 4})):
            try:
                train_cli.main(work_dir=os.path.join(tmp, name), num_steps=1, **kw, **extra)
                refusals[name] = "trained"
            except ValueError as e:
                refusals[name] = str(e)
            made.clear()
            free()
        work = os.path.join(tmp, "ft")
        _kernels.reset_counts()
        first = train_cli.main(work_dir=work, num_steps=2, mesh_view=CLI_MESH_VIEW, **kw)
        counts["train_cli_mesh"] = _kernels.counts()
        params, _, saved_step, _ = restore_train_state(first["ckpt_path"])
        live = dict(made[-1][0].unet.named_parameters())
        restored_equal = saved_step == 2 and all(torch.equal(t, live[n].detach().cpu())
                                                  for n, t in params.items())
        first_losses, first_seconds = first["losses"], first["step_seconds"]
        del first, live, params
        made.clear()
        free()
        second = train_cli.main(work_dir=work, num_steps=3, mesh_view=CLI_MESH_VIEW, **kw)
        resumed = len(second["losses"]) == 1 and restore_train_state(second["ckpt_path"])[2] == 3
        losses = first_losses + second["losses"]
        del second
        made.clear()
        free()
    train_cli.random_model_bundle = make
    c_ok = (all(math.isfinite(x) for x in losses) and restored_equal and resumed
            and "does not combine" in refusals["lora_rank"] and "must divide" in refusals["t_mod_mesh_view"]
            and all(counts["train_cli_mesh"][k] > 0 for k in TRAIN_KERNELS))
    cli = {"ok": c_ok, "mesh_view": CLI_MESH_VIEW, "losses": losses, "step_seconds": first_seconds,
           "checkpoint_restored_equal": restored_equal,
           "resumed_for_step_3": resumed, "refusals": refusals, "launches": launches(counts["train_cli_mesh"])}
    ok = a_ok and b_ok and c_ok
    emit({"phase": "sharded_train", "ok": ok, "frames": TRAIN_T, "latent": [RES // 8, RES // 8],
          "remat": True, "attention_sites": sites, "unsharded": ref, "sharded": sharded, "fsdp": fsdp,
          "train_cli_mesh": cli,
          "bar": {"loss_rel": TRAIN_LOSS_REL, "grad_rel_l2": TRAIN_GRAD_REL_L2, "fsdp_param_rel": FSDP_PARAM_REL,
                  "fsdp_bytes_share": FSDP_BYTES_SHARE, "collective_timeout_s": MESH_TIMEOUT},
          "cuts": {"steps": "2 (sharded), 1 (FSDP), 2 + 1 resumed (CLI)",
                   "ranks": "threads on the one card's cuda:0, each on its own stream",
                   "weights": "random bf16 (flax-default init, seed 0), full width"}})
    if not ok:
        raise AssertionError("the sharded training path failed its checks")
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

    t_start = t0 = time.perf_counter()
    _kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted({k.library().name for k in _kernels.KERNELS.values()})})

    failures: list[str] = []
    results: dict = {}
    ring_counts: dict = {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for key, fn in (("flash_attention", check_k1), ("time_attention", check_k2),
                    ("k1_bwd", check_k1_bwd), ("ring_bwd", check_ring_backward),
                    ("flash_attention_blhd", lambda g: check_layout_kernel(g, "blhd")),
                    ("flash_attention_packed", lambda g: check_layout_kernel(g, "packed")),
                    ("flash_attention_fp32", check_fp32_flash), ("fp32_flash_bwd", check_fp32_flash_bwd)):
        try:
            out = fn(gen)
            if key in ("k1_bwd", "fp32_flash_bwd"):
                results.update(out)
            elif key == "ring_bwd":
                ring_counts = out
            else:
                results[key] = out
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failures.append(key)

    counts: dict[str, dict] = {"render": {}, "advanced": {}, "gui": {}, "cli": {}, "checkpoint": {},
                               "train": {}, "k5": {}, "quant_w8a8": {}, "quant_static": {}, "server": {},
                               "server_static": {}, "export": {}, "export_server": {},
                               "parallel_view1": {}, f"parallel_view{PARALLEL_VIEW}": {}, "parallel_cli": {},
                               "parallel_chunk_batch": {}, "stream": {}, "film_cache": {},
                               "ring_bwd": ring_counts, "sharded_train": {}, "fsdp_train": {},
                               "train_cli_mesh": {}, "fp32_tiny_cli": {}, "fp32_forward": {}, "fp32_flash": {},
                               "fp32_packed": {}, "fp32_train": {},
                               **{"tp_" + "x".join(map(str, m)): {} for m in TP_MESHES},
                               **{f"tp_{q}_" + "x".join(map(str, TP_MESHES[0])): {} for q in ("w8a8", "w8a8-static")}}
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
    try:
        check_align_sharded()
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        failures.append("align_sharded")
    pipe = None
    try:
        pipe = check_dust3r_forward()
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        failures.append("dust3r_forward")
    upstream: dict = {}
    recorded: dict[str, dict] = {"render": {}, "advanced": {}}
    cli_frames: dict = {}
    main_frames: dict = {}
    gui_frames: dict = {}
    tiny_shapes: set = set()
    try:
        t0 = time.perf_counter()
        bundle = random_bundle(SevaSpec(), ClipVisionSpec(), dtype=torch.bfloat16, device=DEVICE,
                               generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        torch.cuda.synchronize()
        emit({"phase": "weights", "seconds": time.perf_counter() - t0,
              "unet_params": sum(p.numel() for p in bundle.unet.parameters())})
        for key, fn in (("unet_forward", lambda: upstream.update(check_unet(bundle, gen))),
                        ("unet_forward_backends", lambda: check_unet_backends(bundle, upstream)),
                        ("f1_fp32_routes", lambda: counts.update(check_fp32_routes(bundle, upstream, gen, tiny_shapes))),
                        ("k2_any_time_attention",
                         lambda: results.__setitem__("time_attention_any", check_time_any(gen, tiny_shapes))),
                        ("main_path", lambda: run_main_path(bundle, recorded["render"], main_frames)),
                        ("advanced_path", lambda: run_advanced_path(bundle, pipe, recorded["advanced"])),
                        ("gui_path", lambda: run_gui_path(bundle, pipe, main_frames, gui_frames)),
                        ("profile_trace", lambda: check_profile_trace(bundle, upstream)),
                        ("lpips", lambda: check_lpips(gui_frames["frames"])),
                        ("k1_k2_path_shapes", lambda: check_path_shapes(gen, recorded)),
                        ("cli_path", lambda: run_cli_path(cli_frames)),
                        ("checkpoint_path",
                         lambda: run_checkpoint_path(cli_frames["img2img_single_pass"])),
                        ("quant_ops", lambda: check_quant_ops(gen)),
                        ("quant_path", lambda: check_quant_path(bundle, upstream)),
                        ("server_path", lambda: check_server_path(cli_frames)),
                        ("export_path", lambda: run_export_path(cli_frames)),
                        ("parallel_path", lambda: run_parallel_path(bundle)),
                        ("stream_path", run_stream_path),
                        ("tp_path", lambda: run_tp_path(bundle)),
                        ("film_cache", lambda: run_film_cache(bundle)),
                        ("train_grad", lambda: check_train_grad(bundle, gen)),
                        ("train_profile", lambda: profile_train_step(bundle, gen)),
                        ("train_path", lambda: run_train_path(bundle)),
                        ("sharded_train", lambda: run_sharded_train(bundle, gen))):
            try:
                out = fn()
                if key == "main_path":
                    counts["render"] = out
                elif key == "advanced_path":
                    counts["advanced"] = out
                elif key == "gui_path":
                    counts["gui"] = out
                    pipe = None  # free the DUSt3R weights
                elif key == "k1_k2_path_shapes":
                    for kernel, by_path in out.items():
                        r = results.setdefault(kernel, {})
                        r["path_shapes"] = by_path
                        r["max_abs_err"] = max([r.get("max_abs_err", 0.0)]
                                               + [p["max_abs_err"] for p in by_path.values()])
                elif key == "cli_path":
                    counts["cli"] = out
                elif key == "checkpoint_path":
                    counts["checkpoint"] = out
                elif key == "quant_path":
                    counts["quant_w8a8"], counts["quant_static"] = out["w8a8"], out["static"]
                elif key in ("server_path", "export_path", "parallel_path", "tp_path"):
                    counts.update(out)
                elif key == "stream_path":
                    counts["stream"] = out
                elif key == "film_cache":
                    counts["film_cache"] = out
                elif key == "train_path":
                    counts["train"] = out
                elif key == "sharded_train":
                    counts.update(out)
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
        "flash_attention_fp32": "stable_virtual_camera_tpu/ops/flash_upstream.py:74, ops/flash_attention.py:122 "
                                "and ops/flash_attention_packed.py:156 on fp32 inputs",
        "flash_attention_bwd_dkv_fp32": "stable_virtual_camera_tpu/ops/flash_upstream.py:74 under grad on fp32 "
                                        f"inputs: {upstream}:1121 (_flash_attention_bwd_dkv)",
        "flash_attention_bwd_dq_fp32": "stable_virtual_camera_tpu/ops/flash_upstream.py:74 under grad on fp32 "
                                       f"inputs: {upstream}:1456 (_flash_attention_bwd_dq)",
        "time_attention_any": "stable_virtual_camera_tpu/ops/time_attention.py:134 at any head dim and dtype "
                              "(the Hopper K2 takes bf16 at head dim 64)",
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
            "flash_attention_blhd": "cli", "flash_attention_packed": "cli", "layer_norm": "k5",
            "flash_attention_fp32": "fp32_forward", "flash_attention_bwd_dkv_fp32": "fp32_train",
            "flash_attention_bwd_dq_fp32": "fp32_train", "time_attention_any": "fp32_forward"}
    # the torch.library custom op each kernel launches from (K5 is called
    # directly: no model path runs it)
    custom_op = {"flash_attention": "svc::flash_attention", "flash_attention_bwd_dkv": "svc::flash_attention_bwd",
                 "flash_attention_bwd_dq": "svc::flash_attention_bwd", "time_attention": "svc::time_attention",
                 "flash_attention_blhd": "svc::flash_attention_blhd",
                 "flash_attention_packed": "svc::flash_attention_packed", "layer_norm": None,
                 "flash_attention_fp32": "svc::flash_attention, svc::flash_attention_blhd, "
                                         "svc::flash_attention_packed",
                 "flash_attention_bwd_dkv_fp32": "svc::flash_attention_bwd",
                 "flash_attention_bwd_dq_fp32": "svc::flash_attention_bwd", "time_attention_any": "svc::time_attention"}
    rows = []
    for k in _kernels.KERNELS.values():
        r = results.get(k.name, {})
        rows.append({
            "name": k.name,
            "route": "cuda",
            "custom_op": custom_op[k.name],
            "source": f"stable_virtual_camera_tpu_torch/csrc/{k.source.name}",
            "replaces": replaces[k.name],
            "launches": counts[home[k.name]].get(k.name, 0),
            "launches_by_path": {path: c.get(k.name, 0) for path, c in counts.items()},
            **{key: r.get(key) for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
            **{key: r[key] for key in ("library", "plain_and_library_cover", "delta_ms", "path_shapes",
                                       "cold_ms", "library_cold_ms", "device_us", "library_device_us",
                                       "bound_share", "bound_ffma_ms", "bound_tf32x3_ms", "ptxas", "by_layout",
                                       "tiny_cli") if key in r},
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start, "limit_s": 1200})
    emit({"kernels": rows})
    missing = [f"{k}@{path}" for path, ks in (
                   ("render", ("flash_attention", "time_attention")),
                   ("advanced", ("flash_attention", "time_attention")),
                   ("gui", ("flash_attention", "time_attention")),
                   ("k5", ("layer_norm",)),
                   ("cli", ("flash_attention", "time_attention", "flash_attention_blhd",
                            "flash_attention_packed")),
                   ("checkpoint", ("flash_attention", "time_attention")),
                   ("quant_w8a8", ("flash_attention", "time_attention")),
                   ("quant_static", ("flash_attention", "time_attention")),
                   ("server", ("flash_attention", "time_attention")),
                   ("server_static", ("flash_attention", "time_attention")),
                   ("export", ("flash_attention", "time_attention")),
                   ("export_server", ("flash_attention", "time_attention")),
                   ("parallel_view1", ("flash_attention", "time_attention")),
                   (f"parallel_view{PARALLEL_VIEW}", ("flash_attention", "time_attention")),
                   ("parallel_cli", ("flash_attention", "time_attention")),
                   ("parallel_chunk_batch", ("flash_attention", "time_attention")),
                   ("stream", ("flash_attention_blhd", "time_attention")),
                   ("tp_1x1x2", ("flash_attention", "time_attention")),
                   ("film_cache", ("flash_attention", "time_attention")),
                   ("train", TRAIN_KERNELS),
                   ("ring_bwd", ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")),
                   ("sharded_train", TRAIN_KERNELS),
                   ("fsdp_train", TRAIN_KERNELS),
                   ("train_cli_mesh", TRAIN_KERNELS),
                   ("fp32_tiny_cli", ("time_attention_any",)),
                   ("fp32_forward", ("flash_attention_fp32", "time_attention_any")),
                   ("fp32_flash", ("flash_attention_fp32",)),
                   ("fp32_packed", ("flash_attention_fp32",)),
                   ("fp32_train", FP32_TRAIN_KERNELS),
                   *((f"tp_{q}_" + "x".join(map(str, TP_MESHES[0])), ("flash_attention", "time_attention"))
                     for q in ("w8a8", "w8a8-static")))
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
