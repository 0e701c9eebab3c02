#!/usr/bin/env python3
"""How far the full-width bf16 UNet moves when only the batch around a chunk
changes, on one NVIDIA GPU: the noise floor against which the mesh's and
`chunk_batch`'s renders are read (chip_smoke.py `parallel_path`).

Prints one JSON object:
  * `ops`: for each op of the UNet at a 576x576 render's shapes (the GEGLU
    projection, a 3x3 conv, GroupNorm, LayerNorm, K1, K2), whether chunk A's
    rows come out bit-equal when computed alone (42 frames) and inside a
    batch with a second chunk B (84 frames), and the max abs difference;
  * `forward`: one UNet forward of chunk A alone against A inside [A; B],
    and against A's 3 view shards (parallel/, 3 ranks on this card);
  * `chunk`: the same three at 4 sampling steps (latents' relative L2, the
    decoded frames' max uint8 step and PSNR);
each with cuBLAS's reduced-precision bf16 reductions allowed (torch's
default) and disallowed.

Run from the repository root: python3 scripts/batch_variance.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from stable_virtual_camera_tpu_torch.config import SevaSpec  # noqa: E402
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec  # noqa: E402
from stable_virtual_camera_tpu_torch.models.io import random_bundle  # noqa: E402
from stable_virtual_camera_tpu_torch.ops.flash_upstream import flash_attention_cuda  # noqa: E402
from stable_virtual_camera_tpu_torch.ops.norms import group_norm_nhwc, layer_norm_fp32  # noqa: E402
from stable_virtual_camera_tpu_torch.ops.time_attention import time_attention_cuda  # noqa: E402
from stable_virtual_camera_tpu_torch.parallel.comm import run_ranks  # noqa: E402
from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from stable_virtual_camera_tpu_torch.parallel.sharding import (  # noqa: E402
    frames_of,
    make_batched_sampler,
    make_sharded_sampler,
    sample_shard,
    stack_conditioning,
)
from stable_virtual_camera_tpu_torch.sampling.sampler import torch_noise  # noqa: E402

DEV = "cuda"
T, H = 21, 72  # frames a chunk, latent side at 576x576


def compare(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.float() - b.float())
    return {"bit_equal": bool(torch.equal(a, b)), "max_abs": d.abs().max().item(),
            "rel_l2": (d.norm() / b.float().norm()).item()}


def op_rows(gen) -> dict:
    """Chunk A's rows alone against A's rows inside [A; B], per op."""
    def r(*s):
        return torch.randn(s, generator=gen, device=DEV).to(torch.bfloat16)

    n = 2 * T
    w_ff, w_conv = r(2560, 320) * 0.05, r(320, 320, 3, 3).to(memory_format=torch.channels_last) * 0.02
    gamma, beta = r(320).float(), r(320).float()
    rows = {}
    x = r(2 * n, H, H, 320)
    rows["linear_320_2560"] = compare(torch.nn.functional.linear(x, w_ff)[:n],
                                      torch.nn.functional.linear(x[:n], w_ff))
    xc = x.permute(0, 3, 1, 2)
    rows["conv3x3_320"] = compare(torch.nn.functional.conv2d(xc, w_conv, padding=1)[:n],
                                  torch.nn.functional.conv2d(xc[:n], w_conv, padding=1))
    rows["group_norm_320"] = compare(group_norm_nhwc(x, gamma, beta, 32, 1e-5)[:n],
                                     group_norm_nhwc(x[:n], gamma, beta, 32, 1e-5))
    xl = x.reshape(2 * n, H * H, 320)
    rows["layer_norm_320"] = compare(layer_norm_fp32(xl, gamma, beta, 1e-5)[:n],
                                     layer_norm_fp32(xl[:n], gamma, beta, 1e-5))
    q, k, v = (r(4, 10, 1701, 64) for _ in range(3))
    rows["k1_1701"] = compare(flash_attention_cuda(q, k, v)[:2], flash_attention_cuda(q[:2], k[:2], v[:2]))
    q, k, v = (r(2 * n, 5, 64, H * H) for _ in range(3))
    rows["k2_5184"] = compare(time_attention_cuda(q, k, v, T)[:n], time_attention_cuda(q[:n], k[:n], v[:n], T))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("batch_variance: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    bundle = random_bundle(SevaSpec(), ClipVisionSpec(), dtype=torch.bfloat16, device=DEV,
                           generator=torch.Generator(DEV).manual_seed(cs.SEED))
    cond_a = cs.seeded_chunk(bundle.spec.context_dim, H)
    cond_b = cs.seeded_chunk(bundle.spec.context_dim, H)
    cond_b.crossattn = cond_b.crossattn.flip(0)  # another chunk: other embeddings and scales
    cond_b.scale = cond_b.scale.flip(0)
    plan = bundle.plan(cs.NUM_STEPS)
    shape = (T, H, H, 4)

    def draws(chunk):
        return lambda step: torch_noise(cs.SEED, 2, chunk, step, shape, DEV)

    mesh = make_mesh(1, 3, devices=[DEV] * 3)
    out = {"device": torch.cuda.get_device_name(0), "steps": cs.NUM_STEPS}
    for reduced in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        key = f"bf16_reduced_reductions_{'on' if reduced else 'off'}"
        res = {"ops": op_rows(torch.Generator(DEV).manual_seed(1))}
        # one forward: the first step's network input of chunk A, alone and beside B
        x_a = torch_noise(cs.SEED, 9, 0, None, (2 * T, H, H, 11), DEV)
        x_b = torch_noise(cs.SEED, 9, 1, None, (2 * T, H, H, 11), DEV)
        t = torch.full((2 * T,), 500, device=DEV)
        stacked = stack_conditioning([cond_a, cond_b])
        with torch.inference_mode():
            alone = bundle.unet(x_a, t, cond_a.crossattn, cond_a.dense, T)
            pair = bundle.unet(torch.cat([x_a[:T], x_b[:T], x_a[T:], x_b[T:]]), torch.cat([t, t]),
                               stacked.crossattn, stacked.dense, T)
            pair_a = torch.cat([pair[:T], pair[2 * T:3 * T]])

        def shard(ctx):
            def mine(a):
                return frames_of(a, ctx.view, 3, 2)

            with torch.inference_mode():
                return bundle.unet(mine(x_a), mine(t), mine(cond_a.crossattn), mine(cond_a.dense), T // 3,
                                   group=ctx.comm)

        parts = run_ranks(mesh, shard)
        views = torch.cat([torch.cat([p[:T // 3] for p in parts]), torch.cat([p[T // 3:] for p in parts])])
        res["forward"] = {"batched": compare(pair_a, alone), "view3": compare(views, alone)}
        # four steps: A alone, A batched with B, A on 3 view ranks
        single = sample_shard(bundle.network, [draws(0)(None)], plan, [cond_a], T, [draws(0)])[0]
        batched = make_batched_sampler(bundle.network, T)(
            [draws(0)(None), draws(1)(None)], plan, [cond_a, cond_b], [draws(0), draws(1)])[0]
        sharded = make_sharded_sampler(bundle.network, mesh, T)(draws(0)(None), plan, cond_a, draws(0))
        f_single = bundle.vae.decode(single, None, uint8=True)
        res["chunk"] = {}
        for name, x in (("batched", batched), ("view3", sharded)):
            f = bundle.vae.decode(x, None, uint8=True)
            res["chunk"][name] = {**compare(x, single),
                                  "frames_max_step": int(np.abs(f.astype(np.int16) - f_single.astype(np.int16)).max()),
                                  "frames_psnr_db": cs.psnr(f, f_single)}
        out[key] = res
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
