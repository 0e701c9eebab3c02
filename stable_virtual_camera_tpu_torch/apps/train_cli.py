"""Fine-tuning command line: scene directory -> fine-tuned UNet checkpoint.

Counterpart of stable_virtual_camera_tpu/apps/train_cli.py: parse a scene
(COLMAP / reconfusion), stream T-frame chunks through the prefetched host
pipeline, and run the epsilon-prediction step (view-sharded with
--mesh_view N: training/train_step.make_sharded_train_step on a (1, N) mesh
of the local CUDA devices, repeated where there are fewer cards, or of the
CPU under --platform cpu) with warmup-cosine LR, optional EMA shadow
weights, gradient accumulation, rematerialisation and periodic
checkpoint/resume. The checkpoint holds the whole state either way, so a
sharded run resumes unsharded and the other way round.

Invocation (the same fire-style flags as the JAX package's CLI, plus
`device` and `mesh_timeout`, the seconds a rank waits at a collective;
`--platform cpu|gpu` picks the device as in apps/cli.py):
  python -m stable_virtual_camera_tpu_torch.apps.train_cli \
      --data_path scenes/rose --random_model True \
      --work_dir work_dirs/ft_rose --num_steps 2000 --lr 1e-5 \
      --ema_decay 0.9999 --num_input_frames 3
Parameter-efficient: --lora_rank 16 [--lora_alpha 16] [--save_merged True]
trains low-rank adapters only (training/lora.py) and can fold them back into
one weight set, written as the converted cache in `<work_dir>/merged`, which
`--checkpoint_dir` of this CLI and of apps/cli.py reads. --checkpoint_dir
loads the converted cache or the released files in bf16
(models/io.load_bundle) and trains at 576x576; --random_model True draws
full-width bf16 weights at 576x576 on the card, or the tiny spec at 64x64 in
fp32 with --device cpu.
"""

from __future__ import annotations

import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from stable_virtual_camera_tpu_torch.data.dataset import Dataset
from stable_virtual_camera_tpu_torch.data.parsers import get_parser
from stable_virtual_camera_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT
from stable_virtual_camera_tpu_torch.training.checkpoint import (
    restore_train_state,
    save_train_state,
)
from stable_virtual_camera_tpu_torch.training.data import SceneChunkSampler, device_prefetch
from stable_virtual_camera_tpu_torch.training.optim import (
    AdamW,
    MultiSteps,
    warmup_cosine_decay_schedule,
)
from stable_virtual_camera_tpu_torch.training.train_step import (
    ema_init,
    make_sharded_train_step,
    make_train_step,
    torch_draw,
)
from stable_virtual_camera_tpu_torch.utils import profiling
from stable_virtual_camera_tpu_torch.utils.seeding import seed_everything


def _detect_parser(data_path: str) -> str:
    if osp.exists(osp.join(data_path, "transforms.json")):
        return "reconfusion"
    if osp.exists(osp.join(data_path, "sparse")):
        return "colmap"
    raise ValueError(
        f"Cannot auto-detect the scene format of {data_path}; pass --parser colmap|reconfusion"
    )


def random_model_bundle(device):
    """Random weights for --random_model: the full-width model in bf16 on a
    CUDA device, the tiny spec in fp32 on the CPU; with the image size
    (W, H) each is trained at."""
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec
    from stable_virtual_camera_tpu_torch.models.io import random_bundle

    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(0)
    if device.type == "cpu":
        return random_bundle(device=device, generator=generator), (64, 64)
    bundle = random_bundle(SevaSpec(), ClipVisionSpec(), dtype=torch.bfloat16, device=device,
                           generator=generator)
    return bundle, (576, 576)


def main(
    data_path: str,
    work_dir: str = "work_dirs/train",
    checkpoint_dir: str | None = None,
    random_model: bool = False,
    parser: str = "auto",
    num_steps: int = 1000,
    num_input_frames: int = 3,
    W: int | None = None,
    H: int | None = None,
    lr: float = 1e-5,
    warmup_steps: int = 100,
    weight_decay: float = 1e-2,
    ema_decay: float | None = None,
    grad_accum: int = 1,
    remat: bool = False,
    lora_rank: int | None = None,
    lora_alpha: float | None = None,
    lora_pattern: str | None = None,
    save_merged: bool = False,
    ckpt_every: int = 500,
    log_every: int = 10,
    resume: bool = True,
    seed: int = 23,
    prefetch: int = 2,
    encoding_t: int = 0,
    device: str = "cuda",
    mesh_view: int = 1,
    platform: str | None = None,
    mesh_timeout: float = DEFAULT_TIMEOUT,
):
    from stable_virtual_camera_tpu_torch.apps.cli import platform_device

    device = platform_device(platform, device)
    seed_everything(seed)
    mesh = train_mesh(mesh_view, device, mesh_timeout)
    if random_model:
        bundle, (W0, H0) = random_model_bundle(device)
    elif checkpoint_dir:
        from stable_virtual_camera_tpu_torch.models.io import load_bundle

        bundle, (W0, H0) = load_bundle(checkpoint_dir, device=device), (576, 576)
    else:
        raise SystemExit("--checkpoint_dir or --random_model required")
    if parser == "auto":
        parser = _detect_parser(data_path)
    scene_parser = get_parser(parser, data_dir=data_path)
    T = bundle.spec.num_frames
    if mesh is not None and T % mesh_view != 0:
        raise ValueError(f"num_frames {T} must divide --mesh_view {mesh_view}")
    num_input_frames = min(num_input_frames, T - 1)
    split_n = None
    if parser == "reconfusion":
        # train on one of the scene's train/test splits (the split key is its
        # input-view count, e.g. train_test_split_9.json)
        keys = sorted(scene_parser.splits_per_num_input_frames.keys())
        split_n = num_input_frames if num_input_frames in keys else keys[-1]
    dataset = Dataset(scene_parser, split="train", num_input_frames=split_n)
    print(f"[train] scene {data_path} ({parser}): {len(dataset)} train views")
    return train(
        bundle, dataset, work_dir=work_dir, num_steps=num_steps,
        num_input_frames=num_input_frames, image_size=(W or W0, H or H0), lr=lr,
        warmup_steps=warmup_steps, weight_decay=weight_decay, ema_decay=ema_decay,
        grad_accum=grad_accum, remat=remat, lora_rank=lora_rank, lora_alpha=lora_alpha,
        lora_pattern=lora_pattern, save_merged=save_merged, ckpt_every=ckpt_every,
        log_every=log_every, resume=resume, seed=seed, prefetch=prefetch, encoding_t=encoding_t,
        mesh=mesh,
    )


def train_mesh(mesh_view: int, device, timeout: float = DEFAULT_TIMEOUT):
    """The (1, mesh_view) view mesh of --mesh_view, or None for 1: the local
    CUDA devices, repeated where there are fewer, or `device` repeated off
    the card; its collectives wait at most `timeout` seconds."""
    n = int(mesh_view or 1)
    if n < 1:
        raise ValueError(f"--mesh_view must be >= 1, got {mesh_view}")
    if n == 1:
        return None
    from stable_virtual_camera_tpu_torch.parallel.mesh import local_cuda_devices, make_mesh

    dev = torch.device(device)
    pool = local_cuda_devices() if dev.type == "cuda" else [dev]
    return make_mesh(1, n, devices=[pool[i % len(pool)] for i in range(n)], timeout=timeout)


def train(
    bundle,
    dataset: Dataset,
    *,
    work_dir: str,
    num_steps: int,
    num_input_frames: int,
    image_size: tuple[int, int],
    lr: float,
    warmup_steps: int,
    weight_decay: float,
    ema_decay: float | None,
    grad_accum: int,
    remat: bool,
    lora_rank: int | None,
    lora_alpha: float | None,
    lora_pattern: str | None,
    save_merged: bool,
    ckpt_every: int,
    log_every: int,
    resume: bool,
    seed: int,
    prefetch: int,
    encoding_t: int,
    mesh=None,
) -> dict:
    """The fine-tuning loop on a parsed scene, view-sharded on `mesh` (a
    parallel/mesh.Mesh) when given. Returns {"losses", "step_seconds"
    (wall time of each step, loss read back included), "ckpt_path", "lora"
    (the adapters or None), "ema_params"}."""
    os.makedirs(work_dir, exist_ok=True)
    unet = bundle.unet
    dev = bundle.device
    T = bundle.spec.num_frames
    W, H = image_size
    sampler = SceneChunkSampler(dataset, num_frames=T, num_input_frames=num_input_frames,
                                image_size=(W, H))
    print(f"[train] chunks of T={T} with {num_input_frames} inputs at {W}x{H} on {dev}")

    schedule = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, decay_steps=max(num_steps, warmup_steps + 1)
    )
    lora = ema_params = None
    if lora_rank is not None:
        # parameter-efficient path (training/lora.py): only the adapters
        # train; the base weights flow through the step frozen
        if mesh is not None:
            raise ValueError("--lora_rank does not combine with --mesh_view (shard the full fine-tune instead)")
        if ema_decay is not None:
            raise ValueError("--lora_rank does not combine with --ema_decay (adapters converge "
                             "in few steps; EMA targets the full fine-tune)")
        from stable_virtual_camera_tpu_torch.training.lora import (
            DEFAULT_PATTERN,
            init_lora,
            make_lora_train_step,
        )

        lora = init_lora(unet, int(lora_rank), torch.Generator(device=dev).manual_seed(seed + 1),
                         pattern=lora_pattern or DEFAULT_PATTERN)
        trained = [t for ab in lora.values() for t in (ab["a"], ab["b"])]
        n_adapt = sum(t.numel() for t in trained)
        n_base = sum(p.numel() for p in unet.parameters())
        print(f"[train] LoRA rank {lora_rank}: {len(lora)} kernels, {n_adapt:,} trainable "
              f"params ({n_adapt / n_base:.2%} of base)")
    else:
        trained = list(unet.parameters())
    opt = AdamW(trained, schedule, weight_decay=weight_decay)
    if grad_accum > 1:
        opt = MultiSteps(opt, grad_accum)
    if lora is not None:
        lora_step = make_lora_train_step(unet, opt, T, alpha=lora_alpha, remat=remat)

        def step_fn(batch, draw):
            return lora_step(lora, batch, draw)
    else:
        ema_params = ema_init(unet) if ema_decay is not None else None
        if mesh is not None:
            full_step = make_sharded_train_step(unet, opt, T, mesh, remat=remat, ema_decay=ema_decay)
        else:
            full_step = make_train_step(unet, opt, T, remat=remat, ema_decay=ema_decay)

        def step_fn(batch, draw):
            return full_step(batch, draw, ema_params)

    def state() -> dict:
        if lora is not None:
            return lora
        return {n: p.detach() for n, p in unet.named_parameters()}

    start_step = 0
    ckpt_path = osp.join(osp.abspath(work_dir), "state.pt")
    if resume and osp.exists(ckpt_path):
        restored, opt_state, start_step, restored_ema = restore_train_state(ckpt_path)
        with torch.no_grad():
            if lora is not None:  # LoRA checkpoints hold the adapter dict
                for path, ab in lora.items():
                    for key, t in ab.items():
                        t.copy_(restored[path][key])
            else:
                for n, p in unet.named_parameters():
                    p.copy_(restored[n])
            if ema_params is not None and restored_ema is not None:
                for n, e in ema_params.items():
                    e.copy_(restored_ema[n])
        opt.load_state_dict(opt_state)
        print(f"[train] resumed from {ckpt_path} at step {start_step}")

    draw = torch_draw(torch.Generator(device=dev).manual_seed(seed))
    batches = device_prefetch(
        sampler.batches(bundle.vae, bundle.clip, seed=seed + start_step, encoding_t=encoding_t),
        dev, size=prefetch,
    )
    losses, step_seconds = [], []
    t0 = time.perf_counter()
    for i, batch in zip(range(start_step, num_steps), batches):
        ts = time.perf_counter()
        with profiling.request():  # the step's spans share one request id
            losses.append(float(step_fn(batch, draw)))
        step_seconds.append(time.perf_counter() - ts)
        step = i + 1
        if step % log_every == 0 or step == num_steps:
            print(f"[train] step {step}/{num_steps} loss {np.mean(losses[-log_every:]):.5f} "
                  f"({(time.perf_counter() - t0) / len(losses):.2f} s/step)")
        if step % ckpt_every == 0 or step == num_steps:
            save_train_state(ckpt_path, state(), opt.state_dict(), step=step, ema_params=ema_params)
            print(f"[train] checkpoint at step {step}: {ckpt_path}")
    if lora is not None and save_merged:
        # one served weight set: base + adapters folded in, written as the
        # converted cache that load_bundle reads
        from stable_virtual_camera_tpu_torch.models.io import save_converted
        from stable_virtual_camera_tpu_torch.training.lora import merge_lora

        with torch.no_grad():
            unet_sd = {n: p.detach() for n, p in unet.named_parameters()}
            unet_sd.update(merge_lora(unet, lora, lora_alpha))
        merged_dir = osp.join(osp.abspath(work_dir), "merged")
        save_converted({"unet": unet_sd, "vae": bundle.vae.module.state_dict(),
                        "clip": bundle.clip.module.state_dict()}, merged_dir,
                       specs={"seva": bundle.spec, "clip": bundle.clip.module.spec})
        print(f"[train] merged LoRA weights -> {merged_dir}")
    print(f"[train] done: {ckpt_path}")
    return {"losses": losses, "step_seconds": step_seconds, "ckpt_path": ckpt_path,
            "lora": lora, "ema_params": ema_params}


def _parse_argv(argv):
    """fire-style flag parsing: --key value / --key=value, literals eval'd."""
    import ast

    kwargs = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"Unexpected positional arg {arg}")
        if "=" in arg:
            key, val = arg[2:].split("=", 1)
            i += 1
        else:
            key = arg[2:]
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                val = argv[i + 1]
                i += 2
            else:
                val = "True"
                i += 1
        try:
            kwargs[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            kwargs[key] = val
    return kwargs


if __name__ == "__main__":
    main(**_parse_argv(sys.argv[1:]))
