"""The full fine-tune of the port's train CLI (`apps/train_cli.train`), driven
piece by piece: `SceneChunkSampler.batches` (VAE encode and CLIP embed of
each chunk's views on the card) through `device_prefetch`, and the step of
`make_train_step(unet, AdamW, T, remat=...)` with the loss read back after
each step, as `train()` does, without its logging and checkpoints (its last
step writes a checkpoint of the weights and AdamW's moments, far more than
a run may write).

Traffic parameters (traffic/<name>.json):
  num_views, image_hw   the seeded orbit scene written in set-up as a
                        reconfusion scene directory under TMPDIR: random
                        images, cameras on a circle looking at its centre
  num_input_frames, prefetch, encoding_t   as the train CLI's flags
  checked_steps         the steps set-up runs, which the reference follows
  trace_steps           [a, b]: the traced sub-window holds window steps a+1..b

The first `checked_steps` steps run in set-up and are compared: each
step's loss, the first step's gradient as AdamW holds it (its first moment
over 1 - b1) and the parameters' change over the steps, leaf by leaf, and
the first batch's VAE latents and CLIP embeddings, against the reference
on the same images, draws and weights.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.counts import unet as counts
from perfbench.drivers.render import DTYPES, port_bundle, rel
from perfbench.reference import training as ref_training
from perfbench.reference.precision import Precision, strict_fp32

# leaves whose reference gradient is under this share of the median leaf's
# are nought to rounding (a parameter the loss does not reach, or barely)
GRAD_FLOOR = 1e-3


def write_scene(root: str, seed: int, n: int, hw) -> None:
    """n seeded random images on a circular orbit around the origin, each
    camera looking at it, as transforms.json (OpenGL cameras) and one
    train/test split keyed by 3 input views."""
    import cv2

    H, W = hw
    rng = np.random.default_rng(harness.derive_seed(seed, "scene"))
    theta = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    frames = []
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i, th in enumerate(theta):
        pos = np.array([2.0 * np.cos(th), -0.3, 2.0 * np.sin(th)])
        z = -pos / np.linalg.norm(pos)  # OpenCV: +z looks at the origin, +y down
        x = np.cross(np.array([0.0, -1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2w[:3, 3] = pos
        c2w[:, [1, 2]] *= -1  # OpenCV -> OpenGL
        name = f"images/frame_{i:03d}.png"
        cv2.imwrite(os.path.join(root, name), rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        frames.append({"file_path": f"./{name}", "transform_matrix": c2w.tolist(), "fl_x": 0.8 * W,
                       "fl_y": 0.8 * W, "cx": W / 2, "cy": H / 2, "w": W, "h": H})
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"frames": frames}, f)
    with open(os.path.join(root, "train_test_split_3.json"), "w") as f:
        json.dump({"train_ids": list(range(n - 4)), "test_ids": list(range(n - 4, n))}, f)


class Draw:
    """The step's (timestep, noise), drawn by the benchmark on the device;
    the first `keep` draws are kept for the reference."""

    def __init__(self, seed: int, device, keep: int):
        self.g = torch.Generator(device=device).manual_seed(harness.derive_seed(seed, "draw"))
        self.device, self.keep, self.kept = device, keep, []

    def __call__(self, shape):
        t = torch.randint(0, 1000, (), generator=self.g, device=self.device)
        eps = torch.randn(shape, generator=self.g, device=self.device)
        if len(self.kept) < self.keep:
            self.kept.append((t, eps))
        return t, eps


class FirstCall:
    """The input and output of a module's first call."""

    def __init__(self, module):
        self.args = self.out = None
        self.armed = True
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, _module, args, out):
        if self.armed and self.out is None:
            self.args, self.out = args[0].detach().clone(), out.detach().clone()
            self.armed = False

    def remove(self):
        self.handle.remove()


def first_gradient_norm(state: dict) -> float:
    """The norm of a leaf's gradient as AdamW got it at its first update:
    the first moment over 1 - b1 (0 where AdamW holds no state for it)."""
    m = state.get("exp_avg")
    return 0.0 if m is None else (m.float() / (1 - ref_training.B1)).norm().item()


def run(ctx: harness.Context) -> None:
    from stable_virtual_camera_tpu_torch.data.dataset import Dataset
    from stable_virtual_camera_tpu_torch.data.parsers import get_parser
    from stable_virtual_camera_tpu_torch.training.data import SceneChunkSampler, device_prefetch
    from stable_virtual_camera_tpu_torch.training.optim import AdamW, warmup_cosine_decay_schedule
    from stable_virtual_camera_tpu_torch.training.train_step import make_train_step

    strict_fp32()
    cfg, tr, data, dev = ctx.cell.config, ctx.cell.traffic, ctx.run, ctx.device
    tc = cfg["training"]
    phases = harness.Phases(dev)
    with phases("weights"):
        state = weights.make_all(cfg, harness.derive_seed(ctx.seed, "weights"), DTYPES[cfg["dtype"]], dev)
        bundle = port_bundle(cfg, state, dev)
        del state
    unet, T = bundle.unet, bundle.spec.num_frames
    scene_dir = tempfile.TemporaryDirectory(prefix="perfbench-scene-")
    with phases("scene"):
        write_scene(scene_dir.name, ctx.seed, tr["num_views"], tr["image_hw"])
        parser = get_parser("reconfusion", data_dir=scene_dir.name)
        dataset = Dataset(parser, split="train", num_input_frames=3)
    H, W = tr["image_hw"]
    sampler = SceneChunkSampler(dataset, num_frames=T, num_input_frames=tr["num_input_frames"], image_size=(W, H))
    schedule = warmup_cosine_decay_schedule(0.0, tc["lr"], tc["warmup_steps"],
                                            decay_steps=max(tc["num_steps"], tc["warmup_steps"] + 1))
    opt = AdamW(list(unet.parameters()), schedule, weight_decay=tc["weight_decay"])
    step = make_train_step(unet, opt, T, remat=tc["remat"])
    draw = Draw(ctx.seed, dev, tr["checked_steps"])
    enc = FirstCall(bundle.vae.module.encoder)
    clip = FirstCall(bundle.clip.module)
    batches = device_prefetch(sampler.batches(bundle.vae, bundle.clip, seed=harness.derive_seed(ctx.seed, "batches"),
                                              encoding_t=tr["encoding_t"]), dev, size=tr["prefetch"])
    checked, losses = [], []
    with phases("checked_steps"):
        for i in range(tr["checked_steps"]):
            batch = next(batches)
            checked.append({k: getattr(batch, k) for k in ("latents", "concat", "crossattn", "dense", "loss_mask")})
            losses.append(float(step(batch, draw)))
            if i == 0:
                grad_norms = {name: first_gradient_norm(opt.opt.state.get(p, {})) for name, p in unet.named_parameters()}
    enc.remove()
    clip.remove()
    # the change of the parameters over the checked steps, leaf by leaf
    g = torch.Generator(device=dev).manual_seed(harness.derive_seed(ctx.seed, "weights"))
    start = weights.make(weights.reference_models(cfg)[0], g, DTYPES[cfg["dtype"]], dev)
    changes = {n: (p.detach().float() - start[n].float()).norm().item() for n, p in unet.named_parameters()}
    del start
    sub = harness.SubWindow(ctx.trace, *tr["trace_steps"], dev)
    sub.warm()
    phases.report(ctx.t_start)
    setup_done = time.perf_counter()

    count, wait = 0, 0.0
    with harness.window_memory(dev, data, "train_peak_mem_gib"):
        deadline = time.perf_counter() + ctx.seconds
        t0 = time.perf_counter()
        while True:
            tw = time.perf_counter()
            batch = next(batches)
            wait += time.perf_counter() - tw
            sub.span("step")
            float(step(batch, draw))
            count += 1
            done = time.perf_counter() >= deadline
            sub.at_step(count, "batch_wait")
            if done:
                break
        harness.sync(dev)
        data.window_s = time.perf_counter() - t0
        sub.close()
    data.steps = count
    data.end_to_end["setup_s"] = setup_done - ctx.t_start
    data.end_to_end["train_step_s"] = data.window_s / count
    data.extra["batch_wait_ms"] = 1e3 * wait / count
    sub.reduce(data)
    if torch.device(dev).type == "cuda":
        data.power_limit_w = harness.power_limit()
    h, w = H // 8, W // 8
    spec = cfg["unet"]
    # forward and backward: three times the forward's FLOPs (remat's
    # recompute, the VAE and CLIP not counted)
    forward = counts.count(spec, T, T, h, w)
    data.step_flops = 3 * forward.flops
    data.extra["k1_bwd_bound_s"] = forward.k1_bwd_bound_s()
    inputs = {"latents": (enc.args, checked[0]["latents"]), "clip": (clip.args, clip.out)}
    del bundle, unet, opt, step, batch, batches, sampler
    harness.free_memory()
    compare(ctx, checked, losses, grad_norms, draw.kept, inputs, changes)
    # last: the prefetch thread may be reading the scene until its queue is full
    scene_dir.cleanup()


def compare(ctx: harness.Context, checked: list, losses: list, grad_norms: dict, draws: list, inputs: dict,
            changes: dict) -> None:
    """The checked steps against the reference: the first batch's latents
    (reference encoder on the images the program encoded) and CLIP
    embeddings (reference tower on the pixels the program embedded); each
    step's loss on the program's batch and draw, the reference's weights
    following its own AdamW; the first step's gradient and the parameters'
    change after those steps, leaf by leaf."""
    cfg, dev, tc = ctx.cell.config, ctx.device, ctx.cell.config["training"]
    T = cfg["unet"]["num_frames"]
    store = DTYPES[cfg["dtype"]]
    state = weights.make_all(cfg, harness.derive_seed(ctx.seed, "weights"), store, dev)
    unet, vae, clip = weights.reference_models(cfg, dev)
    for module, key in ((unet, "unet"), (vae, "vae"), (clip, "clip")):
        module.load_state_dict({k: v.float() for k, v in state[key].items()}, strict=True, assign=True)
    del state
    harness.free_memory()
    names = [n for n, _ in unet.named_parameters()]
    params = [p for _, p in unet.named_parameters()]
    initial = [p.detach().to(store, copy=True) for p in params]
    sigmas = ref_training.registered_sigmas(cfg["sampler"], dev)
    P = Precision()
    images, latents = inputs["latents"]
    pixels, embeds = inputs["clip"]
    with torch.inference_mode():
        ref_latents = vae.encode(P, images)
        ref_embeds = clip.run(P, pixels)
        readings = {"latent_rel": rel(latents, ref_latents), "clip_rel": rel(embeds, ref_embeds)}
        control = {}
        if ctx.control:
            P8 = Precision("fp8")
            control = {"latent_rel": rel(vae.encode(P8, images), ref_latents),
                       "clip_rel": rel(clip.run(P8, pixels), ref_embeds)}
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    ref_losses, ref_norms = [], None
    for i, (batch, (t_idx, eps)) in enumerate(zip(checked, draws)):
        for p in params:
            p.grad = None
        loss = ref_training.loss(unet, P, batch, t_idx, eps, sigmas, T)
        loss.backward()
        ref_losses.append(loss.item())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if i == 0:
            ref_norms = [g.norm().item() for g in grads]
            if ctx.control:
                for p in params:
                    p.grad = None
                l8 = ref_training.loss(unet, Precision("fp8"), batch, t_idx, eps, sigmas, T)
                l8.backward()
                n8 = [(p.grad.norm().item() if p.grad is not None else 0.0) for p in params]
                control["loss_rel"] = abs(l8.item() - ref_losses[0]) / abs(ref_losses[0])
                floor = GRAD_FLOOR * float(np.median(ref_norms))
                control["grad_gap"] = leaf_gap(n8, ref_norms, [r >= floor for r in ref_norms])
        lr = ref_training.schedule(i, tc["lr"], tc["warmup_steps"], max(tc["num_steps"], tc["warmup_steps"] + 1))
        ref_training.adamw(params, grads, m, v, i, lr, tc["weight_decay"], store)
    with torch.no_grad():
        ref_changes = [(p - start.float()).norm().item() for p, start in zip(params, initial)]
    median = float(np.median(ref_norms))
    counted = [r >= GRAD_FLOOR * median for r in ref_norms]
    readings["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    readings["grad_gap"] = leaf_gap([grad_norms[n] for n in names], ref_norms, counted)
    readings["change_gap"] = leaf_gap([changes[n] for n in names], ref_changes, counted)
    ctx.record(readings, control)


def leaf_gap(norms: list, ref_norms: list, counted: list) -> float:
    """The worst counted leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median counted leaf's. Leaves whose reference gradient is under
    GRAD_FLOOR of the median leaf's are not counted: nought to rounding.
    A leaf the program moves where the reference and the median leaf do
    not move reads infinite."""
    ref = [r for r, c in zip(ref_norms, counted) if c]
    median = float(np.median(ref))
    gaps = []
    for p, r, c in zip(norms, ref_norms, counted):
        if c:
            d = max(r, median)
            gaps.append(abs(p - r) / d if d else (0.0 if p == 0 else math.inf))
    return max(gaps)
