"""The Basic render of the port's GUI, headless: one seeded image, a preset
orbit of targets, the anchors' first pass and the second pass over every
target, through `apps/renderer.HeadlessRenderer` and the engine.

Traffic parameters (traffic/<name>.json):
  step_metric     the end-to-end metric the window's time a step is reported as
  pass            1: requests back to back, each a new seeded image from
                  `prepare` through the first pass to the anchors' frames;
                  2: set-up renders one image's first pass, and the window
                  drives its second pass
  image_hw        the seeded input image's (H, W); `shorter` the side the
                  preprocess resizes to
  preset, num_targets    the trajectory
  trace_steps     [a, b]: the traced sub-window holds steps a+1..b of the
                  window
  capture_step    the first step of the window's first chunk whose network
                  call may be compared (the compared step is drawn from the
                  seed between it and the chunk's second-to-last step)
  decode_frames   frames of the window's first decoded chunk compared

The window ends at the first step that completes after `--seconds`: the
driver sets the engine's `abort_event`, the engine stops after that step,
and the window closes at the synchronize that follows.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.counts import unet as counts
from perfbench.reference import sampling as ref_sampling
from perfbench.reference.precision import Precision, strict_fp32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_bundle(config: dict, state: dict, device):
    """The port's ModelBundle with the benchmark's weights."""
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.engine.runner import ClipApplier, ModelBundle, VaeApplier
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec, ClipVisionTower
    from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
    from stable_virtual_camera_tpu_torch.models.vae import AutoEncoderKL

    spec = SevaSpec(**{k: tuple(v) if isinstance(v, list) else v for k, v in config["unet"].items()})
    clip_spec = ClipVisionSpec(**config["clip"])
    dtype = DTYPES[config["dtype"]]
    with torch.device("meta"):
        models = (SevaUNet(spec, config["attention"]), AutoEncoderKL(), ClipVisionTower(clip_spec))
    for module, key in zip(models, ("unet", "vae", "clip")):
        module.load_state_dict(state[key], strict=True, assign=True)
    unet, vae, clip = (m.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval() for m in models)
    return ModelBundle(spec=spec, unet=unet, vae=VaeApplier(vae), clip=ClipApplier(clip))


class Noise:
    """The sampler's noise, drawn by the benchmark: one generator on the
    device per (seed, pass, chunk, step). While `draws` is a list, each
    draw's key is appended to it."""

    def __init__(self):
        self.draws = None

    def key(self, seed, pass_id, chunk_id, step):
        return (int(seed), int(pass_id), int(chunk_id), -1 if step is None else int(step))

    def draw(self, key, shape, device) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(harness.derive_seed(*key))
        return torch.randn(tuple(shape), generator=g, device=device, dtype=torch.float32)

    def __call__(self, seed, pass_id, chunk_id, step, shape, device):
        key = self.key(seed, pass_id, chunk_id, step)
        if self.draws is not None:
            self.draws.append(key)
        return self.draw(key, shape, device)


def seeded_image(seed: int, r: int, hw) -> np.ndarray:
    rng = np.random.default_rng(harness.derive_seed(seed, "image", r))
    return rng.integers(0, 256, (*hw, 3), dtype=np.uint8)


class Capture:
    """Hooks on the port's modules that keep what the window produced for
    the comparison: the inputs of the UNet's calls `step` and `step + 1` of
    the window's first chunk and the output of call `step`; the first
    `frames` frames that the VAE decodes in the window (the decoder's input
    and output)."""

    def __init__(self, bundle, step: int, frames: int):
        self.step, self.frames = step, frames
        self.armed = False
        self.calls = 0
        self.unet_in, self.unet_out = {}, None
        self.dec_in, self.dec_out = [], []
        vae = bundle.vae.module
        self.handles = [
            bundle.unet.register_forward_pre_hook(self._unet_in, with_kwargs=True),
            bundle.unet.register_forward_hook(self._unet_out),
            vae.post_quant_conv.register_forward_pre_hook(self._dec_in),
            vae.decoder.register_forward_hook(self._dec_out),
        ]

    def _unet_in(self, _module, args, _kwargs):
        if self.armed and self.calls in (self.step, self.step + 1):
            self.unet_in[self.calls] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args[:5])

    def _unet_out(self, _module, _args, out):
        if self.armed:
            if self.calls == self.step:
                self.unet_out = out.detach().clone()
            self.calls += 1

    def _decoding(self) -> bool:
        return self.armed and sum(x.shape[0] for x in self.dec_out) < self.frames

    def _dec_in(self, _module, args):
        if self._decoding():
            self.dec_in.append(args[0].detach().clone())

    def _dec_out(self, _module, _args, out):
        if self._decoding():
            self.dec_out.append(out.detach().clone())

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


class Render:
    """The port's bundle with the benchmark's weights, behind the headless
    renderer with the benchmark's noise."""

    def __init__(self, ctx: harness.Context):
        from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer, preprocess_basic

        self.ctx, self.cfg, self.tr = ctx, ctx.cell.config, ctx.cell.traffic
        self.preprocess = preprocess_basic
        state = weights.make_all(self.cfg, harness.derive_seed(ctx.seed, "weights"), DTYPES[self.cfg["dtype"]],
                                 ctx.device)
        self.bundle = port_bundle(self.cfg, state, ctx.device)
        del state
        self.noise = Noise()
        self.renderer = HeadlessRenderer(self.bundle, work_dir=None, noise_fn=self.noise)
        self.abort = threading.Event()
        # the measured pass's progress callback, set when its window opens
        self.progress = None

    def plan(self, r: int, num_steps: int):
        s = self.cfg["sampler"]
        pre = self.preprocess(seeded_image(self.ctx.seed, r, self.tr["image_hw"]), shorter=self.tr["shorter"])
        return self.renderer.prepare(
            pre, seed=harness.derive_seed(self.ctx.seed, "plan", r), chunk_strategy=s["chunk_strategy"],
            cfg=s["cfg"][0], preset_traj=self.tr["preset"], num_frames=self.tr["num_targets"],
            camera_scale=s["camera_scale"], num_steps=num_steps)

    def render(self, plan):
        """The engine's generator for `plan`; the steps of the pass the cell
        measures go to `self.progress` when it is set."""

        def pbar(i, n):
            if self.progress is not None:
                self.progress(i, n)

        kw = {"first_pass_pbar": pbar} if self.tr["pass"] == 1 else {"second_pass_pbar": pbar}
        return self.renderer.run(plan, abort_event=self.abort, **kw)


def _warm(r: Render) -> None:
    """The cell's shapes at 2 steps: pass 1, one request; pass 2, the first
    pass and the second pass's first chunk with its decode, stopped in the
    second chunk."""
    count = [0]

    def stop_in_second_chunk(i, n):
        count[0] += 1
        if count[0] > n:
            r.abort.set()

    r.progress = stop_in_second_chunk
    gen = r.render(r.plan(0, 2))
    if r.tr["pass"] == 1:
        next(gen)
        gen.close()
    else:
        for _ in gen:
            pass
    r.abort.clear()
    r.progress = None


def run(ctx: harness.Context) -> None:
    """Set-up, the window, then the comparison with the reference."""
    strict_fp32()
    tr, data = ctx.cell.traffic, ctx.run
    num_steps = ctx.cell.config["sampler"]["num_steps"]
    rng = np.random.default_rng(harness.derive_seed(ctx.seed, "capture"))
    step = int(rng.integers(tr["capture_step"], num_steps - 1))
    phases = harness.Phases(ctx.device)
    with phases("weights"):
        r = Render(ctx)
    sub = harness.SubWindow(ctx.trace, *tr["trace_steps"], ctx.device)
    with phases("warm"):
        _warm(r)
        sub.warm()
    if tr["pass"] == 2:
        with phases("first_pass"):
            gen = r.render(r.plan(0, num_steps))
            next(gen)  # the first pass: its anchors condition the second
    phases.report(ctx.t_start)
    capture = Capture(r.bundle, step, tr["decode_frames"])
    r.noise.draws = draws = []
    count = [0]
    setup_done = time.perf_counter()

    with harness.window_memory(ctx.device, data):
        clock = harness.StepClock(ctx.device, ctx.seconds)
        capture.armed = True
        t0 = time.perf_counter()

        def progress(i, n):
            count[0] += 1
            if clock.step(i == n):
                r.abort.set()
            sub.at_step(count[0], "chunk_boundary" if i == n else "step")

        r.progress = progress
        if tr["pass"] == 2:
            for _ in gen:
                pass
        else:
            req = 1
            while not r.abort.is_set():
                gen = r.render(r.plan(req, num_steps))
                next(gen, None)
                gen.close()
                req += 1
        harness.sync(ctx.device)
        data.window_s = time.perf_counter() - t0
        capture.armed = False
        sub.close()
    r.noise.draws = None
    capture.remove()
    data.steps = count[0]
    data.end_to_end["setup_s"] = setup_done - ctx.t_start
    data.end_to_end[tr["step_metric"]] = data.window_s / data.steps
    clock.fill(data)
    sub.reduce(data)
    if torch.device(ctx.device).type == "cuda":
        data.power_limit_w = harness.power_limit()
    spec = ctx.cell.config["unet"]
    x = capture.unet_in[step][0]
    T, h, w = x.shape[0] // 2, x.shape[1], x.shape[2]
    forward = counts.count(spec, 2 * T, T, h, w)
    data.step_flops = forward.flops
    data.step_k1_bound_s = forward.k1_bound_s()
    data.step_k2_bound_s = forward.k2_bound_s()
    del r, gen
    harness.free_memory()
    compare(ctx, capture, draws, step)


def compare(ctx: harness.Context, capture: Capture, draws: list, step: int) -> None:
    """The window's outputs against the reference: the UNet's output at
    call `step` of the window's first chunk (against the reference UNet on
    the same inputs); that step's CFG-combined Euler update, read from the
    inputs of calls `step` and `step + 1`, against the reference's
    arithmetic applied to the program's own network output (the sampler's
    stage, checked apart from the network's: with CFG scales up to 4 the
    update magnifies the network's bf16 rounding); and the first frames the
    window decoded (against the reference decoder on the same latents)."""
    cfg, dev = ctx.cell.config, ctx.device
    s = cfg["sampler"]
    pass_index = ctx.cell.traffic["pass"] - 1
    state = weights.make_all(cfg, harness.derive_seed(ctx.seed, "weights"), DTYPES[cfg["dtype"]], dev)
    unet, vae, _clip = weights.reference_models(cfg, dev)
    for module, key in ((unet, "unet"), (vae, "vae")):
        module.load_state_dict({k: v.float() for k, v in state[key].items()}, strict=True, assign=True)
    del state, _clip
    harness.free_memory()
    rows, _ = ref_sampling.step_scalars(s["num_steps"], s["beta_linear_start"], s["beta_linear_end"],
                                        s["log_snr_shift"])
    x_k, t_k, context, dense, T = capture.unet_in[step]
    x_n = capture.unet_in[step + 1][0]
    chunk = next(k for k in draws if k[3] == -1)
    eps = Noise().draw(chunk[:3] + (step + 1,), (T,) + tuple(x_k.shape[1:3]) + (4,), dev)
    c_in_n, noise_n = rows[step + 1][1], rows[step + 1][5]
    u_prog = (x_n[:T, ..., :4].float() / c_in_n - eps * noise_n) - x_k[:T, ..., :4].float() / rows[step][1]
    cond = x_k[T:].float()
    mask = (cond[:, 0, 0, 4] > 0.5).cpu().numpy()
    pl = cond[..., 5:11].reshape(T, -1)
    # a frame's camera is an input frame's (the rule's rotation, translation
    # and exact-intrinsics test) where its Plücker map is that frame's, bit
    # for bit: the maps are a function of the camera alone, and on these
    # orbits the frames that share an input's position share its rotation
    # too (the first anchor repeats the input's pose, with intrinsics one
    # rounding apart: not close by the rule, and its map differs)
    close = np.array([any(torch.equal(pl[f], pl[g]) for g in np.flatnonzero(mask)) for f in range(T)])
    scale = torch.from_numpy(ref_sampling.cfg_scale(s["guider_types"][pass_index], s["cfg"][pass_index],
                                                    s["cfg_min"], mask, close)).to(dev)
    frames = ctx.cell.traffic["decode_frames"]
    if sum(x.shape[0] for x in capture.dec_out) < frames:
        raise RuntimeError(f"the window decoded fewer than {frames} frames: it needs to be longer")
    z = torch.cat(capture.dec_in)[:frames]
    img = torch.cat(capture.dec_out)[:frames]
    out = capture.unet_out
    with torch.inference_mode():
        ref_out = unet.run(Precision(), x_k, t_k, context, dense, T)
        ref_img = vae.decode_scaled(Precision(), z)
        euler = ref_sampling.euler_update(out, x_k, T, rows[step], scale)
        readings = {"t_index_gap": float((t_k.double() - rows[step][0]).abs().max()),
                    "unet_rel": rel(out, ref_out), "euler_rel": rel(u_prog, euler), "decode_rel": rel(img, ref_img)}
        control = {}
        if ctx.control:
            # the reference in the program's place, one precision down: float8
            # operands for the bf16 network, bfloat16 for the fp32 sampler step
            P = Precision("fp8")
            control = {
                "unet_rel": rel(unet.run(P, x_k, t_k, context, dense, T), ref_out),
                "euler_rel": rel(ref_sampling.euler_update(out, x_k, T, rows[step], scale, torch.bfloat16), euler),
                "decode_rel": rel(vae.decode_scaled(P, z), ref_img)}
    ctx.record(readings, control)
