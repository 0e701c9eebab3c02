"""Euler-EDM sampling as a Python loop over a precomputed sigma schedule.

Counterpart of stable_virtual_camera_tpu/sampling/sampler.py
(`SamplingPlan`, `make_sampling_plan`, `ChunkConditioning`, `euler_edm_step`,
`euler_edm_sample`, `euler_edm_capture`). The schedule is the same host-side numpy plan; each step
is one CFG-doubled UNet forward. Where the JAX sampler runs one jitted scan
with `io_callback` ticks, this loop calls `progress_cb(step, total)` and polls
`abort_event` after every step.

`euler_edm_step` is a function of tensors only: the step's scalars come in
as one fp32 host tensor (`step_scalars`, computed with the float32 numpy
arithmetic of JAX's step) and the timestep index as a 0-d tensor on the
device, so the same step serves the live loop and the exported program of
models/export.py, as JAX's `make_scan_fn` serves both `sample` and export.
The scalars stay on the host: a CUDA op reads a 0-d CPU tensor as a scalar
argument, exactly as it reads a Python float (a division by one is a
multiplication by its reciprocal there), so the step computes what a step
with Python floats computes, bit for bit, on both devices. `run_steps` is
the host loop around any such step: the live network's, or an exported
program's.

Noise is drawn through a `noise_fn(seed, pass_id, chunk_id, step, shape,
device)`: `step=None` is a chunk's initial noise, `step=i` the churn noise of
step i. The churn noise is small but not zero: `make_sampling_plan` adds 1e-6
to every sigma_hat, so noise_coeff = sqrt(2e-6 sigma + 1e-12) (0.013 at the
first of 4 steps). The default `torch_noise` seeds a `torch.Generator` from
(seed, pass, chunk, step); tests replay the JAX package's threefry draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from stable_virtual_camera_tpu_torch.sampling.discretization import (
    DDPMDiscretization,
    sigma_to_idx,
)
from stable_virtual_camera_tpu_torch.utils import profiling

NoiseFn = Callable[..., torch.Tensor]
NetworkFn = Callable[..., torch.Tensor]
# network_fn(x_2T (4ch), concat_2T (7ch), t_vec, crossattn, dense, num_frames)
#   -> (2T, h, w, 4) fp32; the concat channels are appended to the
#   preconditioned latent (models/unet.assemble_network_input)


def torch_noise(seed: int, pass_id: int, chunk_id: int, step: int | None, shape, device) -> torch.Tensor:
    """Standard normal noise from a generator seeded by (seed, pass, chunk,
    step), so every draw is reproducible on its own."""
    mixed = 0
    for v in (seed, pass_id, chunk_id, -1 if step is None else step):
        mixed = (mixed * 1_000_003 + v + 1) % (2**63 - 1)
    g = torch.Generator(device=device).manual_seed(mixed)
    return torch.randn(tuple(shape), generator=g, device=device, dtype=torch.float32)


@dataclass(frozen=True)
class SamplingPlan:
    """Host-precomputed per-step schedule arrays (all shape (n,))."""

    sigma_hat_raw: np.ndarray  # churned sigma used in the Euler update
    sigma_hat_quant: np.ndarray  # quantized sigma used for preconditioning
    t_indices: np.ndarray  # discrete timestep index fed to the network
    sigma_next: np.ndarray  # next sigma in the schedule
    noise_coeff: np.ndarray  # per-step injected-noise std (churn)
    init_scale: float  # sqrt(1 + sigma_0^2) initial noise scaling

    @property
    def num_steps(self) -> int:
        return len(self.t_indices)


def make_sampling_plan(
    discretization: DDPMDiscretization,
    num_steps: int,
    s_churn: float = 0.0,
    s_tmin: float = 0.0,
    s_tmax: float = 999.0,
    s_noise: float = 1.0,
) -> SamplingPlan:
    """Precompute the whole sigma schedule (same numbers as the JAX package)."""
    sigmas = discretization(num_steps)  # descending, with appended 0
    registered = discretization.registered_sigmas()
    n = num_steps

    sigma = sigmas[:n].astype(np.float64)
    gamma = np.where(
        (s_tmin <= sigma) & (sigma <= s_tmax),
        min(s_churn / max(n - 1, 1), 2**0.5 - 1),
        0.0,
    )
    sigma_hat_raw = sigma * (gamma + 1.0) + 1e-6
    t_indices = sigma_to_idx(sigma_hat_raw.astype(np.float32), registered)
    sigma_hat_quant = registered[t_indices]
    noise_coeff = np.sqrt(np.maximum(sigma_hat_raw**2 - sigma**2, 0.0)) * s_noise
    return SamplingPlan(
        sigma_hat_raw=sigma_hat_raw.astype(np.float32),
        sigma_hat_quant=sigma_hat_quant.astype(np.float32),
        t_indices=t_indices.astype(np.int32),
        sigma_next=sigmas[1 : n + 1].astype(np.float32),
        noise_coeff=noise_coeff.astype(np.float32),
        init_scale=float(np.sqrt(1.0 + sigmas[0].astype(np.float64) ** 2)),
    )


@dataclass
class ChunkConditioning:
    """One T-frame chunk's conditioning on the device, CFG-doubled along axis
    0 ([uncond | cond]).

    crossattn: (2T, 1, ctx)   CLIP embedding (zeros in the uncond half)
    concat:    (2T, h, w, 7)  input-mask ++ Plücker (mask zeroed in uncond)
    dense:     (2T, h, w, 6)  Plücker FiLM map (same in both halves)
    replace:   (2T, h, w, 5)  input latents ++ replace mask (zeros in uncond)
    scale:     (T,)           per-frame CFG scale
    """

    crossattn: torch.Tensor
    concat: torch.Tensor
    dense: torch.Tensor
    replace: torch.Tensor
    scale: torch.Tensor


STEP_SCALARS = ("c_in", "neg_s_quant", "s_raw", "d_sigma", "noise_coeff")


def step_scalars(plan: SamplingPlan) -> torch.Tensor:
    """(n, 5) fp32 on the host, one row a step, in the order of
    STEP_SCALARS: c_in = 1/sqrt(s_quant^2 + 1), -s_quant (c_out),
    s_raw, sigma_next - s_raw and the churn noise's coefficient, each
    computed in float32 as the JAX step does."""
    f32 = np.float32
    rows = []
    for i in range(plan.num_steps):
        s_raw, s_quant = f32(plan.sigma_hat_raw[i]), f32(plan.sigma_hat_quant[i])
        c_in = f32(1.0) / np.sqrt(s_quant * s_quant + f32(1.0))
        rows.append([c_in, -s_quant, s_raw, f32(plan.sigma_next[i]) - s_raw, f32(plan.noise_coeff[i])])
    return torch.from_numpy(np.array(rows, np.float32).reshape(plan.num_steps, len(STEP_SCALARS)))


def euler_edm_step(
    network_fn: NetworkFn,
    x: torch.Tensor,
    eps: torch.Tensor,
    scalars: torch.Tensor,
    cond: ChunkConditioning,
    t_index: torch.Tensor,
    num_frames: int,
) -> torch.Tensor:
    """One step of the churned Euler loop, fp32: `scalars` is the step's
    row of `step_scalars` (on the host), `t_index` its 0-d int64 timestep
    index on x's device, `eps` its churn noise."""
    c_in, neg_s_quant, s_raw, d_sigma, noise_coeff = scalars.unbind(0)
    C = x.shape[-1]
    rep_lat, rep_mask = cond.replace[..., :C], cond.replace[..., C:]
    x = x + eps * noise_coeff

    xin = torch.cat([x, x], dim=0)
    # replace conditioning: input-view latents overwrite their slots every call
    xin = xin * (1 - rep_mask) + rep_lat * rep_mask
    t_vec = t_index.expand(2 * num_frames)
    out = network_fn(xin * c_in, cond.concat, t_vec, cond.crossattn, cond.dense, num_frames)
    denoised = out * neg_s_quant + xin  # c_out, c_skip (eps scaling)

    uncond, condit = denoised.chunk(2, dim=0)
    denoised = uncond + cond.scale[:, None, None, None] * (condit - uncond)

    d = (x - denoised) / s_raw
    return x + d_sigma * d


StepFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def run_steps(
    step: StepFn,
    noise: torch.Tensor,
    plan: SamplingPlan,
    step_noise: Callable[[int], torch.Tensor],
    progress_cb=None,
    abort_event=None,
) -> torch.Tensor | None:
    """The host loop: x = noise * init_scale, then `step(x, eps, scalars,
    t_index)` for every step of the plan (a `sample.step` span: the host's
    time in it, its enqueue and any wait on the launch queue), with
    `progress_cb(i + 1, n)` and an `abort_event` poll after each. Returns
    None when aborted."""
    x = noise * float(np.float32(plan.init_scale))
    scalars = step_scalars(plan)
    t_indices = torch.as_tensor(plan.t_indices.astype(np.int64), device=noise.device)
    n = plan.num_steps
    for i in range(n):
        with profiling.span("sample.step"):
            x = step(x, step_noise(i), scalars[i], t_indices[i])
        if progress_cb is not None:
            progress_cb(i + 1, n)
        if abort_event is not None and abort_event.is_set():
            return None
    return x


@torch.inference_mode()
def euler_edm_sample(
    network_fn: NetworkFn,
    noise: torch.Tensor,  # (T, h, w, 4) standard normal
    plan: SamplingPlan,
    cond: ChunkConditioning,
    num_frames: int,
    step_noise: Callable[[int], torch.Tensor],
    progress_cb=None,
    abort_event=None,
) -> torch.Tensor | None:
    """The full denoising loop through `network_fn`. `step_noise(i)` gives
    step i's churn noise. Returns None when `abort_event` is set during the
    loop."""

    def step(x, eps, scalars, t_index):
        return euler_edm_step(network_fn, x, eps, scalars, cond, t_index, num_frames)

    return run_steps(step, noise, plan, step_noise, progress_cb, abort_event)


@torch.inference_mode()
def euler_edm_capture(
    network_fn: NetworkFn,
    noise: torch.Tensor,
    plan: SamplingPlan,
    cond: ChunkConditioning,
    num_frames: int,
    step_noise: Callable[[int], torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """`euler_edm_sample` that also stacks every step's network inputs:
    returns (net_x (n, 2T, h, w, 4), t_vecs (n, 2T)). The static-W8A8
    calibration (engine/runner.ensure_quant_calibrated) feeds them to the
    UNet to observe the activations the serving loop will see."""
    xs, ts = [], []

    def recording(x, concat, t_vec, crossattn, dense, T):
        xs.append(x)
        ts.append(t_vec)
        return network_fn(x, concat, t_vec, crossattn, dense, T)

    euler_edm_sample(recording, noise, plan, cond, num_frames, step_noise)
    return torch.stack(xs), torch.stack(ts)
