"""The sampler's arithmetic, plain: the EDM/DDPM sigma schedule, the
per-step scalars of the churned Euler step, the per-frame CFG scale rules,
and one CFG-combined Euler update from a network output.

Written from the published sampler (Stability-AI/stable-virtual-camera
`seva/sampling.py`: DDPMDiscretization with a sqrt-linear beta schedule and
log-SNR shift, EpsScaling preconditioning, DiscreteDenoiser sigma
quantisation, EulerEDMSampler, MultiviewCFG and MultiviewTemporalCFG).
"""

from __future__ import annotations

import numpy as np
import torch

VANILLA, MULTIVIEW, MULTIVIEW_TEMPORAL = 0, 1, 2


def sigmas(n: int, linear_start: float, linear_end: float, log_snr_shift: float | None,
           num_timesteps: int = 1000) -> np.ndarray:
    """n descending sigmas then 0, float32."""
    betas = np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps, dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    if n < num_timesteps:
        abar = abar[np.linspace(num_timesteps - 1, 0, n, endpoint=False).astype(int)[::-1]]
    s = ((1 - abar) / abar) ** 0.5
    if log_snr_shift is not None:
        s = s * np.exp(log_snr_shift)
    return np.concatenate([s[::-1].astype(np.float32), np.zeros(1, np.float32)])


def step_scalars(num_steps: int, linear_start: float, linear_end: float, log_snr_shift: float | None):
    """Per step: (t_index, c_in, s_quant, s_raw, d_sigma, noise_coeff), as
    float32 numbers (s_churn = 0, so the churn is the 1e-6 on every sigma)."""
    f32 = np.float32
    sig = sigmas(num_steps, linear_start, linear_end, log_snr_shift)
    registered = sigmas(1000, linear_start, linear_end, log_snr_shift)[:-1][::-1]  # ascending
    rows = []
    for i in range(num_steps):
        raw = np.float64(sig[i]) + 1e-6
        s_raw = f32(raw)
        t = int(np.argmin(np.abs(s_raw - registered)))
        s_quant = f32(registered[t])
        noise = f32(np.sqrt(max(raw**2 - np.float64(sig[i]) ** 2, 0.0)))
        rows.append((t, f32(1.0) / np.sqrt(s_quant * s_quant + f32(1.0)), s_quant, s_raw,
                     f32(sig[i + 1]) - s_raw, noise))
    return rows, float(np.sqrt(1.0 + np.float64(sig[0]) ** 2))


def cfg_scale(guider: int, cfg: float, cfg_min: float, input_mask: np.ndarray, close: np.ndarray) -> np.ndarray:
    """(T,) per-frame CFG scale. `close` marks the frames whose camera is an
    input frame's (the published rule: rotation within 10 degrees,
    translation within 1e-5, the same intrinsics); they take cfg_min."""
    T = len(input_mask)
    if guider == VANILLA:
        return np.full(T, cfg, np.float32)
    if guider == MULTIVIEW:
        scales = np.full(T, cfg, np.float64)
    elif guider == MULTIVIEW_TEMPORAL:
        ar = np.arange(T)
        dist = (np.abs(ar[None] - ar[:, None]) + (~input_mask)[None] * T).min(-1)
        scales = dist / max(dist.max(), 1) * (cfg - cfg_min) + cfg_min
    else:
        raise ValueError(f"unknown guider {guider}")
    return np.where(close, cfg_min, scales).astype(np.float32)


def euler_update(out, net_in, T, scalars, scale, dtype=torch.float32) -> torch.Tensor:
    """The CFG-combined Euler update x_next - x' of one step, from the
    network's output `out` (2T, h, w, 4) for the input `net_in` (2T, h, w,
    4 + concat), whose first channels hold c_in * x' (x' = x + churn, the
    input views' latents written into the conditional half), computed in
    `dtype` (float32 as the sampler; bfloat16 for the control)."""
    _t, c_in, s_quant, s_raw, d_sigma, _noise = scalars
    xin = (net_in[..., :4].float() / c_in).to(dtype)
    denoised = out.to(dtype) * -s_quant + xin
    uncond, cond = denoised.chunk(2, dim=0)
    denoised = uncond + scale.to(dtype)[:, None, None, None] * (cond - uncond)
    return (d_sigma * (xin[:T] - denoised) / s_raw).float()
