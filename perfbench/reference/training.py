"""The fine-tune's objective and optimizer, plain.

Written from the port's documented training contract, which follows the
published Seva training recipe and optax (training/train_step.py,
training/optim.py of the port describe it; nothing here imports them):
epsilon-prediction MSE at one discrete timestep shared by the chunk's
frames, x_sigma = x0 + sigma eps fed as c_in x_sigma with c_in =
1 / sqrt(sigma^2 + 1), the per-frame mean over (h, w, c) averaged over the
frames the loss mask keeps; AdamW as optax.adamw (b1 0.9, b2 0.999, eps
1e-8, decoupled weight decay scaled by the learning rate) under optax's
warmup-cosine schedule from 0.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import sampling

B1, B2, EPS = 0.9, 0.999, 1e-8


def registered_sigmas(s: dict, device) -> torch.Tensor:
    """The 1000 discrete sigmas, ascending, float32."""
    sig = sampling.sigmas(1000, s["beta_linear_start"], s["beta_linear_end"], s["log_snr_shift"])
    return torch.from_numpy(sig[:-1][::-1].copy()).to(device)


def loss(unet, P, batch: dict, t_idx, eps, sigmas: torch.Tensor, T: int, remat: bool = True) -> torch.Tensor:
    """batch: latents (T, h, w, 4), concat (T, h, w, 7), crossattn (T, 1, ctx),
    dense (T, h, w, 6), loss_mask (T,)."""
    x0 = batch["latents"].float()
    sigma = sigmas[t_idx]
    x = (x0 + sigma * eps) * torch.rsqrt(sigma**2 + 1.0)
    net_in = torch.cat([x, batch["concat"].float()], dim=-1)
    t_vec = t_idx.reshape(()).expand(T)
    pred = unet.run(P, net_in, t_vec, batch["crossattn"], batch["dense"], T, remat=remat)
    per_frame = ((pred - eps) ** 2).mean(dim=(1, 2, 3))
    mask = batch["loss_mask"].float()
    return (per_frame * mask).sum() / mask.sum().clamp(min=1.0)


def schedule(count: int, lr: float, warmup: int, decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps) at `count`."""
    if count < warmup:
        return lr * count / warmup
    c = min(count - warmup, decay_steps - warmup)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / (decay_steps - warmup)))


@torch.no_grad()
def adamw(params: list, grads: list, m: list, v: list, count: int, lr: float, weight_decay: float,
          store_dtype: torch.dtype) -> None:
    """One AdamW update in float32, in place; each parameter is then held in
    `store_dtype` (the configuration's parameter dtype) and back."""
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(B1).add_(g, alpha=1 - B1)
        vi.mul_(B2).addcmul_(g, g, value=1 - B2)
        m_hat = mi / (1 - B1 ** (count + 1))
        v_hat = vi / (1 - B2 ** (count + 1))
        p.sub_(lr * (m_hat / (v_hat.sqrt() + EPS) + weight_decay * p))
        p.copy_(p.to(store_dtype).float())
