"""LayerNorm and GroupNorm with fp32 statistics, returning the input dtype.

Counterpart of stable_virtual_camera_tpu/ops/norms.py: the same single-pass
E[x^2] - E[x]^2 statistics in fp32 (the GroupNorm32 numerics contract), on
NHWC / (..., C) tensors.
"""

from __future__ import annotations

import torch


def layer_norm_fp32(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis with single-pass fp32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    msq = (xf * xf).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(torch.clamp(msq - mean * mean, min=0.0) + eps)
    y = (xf - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype)


def group_norm_nhwc(
    x: torch.Tensor,  # (B, H, W, C) or (B, L, C)
    gamma: torch.Tensor,
    beta: torch.Tensor,
    groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over (spatial, C // groups) with fp32 statistics."""
    shape = x.shape
    B, C = shape[0], shape[-1]
    xf = x.float().reshape(B, -1, C)
    n = xf.shape[1] * (C // groups)
    s1 = xf.sum(dim=1)
    s2 = (xf * xf).sum(dim=1)
    g1 = s1.reshape(B, groups, C // groups).sum(-1)
    g2 = s2.reshape(B, groups, C // groups).sum(-1)
    mean = g1 / n
    var = g2 / n - mean * mean
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    gamma_f = gamma.float()
    a = torch.repeat_interleave(rstd, C // groups, dim=-1) * gamma_f
    b = beta.float() - torch.repeat_interleave(mean * rstd, C // groups, dim=-1) * gamma_f
    y = xf * a[:, None, :] + b[:, None, :]
    return y.reshape(shape).to(x.dtype)
