"""LayerNorm with one-pass fp32 statistics: kernel K5 and its plain twin.

Counterpart of benchmark/ln_probe.py::ln_pallas, the JAX package's fused
LayerNorm probe at the UNet's main LayerNorm shape (42 * 5184 rows of 320).
`ln_reduce` is the probe's `ln_reduce`, the same function as
ops/norms.py::layer_norm_fp32: mean and E[x^2] in fp32, var = max(E[x^2] -
mean^2, 0), (x - mean) * rsqrt(var + eps) * gamma + beta, cast back to x's
dtype. `ln_fused` runs it for CPU tensors and launches the hand-written
kernel in csrc/layer_norm.cu for CUDA tensors (or raises).

No model of the port calls K5, as no model of the JAX package calls the
probe: whether the UNet's `layer_norm_fp32` should go through it is a later
decision, to be made from a profile.
"""

from __future__ import annotations

import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops.norms import layer_norm_fp32 as ln_reduce

MAX_WIDTH = 2048
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

__all__ = ["MAX_WIDTH", "ln_fused", "ln_fused_cuda", "ln_reduce"]


def ln_fused_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Launch K5. x: (..., C) contiguous bf16 or fp32 with C even and at
    most MAX_WIDTH; gamma and beta: (C,) of x's dtype. Returns a new tensor
    of x's shape and dtype."""
    C = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer norm takes bfloat16 or float32, got {x.dtype}")
    if C % 2 or not 2 <= C <= MAX_WIDTH:
        raise ValueError(f"layer norm takes an even width of at most {MAX_WIDTH}, got {C}")
    if not x.is_contiguous():
        raise ValueError(f"layer norm needs a contiguous input, got strides {x.stride()}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (C,) or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"layer norm: {name} must be a contiguous ({C},) {x.dtype} tensor, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError("layer norm: x, gamma and beta must be on one device")
    pair = 2 * x.element_size()
    if any(t.data_ptr() % pair for t in (x, gamma, beta)):
        raise ValueError("layer norm needs element pairs aligned in memory")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.LAYER_NORM.launch(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            x.numel() // C, C, _DTYPES[x.dtype], eps, stream,
        )
    return y


def ln_fused(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with one-pass fp32 statistics: the plain
    version for CPU tensors, kernel K5 for CUDA tensors (or an error)."""
    if x.device.type == "cpu":
        return ln_reduce(x, gamma, beta, eps)
    if x.device.type == "cuda":
        return ln_fused_cuda(x, gamma, beta, eps)
    raise RuntimeError(f"layer norm has no kernel for device {x.device}")
