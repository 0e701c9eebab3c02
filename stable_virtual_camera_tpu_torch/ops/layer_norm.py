"""LayerNorm with one-pass fp32 statistics: kernel K5 and its plain twin.

Counterpart of benchmark/ln_probe.py::ln_pallas, the JAX package's fused
LayerNorm probe at the UNet's main LayerNorm shape (42 * 5184 rows of 320).
`ln_reduce` is the probe's `ln_reduce`, the same function as
ops/norms.py::layer_norm_fp32: mean and E[x^2] in fp32, var = max(E[x^2] -
mean^2, 0), (x - mean) * rsqrt(var + eps) * gamma + beta, cast back to x's
dtype. `ln_fused` runs it for CPU tensors and launches the hand-written
kernel in csrc/layer_norm.cu for CUDA tensors (or raises).

The kernel walks tiles of rows through a ring of shared-memory stages filled
by 1-D bulk copies; `_check_ln` checks what it takes and plans the tiles.

No model of the port calls K5, as no model of the JAX package calls the
probe: whether the UNet's `layer_norm_fp32` should go through it is a later
decision, to be made from a profile.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops.norms import layer_norm_fp32 as ln_reduce

MAX_WIDTH = 2048
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# a stage holds the most rows (a multiple of 8, at least 8) that fit in
# STAGE_BYTES, and the ring STAGES of them: at the UNet's widths 320, 640 and
# 1280 in bf16, deeper rings and larger or smaller stages measured slower on
# an H100 (PERF.md, K5 findings)
STAGE_BYTES = 16 * 1024
STAGES = 2
_ALIGN = 16  # a bulk copy's address alignment and size granule

__all__ = ["MAX_WIDTH", "LnPlan", "ln_fused", "ln_fused_cuda", "ln_reduce"]


class LnPlan(NamedTuple):
    """K5's tiles: `rows_per_tile` (R) rows a ring stage, `stages` in the
    ring, `tiles` = ceil(rows / R), and the last tile's `tail_rows` (1 to
    R) and `tail_bytes`, of which the bulk copy takes the largest multiple
    of 16."""

    rows_per_tile: int
    stages: int
    tiles: int
    tail_rows: int
    tail_bytes: int


def _check_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              out: torch.Tensor | None = None) -> LnPlan:
    """Raise on what K5 does not take; else its tile plan for x. Needs no
    card: it reads shapes, dtypes, strides and addresses only."""
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
        if t.data_ptr() % (2 * x.element_size()):
            raise ValueError(f"layer norm needs {name}'s element pairs aligned in memory")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"layer norm: out must be a contiguous {tuple(x.shape)} {x.dtype} tensor "
                         f"on {x.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    for name, t in (("x", x), ("out", out)):
        if t is not None and t.data_ptr() % _ALIGN:
            raise ValueError(f"layer norm needs {name} to start on a {_ALIGN}-byte boundary "
                             f"(a bulk copy's alignment), got address {t.data_ptr():#x}")
    row_bytes = C * x.element_size()
    R = max(8, STAGE_BYTES // row_bytes // 8 * 8)
    rows = x.numel() // C
    tiles = -(-rows // R)
    tail_rows = rows - (tiles - 1) * R if tiles else 0
    return LnPlan(R, STAGES, tiles, tail_rows, tail_rows * row_bytes)


def ln_fused_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5, out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K5. x: (..., C) contiguous bf16 or fp32 with C even and at
    most MAX_WIDTH, starting on a 16-byte boundary; gamma and beta: (C,) of
    x's dtype. Writes into `out` (x's shape and dtype, contiguous, on a
    16-byte boundary) when given, else into a new tensor, and returns it."""
    plan = _check_ln(x, gamma, beta, out)
    y = torch.empty_like(x) if out is None else out
    C = x.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.LAYER_NORM.launch(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            x.numel() // C, C, _DTYPES[x.dtype], eps, plan.rows_per_tile, plan.stages, stream,
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
