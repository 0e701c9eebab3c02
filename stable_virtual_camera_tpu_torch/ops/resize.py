"""Resizes with the interpolation semantics the models need.

Counterpart of stable_virtual_camera_tpu/ops/resize.py: the align-corners
bilinear resize of the ResBlock FiLM path as two small matrix contractions,
and the nearest-2x upsample followed by a 3x3 conv (computed directly, which
is the same math as the JAX package's pixel-shuffle form).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, align_corners=True."""
    A = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1 or out_size == 1:
        A[:, 0] = 1.0
        return A
    coords = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    lo = np.clip(np.floor(coords).astype(np.int64), 0, in_size - 2)
    frac = coords - lo
    A[np.arange(out_size), lo] = 1.0 - frac
    A[np.arange(out_size), lo + 1] = frac
    return A


def resize_bilinear_align_corners(
    x: torch.Tensor, out_hw: tuple[int, int]
) -> torch.Tensor:
    """NHWC bilinear resize with align_corners=True, computed in fp32."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    Ah = torch.from_numpy(_align_corners_matrix(h_in, h_out)).to(x.device)
    Aw = torch.from_numpy(_align_corners_matrix(w_in, w_out)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", Ah, x.float())
    y = torch.einsum("ow,bhwc->bhoc", Aw, y)
    return y.to(x.dtype)


def conv_nhwc(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
    stride: int = 1, padding: int = 0,
) -> torch.Tensor:
    """2-D convolution on an NHWC tensor with an OIHW weight. The permutes
    are views: with channels_last weights the conv runs NHWC natively."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def upsample_2x_conv3x3(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Nearest-2x upsample then a 3x3 SAME conv, NHWC in and out."""
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return F.conv2d(up, weight, bias, padding=1).permute(0, 2, 3, 1)
