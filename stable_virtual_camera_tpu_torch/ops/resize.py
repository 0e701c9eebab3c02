"""Resizes with the interpolation semantics the models need.

Counterpart of stable_virtual_camera_tpu/ops/resize.py: the align-corners
bilinear resize of the ResBlock FiLM path as two small matrix contractions,
and the nearest-2x upsample followed by a 3x3 conv (computed directly, which
is the same math as the JAX package's pixel-shuffle form). Under W8A8 the
UNet's upsample takes JAX's form instead (`rearranged_upsample_weight`, a
low-resolution conv, `pixel_shuffle_2x`), so that its int8 scales are the
rearranged kernel's.
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


# output offset d in {0, 1} of the nearest-2x upsample reads, for kernel tap
# k in {0, 1, 2}, the low-resolution row i + _TAPS[d][k]
_TAPS = ((-1, 0, 0), (0, 0, 1))


def rearranged_upsample_weight(weight: torch.Tensor) -> torch.Tensor:
    """The OIHW 3x3 weight of nearest-2x + conv as the (4 C_out, C_in, 3, 3)
    weight of a low-resolution 3x3 conv whose output channel
    (2 di + dj) * C_out + o is sub-pixel phase (di, dj) of channel o (JAX's
    ops/resize.upsample_2x_conv3x3, summed in its order)."""
    c_out, c_in = weight.shape[:2]
    w2 = torch.zeros((4, c_out, c_in, 3, 3), dtype=weight.dtype, device=weight.device)
    for di in (0, 1):
        for dj in (0, 1):
            o = di * 2 + dj
            for ki in range(3):
                for kj in range(3):
                    w2[o, :, :, _TAPS[di][ki] + 1, _TAPS[dj][kj] + 1] += weight[:, :, ki, kj]
    return w2.reshape(4 * c_out, c_in, 3, 3)


def pixel_shuffle_2x(y: torch.Tensor) -> torch.Tensor:
    """(b, h, w, 4 C) with phase-major channels -> (b, 2h, 2w, C), NHWC."""
    b, h, w, c4 = y.shape
    c = c4 // 4
    return y.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)
