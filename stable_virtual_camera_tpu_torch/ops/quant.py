"""W8A8 int8 serving quantization: dynamic and calibrated static.

Counterpart of stable_virtual_camera_tpu/ops/quant.py. The mode is an
explicit argument of the model (`SevaUNet.set_quant`), never an environment
variable or a process-wide switch:
  "0"            exact (the default; the model runs as if this module were
                 not there),
  "w8a8"         dynamic: per-token (per-row) activation scales and
                 per-output-channel weight scales, computed in the forward;
                 convolutions use per-sample activation scales, which stay
                 exact under the conv's spatial summation,
  "w8a8-static"  calibrated: weights prequantized once, activations scaled by
                 a per-tensor abs-max recorded on a calibration trajectory
                 (engine/runner.ensure_quant_calibrated),
  "w8a8-calib"   the calibration pass itself: exact math while each site
                 records its activation abs-max and quantizes its weight.

Numerics follow the JAX package operation for operation, so the CPU tests
hold the outputs to fp32 rounding: symmetric int8 in [-127, 127] with
round-half-to-even, scales clamped at 1e-8 / 127, an exact int32 product,
the dynamic rescale `acc * sx * sw` left to right, the static one
`acc * (sx * ws)`, the bias added in fp32, then the cast.

Layouts are the port's: a Linear weight is (out, in), so its
per-output-channel scales run over rows; a conv weight is OIHW, scaled per
O. The int8 products go through `int8_matmul` (torch._int_mm, cuBLASLt on
the card). PyTorch has no int8 convolution on CUDA, so a conv is an im2col
of the int8 NHWC activation (padding and kh*kw strided slices) times the
(O, kh*kw*I) weight. The JAX package computes these products outside any
Pallas kernel (lax.dot_general / conv_general_dilated with int32
accumulation), so this module ports no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# symmetric int8, zero-point 0; scales are clamped so an all-zero row or
# channel quantizes to zeros instead of NaN
_QMAX = 127.0
_MIN_SCALE = 1e-8

W8A8_MODES = ("w8a8", "w8a8-static", "w8a8-calib")
QUANT_MODES = ("0",) + W8A8_MODES

# torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def serving_mode(quant) -> str:
    """The CLI's and `load_bundle`'s `quant` as a mode: None is "0"; "w8a8",
    "w8a8-static" and "0" pass; anything else raises ValueError with the
    JAX CLI's message."""
    if quant is None:
        return "0"
    if str(quant) not in ("w8a8", "w8a8-static", "0"):
        raise ValueError(f"--quant must be 'w8a8', 'w8a8-static' or '0', got {quant!r}")
    return str(quant)


def check_mode(mode: str) -> str:
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode must be one of {QUANT_MODES}, got {mode!r}")
    return mode


def _quantize(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with abs-max scales reduced over `dims` (kept). The
    fp32 temporaries are reused in place: the same operations, fewer
    full-size buffers alive at once."""
    xf = x.float()
    amax = torch.linalg.vector_norm(xf, ord=float("inf"), dim=dims, keepdim=True)
    s = torch.clamp(amax, min=_MIN_SCALE) / _QMAX
    return _round_to_int8(xf / s), s


def _round_to_int8(t: torch.Tensor) -> torch.Tensor:
    """round-half-to-even, clip to [-127, 127], int8; `t` (fp32) is consumed."""
    return t.round_().clamp_(-_QMAX, _QMAX).to(torch.int8)


def quantize_rowwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-dim) int8: (..., C) -> int8 values, fp32 scales (..., 1).
    Rows are tokens: one outlier token does not wash out the others."""
    return _quantize(x, -1)


def quantize_colwise(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 for an (out, in) Linear weight: int8 values,
    fp32 scales (out, 1)."""
    return _quantize(w, -1)


def quantize_persample(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample int8 for an NHWC activation: scales (B, 1, 1, 1)."""
    return _quantize(x, (1, 2, 3))


def quantize_conv_kernel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 for an OIHW conv weight: scales (O, 1, 1, 1)."""
    return _quantize(w, (1, 2, 3))


def quantize_static(x: torch.Tensor, ax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 with one per-tensor scale from a calibrated abs-max `ax`
    (scalar); values beyond the calibrated range saturate at +-127."""
    s = torch.clamp(ax.float(), min=_MIN_SCALE) / _QMAX
    return _round_to_int8(x.float() / s), s


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 product a @ w.T of int8 a (M, K) and int8 w (N, K).

    `w.t()` is the (K, N) column-major operand cuBLASLt's int8 product
    takes. Zero rows pad M to at least 17 and zeros pad K and N to multiples
    of 8 where needed (torch._int_mm's rule on CUDA), on every device, so a
    CPU run goes through the same padding; the padding adds nothing to the
    sums and is sliced off."""
    M, K = a.shape
    N = w.shape[0]
    k8, n8 = -(-K // _ALIGN) * _ALIGN, -(-N // _ALIGN) * _ALIGN
    a = _pad_to(_pad_to(a, 1, k8), 0, _MIN_ROWS).contiguous()
    w = _pad_to(_pad_to(w, 1, k8), 0, n8).contiguous()
    acc = torch._int_mm(a, w.t())
    return acc[:M, :N]


def im2col_nhwc(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * Ho * Wo, k * k * C): each output pixel's taps,
    tap-major ((ki, kj) row by row) and channel-minor, the order of an
    OIHW weight permuted to (O, kh, kw, I). Works for int8 (F.unfold's
    im2col has no int8 kernel on the CPU). At the UNet's ds1 (42 frames at 72x72, C = 320, k = 3) the
    int8 columns take 627 MB."""
    B, H, W, C = x.shape
    if k == 1 and stride == 1 and pad == 0:
        return x.reshape(B * H * W, C)
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    Ho = (H + 2 * pad - k) // stride + 1
    Wo = (W + 2 * pad - k) // stride + 1
    taps = [
        x[:, ki : ki + stride * (Ho - 1) + 1 : stride, kj : kj + stride * (Wo - 1) + 1 : stride]
        for ki in range(k)
        for kj in range(k)
    ]
    return torch.stack(taps, dim=3).reshape(B * Ho * Wo, k * k * C)


def conv_matrix(wq: torch.Tensor) -> torch.Tensor:
    """An OIHW weight as the (O, kh * kw * I) matrix that `im2col_nhwc`'s
    columns multiply (a view when the weight is channels_last)."""
    return wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)


def _int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """int32 NHWC result of an int8 conv (an im2col product)."""
    B, H, W, _ = xq.shape
    k = wq.shape[-1]
    Ho = (H + 2 * pad - k) // stride + 1
    Wo = (W + 2 * pad - k) // stride + 1
    acc = int8_matmul(im2col_nhwc(xq, k, stride, pad), conv_matrix(wq))
    return acc.reshape(B, Ho, Wo, wq.shape[0])


def _rescale(acc: torch.Tensor, *scales: torch.Tensor) -> torch.Tensor:
    """acc (int32) in fp32 times each scale in turn, in place after the
    conversion (`acc * a * b` as JAX writes it, one fp32 buffer)."""
    y = acc.float()
    for s in scales:
        y.mul_(s)
    return y


def _finish(y: torch.Tensor, bias, out_dtype) -> torch.Tensor:
    if bias is not None:
        y.add_(bias.float())
    return y.to(out_dtype)


def quantized_dense(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, out_dtype=None
) -> torch.Tensor:
    """Dynamic W8A8 x @ weight.T (+ bias): per-token int8 x, per-output-
    channel int8 weight (out, in), exact int32 product, fp32 rescale."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xq, sx = quantize_rowwise(x.reshape(-1, x.shape[-1]))
    wq, sw = quantize_colwise(weight)
    y = _rescale(int8_matmul(xq, wq), sx, sw.reshape(1, -1))
    return _finish(y, bias, out_dtype).reshape(*lead, weight.shape[0])


def quantized_conv(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
    stride: int = 1, padding: int = 1, out_dtype=None,
) -> torch.Tensor:
    """Dynamic W8A8 conv of an NHWC x with an OIHW weight: per-sample int8
    x, per-output-channel int8 weight."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_persample(x)
    wq, sw = quantize_conv_kernel(weight)
    y = _rescale(_int8_conv(xq, wq, stride, padding), sx, sw.reshape(1, 1, 1, -1))
    return _finish(y, bias, out_dtype)


def quantized_dense_static(
    x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, ax: torch.Tensor,
    bias: torch.Tensor | None = None, out_dtype=None,
) -> torch.Tensor:
    """Static W8A8 x @ wq.T (+ bias) with a prequantized (out, in) weight,
    its per-output-channel scales `ws` (out,) and the calibrated abs-max."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xq, sx = quantize_static(x.reshape(-1, x.shape[-1]), ax)
    y = _rescale(int8_matmul(xq, wq), sx * ws.reshape(1, -1))
    return _finish(y, bias, out_dtype).reshape(*lead, wq.shape[0])


def quantized_conv_static(
    x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, ax: torch.Tensor,
    bias: torch.Tensor | None = None, stride: int = 1, padding: int = 1, out_dtype=None,
) -> torch.Tensor:
    """Static W8A8 conv of an NHWC x with a prequantized OIHW weight."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_static(x, ax)
    y = _rescale(_int8_conv(xq, wq, stride, padding), sx * ws.reshape(1, 1, 1, -1))
    return _finish(y, bias, out_dtype)
