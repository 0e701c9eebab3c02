"""Small shared building blocks of the port's models.

Counterpart of stable_virtual_camera_tpu/models/common.py::QuantSite: the
static-W8A8 state of one quantized call site.
"""

from __future__ import annotations

import torch
from torch import nn

from stable_virtual_camera_tpu_torch.ops.quant import _quantize


class QuantSite(nn.Module):
    """Static-W8A8 state of one call site, in buffers that are not part of
    the state dict (the checkpoint's parameters are the same in every mode):

      wq  int8 prequantized weight, the layer weight's shape (Linear (out,
          in); conv OIHW, laid out channels_last like the conv weights)
      ws  fp32 per-output-channel weight scales, (out,)
      ax  fp32 scalar, the calibrated activation abs-max (a running max)

    `record(weight, act)` is the calibration step: it quantizes the weight
    and raises `ax` to the input's abs-max; the caller then runs the exact
    math. `frozen()` returns (wq, ws, ax) for serving and raises before any
    calibration, as flax's immutable "quant" collection does in JAX.

    The buffers stay fp32 and int8 when the model is cast: `.to(dtype)`
    moves them to the model's device and leaves their dtypes alone.
    """

    def __init__(self, weight_shape, device=None):
        super().__init__()
        shape = tuple(weight_shape)
        wq = torch.zeros(shape, dtype=torch.int8, device=device)
        if len(shape) == 4:
            wq = wq.to(memory_format=torch.channels_last)
        self.register_buffer("wq", wq, persistent=False)
        self.register_buffer("ws", torch.zeros(shape[0], dtype=torch.float32, device=device),
                             persistent=False)
        self.register_buffer("ax", torch.zeros((), dtype=torch.float32, device=device),
                             persistent=False)
        self.ready = False

    def _apply(self, fn, recurse=True):
        device = fn(torch.zeros((), dtype=torch.float32, device=self.ax.device)).device
        for name in ("wq", "ws", "ax"):
            setattr(self, name, getattr(self, name).to(device))
        return self

    @torch.no_grad()
    def record(self, weight: torch.Tensor, act: torch.Tensor) -> None:
        q, s = _quantize(weight.float(), tuple(range(1, weight.dim())))
        self.wq.copy_(q)
        self.ws.copy_(s.reshape(-1))
        self.ax.copy_(torch.maximum(self.ax, act.float().abs().max()))
        self.ready = True

    def frozen(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if not self.ready:
            raise RuntimeError(
                "w8a8-static site served before calibration: run the calibration "
                "(engine/runner.ensure_quant_calibrated) or load a calibrated state first"
            )
        return self.wq, self.ws, self.ax
