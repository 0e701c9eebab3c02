"""LPIPS (VGG16 variant): the benchmark protocol's perceptual metric.

Counterpart of stable_virtual_camera_tpu/models/lpips.py, the LPIPS v0.1
graph (Zhang et al. 2018, the `lpips` package's semantics): inputs in
[-1, 1], the ScalingLayer's shift and scale, VGG16 features after the relu
of conv 2, 7, 14, 21 and 28 (relu1_2 ... relu5_3), unit normalization over
channels (eps 1e-10), squared differences, the five 1x1 no-bias heads,
spatial means, summed over the levels. The convs are PyTorch's (cuDNN on
the card): no Pallas kernel of the JAX package is on this path.

  * `LPIPS`: the module; NCHW inputs in [-1, 1], returns (B,).
  * `convert_lpips`: the released layouts (torchvision's `vgg16` state dict,
    `features.{idx}.weight` (O, I, 3, 3) and `.bias`; the lpips package's
    `vgg.pth`, `lin{i}.model.1.weight` (1, C, 1, 1)) -> this module's
    state dict.
  * `synthetic_lpips_params`: random weights with the real topology
    (flax's default initialisers, from a seeded `torch.Generator`).
  * `save_lpips` / `load_lpips`: a state dict through the port's
    safetensors writer and reader (models/io.py), where the JAX package
    writes flax msgpack.
  * `lpips_apply_fn`: a (pred, target) -> float scorer over HWC [0, 1]
    numpy images, on the card unless the caller asks for another device.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16 `features` conv indices and their output channels
_VGG16_CONVS: tuple[tuple[int, int], ...] = (
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512),
    (24, 512), (26, 512), (28, 512),
)
# features are tapped AFTER the relu following these conv indices
_TAP_AFTER: tuple[int, ...] = (2, 7, 14, 21, 28)
# maxpool sits before these conv indices
_POOL_BEFORE: tuple[int, ...] = (5, 10, 17, 24)
_TAP_CHANNELS: tuple[int, ...] = tuple(ch for idx, ch in _VGG16_CONVS if idx in _TAP_AFTER)

# LPIPS ScalingLayer constants (lpips/lpips.py ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16Features(nn.Module):
    """VGG16 `features` trunk returning the 5 LPIPS tap activations."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for idx, ch in _VGG16_CONVS:
            setattr(self, f"conv{idx}", nn.Conv2d(c_in, ch, 3, padding=1))
            c_in = ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for idx, _ in _VGG16_CONVS:
            if idx in _POOL_BEFORE:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(getattr(self, f"conv{idx}")(x))
            if idx in _TAP_AFTER:
                taps.append(x)
        return taps


class LPIPS(nn.Module):
    """lpips(pred, target) for NCHW inputs in [-1, 1]; returns (B,)."""

    def __init__(self, eps: float = 1e-10):
        super().__init__()
        self.eps = eps
        self.vgg = VGG16Features()
        for i, ch in enumerate(_TAP_CHANNELS):
            setattr(self, f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        b = pred.shape[0]
        # one trunk pass over both images (shared weights)
        feats = self.vgg((torch.cat([pred, target], 0) - self.shift) / self.scale)

        def unit_norm(f):
            return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + self.eps)

        total = 0.0
        for i, f in enumerate(feats):
            d = torch.square(unit_norm(f[:b]) - unit_norm(f[b:]))
            total = total + getattr(self, f"lin{i}")(d).mean(dim=(1, 2, 3))
        return total


def convert_lpips(vgg_state_dict: Mapping, lin_state_dict: Mapping,
                  dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Released checkpoints -> the LPIPS module's state dict.

    `vgg_state_dict`: torchvision vgg16 (whole or `features` only),
    `features.{idx}.weight` (O, I, 3, 3) and `.bias`; classifier keys are
    ignored. `lin_state_dict`: the lpips `vgg.pth` layout,
    `lin{i}.model.1.weight` of shape (1, C, 1, 1). Values may be tensors or
    numpy arrays."""

    def t(v):
        return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(dtype)

    out: dict[str, torch.Tensor] = {}
    for idx, ch in _VGG16_CONVS:
        w = t(vgg_state_dict[f"features.{idx}.weight"])
        if w.shape[0] != ch or w.shape[2:] != (3, 3):
            raise ValueError(f"features.{idx}.weight has shape {tuple(w.shape)}, "
                             f"expected ({ch}, C, 3, 3)")
        out[f"vgg.conv{idx}.weight"] = w.contiguous()
        out[f"vgg.conv{idx}.bias"] = t(vgg_state_dict[f"features.{idx}.bias"]).contiguous()
    for i, ch in enumerate(_TAP_CHANNELS):
        w = t(lin_state_dict[f"lin{i}.model.1.weight"])
        if tuple(w.shape) != (1, ch, 1, 1):
            raise ValueError(f"lin{i}.model.1.weight has shape {tuple(w.shape)}, "
                             f"expected (1, {ch}, 1, 1)")
        out[f"lin{i}.weight"] = w.contiguous()
    return out


def synthetic_lpips_params(seed: int = 0) -> dict[str, torch.Tensor]:
    """Random weights with the real topology (flax's default initialisers,
    lecun-normal kernels and zero biases, from a seeded generator)."""
    from stable_virtual_camera_tpu_torch.models.io import init_flax_defaults

    module = init_flax_defaults(LPIPS(), torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def save_lpips(params: Mapping[str, torch.Tensor], path: str) -> None:
    from stable_virtual_camera_tpu_torch.models.io import write_safetensors

    write_safetensors(params, path)


def load_lpips(path: str) -> dict[str, torch.Tensor]:
    from stable_virtual_camera_tpu_torch.models.io import read_safetensors

    params = read_safetensors(path)
    LPIPS().load_state_dict(params, strict=True)  # the full set of keys and shapes
    return params


def lpips_apply_fn(params: Mapping[str, torch.Tensor], device="cuda"):
    """(pred, target) -> float scorer over HWC [0, 1] numpy images (the
    benchmark/metrics.py contract), the module on `device` in fp32."""
    module = LPIPS()
    module.load_state_dict(params, strict=True)
    module = module.to(device).eval()

    def to_input(img: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(img, np.float32)))
        return (x.permute(2, 0, 1)[None] * 2.0 - 1.0).to(device)

    def compute(pred: np.ndarray, target: np.ndarray) -> float:
        with torch.inference_mode():
            return float(module(to_input(pred), to_input(target))[0])

    return compute
