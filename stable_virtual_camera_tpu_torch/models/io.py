"""Model bundles: random weights at any spec, or weights bridged from JAX.

Counterpart of the `random_bundle` part of stable_virtual_camera_tpu/
models/io.py. Random weights follow flax's defaults as the JAX package uses
them: lecun-normal (truncated) kernels, zero biases, unit norm scales, and
normal(0.02) CLIP class/positional embeddings and projection. Loading the
released safetensors checkpoints is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec, ClipVisionTower
from stable_virtual_camera_tpu_torch.models.unet import Affine, SevaUNet
from stable_virtual_camera_tpu_torch.models.vae import AutoEncoderKL

# flax's lecun_normal draws from a normal truncated at +-2 std and rescales
# by this constant so the truncated distribution keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std^2) truncated to +-2 std, by the inverse CDF (one uniform draw
    per element)."""
    cdf = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Phi(-2)
    w.uniform_(2.0 * cdf - 1.0, 1.0 - 2.0 * cdf, generator=generator)
    w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def init_flax_defaults(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise `module` in place as flax's default initialisers would."""
    for sub in module.modules():
        if isinstance(sub, (nn.Linear, nn.Conv2d)):
            w = sub.weight
            _trunc_normal_(w, math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD, generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, Affine):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        if isinstance(sub, ClipVisionTower):
            for p in (sub.class_embedding, sub.positional_embedding, sub.proj):
                p.normal_(0.0, 0.02, generator=generator)
    return module


def _finish(module: nn.Module, dtype: torch.dtype, device) -> nn.Module:
    # channels_last conv weights let the NHWC activations convolve in place
    return module.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()


def build_models(spec: SevaSpec, clip_spec: ClipVisionSpec, device, dtype,
                 attention: str = "upstream"):
    """Uninitialised (unet, vae, clip) on `device` in `dtype`; `attention` is
    the UNet's self-attention backend (models/unet.py)."""
    if clip_spec.embed_dim != spec.context_dim:
        raise ValueError("CLIP embed_dim must equal the UNet context_dim")
    with torch.device(device):
        unet, vae, clip = SevaUNet(spec, attention), AutoEncoderKL(), ClipVisionTower(clip_spec)
    return tuple(_finish(m, dtype, device) for m in (unet, vae, clip))


def _bundle(spec, unet, vae, clip):
    from stable_virtual_camera_tpu_torch.engine.runner import (
        ClipApplier,
        ModelBundle,
        VaeApplier,
    )

    return ModelBundle(spec=spec, unet=unet, vae=VaeApplier(vae), clip=ClipApplier(clip))


def random_bundle(
    spec: SevaSpec | None = None,
    clip_spec: ClipVisionSpec | None = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    generator: torch.Generator | None = None,
    attention: str = "upstream",
):
    """A ModelBundle with flax-default random weights (tests, smoke runs),
    on the card unless `device` says otherwise. Weights are drawn in fp32 on
    `device` from `generator` (seed 0 on that device when omitted), then
    cast to `dtype`. `attention` is the UNet's self-attention backend; the
    weights do not depend on it."""
    spec = spec or SevaSpec.tiny()
    clip_spec = clip_spec or ClipVisionSpec.tiny()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    models = build_models(spec, clip_spec, device, torch.float32, attention)
    models = [_finish(init_flax_defaults(m, generator), dtype, device) for m in models]
    return _bundle(spec, *models)

