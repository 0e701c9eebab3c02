"""Model bundles: random weights at any spec, or weights bridged from JAX.

Counterpart of the `random_bundle` part of stable_virtual_camera_tpu/
models/io.py. Random weights follow flax's defaults as the JAX package uses
them: lecun-normal (truncated) kernels, zero biases, unit norm scales, and
normal(0.02) CLIP class/positional embeddings and projection. Loading the
released safetensors checkpoints is not ported yet. `load_dust3r_state`
reads the released DUSt3R `.pth` checkpoint into the port's names.
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
        if isinstance(sub, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
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


def attention_backend(attention: str | None, dtype: torch.dtype, device) -> str:
    """The UNet's self-attention backend (models/unet.py) for a model in
    `dtype` on `device`. The kernels have bf16 entries only (JAX's Pallas
    kernels also take fp32: ROADMAP lists the gap), so an fp32 model on the
    card runs "plain", the same routes through each kernel's plain version.
    None picks "plain" there and "upstream" elsewhere; a kernel backend for
    an fp32 model on the card raises."""
    plain_only = torch.device(device).type == "cuda" and dtype != torch.bfloat16
    if attention is None:
        return "plain" if plain_only else "upstream"
    if plain_only and attention != "plain":
        raise ValueError(
            f"attention={attention!r} launches bf16 kernels; a {dtype} model on the card "
            "takes attention='plain' (or None)"
        )
    return attention


def _modules(spec: SevaSpec, clip_spec: ClipVisionSpec, device, attention: str):
    if clip_spec.embed_dim != spec.context_dim:
        raise ValueError("CLIP embed_dim must equal the UNet context_dim")
    with torch.device(device):
        unet, vae, clip = SevaUNet(spec, attention), AutoEncoderKL(), ClipVisionTower(clip_spec)
    return [_finish(m, torch.float32, device) for m in (unet, vae, clip)]


def build_models(spec: SevaSpec, clip_spec: ClipVisionSpec, device, dtype,
                 attention: str | None = None):
    """Uninitialised (unet, vae, clip) on `device` in `dtype`; `attention` is
    the UNet's self-attention backend (`attention_backend`)."""
    models = _modules(spec, clip_spec, device, attention_backend(attention, dtype, device))
    return tuple(_finish(m, dtype, device) for m in models)


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
    attention: str | None = None,
):
    """A ModelBundle with flax-default random weights (tests, smoke runs),
    on the card unless `device` says otherwise. Weights are drawn in fp32 on
    `device` from `generator` (seed 0 on that device when omitted), then
    cast to `dtype`. `attention` is the UNet's self-attention backend
    (`attention_backend`); the weights do not depend on it."""
    spec = spec or SevaSpec.tiny()
    clip_spec = clip_spec or ClipVisionSpec.tiny()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    models = _modules(spec, clip_spec, device, attention_backend(attention, dtype, device))
    models = [_finish(init_flax_defaults(m, generator), dtype, device) for m in models]
    return _bundle(spec, *models)


def load_dust3r_state(weight_path: str, spec=None) -> dict[str, torch.Tensor]:
    """The released DUSt3R checkpoint (`naver/DUSt3R_ViTLarge_BaseDecoder_512_dpt`,
    a torch `.pth`) as the port's `AsymmetricCroCoStereo` state dict, fp32
    on the CPU. A `.safetensors` file raises: its reader is not ported
    (ROADMAP item 2)."""
    import pickle

    from stable_virtual_camera_tpu_torch.models.convert_dust3r import convert_dust3r_state_dict

    if not weight_path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{weight_path}: only torch .pth/.pt DUSt3R checkpoints load here; "
            "safetensors loading waits for ROADMAP item 2"
        )
    try:
        ckpt = torch.load(weight_path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # the released .pth keeps an argparse.Namespace under ckpt["args"],
        # which weights_only refuses
        ckpt = torch.load(weight_path, map_location="cpu", weights_only=False)
    return convert_dust3r_state_dict(ckpt.get("model", ckpt), spec)
