"""CLIP image tower (OpenCLIP ViT-H/14) in PyTorch, NHWC at its interface.

Counterpart of stable_virtual_camera_tpu/models/clip.py. `preprocess`
resizes [-1, 1] images to 224^2 with the same antialiased Keys-cubic
(a = -0.5) weights as `jax.image.resize(..., "bicubic")`, built here as
explicit matrices (torch's bicubic uses a = -0.75 and no antialiasing).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stable_virtual_camera_tpu_torch.models.unet import Affine
from stable_virtual_camera_tpu_torch.ops.attention import scaled_dot_product_attention
from stable_virtual_camera_tpu_torch.ops.resize import conv_nhwc

# The JAX package's models/ imports jax on import, so the spec and the
# normalisation constants are restated here.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class ClipVisionSpec:
    """ViT-H/14 (laion2b_s32b_b79k) defaults."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    mlp_ratio: float = 4.0
    embed_dim: int = 1024  # output projection dim (the UNet's context_dim)

    @staticmethod
    def tiny() -> "ClipVisionSpec":
        return ClipVisionSpec(
            image_size=28, patch_size=14, width=64, layers=2, heads=4, embed_dim=64
        )


class ClipLayerNorm(nn.Module):
    """LayerNorm (eps 1e-5) computed in fp32, output in the input dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.ln = Affine(channels)

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.ln.weight.float(), self.ln.bias.float(), 1e-5)
        return y.to(x.dtype)


class ClipBlock(nn.Module):
    def __init__(self, spec: ClipVisionSpec):
        super().__init__()
        w = spec.width
        self.heads = spec.heads
        self.ln_1 = ClipLayerNorm(w)
        self.qkv = nn.Linear(w, 3 * w)
        self.out_proj = nn.Linear(w, w)
        self.ln_2 = ClipLayerNorm(w)
        self.c_fc = nn.Linear(w, int(w * spec.mlp_ratio))
        self.c_proj = nn.Linear(int(w * spec.mlp_ratio), w)

    def forward(self, x):
        B, L, W = x.shape
        shp = (B, L, self.heads, W // self.heads)
        q, k, v = self.qkv(self.ln_1(x)).chunk(3, dim=-1)
        o = scaled_dot_product_attention(q.reshape(shp), k.reshape(shp), v.reshape(shp))
        x = x + self.out_proj(o.reshape(B, L, W))
        h = F.gelu(self.c_fc(self.ln_2(x)).float()).to(x.dtype)
        return x + self.c_proj(h)


class ClipVisionTower(nn.Module):
    """Pre-LN ViT with a class token; returns the projected class embedding
    (B, embed_dim) in fp32. Computes in the dtype of its parameters."""

    def __init__(self, spec: ClipVisionSpec):
        super().__init__()
        self.spec = spec
        grid = spec.image_size // spec.patch_size
        w = spec.width
        self.patch_embed = nn.Conv2d(3, w, spec.patch_size, stride=spec.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, w))
        self.ln_pre = ClipLayerNorm(w)
        for i in range(spec.layers):
            self.add_module(f"block_{i}", ClipBlock(spec))
        self.ln_post = ClipLayerNorm(w)
        self.proj = nn.Parameter(torch.zeros(w, spec.embed_dim))  # (in, out)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (B, image_size, image_size, 3), CLIP-normalised."""
        sp = self.spec
        dt = self.proj.dtype
        B = pixels.shape[0]
        h = conv_nhwc(pixels.to(dt), self.patch_embed.weight, None, stride=sp.patch_size)
        h = h.reshape(B, -1, sp.width)
        cls = self.class_embedding.to(dt).expand(B, 1, sp.width)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(dt)[None]
        h = self.ln_pre(h)
        for i in range(sp.layers):
            h = getattr(self, f"block_{i}")(h)
        h = self.ln_post(h[:, 0])
        return h.float() @ self.proj.float()


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (dtype-preserving)."""
    f = x.dtype.type
    x = np.abs(x)
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out)


@functools.lru_cache(maxsize=None)
def bicubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) weights of jax.image.resize's antialiased
    half-pixel Keys-cubic resize along one axis (scale = out / in), computed
    in float32 as jax computes them."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(np.float32))


def preprocess(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[-1, 1] NHWC images -> CLIP-normalised (B, S, S, 3) fp32."""
    _, h, w, _ = images.shape
    Ah = torch.from_numpy(bicubic_resize_matrix(h, image_size)).to(images.device)
    Aw = torch.from_numpy(bicubic_resize_matrix(w, image_size)).to(images.device)
    x = torch.einsum("oh,bhwc->bowc", Ah, images.float())
    x = torch.einsum("ow,bhwc->bhoc", Aw, x)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=images.device)
    std = torch.tensor(CLIP_STD, device=images.device)
    return (x - mean) / std
