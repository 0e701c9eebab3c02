"""The SD2.1 AutoencoderKL and the OpenCLIP ViT-H/14 image tower, plain and
in float32.

Written from the published models (stabilityai/stable-diffusion-2-1-base
`vae/config.json`: block_out_channels (128, 256, 512, 512), two resnets a
down block and three an up block, one single-head attention in the mid
block, GroupNorm 32 groups eps 1e-6, scaling factor 0.18215; OpenCLIP
ViT-H-14: width 1280, 32 layers, 16 heads, patch 14 at 224, pre-LN with a
class token, exact GELU, output projection to 1024), with the port's
parameter names. NHWC tensors. The encoder's downsampling pads (0, 1) on
each spatial axis, as diffusers' Downsample2D does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.precision import Precision, attention
from perfbench.reference.seva import Conv, GroupNorm, LayerNorm, Linear, Upsample

SCALE_FACTOR = 0.18215
BLOCK_OUT = (128, 256, 512, 512)


class ResnetBlock(nn.Module):
    def __init__(self, channels, out_channels):
        super().__init__()
        self.norm1 = GroupNorm(channels, eps=1e-6)
        self.conv1 = Conv(channels, out_channels, 3)
        self.norm2 = GroupNorm(out_channels, eps=1e-6)
        self.conv2 = Conv(out_channels, out_channels, 3)
        self.conv_shortcut = Conv(channels, out_channels, 1) if out_channels != channels else None

    def run(self, P, x):
        h = self.conv1.run(P, F.silu(self.norm1(x)))
        h = self.conv2.run(P, F.silu(self.norm2(h)))
        return (x.float() if self.conv_shortcut is None else self.conv_shortcut.run(P, x)) + h


class MidAttention(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.group_norm = GroupNorm(channels, eps=1e-6)
        self.to_q, self.to_k = Linear(channels, channels), Linear(channels, channels)
        self.to_v, self.to_out = Linear(channels, channels), Linear(channels, channels)

    def run(self, P, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, 1, H * W, C)
        o = attention(P, self.to_q.run(P, h), self.to_k.run(P, h), self.to_v.run(P, h))
        return x.float() + self.to_out.run(P, o.reshape(B, H * W, C)).reshape(B, H, W, C)


class MidBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.resnet_0 = ResnetBlock(channels, channels)
        self.attn = MidAttention(channels)
        self.resnet_1 = ResnetBlock(channels, channels)

    def run(self, P, x):
        return self.resnet_1.run(P, self.attn.run(P, self.resnet_0.run(P, x)))


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=0)

    def run(self, P, x):
        return self.conv.run(P, F.pad(x.float(), (0, 0, 0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, layers_per_block=2, latent_channels=4):
        super().__init__()
        self.layers_per_block = layers_per_block
        self.conv_in = Conv(3, BLOCK_OUT[0], 3)
        ch = BLOCK_OUT[0]
        for i, out in enumerate(BLOCK_OUT):
            for j in range(layers_per_block):
                self.add_module(f"down_{i}_resnet_{j}", ResnetBlock(ch, out))
                ch = out
            if i < len(BLOCK_OUT) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(ch))
        self.mid = MidBlock(ch)
        self.conv_norm_out = GroupNorm(ch, eps=1e-6)
        self.conv_out = Conv(ch, 2 * latent_channels, 3)

    def run(self, P, x):
        h = self.conv_in.run(P, x)
        for i in range(len(BLOCK_OUT)):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_{i}_resnet_{j}").run(P, h)
            if i < len(BLOCK_OUT) - 1:
                h = getattr(self, f"down_{i}_downsample").run(P, h)
        return self.conv_out.run(P, F.silu(self.conv_norm_out(self.mid.run(P, h))))


class Decoder(nn.Module):
    def __init__(self, layers_per_block=3, out_channels=3):
        super().__init__()
        self.layers_per_block = layers_per_block
        rev = tuple(reversed(BLOCK_OUT))
        self.conv_in = Conv(4, rev[0], 3)
        self.mid = MidBlock(rev[0])
        ch = rev[0]
        for i, out in enumerate(rev):
            for j in range(layers_per_block):
                self.add_module(f"up_{i}_resnet_{j}", ResnetBlock(ch, out))
                ch = out
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", Upsample(ch))
        self.conv_norm_out = GroupNorm(ch, eps=1e-6)
        self.conv_out = Conv(ch, out_channels, 3)

    def run(self, P, z):
        h = self.mid.run(P, self.conv_in.run(P, z))
        for i in range(len(BLOCK_OUT)):
            for j in range(self.layers_per_block):
                h = getattr(self, f"up_{i}_resnet_{j}").run(P, h)
            if i < len(BLOCK_OUT) - 1:
                h = getattr(self, f"up_{i}_upsample").run(P, h)
        return self.conv_out.run(P, F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = Decoder()
        self.quant_conv = Conv(8, 8, 1)
        self.post_quant_conv = Conv(4, 4, 1)

    def encode(self, P, x):
        """(N, H, W, 3) in [-1, 1] -> scaled posterior mean, one frame at a time."""
        return torch.cat([self.quant_conv.run(P, self.encoder.run(P, x[i : i + 1]))[..., :4]
                          for i in range(x.shape[0])]) * SCALE_FACTOR

    def decode_scaled(self, P, zs):
        """Latents already divided by the scaling factor -> (N, H, W, 3), one
        frame at a time."""
        return torch.cat([self.decoder.run(P, self.post_quant_conv.run(P, zs[i : i + 1]))
                          for i in range(zs.shape[0])])

    def decode(self, P, z):
        return self.decode_scaled(P, z.float() / SCALE_FACTOR)


@dataclass(frozen=True)
class ClipSpec:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    mlp_ratio: float = 4.0
    embed_dim: int = 1024

    @staticmethod
    def from_dict(d: dict) -> "ClipSpec":
        return ClipSpec(**{k: v for k, v in d.items() if k in ClipSpec.__dataclass_fields__})


class ClipBlock(nn.Module):
    def __init__(self, spec: ClipSpec):
        super().__init__()
        w, hidden = spec.width, int(spec.width * spec.mlp_ratio)
        self.heads = spec.heads
        self.ln_1 = LayerNorm(w)
        self.qkv = Linear(w, 3 * w)
        self.out_proj = Linear(w, w)
        self.ln_2 = LayerNorm(w)
        self.c_fc = Linear(w, hidden)
        self.c_proj = Linear(hidden, w)

    def run(self, P, x):
        B, L, W = x.shape
        q, k, v = self.qkv.run(P, self.ln_1(x)).view(B, L, 3, self.heads, W // self.heads).permute(2, 0, 3, 1, 4)
        x = x + self.out_proj.run(P, attention(P, q, k, v).transpose(1, 2).reshape(B, L, W))
        return x + self.c_proj.run(P, F.gelu(self.c_fc.run(P, self.ln_2(x))))


class ClipVisionTower(nn.Module):
    """run(P, pixels (B, S, S, 3) CLIP-normalised) -> (B, embed_dim)."""

    def __init__(self, spec: ClipSpec):
        super().__init__()
        self.spec = spec
        grid = spec.image_size // spec.patch_size
        self.patch_embed = nn.Conv2d(3, spec.width, spec.patch_size, stride=spec.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(spec.width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, spec.width))
        self.ln_pre = LayerNorm(spec.width)
        for i in range(spec.layers):
            self.add_module(f"block_{i}", ClipBlock(spec))
        self.ln_post = LayerNorm(spec.width)
        self.proj = nn.Parameter(torch.zeros(spec.width, spec.embed_dim))

    def run(self, P, pixels):
        sp = self.spec
        B = pixels.shape[0]
        h = P.conv(pixels, self.patch_embed.weight, None, stride=sp.patch_size).reshape(B, -1, sp.width)
        h = torch.cat([self.class_embedding.float().expand(B, 1, sp.width), h], 1) + self.positional_embedding.float()
        h = self.ln_pre(h)
        for i in range(sp.layers):
            h = getattr(self, f"block_{i}").run(P, h)
        return P.matmul(self.ln_post(h[:, 0]), self.proj)

