"""SD2.1 VAE (AutoencoderKL) in PyTorch, NHWC at its public interface.

Counterpart of stable_virtual_camera_tpu/models/vae.py: `encode` returns the
posterior mean scaled by 0.18215, `decode` inverts it, `decode_uint8`
quantises with the host writer's exact op order. GroupNorms keep fp32
statistics (eps 1e-6); downsampling pads (0, 1) asymmetrically.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stable_virtual_camera_tpu_torch.models.unet import Affine, Conv
from stable_virtual_camera_tpu_torch.ops.norms import group_norm_nhwc
from stable_virtual_camera_tpu_torch.ops.resize import conv_nhwc, upsample_2x_conv3x3

SCALE_FACTOR = 0.18215
DOWNSAMPLE = 8
BLOCK_OUT = (128, 256, 512, 512)


class VaeGroupNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.gn = Affine(channels)
        self.eps = eps

    def forward(self, x):
        return group_norm_nhwc(x, self.gn.weight, self.gn.bias, 32, self.eps)


class VaeResnetBlock(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.norm1 = VaeGroupNorm(channels)
        self.conv1 = Conv(channels, out_channels, 3)
        self.norm2 = VaeGroupNorm(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3)
        self.conv_shortcut = (
            Conv(channels, out_channels, 1) if out_channels != channels else None
        )

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VaeAttention(nn.Module):
    """Single-head self-attention over all spatial positions (mid block)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = VaeGroupNorm(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        scores = torch.einsum("bld,bsd->bls", q.float(), k.float())
        probs = torch.softmax(scores * C**-0.5, dim=-1).to(v.dtype)
        o = self.to_out(torch.einsum("bls,bsd->bld", probs, v))
        return x + o.reshape(B, H, W, C)


class VaeDownsample(nn.Module):
    """Stride-2 3x3 conv with (0, 1) padding on each spatial axis."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        x = F.pad(x, (0, 0, 0, 1, 0, 1))  # NHWC: C, then W, then H
        return conv_nhwc(x, self.conv.weight, self.conv.bias, stride=2)


class VaeUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return upsample_2x_conv3x3(x, self.conv.weight, self.conv.bias)


class VaeMidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnet_0 = VaeResnetBlock(channels, channels)
        self.attn = VaeAttention(channels)
        self.resnet_1 = VaeResnetBlock(channels, channels)

    def forward(self, x):
        return self.resnet_1(self.attn(self.resnet_0(x)))


class VaeEncoder(nn.Module):
    def __init__(self, layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        self.layers_per_block = layers_per_block
        self.conv_in = Conv(3, BLOCK_OUT[0], 3)
        ch = BLOCK_OUT[0]
        for i, out in enumerate(BLOCK_OUT):
            for j in range(layers_per_block):
                self.add_module(f"down_{i}_resnet_{j}", VaeResnetBlock(ch, out))
                ch = out
            if i < len(BLOCK_OUT) - 1:
                self.add_module(f"down_{i}_downsample", VaeDownsample(ch))
        self.mid = VaeMidBlock(ch)
        self.conv_norm_out = VaeGroupNorm(ch)
        self.conv_out = Conv(ch, 2 * latent_channels, 3)

    def forward(self, x):
        h = self.conv_in(x)
        for i in range(len(BLOCK_OUT)):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_{i}_resnet_{j}")(h)
            if i < len(BLOCK_OUT) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))  # mean ++ logvar


class VaeDecoder(nn.Module):
    def __init__(self, layers_per_block: int = 3, out_channels: int = 3):
        super().__init__()
        self.layers_per_block = layers_per_block
        rev = tuple(reversed(BLOCK_OUT))
        self.conv_in = Conv(4, rev[0], 3)
        self.mid = VaeMidBlock(rev[0])
        ch = rev[0]
        for i, out in enumerate(rev):
            for j in range(layers_per_block):
                self.add_module(f"up_{i}_resnet_{j}", VaeResnetBlock(ch, out))
                ch = out
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", VaeUpsample(ch))
        self.conv_norm_out = VaeGroupNorm(ch)
        self.conv_out = Conv(ch, out_channels, 3)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for i in range(len(BLOCK_OUT)):
            for j in range(self.layers_per_block):
                h = getattr(self, f"up_{i}_resnet_{j}")(h)
            if i < len(BLOCK_OUT) - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoEncoderKL(nn.Module):
    """encode: (B, H, W, 3) in [-1, 1] -> (B, H/8, W/8, 4) scaled posterior
    mean; decode: the inverse. Computes in the dtype of its parameters."""

    def __init__(self):
        super().__init__()
        self.encoder = VaeEncoder()
        self.decoder = VaeDecoder()
        self.quant_conv = Conv(8, 8, 1)
        self.post_quant_conv = Conv(4, 4, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x):
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        return moments[..., :4].float() * SCALE_FACTOR

    def decode(self, z):
        z = (z / SCALE_FACTOR).to(self.dtype)
        return self.decoder(self.post_quant_conv(z)).float()

    def decode_uint8(self, z):
        """Decode straight to uint8 with the op order of engine/saving.to_uint8:
        (x + 1) / 2, * 255, clip, floor."""
        v = ((self.decode(z) + 1.0) / 2.0) * 255.0
        return torch.floor(torch.clamp(v, 0.0, 255.0)).to(torch.uint8)

    def forward(self, x):
        return self.decode(self.encode(x))
