"""The Seva multiview diffusion UNet, plain and in float32.

Written from the published model (Stability-AI/stable-virtual-camera,
`seva/model.py` SevaParams and `seva/modules/`): an SGM UNet whose
attention blocks are multiview transformers (spatial self-attention per
frame, or over all T frames' tokens of a scene at the levels the spec names
"unflatten"), each followed by a temporal block over the T frames of every
position, with a single CLIP token as cross-attention context and the
Plücker map as dense FiLM conditioning of every ResBlock. NHWC tensors; the
parameters carry the names of the port's state dict (the fused q/k/v
projection is `qkv`, rows q, k, v, heads-major). Departures from the
published code, none of which changes the mathematics:
  * cross-attention over one context token is its value projection (the
    softmax over one key is 1), so the query path and `norm2` are unused;
  * GroupNorm and LayerNorm compute in float32, as the published GroupNorm32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from perfbench.reference.precision import Precision, attention


@dataclass(frozen=True)
class UNetSpec:
    in_channels: int = 11
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: tuple = (4, 2, 1)
    channel_mult: tuple = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: tuple = (1, 1, 1, 1)
    context_dim: int = 1024
    dense_in_channels: int = 6
    unflatten_names: tuple = ("middle_ds8", "output_ds4", "output_ds2")

    @staticmethod
    def from_dict(d: dict) -> "UNetSpec":
        known = UNetSpec.__dataclass_fields__
        return UNetSpec(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in known})


class Affine(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))


class GroupNorm(nn.Module):
    def __init__(self, channels: int, eps: float, groups: int = 32):
        super().__init__()
        self.gn = Affine(channels)
        self.eps, self.groups = eps, groups

    def forward(self, x):  # NHWC or (B, L, C)
        xf = x.float().movedim(-1, 1)
        y = F.group_norm(xf, self.groups, self.gn.weight.float(), self.gn.bias.float(), self.eps)
        return y.movedim(1, -1)


class LayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.ln = Affine(channels)
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.ln.weight.float(), self.ln.bias.float(), self.eps)


class Linear(nn.Linear):
    def run(self, P: Precision, x):
        return P.linear(x, self.weight, self.bias)


class Conv(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int | None = None):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2 if padding is None else padding)

    def run(self, P: Precision, x):
        return P.conv(x, self.weight, self.bias, self.stride, self.padding)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def spatial_attention(P, q, k, v):
    """Self-attention over the L tokens of each row: (B, H, L, D), in blocks."""
    return attention(P, q, k, v)


def temporal_attention(P, q, k, v):
    """Self-attention over the T frames of each (scene, position): (b S, H, T, D)."""
    s = P.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5  # T x T a position
    return P.matmul(torch.softmax(s, dim=-1), v)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.qkv = Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = Linear(heads * dim_head, dim)

    def run(self, P, x):
        """Over the L tokens of each row of x (B, L, C)."""
        B, L, _ = x.shape
        q, k, v = self.qkv.run(P, x).view(B, L, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        o = spatial_attention(P, q, k, v)
        return self.to_out.run(P, o.transpose(1, 2).reshape(B, L, -1))

    def run_temporal(self, P, x, T: int):
        """Over the T frames of each scene at every position; x (b*T, S, C)."""
        B, S, _ = x.shape
        b, H, D = B // T, self.heads, self.dim_head
        qkv = self.qkv.run(P, x).view(b, T, S, 3, H, D).permute(3, 0, 2, 4, 1, 5)  # (3, b, S, H, T, D)
        q, k, v = (t.reshape(b * S, H, T, D) for t in qkv)
        o = temporal_attention(P, q, k, v)
        return self.to_out.run(P, o.view(b, S, H, T, D).permute(0, 3, 1, 2, 4).reshape(B, S, H * D))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.to_v = Linear(context_dim, heads * dim_head, bias=False)
        self.to_out = Linear(heads * dim_head, dim)

    def run(self, P, context):
        return self.to_out.run(P, self.to_v.run(P, context))


class FeedForward(nn.Module):
    """GEGLU with the exact (erf) GELU."""

    def __init__(self, dim: int, dim_out: int | None = None, mult: int = 4):
        super().__init__()
        self.proj_gate = Linear(dim, 2 * dim * mult)
        self.proj_out = Linear(dim * mult, dim_out or dim)

    def run(self, P, x):
        val, gate = self.proj_gate.run(P, x).chunk(2, dim=-1)
        return self.proj_out.run(P, val * F.gelu(gate))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = SelfAttention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def run(self, P, x, context):
        x = self.attn1.run(P, self.norm1(x)) + x
        x = self.attn2.run(P, context) + x
        return self.ff.run(P, self.norm3(x)) + x


class TimeMixBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim, dim_out=dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = SelfAttention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def run(self, P, x, time_context, T: int):
        B, S, C = x.shape
        x = self.ff_in.run(P, self.norm_in(x)) + x
        x = self.attn1.run_temporal(P, self.norm1(x), T) + x
        cross = self.attn2.run(P, time_context)  # (b, 1, C)
        x = x + cross.repeat_interleave(T, dim=0)
        return self.ff.run(P, self.norm3(x))  # no residual


class MultiviewTransformer(nn.Module):
    def __init__(self, channels, heads, dim_head, depth, unflatten, context_dim):
        super().__init__()
        inner = heads * dim_head
        self.depth, self.unflatten = depth, unflatten
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = Linear(channels, inner)
        for d in range(depth):
            self.add_module(f"spatial_{d}", TransformerBlock(inner, heads, dim_head, context_dim))
            self.add_module(f"temporal_{d}", TimeMixBlock(inner, heads, dim_head, context_dim))
        self.proj_out = Linear(inner, channels)

    def run(self, P, x, context, T: int):
        B, h, w, C = x.shape
        b = B // T
        time_context = context[::T]
        ctx = time_context if self.unflatten else context
        y = self.proj_in.run(P, self.norm(x).reshape(B, h * w, C))
        inner = y.shape[-1]
        for d in range(self.depth):
            if self.unflatten:
                y = getattr(self, f"spatial_{d}").run(P, y.reshape(b, T * h * w, inner), ctx).reshape(B, h * w, inner)
            else:
                y = getattr(self, f"spatial_{d}").run(P, y, ctx)
            y = y + getattr(self, f"temporal_{d}").run(P, y, time_context, T)
        return x.float() + self.proj_out.run(P, y).reshape(B, h, w, C)


class ResBlock(nn.Module):
    def __init__(self, channels, out_channels, emb_dim, dense_in):
        super().__init__()
        self.in_gn = GroupNorm(channels, eps=1e-5)
        self.dense_proj = Conv(dense_in, 2 * channels, 1)
        self.in_conv = Conv(channels, out_channels, 3)
        self.emb_proj = Linear(emb_dim, out_channels)
        self.out_gn = GroupNorm(out_channels, eps=1e-5)
        self.out_conv = Conv(out_channels, out_channels, 3)
        self.skip = Conv(channels, out_channels, 1) if out_channels != channels else None

    def run(self, P, x, emb, dense):
        h = F.silu(self.in_gn(x))
        hw = (x.shape[1], x.shape[2])
        d = dense.float()
        if tuple(d.shape[1:3]) != hw:
            d = F.interpolate(d.permute(0, 3, 1, 2), size=hw, mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
        scale, shift = self.dense_proj.run(P, d).chunk(2, dim=-1)
        h = self.in_conv.run(P, h * (1 + scale) + shift)
        h = h + self.emb_proj.run(P, F.silu(emb))[:, None, None, :]
        h = self.out_conv.run(P, F.silu(self.out_gn(h)))
        skip = x.float() if self.skip is None else self.skip.run(P, x)
        return skip + h


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2)

    def run(self, P, x):
        return self.conv.run(P, x)


class Upsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv(channels, channels, 3)

    def run(self, P, x):
        up = F.interpolate(x.float().permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)
        return self.conv.run(P, up)


class SevaUNet(nn.Module):
    """run(P, x (B, h, w, in), t (B,), context (B, 1, ctx), dense (B, h, w, 6),
    T) -> (B, h, w, out) float32, B = scenes * T."""

    def __init__(self, spec: UNetSpec):
        super().__init__()
        self.spec = sp = spec
        mc = sp.model_channels
        emb_dim = 4 * mc
        self.time_embed_0 = Linear(mc, emb_dim)
        self.time_embed_2 = Linear(emb_dim, emb_dim)

        def depth(level):
            return sp.transformer_depth[min(level, len(sp.transformer_depth) - 1)]

        def mvt(name, ch, level_name, level):
            self.add_module(name, MultiviewTransformer(ch, ch // sp.num_head_channels, sp.num_head_channels,
                                                       depth(level), level_name in sp.unflatten_names,
                                                       sp.context_dim))

        self.input_blocks_0_0 = Conv(sp.in_channels, mc, 3)
        self.encoder, skip_ch = [], [mc]
        ch, ds, idx = mc, 1, 1
        for level, mult in enumerate(sp.channel_mult):
            for _ in range(sp.num_res_blocks):
                self.add_module(f"input_blocks_{idx}_0", ResBlock(ch, mult * mc, emb_dim, sp.dense_in_channels))
                ch = mult * mc
                attn = None
                if ds in sp.attention_resolutions:
                    attn = f"input_blocks_{idx}_1"
                    mvt(attn, ch, f"input_ds{ds}", level)
                self.encoder.append((f"input_blocks_{idx}_0", attn))
                skip_ch.append(ch)
                idx += 1
            if level != len(sp.channel_mult) - 1:
                self.add_module(f"input_blocks_{idx}_0", Downsample(ch))
                self.encoder.append((f"input_blocks_{idx}_0", None))
                ds *= 2
                skip_ch.append(ch)
                idx += 1
        self.middle_block_0 = ResBlock(ch, ch, emb_dim, sp.dense_in_channels)
        mvt("middle_block_1", ch, f"middle_ds{ds}", len(sp.channel_mult) - 1)
        self.middle_block_2 = ResBlock(ch, ch, emb_dim, sp.dense_in_channels)
        self.decoder, idx = [], 0
        for level, mult in list(enumerate(sp.channel_mult))[::-1]:
            for i in range(sp.num_res_blocks + 1):
                self.add_module(f"output_blocks_{idx}_0",
                                ResBlock(ch + skip_ch.pop(), mult * mc, emb_dim, sp.dense_in_channels))
                ch = mult * mc
                layer, attn, up = 1, None, None
                if ds in sp.attention_resolutions:
                    attn = f"output_blocks_{idx}_{layer}"
                    mvt(attn, ch, f"output_ds{ds}", level)
                    layer += 1
                if level and i == sp.num_res_blocks:
                    up = f"output_blocks_{idx}_{layer}"
                    self.add_module(up, Upsample(ch))
                    ds //= 2
                self.decoder.append((f"output_blocks_{idx}_0", attn, up))
                idx += 1
        self.out_gn = GroupNorm(ch, eps=1e-5)
        self.out_conv = Conv(ch, sp.out_channels, 3)

    def run(self, P: Precision, x, t, context, dense, T: int, remat: bool = False):
        """With `remat`, each ResBlock and multiview transformer keeps only its
        inputs for the backward and recomputes the rest there."""
        context = context.float()

        def call(block, *args):
            if remat and torch.is_grad_enabled():
                return checkpoint(lambda *a: block.run(P, *a), *args, use_reentrant=False)
            return block.run(P, *args)

        emb = self.time_embed_0.run(P, timestep_embedding(t, self.spec.model_channels))
        emb = self.time_embed_2.run(P, F.silu(emb))
        h = self.input_blocks_0_0.run(P, x)
        hs = [h]
        for name, attn in self.encoder:
            block = getattr(self, name)
            h = block.run(P, h) if isinstance(block, Downsample) else call(block, h, emb, dense)
            if attn is not None:
                h = call(getattr(self, attn), h, context, T)
            hs.append(h)
        h = call(self.middle_block_0, h, emb, dense)
        h = call(self.middle_block_1, h, context, T)
        h = call(self.middle_block_2, h, emb, dense)
        for name, attn, up in self.decoder:
            h = call(getattr(self, name), torch.cat([h, hs.pop()], dim=-1), emb, dense)
            if attn is not None:
                h = call(getattr(self, attn), h, context, T)
            if up is not None:
                h = getattr(self, up).run(P, h)
        return self.out_conv.run(P, F.silu(self.out_gn(h)))
