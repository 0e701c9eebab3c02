"""DUSt3R two-view stereo network (AsymmetricCroCo3DStereo) in PyTorch, NHWC.

Counterpart of stable_virtual_camera_tpu/models/dust3r.py: for every image
pair it regresses a per-pixel 3D pointmap in the first camera's frame plus
confidences, which core/global_alignment.py fuses into per-image intrinsics,
poses and points.

Architecture (`naver/DUSt3R_ViTLarge_BaseDecoder_512_dpt`, `Dust3rSpec()`):
- a shared ViT-L encoder over both images: 16x16 patch embed -> 24 pre-LN
  blocks, 2D RoPE (base 100) on q/k of every self-attention;
- two entangled 12-block decoders (separate weights per view): each block is
  self-attention -> cross-attention to the OTHER view's previous-layer
  tokens -> MLP;
- two DPT heads (separate weights per view) over hooks [enc_out, dec 1/2,
  dec 3/4, dec last]: reassembly to /4 /8 /16 /32, RefineNet fusion at
  width 256, full-resolution 4-channel output;
- post-processing: pts3d = dir(xyz) * expm1(|xyz|), conf = 1 + exp(c).

Modules are named after the flax parameter tree (`enc_block_{i}`,
`dec_block_{i}`, `dec2_block_{i}`, `head1.refinenet4.rcu2.conv1`, ...), so
models/weights.py carries JAX parameters across, and
models/convert_dust3r.py maps the released checkpoint's keys onto them.
Attention is plain torch math as in JAX (einsums, fp32 softmax, the
probabilities cast back to v's dtype); the JAX package has no kernel here.
LayerNorm (eps 1e-6, one-pass fp32 statistics as flax computes them) and
the exact-erf GELU run in fp32. Any H, W divisible by the patch size work,
with RoPE positions from the true token grid.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from stable_virtual_camera_tpu_torch.models.unet import Affine
from stable_virtual_camera_tpu_torch.ops.norms import layer_norm_fp32
from stable_virtual_camera_tpu_torch.ops.resize import conv_nhwc, resize_bilinear_align_corners


@dataclass(frozen=True)
class Dust3rSpec:
    """DUSt3R_ViTLarge_BaseDecoder_512_dpt defaults."""

    img_size: int = 512  # long-side inference resolution (loader target)
    patch_size: int = 16
    enc_depth: int = 24
    enc_dim: int = 1024
    enc_heads: int = 16
    dec_depth: int = 12
    dec_dim: int = 768
    dec_heads: int = 12
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    dpt_layer_dims: tuple[int, int, int, int] = (96, 192, 384, 768)
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128
    out_channels: int = 4  # xyz + conf

    @property
    def dpt_hooks(self) -> tuple[int, int, int, int]:
        """Indices into [enc_out, dec_1, ..., dec_last] (len dec_depth+1)."""
        d = self.dec_depth
        return (0, d * 2 // 4, d * 3 // 4, d)

    @staticmethod
    def tiny() -> "Dust3rSpec":
        return Dust3rSpec(
            img_size=64, enc_depth=2, enc_dim=32, enc_heads=2, dec_depth=4, dec_dim=24,
            dec_heads=2, dpt_layer_dims=(8, 12, 16, 24), dpt_feature_dim=16, dpt_last_dim=8,
        )


# ---------------------------------------------------------------------------
# 2D rotary position embedding (CroCo RoPE2D)


def _rope_1d(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """1D rotary embedding of the last dim of x (..., N, Dh): Dh/2
    frequencies duplicated (not interleaved), rotate_half = (-x2, x1) over
    the two contiguous halves. pos: (N,) integer coordinates."""
    dh = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = pos.float()[:, None] * inv[None]  # (N, Dh/2)
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)
    x1, x2 = x.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (x * cos + rot * sin).to(x.dtype)


def rope_2d(x: torch.Tensor, pos: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """CroCo RoPE2D: the first half of the head dim rotates with the token's
    y coordinate, the second half with x. x: (B, H, N, D) with D % 4 == 0;
    pos: (N, 2) integer (y, x) grid coordinates."""
    y, xx = x.chunk(2, dim=-1)
    return torch.cat([_rope_1d(y, pos[:, 0], base), _rope_1d(xx, pos[:, 1], base)], dim=-1)


# ---------------------------------------------------------------------------
# Building blocks


class LayerNorm(nn.Module):
    """fp32 LayerNorm island (eps 1e-6), output in the input dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = Affine(dim)

    def forward(self, x):
        return layer_norm_fp32(x, self.ln.weight, self.ln.bias, 1e-6)


class Conv(nn.Conv2d):
    """Conv on NHWC tensors with explicit stride and symmetric padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, padding=padding, bias=bias)

    def forward(self, x):
        return conv_nhwc(x, self.weight, self.bias, self.stride, self.padding)


class ConvTranspose(nn.ConvTranspose2d):
    """Transposed conv with stride equal to its kernel, on NHWC tensors
    (flax `ConvTranspose(transpose_kernel=True)`; weight (in, out, k, k))."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, stride=k)

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=self.stride)
        return y.permute(0, 2, 3, 1)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).transpose(1, 2)


def _merge(o: torch.Tensor) -> torch.Tensor:
    b, h, n, d = o.shape
    return o.transpose(1, 2).reshape(b, n, h * d)


def _sdpa(q, k, v):
    s = torch.einsum("bhnd,bhmd->bhnm", q, k).float() * (q.shape[-1] ** -0.5)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p, v)


class RopeSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, rope_base: float):
        super().__init__()
        self.heads = heads
        self.rope_base = rope_base
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos):
        q, k, v = (_heads(t, self.heads) for t in self.qkv(x).chunk(3, dim=-1))
        q = rope_2d(q, pos, self.rope_base)
        k = rope_2d(k, pos, self.rope_base)
        return self.proj(_merge(_sdpa(q, k, v)))


class RopeCrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, rope_base: float):
        super().__init__()
        self.heads = heads
        self.rope_base = rope_base
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mem, pos_q, pos_k):
        q = rope_2d(_heads(self.projq(x), self.heads), pos_q, self.rope_base)
        k = rope_2d(_heads(self.projk(mem), self.heads), pos_k, self.rope_base)
        v = _heads(self.projv(mem), self.heads)
        return self.proj(_merge(_sdpa(q, k, v)))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        h = F.gelu(self.fc1(x).float()).to(x.dtype)  # exact erf, fp32
        return self.fc2(h)


class EncoderBlock(nn.Module):
    def __init__(self, spec: Dust3rSpec):
        super().__init__()
        d = spec.enc_dim
        self.norm1 = LayerNorm(d)
        self.attn = RopeSelfAttention(d, spec.enc_heads, spec.rope_base)
        self.norm2 = LayerNorm(d)
        self.mlp = Mlp(d, int(d * spec.mlp_ratio))

    def forward(self, x, pos):
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """CroCo decoder block: self-attention, cross-attention to the other
    view's tokens (memory normalized by norm_y), MLP, all residual."""

    def __init__(self, spec: Dust3rSpec):
        super().__init__()
        d = spec.dec_dim
        self.norm1 = LayerNorm(d)
        self.attn = RopeSelfAttention(d, spec.dec_heads, spec.rope_base)
        self.norm_y = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.cross_attn = RopeCrossAttention(d, spec.dec_heads, spec.rope_base)
        self.norm3 = LayerNorm(d)
        self.mlp = Mlp(d, int(d * spec.mlp_ratio))

    def forward(self, x, mem, pos_x, pos_mem):
        x = x + self.attn(self.norm1(x), pos_x)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(mem), pos_x, pos_mem)
        return x + self.mlp(self.norm3(x))


# ---------------------------------------------------------------------------
# DPT regression head


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv(features, features, 3, padding=1)
        self.conv2 = Conv(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionBlock(nn.Module):
    """RefineNet fusion: optional skip through one RCU, the main path through
    another, x2 align-corners upsample, 1x1 out conv. refinenet4 has no skip
    and so no `rcu1`."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.rcu1 = ResidualConvUnit(features)
        self.rcu2 = ResidualConvUnit(features)
        self.out_conv = Conv(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        x = resize_bilinear_align_corners(x, (2 * x.shape[1], 2 * x.shape[2]))
        return self.out_conv(x)


class DptHead(nn.Module):
    """DPT reassembly and fusion over 4 hooked token sets at 1/16
    resolution: reassembly to /4, /8, /16, /32, fusion back up to /2, and a
    last x2 upsample to the input resolution."""

    def __init__(self, spec: Dust3rSpec):
        super().__init__()
        ld, fd = spec.dpt_layer_dims, spec.dpt_feature_dim
        din = (spec.enc_dim, spec.dec_dim, spec.dec_dim, spec.dec_dim)
        self.act1_proj = Conv(din[0], ld[0], 1)
        self.act1_up = ConvTranspose(ld[0], ld[0], 4)
        self.act2_proj = Conv(din[1], ld[1], 1)
        self.act2_up = ConvTranspose(ld[1], ld[1], 2)
        self.act3_proj = Conv(din[2], ld[2], 1)
        self.act4_proj = Conv(din[3], ld[3], 1)
        self.act4_down = Conv(ld[3], ld[3], 3, stride=2, padding=1)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn", Conv(ld[i], fd, 3, padding=1, bias=False))
        self.refinenet4 = FusionBlock(fd, skip=False)
        self.refinenet3 = FusionBlock(fd)
        self.refinenet2 = FusionBlock(fd)
        self.refinenet1 = FusionBlock(fd)
        self.head_conv1 = Conv(fd, fd // 2, 3, padding=1)
        self.head_conv2 = Conv(fd // 2, spec.dpt_last_dim, 3, padding=1)
        self.head_out = Conv(spec.dpt_last_dim, spec.out_channels, 1)

    def forward(self, feats, grid_hw: tuple[int, int]):
        nh, nw = grid_hw
        maps = [f.reshape(f.shape[0], nh, nw, f.shape[-1]) for f in feats]
        l0 = self.act1_up(self.act1_proj(maps[0]))
        l1 = self.act2_up(self.act2_proj(maps[1]))
        l2 = self.act3_proj(maps[2])
        l3 = self.act4_down(self.act4_proj(maps[3]))
        rn = [self.layer1_rn(l0), self.layer2_rn(l1), self.layer3_rn(l2), self.layer4_rn(l3)]
        path4 = self.refinenet4(rn[3])[:, : rn[2].shape[1], : rn[2].shape[2]]
        path3 = self.refinenet3(path4, rn[2])
        path2 = self.refinenet2(path3, rn[1])
        path1 = self.refinenet1(path2, rn[0])
        h = self.head_conv1(path1)
        h = resize_bilinear_align_corners(h, (2 * h.shape[1], 2 * h.shape[2]))
        return self.head_out(F.relu(self.head_conv2(h)))


# ---------------------------------------------------------------------------
# Post-processing


def reg_dense_pts3d(xyz: torch.Tensor) -> torch.Tensor:
    """depth_mode ('exp', -inf, inf): direction * expm1(norm), the norm
    clipped at 80 (expm1(80) ~ 5.5e34 is still finite in fp32) and the
    divisor at 1e-8."""
    d = torch.linalg.norm(xyz.float(), dim=-1, keepdim=True)
    return (xyz / d.clamp(min=1e-8)) * torch.expm1(d.clamp(max=80.0))


def reg_dense_conf(c: torch.Tensor) -> torch.Tensor:
    """conf_mode ('exp', 1, inf): 1 + exp(c), c clipped to +-30."""
    return 1.0 + torch.exp(c.float().clamp(-30.0, 30.0))


# ---------------------------------------------------------------------------
# The two-view model


class AsymmetricCroCoStereo(nn.Module):
    """Two-view pointmap regressor. forward(img1, img2) takes NHWC images in
    [-1, 1] (H, W multiples of patch_size; the two views may differ) and
    returns

        {"pred1": {"pts3d": (B,H1,W1,3), "conf": (B,H1,W1)},
         "pred2": {"pts3d_in_other_view": (B,H2,W2,3), "conf": (B,H2,W2)}}

    with pred2's pointmap in view 1's camera frame."""

    def __init__(self, spec: Dust3rSpec | None = None):
        super().__init__()
        sp = self.spec = spec or Dust3rSpec()
        self.patch_embed = Conv(3, sp.enc_dim, sp.patch_size, stride=sp.patch_size)
        self.enc_blocks = [EncoderBlock(sp) for _ in range(sp.enc_depth)]
        for i, blk in enumerate(self.enc_blocks):
            self.add_module(f"enc_block_{i}", blk)
        self.enc_norm = LayerNorm(sp.enc_dim)
        self.decoder_embed = nn.Linear(sp.enc_dim, sp.dec_dim)
        self.dec_blocks = [DecoderBlock(sp) for _ in range(sp.dec_depth)]
        self.dec_blocks2 = [DecoderBlock(sp) for _ in range(sp.dec_depth)]
        for i, (b1, b2) in enumerate(zip(self.dec_blocks, self.dec_blocks2)):
            self.add_module(f"dec_block_{i}", b1)
            self.add_module(f"dec2_block_{i}", b2)
        self.dec_norm = LayerNorm(sp.dec_dim)
        self.head1 = DptHead(sp)
        self.head2 = DptHead(sp)

    def _encode(self, img: torch.Tensor):
        sp = self.spec
        b, h, w, _ = img.shape
        nh, nw = h // sp.patch_size, w // sp.patch_size
        dtype = self.patch_embed.weight.dtype
        x = self.patch_embed(img.to(dtype)).reshape(b, nh * nw, sp.enc_dim)
        yy, xx = torch.meshgrid(torch.arange(nh, device=img.device),
                                torch.arange(nw, device=img.device), indexing="ij")
        pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)  # (N, 2)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos, (nh, nw)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> dict:
        f1, pos1, hw1 = self._encode(img1)
        f2, pos2, hw2 = self._encode(img2)
        # entangled decoders: both streams read the other view's previous-layer tokens
        outs1, outs2 = [f1], [f2]
        d1, d2 = self.decoder_embed(f1), self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            d1, d2 = blk1(d1, d2, pos1, pos2), blk2(d2, d1, pos2, pos1)
            outs1.append(d1)
            outs2.append(d2)
        outs1[-1] = self.dec_norm(outs1[-1])
        outs2[-1] = self.dec_norm(outs2[-1])

        hooks = self.spec.dpt_hooks
        out1 = self.head1([outs1[i].float() for i in hooks], hw1)
        out2 = self.head2([outs2[i].float() for i in hooks], hw2)
        return {
            "pred1": {"pts3d": reg_dense_pts3d(out1[..., :3]), "conf": reg_dense_conf(out1[..., 3])},
            "pred2": {"pts3d_in_other_view": reg_dense_pts3d(out2[..., :3]),
                      "conf": reg_dense_conf(out2[..., 3])},
        }
