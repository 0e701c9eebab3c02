"""The Seva multiview diffusion UNet in PyTorch, NHWC at its public interface.

Counterpart of stable_virtual_camera_tpu/models/unet.py. Modules are named
after the flax parameter tree (models/weights.py only flattens and
transposes), convs run on NHWC tensors through channels_last weights, and
norms, softmax and the time embedding keep the JAX package's fp32 islands.

Attention dispatch follows the JAX package exactly, with the `attention`
backend in place of JAX's use_pallas flag and SVC_UPSTREAM_FLASH /
SVC_PACKED_ATTENTION knobs:
  * "upstream" (default): self-attention with dim_head 64 and L >= 1024 ->
    kernel K1 (ops/flash_upstream.flash_attention_upstream_bhld) on the
    (B, H, L, 64) views of the packed qkv projection;
  * "flash" / "packed": every self-attention takes the generic split-qkv
    path to ops/attention.sdpa_packed, which sends the supported shapes to
    kernel K3 (ops/flash_attention) or, under "packed" with W % 128 == 0,
    kernel K4 (ops/flash_attention_packed);
  * temporal attention over T <= 32 frames -> kernel K2
    (ops/time_attention.time_attention_bhds) on the (b*T, H, D, S) layout
    the projection writes directly, whatever the backend and the head dim
    (K2's Hopper kernel takes bf16 at head dim 64, its other entry the
    rest, as JAX's kernel takes any);
  * "plain": the routes of "upstream" with each kernel's plain version, no
    kernel at all;
  * everything else -> the plain routes of ops/attention.sdpa_packed.
A block's routes follow from its backend and head dim, and per call from L
and T, as in JAX; never from a tensor's dtype, strides or address, so a
CUDA tensor routed to a kernel launches it or raises. On CPU tensors the
kernel wrappers run their plain versions.

W8A8 serving (ops/quant.py) quantizes exactly the JAX package's sites, and
`SevaUNet.set_quant(mode)` sets the mode on each: the attention projections
(qkv/to_out of the generic and flash self-attention paths, the temporal path
above 32 frames, the cross-attention's to_v/to_out), the GEGLU
feed-forwards, the MultiviewTransformer's proj_in/proj_out (`QuantLinear`),
the ResBlock convs and the Downsample (`QuantConv`) and the Upsample's
rearranged kernel. At T <= 32 frames the temporal projections stay exact in
every mode, as on JAX's time-kernel branch. The time-embedding MLPs,
emb_proj, dense_proj, the stem and out convs, the VAE and CLIP are never
quantized. Mode "0" runs the same operations as a model without this
support.

View sharding (parallel/): `forward(..., group=comm)` runs one rank's share
of a chunk, `num_frames` frames of each scene (the chunk's T / group.size;
rank r holds frames r*num_frames..(r+1)*num_frames-1 of every scene), as
JAX's `ring_mesh`/`ring_axis` UNet runs under shard_map. The convs,
GroupNorm, FiLM, cross-attention and per-frame self-attention are per
frame and stay local. The time context is each scene's first frame of the
chunk, broadcast from rank 0. The joint (T*h*w)-token self-attention runs
as a ring (parallel/ring_attention.py: K1 a block where the backend routes
to it, else the plain twin), and the temporal attention moves the
projections from frames to positions with an all-to-all, runs K2 (or the
einsum branch above 32 frames) over all T frames at this rank's share of
the positions, and moves the output back. Without a group the UNet runs
exactly as before.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.common import QuantSite
from stable_virtual_camera_tpu_torch.ops.attention import BACKENDS, sdpa_packed
from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
    HEAD_DIM as FLASH_HEAD_DIM,
    flash_attention_plain,
    flash_attention_upstream_bhld,
)
from stable_virtual_camera_tpu_torch.ops.norms import group_norm_nhwc, layer_norm_fp32
from stable_virtual_camera_tpu_torch.ops.quant import check_mode
from stable_virtual_camera_tpu_torch.ops.resize import (
    conv_nhwc,
    pixel_shuffle_2x,
    rearranged_upsample_weight,
    resize_bilinear_align_corners,
    upsample_2x_conv3x3,
)
from stable_virtual_camera_tpu_torch.ops.time_attention import (
    MAX_FRAMES as TIME_MAX_FRAMES,
    time_attention_bhds,
    time_attention_plain,
)
from stable_virtual_camera_tpu_torch.parallel import tensor_parallel as tp
from stable_virtual_camera_tpu_torch.parallel.ring_attention import ring_sdpa_packed

FLASH_MIN_LEN = 1024


def _split_sizes(n: int, parts: int) -> list[int]:
    return [n // parts + (1 if j < n % parts else 0) for j in range(parts)]


def frames_to_positions(t: torch.Tensor, frames: int, group, axis: int) -> torch.Tensor:
    """All-to-all from a rank's frames to its share of the positions: t is
    (b * frames, ...) with the spatial positions S on `axis`; returns
    (b * frames * n, ...) holding every frame of each scene, in rank order,
    at this rank's S / n positions (split as evenly as S allows)."""
    n = group.size
    if n == 1:
        return t
    b = t.shape[0] // frames
    pieces = torch.split(t.unflatten(0, (b, frames)), _split_sizes(t.shape[axis], n), dim=axis + 1)
    return torch.cat(group.all_to_all(list(pieces)), dim=1).flatten(0, 1)


def positions_to_frames(t: torch.Tensor, frames: int, group, axis: int) -> torch.Tensor:
    """The inverse of `frames_to_positions`: t is (b * frames * n, ...) at
    this rank's share of the positions on `axis`; returns (b * frames, ...)
    at all positions."""
    n = group.size
    if n == 1:
        return t
    tv = t.unflatten(0, (t.shape[0] // (frames * n), frames * n))
    pieces = [tv[:, j * frames : (j + 1) * frames] for j in range(n)]
    return torch.cat(group.all_to_all(pieces), dim=axis + 1).flatten(0, 1)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, fp32, [cos | sin] packing."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Affine(nn.Module):
    """Per-channel scale (`weight`) and bias of a norm layer."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics, output in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.gn = Affine(channels)
        self.eps = eps
        self.groups = groups

    def forward(self, x):
        return group_norm_nhwc(x, self.gn.weight, self.gn.bias, self.groups, self.eps)


class LayerNorm32(nn.Module):
    """LayerNorm with single-pass fp32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.ln = Affine(channels)
        self.eps = eps

    def forward(self, x):
        return layer_norm_fp32(x, self.ln.weight, self.ln.bias, self.eps)


class Linear(nn.Linear):
    """nn.Linear that runs on its weight shard under tensor parallelism."""

    def forward(self, x):
        return tp.linear(self, x)


class Conv(nn.Conv2d):
    """k x k SAME conv on NHWC tensors (on its weight shard under tensor
    parallelism)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, bias=bias)

    def _conv(self, x, weight, bias):
        return conv_nhwc(x, weight, bias, self.stride, self.padding)

    def forward(self, x):
        return tp.conv(self, x, self._conv)


class _Quantizable:
    """A layer with a W8A8 mode ("0" unless `set_quant` says otherwise) and,
    in the static and calibration modes, a QuantSite submodule `qsite` for
    the weight `_site_shape()` describes."""

    quant = "0"

    def _site_shape(self) -> tuple[int, ...]:
        return tuple(self.weight.shape)

    def quant_weight(self) -> torch.Tensor:
        """The weight the site quantizes (out first)."""
        return self.weight

    @property
    def sharded_layer(self) -> nn.Module:
        """The module whose weight tensor parallelism shards (its `tp_dim`)."""
        return self

    def site(self) -> QuantSite | None:
        return self._modules.get("qsite")

    def set_quant(self, mode: str) -> None:
        self.quant = check_mode(mode)
        if mode in ("w8a8-static", "w8a8-calib") and self.site() is None:
            self.qsite = QuantSite(self._site_shape(), device=self.weight.device)

    def clear_quant_state(self) -> None:
        self._modules.pop("qsite", None)


class QuantLinear(_Quantizable, nn.Linear):
    """nn.Linear with the W8A8 serving modes (ops/quant.py)."""

    def forward(self, x):
        mode = self.quant
        if mode in ("w8a8", "w8a8-static"):
            return tp.w8a8_linear(self, x)
        if mode == "w8a8-calib":
            self.qsite.record(self.weight, x)
        return tp.linear(self, x)


class QuantConv(_Quantizable, Conv):
    """Conv with the W8A8 serving modes (ops/quant.py)."""

    def forward(self, x):
        mode, stride, pad = self.quant, self.stride[0], self.padding[0]
        if mode in ("w8a8", "w8a8-static"):
            return tp.w8a8_conv(self, x, stride, pad)
        if mode == "w8a8-calib":
            self.qsite.record(self.weight, x)
        return tp.conv(self, x, self._conv)


class SelfAttention(nn.Module):
    """Fused-qkv multi-head self-attention (spatial, joint or temporal);
    `attention` picks the backend of the spatial and joint path."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, attention: str = "upstream"):
        super().__init__()
        if attention not in BACKENDS:
            raise ValueError(f"attention backend must be one of {BACKENDS}, got {attention!r}")
        self.heads = heads
        self.dim_head = dim_head
        self.attention = attention
        inner = heads * dim_head
        self.qkv = QuantLinear(query_dim, 3 * inner, bias=False)
        self.to_out = QuantLinear(inner, query_dim)

    def forward(self, x, time_frames: int | None = None, group=None):
        """Self-attention over x (B, L, C); with `time_frames`, temporal
        attention over that many frames a scene. With a view `group` the
        joint attention runs as a ring over the group's sequence shards, and
        the temporal attention over every rank's frames."""
        if time_frames is not None:
            return self._temporal(x, time_frames, group)
        B, L, _ = x.shape
        H, D = self.heads, self.dim_head
        # (B, L, 3 * inner); under W8A8 the int8 product writes the same
        # layout, so the flash route takes the same strided views
        qkv = self.qkv(x)
        if group is not None:
            kernel = self.attention != "plain" and D == FLASH_HEAD_DIM  # K1's one head dim
            return self.to_out(ring_sdpa_packed(*qkv.chunk(3, dim=-1), H, group, kernel))
        if self.attention in ("upstream", "plain") and D == FLASH_HEAD_DIM and L >= FLASH_MIN_LEN:
            # (B, H, L, D) strided views of the packed projection; the kernel
            # writes (B, L, H, D), so to_out reads it with no copy
            q, k, v = qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
            attend = flash_attention_plain if self.attention == "plain" else flash_attention_upstream_bhld
            o = attend(q, k, v)
            return self.to_out(o.transpose(1, 2).reshape(B, L, H * D))
        q, k, v = qkv.chunk(3, dim=-1)
        return self.to_out(sdpa_packed(q, k, v, H, backend=self.attention))

    def _temporal(self, x, frames: int, group=None):
        """`frames` frames a scene on this rank; with a view group the
        attention runs over all frames * group.size of them, at this rank's
        share of the positions between two all-to-alls."""
        H, D = self.heads, self.dim_head
        inner = H * D
        n = 1 if group is None else group.size
        T = frames * n
        if T <= TIME_MAX_FRAMES:
            # W x^T writes the kernel's (b*T, H, D, S) layout (S contiguous)
            # straight from the GEMM; to_out reads it back transposed. Both
            # projections stay exact in every W8A8 mode (JAX's time-kernel
            # branch keeps them as einsums). Under a group the all-to-all
            # hands K2 a contiguous (b*T, 3*inner, S/n) tensor
            qkv = tp.matmul_channels_first(self.qkv, x)  # (B, 3*inner, S)
            if n > 1:
                qkv = frames_to_positions(qkv, frames, group, axis=2)
            BT, _, S = qkv.shape
            q, k, v = qkv.view(BT, 3, H, D, S).unbind(1)
            kernel = self.attention != "plain"
            o = (time_attention_bhds if kernel else time_attention_plain)(q, k, v, T).reshape(BT, inner, S)
            if n > 1:
                o = positions_to_frames(o, frames, group, axis=2)
            return tp.linear(self.to_out, o.transpose(1, 2))
        qkv = self.qkv(x)  # (B, S, 3*inner)
        if n > 1:
            qkv = frames_to_positions(qkv, frames, group, axis=1)
        B, S, _ = qkv.shape
        b = B // T
        q, k, v = (
            t.reshape(b, T, S, H, D) for t in qkv.chunk(3, dim=-1)
        )
        s = torch.einsum("bqshd,bkshd->bshqk", q.float(), k.float()) * D**-0.5
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bshqk,bkshd->bqshd", p, v).reshape(B, S, inner)
        if n > 1:
            o = positions_to_frames(o, frames, group, axis=1)
        return self.to_out(o)


class CrossAttention(nn.Module):
    """Cross-attention over a single context token: softmax over one key is
    exactly 1, so the output is to_out(to_v(context)) for every query."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.to_v = QuantLinear(context_dim, inner, bias=False)
        self.to_out = QuantLinear(inner, query_dim)

    def forward(self, context):  # (B, 1, ctx) -> (B, 1, query_dim)
        return self.to_out(self.to_v(context))


class FeedForward(nn.Module):
    """GEGLU MLP; GELU is tanh in bf16 and exact (erf) otherwise."""

    def __init__(self, dim: int, dim_out: int | None = None, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.proj_gate = QuantLinear(dim, 2 * inner)
        self.proj_out = QuantLinear(inner, dim_out or dim)

    def forward(self, x):
        val, gate = self.proj_gate(x).chunk(2, dim=-1)
        approx = "tanh" if gate.dtype == torch.bfloat16 else "none"
        return self.proj_out(val * F.gelu(gate, approximate=approx))


class TransformerBlock(nn.Module):
    """Pre-LN self-attn + single-token cross-attn + GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 attention: str = "upstream"):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = SelfAttention(dim, heads, dim_head, attention)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, group=None):
        x = self.attn1(self.norm1(x), group=group) + x
        # norm2 feeds only the (dead) query projection of single-token
        # cross-attention; it is kept for the checkpoint and not evaluated
        x = self.attn2(context) + x
        return self.ff(self.norm3(x)) + x


class TransformerBlockTimeMix(nn.Module):
    """Temporal attention block; the final FF has no residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 attention: str = "upstream"):
        super().__init__()
        self.norm_in = LayerNorm32(dim)
        self.ff_in = FeedForward(dim, dim_out=dim)
        self.norm1 = LayerNorm32(dim)
        self.attn1 = SelfAttention(dim, heads, dim_head, attention)
        self.norm2 = LayerNorm32(dim)  # unused: carried for the checkpoint
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, time_context, num_frames: int, group=None):
        B, S, C = x.shape
        b = B // num_frames
        x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x), time_frames=num_frames, group=group) + x
        cross = self.attn2(time_context)  # (b, 1, C), one row per scene
        x = x + cross[:, None].expand(b, num_frames, 1, C).reshape(B, 1, C)
        return self.ff(self.norm3(x))


class MultiviewTransformer(nn.Module):
    """The 3D attention block: spatial self-attention per frame, or over the
    fused (T*h*w)-token sequence for `unflatten` layers, plus a time-mix
    block at each depth."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 unflatten: bool, context_dim: int, attention: str = "upstream"):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.unflatten = unflatten
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = QuantLinear(channels, inner)
        for d in range(depth):
            self.add_module(
                f"spatial_{d}", TransformerBlock(inner, heads, dim_head, context_dim, attention)
            )
            self.add_module(
                f"temporal_{d}", TransformerBlockTimeMix(inner, heads, dim_head, context_dim, attention)
            )
        self.proj_out = QuantLinear(inner, channels)

    def forward(self, x, context, num_frames: int, group=None, time_context=None):
        """`num_frames` frames a scene (this rank's, under a view `group`);
        `time_context` is each scene's first-frame context, taken from
        `context` when not given."""
        B, h, w, C = x.shape
        b = B // num_frames
        if time_context is None:
            time_context = context[::num_frames]
        ctx = time_context if self.unflatten else context
        joint_group = group if self.unflatten else None
        y = self.proj_in(self.norm(x).reshape(B, h * w, C))
        inner = y.shape[-1]
        for d in range(self.depth):
            if self.unflatten:
                y = y.reshape(b, num_frames * h * w, inner)
            y = getattr(self, f"spatial_{d}")(y, ctx, joint_group)
            if self.unflatten:
                y = y.reshape(B, h * w, inner)
            y = y + getattr(self, f"temporal_{d}")(y, time_context, num_frames, group)
        return x + self.proj_out(y).reshape(B, h, w, C)


class ResBlock(nn.Module):
    """Residual block with time-embedding and dense Plücker FiLM conditioning."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int, dense_in: int):
        super().__init__()
        self.in_gn = GroupNorm32(channels)
        self.dense_proj = Conv(dense_in, 2 * channels, 1)
        self.in_conv = QuantConv(channels, out_channels, 3)
        self.emb_proj = Linear(emb_dim, out_channels)
        self.out_gn = GroupNorm32(out_channels)
        self.out_conv = QuantConv(out_channels, out_channels, 3)
        self.skip = QuantConv(channels, out_channels, 1) if out_channels != channels else None

    def film(self, dense_emb, hw: tuple[int, int]):
        """The FiLM map of this block at resolution `hw`: the Plücker map
        resized (align corners) and 1x1-projected to [scale | shift]. It
        depends only on the chunk's conditioning, never on x or the step."""
        return self.dense_proj(resize_bilinear_align_corners(dense_emb, hw))

    def forward(self, x, emb, dense_emb, film=None):
        """`film` is this block's precomputed `film(...)` (the FiLM cache):
        of x's batch, or of a divisor of it (the CFG halves share one
        Plücker map), broadcast over the batch's repeats."""
        h = F.silu(self.in_gn(x))
        if film is None:
            film = self.film(dense_emb, (x.shape[1], x.shape[2]))
        scale, shift = film.to(h.dtype).chunk(2, dim=-1)
        if film.shape[0] != h.shape[0]:
            hr = h.unflatten(0, (h.shape[0] // film.shape[0], film.shape[0]))
            h = (hr * (1 + scale) + shift).flatten(0, 1)
        else:
            h = h * (1 + scale) + shift
        h = self.in_conv(h)
        e = self.emb_proj(F.silu(emb.float()).to(h.dtype))
        h = h + e[:, None, None, :]
        h = self.out_conv(F.silu(self.out_gn(h)))
        skip = x if self.skip is None else self.skip(x)
        return skip + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = QuantConv(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample(_Quantizable, nn.Module):
    """Nearest-2x upsample + 3x3 conv. Under W8A8 it runs as JAX's does: a
    low-resolution 3x3 conv with the rearranged (4 C, C, 3, 3) kernel, whose
    per-output-channel scales run over the four sub-pixel phases, then a
    pixel shuffle; the site quantizes the rearranged kernel."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    @property
    def weight(self) -> torch.Tensor:
        return self.conv.weight

    def _site_shape(self) -> tuple[int, ...]:
        c_out, c_in = self.conv.weight.shape[:2]
        return (4 * c_out, c_in, 3, 3)

    def quant_weight(self) -> torch.Tensor:
        return rearranged_upsample_weight(self.conv.weight)

    @property
    def sharded_layer(self) -> nn.Module:
        return self.conv

    def forward(self, x):
        mode = self.quant
        if mode in ("w8a8", "w8a8-static"):
            # on a model group: this rank's output channels (or all of them
            # after the int32 all-reduce), gathered after the shuffle
            weight = self.quant_weight() if mode == "w8a8" else None  # static: the site's
            y = tp.w8a8_conv(self.conv, x, 1, 1, site=self, weight=weight, bias=False, gather=False)
            b = tp.local_bias(self.conv, self.conv.bias)
            return tp.gather_channels(self.conv, pixel_shuffle_2x(y + b.to(y.dtype).repeat(4)))
        if mode == "w8a8-calib":
            self.qsite.record(self.quant_weight(), x)
        return tp.conv(self.conv, x, upsample_2x_conv3x3)


class SevaUNet(nn.Module):
    """The full denoiser UNet, NHWC.

    forward(x (B, h, w, 11), t_idx (B,), context (B, 1, ctx),
    dense_emb (B, h, w, 6), num_frames) -> (B, h, w, 4) fp32, B = b * T.
    Computes in the dtype of its parameters. `attention` ("upstream",
    "flash", "packed" or "plain") is the attention backend of every
    transformer block; it changes no parameter. The kernels take bf16 and
    fp32, so a model on the card runs them in either dtype.
    """

    def __init__(self, spec: SevaSpec, attention: str = "upstream"):
        super().__init__()
        self.spec = sp = spec
        self.attention = attention
        mc = sp.model_channels
        emb_dim = 4 * mc
        self.time_embed_0 = Linear(mc, emb_dim)
        self.time_embed_2 = Linear(emb_dim, emb_dim)

        n_levels = len(sp.channel_mult)

        def depth(level: int) -> int:
            return sp.transformer_depth[min(level, len(sp.transformer_depth) - 1)]

        def mvt(name: str, ch: int, level_name: str, level: int):
            self.add_module(name, MultiviewTransformer(
                ch, ch // sp.num_head_channels, sp.num_head_channels, depth(level),
                level_name in sp.unflatten_names, sp.context_dim, attention,
            ))

        def res(name: str, cin: int, cout: int):
            self.add_module(name, ResBlock(cin, cout, emb_dim, sp.dense_in_channels))

        # encoder: (res name, mvt name or None) per stage; None res = downsample
        self.input_blocks_0_0 = Conv(sp.in_channels, mc, 3)
        skip_ch = [mc]
        self._encoder: list[tuple[str, str | None, bool]] = []
        ch, ds, idx = mc, 1, 1
        for level, mult in enumerate(sp.channel_mult):
            for _ in range(sp.num_res_blocks):
                res(f"input_blocks_{idx}_0", ch, mult * mc)
                ch = mult * mc
                attn = None
                if ds in sp.attention_resolutions:
                    attn = f"input_blocks_{idx}_1"
                    mvt(attn, ch, f"input_ds{ds}", level)
                self._encoder.append((f"input_blocks_{idx}_0", attn, False))
                skip_ch.append(ch)
                idx += 1
            if level != n_levels - 1:
                self.add_module(f"input_blocks_{idx}_0", Downsample(ch))
                self._encoder.append((f"input_blocks_{idx}_0", None, True))
                ds *= 2
                skip_ch.append(ch)
                idx += 1

        res("middle_block_0", ch, ch)
        mvt("middle_block_1", ch, f"middle_ds{ds}", n_levels - 1)
        res("middle_block_2", ch, ch)

        # decoder: (res name, mvt name or None, upsample name or None)
        self._decoder: list[tuple[str, str | None, str | None]] = []
        idx = 0
        for level, mult in list(enumerate(sp.channel_mult))[::-1]:
            for i in range(sp.num_res_blocks + 1):
                res(f"output_blocks_{idx}_0", ch + skip_ch.pop(), mult * mc)
                ch = mult * mc
                layer = 1
                attn = up = None
                if ds in sp.attention_resolutions:
                    attn = f"output_blocks_{idx}_{layer}"
                    mvt(attn, ch, f"output_ds{ds}", level)
                    layer += 1
                if level and i == sp.num_res_blocks:
                    up = f"output_blocks_{idx}_{layer}"
                    self.add_module(up, Upsample(ch))
                    ds //= 2
                self._decoder.append((f"output_blocks_{idx}_0", attn, up))
                idx += 1

        self.out_gn = GroupNorm32(ch)
        self.out_conv = Conv(ch, sp.out_channels, 3)

    @property
    def dtype(self) -> torch.dtype:
        return self.out_conv.weight.dtype

    quant = "0"

    def _quant_layers(self):
        return [m for m in self.modules() if isinstance(m, _Quantizable)]

    def set_quant(self, mode: str) -> "SevaUNet":
        """Set the W8A8 mode (ops/quant.py) of every quantized site. The
        static and calibration modes give each site a QuantSite (kept across
        later mode changes; `clear_quant_state` drops them)."""
        for m in self._quant_layers():
            m.set_quant(mode)
        self.quant = mode
        return self

    def clear_quant_state(self) -> None:
        for m in self._quant_layers():
            m.clear_quant_state()

    @property
    def quant_calibrated(self) -> bool:
        """True once a calibration ran (or a calibrated state was loaded). A
        calibration reaches every site its forwards run: all of them but the
        temporal self-attention projections, which stay exact at T <= 32
        frames (JAX's calibrated collection lacks them too)."""
        return any(m.site() is not None and m.site().ready for m in self._quant_layers())

    @contextlib.contextmanager
    def quant_mode(self, mode: str):
        """Run the block in `mode`, then restore the mode before it."""
        prev = self.quant
        self.set_quant(mode)
        try:
            yield self
        finally:
            self.set_quant(prev)

    def film(self, dense_emb, model_group=None) -> dict:
        """The FiLM cache of a chunk: {ResBlock name: its `film` map} for
        every ResBlock, at the resolution the forward gives it, keyed as
        JAX's `film_only` walk keys its dict. Batch and resolution come from
        `dense_emb` (B, h, w, 6); `model_group` as in `forward`."""
        dense_emb = dense_emb.to(self.dtype)
        hw = tuple(dense_emb.shape[1:3])
        films = {}
        with tp.model_group(model_group) if model_group is not None else contextlib.nullcontext():
            for name, _attn, is_down in self._encoder:
                if is_down:  # a SAME stride-2 conv: ceil(n / 2)
                    hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
                else:
                    films[name] = getattr(self, name).film(dense_emb, hw)
            for name in ("middle_block_0", "middle_block_2"):
                films[name] = getattr(self, name).film(dense_emb, hw)
            for name, _attn, up in self._decoder:
                films[name] = getattr(self, name).film(dense_emb, hw)
                if up is not None:
                    hw = (2 * hw[0], 2 * hw[1])
        return films

    def forward(self, x, t_idx, context, dense_emb, num_frames: int, group=None, film=None,
                model_group=None):
        """`num_frames` frames a scene. With a view `group` (parallel/comm.Comm)
        this is one rank's share: num_frames = T / group.size frames of each
        scene, the ranks together the whole chunk. `film` is the chunk's FiLM
        cache (`film(...)`), used in place of each ResBlock's FiLM map. With
        a `model_group` (the Comm of a "model" mesh axis) this is a shard
        module's forward (parallel/tensor_parallel.shard_unet)."""
        if model_group is not None:
            with tp.model_group(model_group):
                return self.forward(x, t_idx, context, dense_emb, num_frames, group, film)
        dt = self.dtype
        x, context, dense_emb = x.to(dt), context.to(dt), dense_emb.to(dt)
        # a view group reaches the MultiviewTransformers as keywords only when
        # set, so an unsharded forward calls each block as before (training's
        # remat wraps their forwards with positional arguments)
        mvt = {}
        if group is not None:
            mvt = {"group": group, "time_context": group.broadcast(context[::num_frames], src=0)}
        temb = self.time_embed_0(timestep_embedding(t_idx, self.spec.model_channels).to(dt))
        temb = self.time_embed_2(F.silu(temb.float()).to(dt))

        def res(name, h):
            # the cache goes positionally, and only when given: training's
            # remat wraps the blocks' forwards with positional arguments
            cached = () if film is None else (film[name],)
            return getattr(self, name)(h, temb, dense_emb, *cached)

        h = self.input_blocks_0_0(x)
        hs = [h]
        for name, attn, is_down in self._encoder:
            if is_down:
                h = getattr(self, name)(h)
            else:
                h = res(name, h)
                if attn is not None:
                    h = getattr(self, attn)(h, context, num_frames, **mvt)
            hs.append(h)

        h = res("middle_block_0", h)
        h = self.middle_block_1(h, context, num_frames, **mvt)
        h = res("middle_block_2", h)

        for name, attn, up in self._decoder:
            h = res(name, torch.cat([h, hs.pop()], dim=-1))
            if attn is not None:
                h = getattr(self, attn)(h, context, num_frames, **mvt)
            if up is not None:
                h = getattr(self, up)(h)

        return self.out_conv(F.silu(self.out_gn(h))).float()


def assemble_network_input(latents: torch.Tensor, concat: torch.Tensor) -> torch.Tensor:
    """Latent (4) ++ input mask (1) ++ Plücker (6) channels, NHWC."""
    return torch.cat([latents, concat.to(latents.dtype)], dim=-1)
