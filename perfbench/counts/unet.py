"""The Seva UNet's forward, counted over the plain reference's own calls.

`count(spec, frames, T, h, w)` runs the reference UNet
(perfbench/reference/seva.py) on the meta device, where nothing is computed
or allocated, under torch's FlopCounterMode (2 a multiply-add in every
matrix product and convolution; bias adds, norms, softmax, resizes and
pointwise work not at all), and records every self-attention call it makes:
the spatial ones (per frame, or joint over all T frames' tokens of a scene)
and the temporal ones. Of these, the port routes to K1 the spatial calls at
head dim 64 over at least 1024 tokens, and to K2 the temporal calls over at
most 32 frames; each kernel's bound is summed over its sites.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.counts.peaks import BF16_FLOPS, FP32_FLOPS, bound_s

K1_HEAD_DIM = 64
K1_MIN_LEN = 1024  # the port routes self-attention of L >= 1024 at head dim 64 to K1
K2_MAX_FRAMES = 32  # and temporal attention over <= 32 frames to K2
BF16 = 2


@dataclass(frozen=True)
class Site:
    """One self-attention call: `sequences` rows of L tokens, H heads of D."""

    kind: str  # "spatial" or "temporal"
    sequences: int
    L: int
    H: int
    D: int

    @property
    def flops(self) -> float:
        return 4.0 * self.sequences * self.H * self.L * self.L * self.D

    @property
    def bytes_bf16(self) -> float:
        """q, k and v read once and o written once, in bf16."""
        return 4.0 * self.sequences * self.H * self.L * self.D * BF16


@dataclass(frozen=True)
class Forward:
    """One forward's FLOPs and its attention sites, in call order."""

    flops: int
    sites: tuple[Site, ...]

    @property
    def k1_sites(self) -> list[Site]:
        return [s for s in self.sites if s.kind == "spatial" and s.D == K1_HEAD_DIM and s.L >= K1_MIN_LEN]

    @property
    def k2_sites(self) -> list[Site]:
        return [s for s in self.sites if s.kind == "temporal" and s.L <= K2_MAX_FRAMES]

    def k1_bound_s(self) -> float:
        """K1's least time over its sites: bf16 products at the tensor cores'
        peak, or the bytes of q, k, v and o."""
        return sum(bound_s(s.flops, s.bytes_bf16, BF16_FLOPS) for s in self.k1_sites)

    def k2_bound_s(self) -> float:
        """K2's least time over its sites: its fp32 arithmetic on the CUDA
        cores, or the bf16 bytes of q, k, v and o."""
        return sum(bound_s(s.flops, s.bytes_bf16, FP32_FLOPS) for s in self.k2_sites)

    def k1_bwd_bound_s(self) -> float:
        """The backward pair's least time over K1's sites, in bf16: K1-dKV's
        8 L^2 D FLOPs a (sequence, head) with q, k, v, dO read and dK, dV
        written; K1-dQ's 6 L^2 D with q, k, v, dO read and dQ written.
        D = rowsum(o dO), a pass of its own, is left out."""
        total = 0.0
        for s in self.k1_sites:
            n = s.sequences * s.H
            total += bound_s(8.0 * n * s.L * s.L * s.D, 6.0 * n * s.L * s.D * BF16, BF16_FLOPS)
            total += bound_s(6.0 * n * s.L * s.L * s.D, 5.0 * n * s.L * s.D * BF16, BF16_FLOPS)
        return total


def count(spec: dict, frames: int, T: int, h: int, w: int) -> Forward:
    """The reference UNet's forward of `frames` frames in chunks of T at
    latent size (h, w), counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference import seva
    from perfbench.reference.precision import Precision

    sites = []
    spatial, temporal = seva.spatial_attention, seva.temporal_attention

    def rec_spatial(P, q, k, v):
        B, H, L, D = q.shape
        sites.append(Site("spatial", B, L, H, D))
        return spatial(P, q, k, v)

    def rec_temporal(P, q, k, v):
        B, H, L, D = q.shape
        sites.append(Site("temporal", B, L, H, D))
        return temporal(P, q, k, v)

    meta = torch.device("meta")
    sp = seva.UNetSpec.from_dict(spec)
    with meta:
        unet = seva.SevaUNet(sp)
        x = torch.empty(frames, h, w, sp.in_channels)
        t = torch.zeros(frames, dtype=torch.long)
        context = torch.empty(frames, 1, sp.context_dim)
        dense = torch.empty(frames, h, w, sp.dense_in_channels)
    seva.spatial_attention, seva.temporal_attention = rec_spatial, rec_temporal
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            unet.run(Precision(), x, t, context, dense, T)
    finally:
        seva.spatial_attention, seva.temporal_attention = spatial, temporal
    return Forward(int(fc.get_total_flops()), tuple(sites))
