"""The weights of a run, made from its seed on its device.

The parameter table (names, shapes, which module owns each) is the
reference's (perfbench/reference), whose names are the port's, so one set
of tensors serves both sides. The rule is flax's defaults, which the port's
own random bundles use: truncated-normal (at 2 std) kernels of variance
1 / fan_in, zero biases, unit norm scales, normal(0.02) CLIP class and
positional embeddings and projection. The draws run on the device in a few
large calls: the kernels of one fan-in are one flat range of a uniform draw
(the inverse-CDF form of the truncated normal), so a model of a billion
parameters takes a few dozen calls, whatever its number of leaves.
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch import nn

from perfbench.reference.autoencoder import AutoencoderKL, ClipSpec, ClipVisionTower
from perfbench.reference.seva import Affine, SevaUNet, UNetSpec

# flax's lecun_normal draws N(0, 1) truncated at +-2 and rescales by this,
# so that the truncated draw keeps variance 1 / fan_in
TRUNC_STD = 0.87962566103423978
EMBED_STD = 0.02
CHUNK = 1 << 28  # elements a uniform draw at most (1 GiB of float32)


def reference_models(config: dict, device="meta"):
    """The reference's (unet, vae, clip) for a configuration, uninitialised."""
    with torch.device(device):
        return (SevaUNet(UNetSpec.from_dict(config["unet"])), AutoencoderKL(),
                ClipVisionTower(ClipSpec.from_dict(config["clip"])))


def _rules(model: nn.Module):
    """(name, shape, kind, std) of every parameter; kind is "kernel",
    "zero", "one" or "embed"."""
    owner = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            owner[f"{mod_name}.{p_name}" if mod_name else p_name] = (mod, p_name)
    rows = []
    for name, p in model.named_parameters():
        mod, leaf = owner[name]
        if isinstance(mod, (nn.Linear, nn.Conv2d)) and leaf == "weight":
            rows.append((name, tuple(p.shape), "kernel", math.sqrt(1.0 / p[0].numel()) / TRUNC_STD))
        elif isinstance(mod, Affine) and leaf == "weight":
            rows.append((name, tuple(p.shape), "one", 0.0))
        elif isinstance(mod, ClipVisionTower):
            rows.append((name, tuple(p.shape), "embed", EMBED_STD))
        else:
            rows.append((name, tuple(p.shape), "zero", 0.0))
    return rows


def make(model: nn.Module, generator: torch.Generator, dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """A state dict for `model`'s parameter table, drawn from `generator` on
    `device` and stored in `dtype`."""
    rows = _rules(model)
    out = {}
    kernels = defaultdict(list)
    embeds = []
    for name, shape, kind, std in rows:
        if kind == "kernel":
            kernels[std].append((name, shape))
        elif kind == "embed":
            embeds.append((name, shape))
        else:
            out[name] = (torch.ones if kind == "one" else torch.zeros)(shape, dtype=dtype, device=device)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    for std in sorted(kernels):
        group = kernels[std]
        n = sum(math.prod(s) for _, s in group)
        flat = torch.empty(n, dtype=dtype, device=device)
        for a in range(0, n, CHUNK):
            u = torch.empty(min(CHUNK, n - a), dtype=torch.float32, device=device)
            u.uniform_(2.0 * lo - 1.0, 1.0 - 2.0 * lo, generator=generator)
            flat[a : a + u.numel()] = u.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
            del u
        a = 0
        for name, shape in group:
            out[name] = flat[a : a + math.prod(shape)].view(shape)
            a += math.prod(shape)
    if embeds:
        n = sum(math.prod(s) for _, s in embeds)
        flat = torch.empty(n, dtype=torch.float32, device=device).normal_(0.0, EMBED_STD, generator=generator).to(dtype)
        a = 0
        for name, shape in embeds:
            out[name] = flat[a : a + math.prod(shape)].view(shape)
            a += math.prod(shape)
    return {name: out[name] for name, *_ in rows}


def make_all(config: dict, seed: int, dtype: torch.dtype, device) -> dict[str, dict[str, torch.Tensor]]:
    """{"unet", "vae", "clip"}: state dicts drawn from `seed`, in that order."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {key: make(model, g, dtype, device)
            for key, model in zip(("unet", "vae", "clip"), reference_models(config))}
