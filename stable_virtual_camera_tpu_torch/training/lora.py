"""LoRA: parameter-efficient fine-tuning of the multiview UNet.

Counterpart of stable_virtual_camera_tpu/training/lora.py. Low-rank adapters
(Hu et al. 2021) on the transformer projection kernels; only the adapters
train, and the result merges back into one weight set for serving.

Adapters live in a separate dict `{flax path: {"a", "b"}}`, keyed by the
parameter's path in the JAX package's flax tree (the port's modules are
named after those paths, models/weights.py): "a/b/kernel" is the weight of
the port's module "a.b". `a` is (in, r) and `b` is (r, out) in the flax
kernel's layout, so the merged flax kernel is base + (a @ b) * alpha / r and
the port's weight is its transpose (conv kernels fold their trailing dims
as the JAX package does, and convert HWIO -> OIHW). The train step merges
functionally, through torch.func.functional_call: the module is not
changed, and the frozen base does not require grad.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from stable_virtual_camera_tpu_torch.models.unet import Affine
from stable_virtual_camera_tpu_torch.training.train_step import Draw, TrainBatch, make_loss_fn

# attention projections + feed-forward matmuls of every transformer block
# (spatial and temporal): the standard LoRA target set
DEFAULT_PATTERN = r"(attn1|attn2|ff|ff_in)/.*kernel$|/(proj_in|proj_out)/kernel$"


def flax_paths(module: nn.Module) -> dict[str, str]:
    """{flax path: port parameter name} for every parameter of `module`: the
    weight of a Linear or Conv2d is the flax `kernel`, the weight of a norm
    its `scale`; every other name maps as it is."""
    out = {}
    for mod_name, mod in module.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            flax_leaf = leaf
            if leaf == "weight":
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    flax_leaf = "kernel"
                elif isinstance(mod, Affine):
                    flax_leaf = "scale"
            prefix = mod_name.replace(".", "/")
            out[f"{prefix}/{flax_leaf}" if prefix else flax_leaf] = (
                f"{mod_name}.{leaf}" if mod_name else leaf
            )
    return out


def _flax_shape(w: torch.Tensor) -> tuple[int, ...]:
    if w.dim() == 2:
        return (w.shape[1], w.shape[0])
    if w.dim() == 4:  # OIHW -> HWIO
        return (w.shape[2], w.shape[3], w.shape[1], w.shape[0])
    return tuple(w.shape)


def _to_port_layout(kernel: torch.Tensor) -> torch.Tensor:
    """A flax-layout kernel in the port's weight layout."""
    if kernel.dim() == 2:
        return kernel.t()
    if kernel.dim() == 4:
        return kernel.permute(3, 2, 0, 1)
    return kernel


def lora_target_paths(unet: nn.Module, pattern: str = DEFAULT_PATTERN) -> list[str]:
    """Flax paths (joined with '/') of the kernels that get adapters."""
    rx = re.compile(pattern)
    params = dict(unet.named_parameters())
    return sorted(
        path for path, name in flax_paths(unet).items()
        if rx.search(path) and params[name].dim() >= 2
    )


def init_lora(
    unet: nn.Module,
    rank: int,
    generator: torch.Generator | None = None,
    pattern: str = DEFAULT_PATTERN,
    dtype: torch.dtype = torch.float32,
) -> dict[str, dict[str, torch.Tensor]]:
    """Adapters {path: {"a": (in, r), "b": (r, out)}} for every target, on
    the model's device and requiring grad. `a` is Gaussian (std 1/rank),
    `b` is zero, so the merged weights start exactly at the base and step 0
    reproduces the pretrained model."""
    paths = lora_target_paths(unet, pattern)
    if not paths:
        raise ValueError(f"no kernels match LoRA pattern {pattern!r}")
    names = flax_paths(unet)
    params = dict(unet.named_parameters())
    lora = {}
    for path in paths:
        w = params[names[path]]
        shape = _flax_shape(w)
        d_in, d_out = shape[0], int(np.prod(shape[1:]))
        a = torch.randn((d_in, rank), generator=generator, device=w.device, dtype=dtype) / rank
        lora[path] = {
            "a": a.requires_grad_(),
            "b": torch.zeros((rank, d_out), device=w.device, dtype=dtype, requires_grad=True),
        }
    return lora


def merge_lora(
    unet: nn.Module, lora: dict, alpha: float | None = None
) -> dict[str, torch.Tensor]:
    """{port parameter name: base + (a @ b) * (alpha / rank)} for every
    adapted weight, in the weight's layout and dtype; differentiable in the
    adapters. `alpha=None` uses alpha = rank (scale 1.0)."""
    names = flax_paths(unet)
    params = dict(unet.named_parameters())
    merged = {}
    for path, ab in lora.items():
        if path not in names:
            raise ValueError(f"adapter path {path!r} not in parameter tree")
        w = params[names[path]]
        rank = ab["a"].shape[-1]
        scale = 1.0 if alpha is None else float(alpha) / rank
        delta = (ab["a"] @ ab["b"]).reshape(_flax_shape(w)) * scale
        merged[names[path]] = w.detach() + _to_port_layout(delta).to(w.dtype)
    return merged


def make_lora_train_step(
    unet: nn.Module,
    optimizer,
    num_frames: int,
    alpha: float | None = None,
    discretization=None,
    remat: bool = False,
):
    """Returns `step(lora, batch, draw) -> loss`: one loss through the
    merged weights, backward into the adapters only and an `optimizer`
    update of them in place (`optimizer` is a training.optim AdamW or
    MultiSteps over the adapter tensors). The base weights of `unet` are
    frozen: this sets requires_grad False on them."""
    unet.requires_grad_(False)
    loss_fn = make_loss_fn(unet, num_frames, discretization, remat)

    def step(lora: dict, batch: TrainBatch, draw: Draw) -> torch.Tensor:
        loss = loss_fn(batch, draw, merge_lora(unet, lora, alpha))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
