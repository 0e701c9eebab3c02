"""Diffusion fine-tuning of the multiview UNet: loss, backward, optimizer
update, EMA, optional rematerialisation.

Counterpart of stable_virtual_camera_tpu/training/train_step.py:29-191 for
one device: discrete-timestep epsilon-prediction MSE under the model's own
DDPM discretization (the sigmas the sampler uses), with c_skip = 1,
c_out = -sigma, c_in = 1 / sqrt(sigma^2 + 1), so the network predicts
epsilon and the loss is ||net(x_sigma c_in, t, cond) - eps||^2 averaged
over the frames of the loss mask.

Where JAX threads a key, the port takes a `draw(shape) -> (t_idx, eps)`
callable: one timestep index in [0, 1000) shared by the chunk and the
unit-normal noise of the latents' shape. `torch_draw` makes one from a
`torch.Generator`; tests replay the JAX package's draws through it. Where
JAX returns new trees, the port updates the module's parameters, the
optimizer's state and the EMA tensors in place.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from stable_virtual_camera_tpu_torch.models.unet import (
    MultiviewTransformer,
    ResBlock,
    SevaUNet,
    assemble_network_input,
)
from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization

Draw = Callable[[tuple[int, ...]], tuple[torch.Tensor, torch.Tensor]]


@dataclass
class TrainBatch:
    """One chunk-shaped training example (frame axis = T views).

    latents:   (T, h, w, 4)  clean VAE latents of all views
    concat:    (T, h, w, 7)  input-mask ++ Plücker conditioning
    crossattn: (T, 1, ctx)   CLIP embedding
    dense:     (T, h, w, 6)  Plücker FiLM map
    loss_mask: (T,)          1.0 for frames that contribute to the loss
                             (input views are replace-conditioned at
                             inference and typically excluded)
    Fields are numpy arrays on the host or tensors on a device.
    """

    latents: np.ndarray | torch.Tensor
    concat: np.ndarray | torch.Tensor
    crossattn: np.ndarray | torch.Tensor
    dense: np.ndarray | torch.Tensor
    loss_mask: np.ndarray | torch.Tensor

    def to(self, device) -> "TrainBatch":
        """The batch as fp32 tensors on `device`."""
        return TrainBatch(*(
            torch.as_tensor(getattr(self, f.name), dtype=torch.float32).to(device)
            for f in fields(self)
        ))


def torch_draw(generator: torch.Generator, num_timesteps: int = 1000) -> Draw:
    """A `draw` from `generator`, on its device."""

    def draw(shape):
        t_idx = torch.randint(0, num_timesteps, (), generator=generator, device=generator.device)
        eps = torch.randn(shape, generator=generator, device=generator.device)
        return t_idx, eps

    return draw


def diffusion_loss(
    network_fn: Callable,
    batch: TrainBatch,
    draw: Draw,
    registered_sigmas: torch.Tensor,  # (1000,) ascending, fp32
    num_frames: int,
) -> torch.Tensor:
    """Epsilon-prediction MSE at one random discrete timestep shared by all
    frames of the chunk (the sampler denoises all T frames at one sigma)."""
    x0 = batch.latents
    t_idx, eps = draw(tuple(x0.shape))
    t_idx = torch.as_tensor(t_idx, device=x0.device).reshape(())
    eps = torch.as_tensor(eps, device=x0.device).to(x0.dtype)
    sigma = registered_sigmas[t_idx]
    x_sigma = x0 + sigma * eps
    c_in = torch.rsqrt(sigma**2 + 1.0)
    t_vec = t_idx.to(torch.int32).expand(num_frames)
    pred_eps = network_fn(
        x_sigma * c_in, batch.concat, t_vec, batch.crossattn, batch.dense, num_frames
    ).float()
    per_frame = ((pred_eps - eps.float()) ** 2).mean(dim=(1, 2, 3))
    mask = batch.loss_mask.float()
    return (per_frame * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_network_fn(unet: SevaUNet, params: dict[str, torch.Tensor] | None = None) -> Callable:
    """The sampler's network convention, `fn(x, concat, t_vec, crossattn,
    dense, num_frames)`, through `unet` with its own parameters or, given
    `params`, with those in their place (torch.func.functional_call)."""

    def network_fn(x, concat, t_vec, crossattn, dense, num_frames):
        args = (assemble_network_input(x, concat), t_vec, crossattn, dense, num_frames)
        if params is None:
            return unet(*args)
        return torch.func.functional_call(unet, params, args, strict=False)

    return network_fn


@torch.no_grad()
def ema_update(ema_params: dict[str, torch.Tensor], params: dict[str, torch.Tensor], decay: float) -> None:
    """Shadow-parameter EMA, in place: ema <- ema + (p - ema) (1 - decay),
    computed in fp32 and cast back (bf16 shadows would stop absorbing
    ~1e-3 updates)."""
    one_minus = 1.0 - torch.tensor(decay, dtype=torch.float32)
    for name, e in ema_params.items():
        e32 = e.float()
        e.copy_((e32 + (params[name].float() - e32) * one_minus.to(e.device)).to(e.dtype))


def ema_init(unet: SevaUNet) -> dict[str, torch.Tensor]:
    """EMA shadows starting at the current parameters."""
    return {n: p.detach().clone() for n, p in unet.named_parameters()}


@contextlib.contextmanager
def _holding(module: torch.nn.Module, tensors: dict[str, torch.Tensor]):
    """Put `tensors` in the place of the module's parameters of the same
    names while the context lasts."""
    saved = []
    for name, t in tensors.items():
        prefix, _, leaf = name.rpartition(".")
        owner = module.get_submodule(prefix)
        saved.append((owner, leaf, owner._parameters[leaf]))
        owner._parameters[leaf] = t
    try:
        yield
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p


@contextlib.contextmanager
def remat_blocks(unet: SevaUNet):
    """While the context lasts, every ResBlock and MultiviewTransformer of
    `unet` keeps only its inputs for the backward and recomputes its
    activations there (torch.utils.checkpoint), so the backward holds one
    block's activations at a time. The recompute runs with the tensors
    that stood in for the block's parameters during the forward (such as
    LoRA-merged weights under functional_call), so the numbers are those of
    the plain backward."""
    blocks = [m for m in unet.children() if isinstance(m, (ResBlock, MultiviewTransformer))]

    def remat_forward(block):
        fwd = block.forward

        def forward(*args):
            held = dict(block.named_parameters())
            return checkpoint(
                fwd, *args, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(), _holding(block, held)),
            )

        return forward

    for block in blocks:
        block.forward = remat_forward(block)
    try:
        yield
    finally:
        for block in blocks:
            del block.forward


def make_loss_fn(
    unet: SevaUNet,
    num_frames: int,
    discretization: DDPMDiscretization | None = None,
    remat: bool = False,
) -> Callable:
    """`loss_fn(batch, draw, params=None) -> loss` through `unet` (with
    `params` in place of its parameters when given), rematerialised per
    block with `remat`."""
    discretization = discretization or DDPMDiscretization()
    registered = torch.as_tensor(discretization.registered_sigmas(), dtype=torch.float32)
    sigmas: dict[torch.device, torch.Tensor] = {}

    def loss_fn(batch: TrainBatch, draw: Draw, params=None) -> torch.Tensor:
        device = batch.latents.device
        if device not in sigmas:
            sigmas[device] = registered.to(device)
        with remat_blocks(unet) if remat else contextlib.nullcontext():
            return diffusion_loss(
                make_network_fn(unet, params), batch, draw, sigmas[device], num_frames
            )

    return loss_fn


def make_train_step(
    unet: SevaUNet,
    optimizer,
    num_frames: int,
    discretization: DDPMDiscretization | None = None,
    remat: bool = False,
    ema_decay: float | None = None,
):
    """Returns `step(batch, draw=None, ema_params=None) -> loss`: one loss,
    backward and optimizer update of `unet`'s parameters in place
    (`optimizer` is a training.optim AdamW or MultiSteps over them), and,
    with `ema_decay`, the EMA update of `ema_params` (see `ema_init`). The
    loss is the detached fp32 scalar. Without `draw`, timesteps and noise
    come from a generator on the model's device seeded with 0.

    `remat=True` recomputes each block's activations in the backward
    (`remat_blocks`) instead of holding them: the same numbers as
    `remat=False`, with the backward's activation memory cut to about one
    block's."""
    loss_fn = make_loss_fn(unet, num_frames, discretization, remat)
    default_draw: list[Draw] = []

    def step(batch: TrainBatch, draw: Draw | None = None, ema_params=None) -> torch.Tensor:
        if ema_decay is not None and ema_params is None:
            raise ValueError("a step with ema_decay needs ema_params (training.train_step.ema_init)")
        if draw is None:
            if not default_draw:
                device = next(unet.parameters()).device
                default_draw.append(torch_draw(torch.Generator(device=device).manual_seed(0)))
            draw = default_draw[0]
        loss = loss_fn(batch, draw)
        loss.backward()
        optimizer.step()
        if ema_decay is not None:
            ema_update(ema_params, dict(unet.named_parameters()), ema_decay)
        return loss.detach()

    return step


def synthetic_batch(spec, T: int, h: int, w: int, generator: torch.Generator) -> TrainBatch:
    """A random batch of the training shapes on the generator's device;
    frame 0 is the input view (masked out of the loss)."""
    dev = generator.device
    mask = torch.ones((T,), device=dev)
    mask[0] = 0.0
    concat = torch.randn((T, h, w, 7), generator=generator, device=dev) * 0.1
    return TrainBatch(
        latents=torch.randn((T, h, w, 4), generator=generator, device=dev),
        concat=concat,
        crossattn=torch.randn((T, 1, spec.context_dim), generator=generator, device=dev) * 0.1,
        dense=concat[..., 1:],
        loss_mask=mask,
    )
