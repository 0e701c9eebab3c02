"""Diffusion fine-tuning of the multiview UNet: loss, backward, optimizer
update, EMA, optional rematerialisation.

Counterpart of stable_virtual_camera_tpu/training/train_step.py:
discrete-timestep epsilon-prediction MSE under the model's own DDPM
discretization (the sigmas the sampler uses), with c_skip = 1,
c_out = -sigma, c_in = 1 / sqrt(sigma^2 + 1), so the network predicts
epsilon and the loss is ||net(x_sigma c_in, t, cond) - eps||^2 averaged
over the frames of the loss mask.

Where JAX threads a key, the port takes a `draw(shape) -> (t_idx, eps)`
callable: one timestep index in [0, 1000) shared by the chunk and the
unit-normal noise of the latents' shape. `torch_draw` makes one from a
`torch.Generator`; tests replay the JAX package's draws through it. Where
JAX returns new trees, the port updates the module's parameters, the
optimizer's state and the EMA tensors in place.

On a mesh (parallel/), the ranks are threads (parallel/comm.run_ranks):
  * `make_sharded_train_step`: the frames shard over "view" (JAX's batch
    sharding), the UNet runs each rank's frames with its view group, and
    params, optimizer state and EMA are replicated, one replica a rank
    (rank 0's are the module's own). Every rank takes its frames of the
    whole chunk's one draw, and its partial loss has the global loss-mask
    sum as denominator. The forward runs in the rank threads; the caller's
    thread then runs ONE backward over the union of the ranks' graphs,
    whose cross-rank exchanges are single join nodes (Comm.
    exchange_with_grad), so no exchange waits inside the autograd engine;
    the partial losses and gradients are then summed in rank order in fp32
    (Comm.all_reduce) and every rank takes the same update, so the replicas
    stay bit-equal.
  * `make_fsdp_train_step`: every parameter, AdamW moment and EMA leaf is
    cut over "data" by JAX's rule (parallel/param_sharding.py, on the flax
    shape, min_size 2, every leaf); a step gathers each rank's whole
    weights before the forward and keeps them, with their gradient, until
    its update. JAX replicates the batch over "data", so every data rank
    computes the whole gradient, and a rank keeps its own cut of it (no
    exchange over "data"). The frames still shard over "view".
"""

from __future__ import annotations

import contextlib
import copy
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
from stable_virtual_camera_tpu_torch.parallel.comm import RematRecord, run_ranks
from stable_virtual_camera_tpu_torch.parallel.param_sharding import tree_shardings
from stable_virtual_camera_tpu_torch.parallel.sharding import frames_of
from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
from stable_virtual_camera_tpu_torch.training.optim import concat_state, map_param_state, slice_state
from stable_virtual_camera_tpu_torch.utils import profiling

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
    denominator: torch.Tensor | None = None,
) -> torch.Tensor:
    """Epsilon-prediction MSE at one random discrete timestep shared by all
    frames of the chunk (the sampler denoises all T frames at one sigma).
    `denominator` (a view rank's: the whole chunk's loss-mask sum) replaces
    the batch's own, max(sum(loss_mask), 1)."""
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
    if denominator is None:
        denominator = torch.clamp(mask.sum(), min=1.0)
    return (per_frame * mask).sum() / denominator


def make_network_fn(unet: SevaUNet, params: dict[str, torch.Tensor] | None = None, group=None) -> Callable:
    """The sampler's network convention, `fn(x, concat, t_vec, crossattn,
    dense, num_frames)`, through `unet` with its own parameters or, given
    `params`, with those in their place (torch.func.functional_call); with
    a view `group`, one rank's share of the chunk (SevaUNet.forward)."""
    kw = {} if group is None else {"group": group}

    def network_fn(x, concat, t_vec, crossattn, dense, num_frames):
        args = (assemble_network_input(x, concat), t_vec, crossattn, dense, num_frames)
        if params is None:
            return unet(*args, **kw)
        return torch.func.functional_call(unet, params, args, kw, strict=False)

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
    the plain backward. A block with a view group exchanges with the other
    ranks; its recompute inside the backward replays those exchanges'
    outputs (parallel/comm.RematRecord) instead of exchanging again."""
    blocks = [m for m in unet.children() if isinstance(m, (ResBlock, MultiviewTransformer))]

    def remat_forward(block):
        fwd = block.forward

        def forward(*args, **kwargs):
            held = dict(block.named_parameters())
            record = RematRecord()

            def run(*a, **k):
                with record:
                    return fwd(*a, **k)

            return checkpoint(
                run, *args, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(), _holding(block, held)), **kwargs,
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
    backward and optimizer update of `unet`'s parameters in place (spans
    `train.step`, and in it `train.loss`, `train.backward` and the
    optimizer's `train.optimizer`)
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
        with profiling.span("train.step"):
            if draw is None:
                if not default_draw:
                    device = next(unet.parameters()).device
                    default_draw.append(torch_draw(torch.Generator(device=device).manual_seed(0)))
                draw = default_draw[0]
            with profiling.span("train.loss"):
                loss = loss_fn(batch, draw)
            with profiling.span("train.backward"):
                loss.backward()
            optimizer.step()
            if ema_decay is not None:
                ema_update(ema_params, dict(unet.named_parameters()), ema_decay)
            return loss.detach()

    return step


def make_train_step_ema(
    unet: SevaUNet,
    optimizer,
    num_frames: int,
    ema_decay: float = 0.9999,
    discretization: DDPMDiscretization | None = None,
    remat: bool = False,
):
    """JAX's named form of `make_train_step(..., ema_decay=...)`."""
    return make_train_step(unet, optimizer, num_frames, discretization, remat, ema_decay)


def _skeleton(unet: SevaUNet) -> SevaUNet:
    """A copy of `unet` whose parameters are empty `meta` tensors: the
    structure a rank runs through functional_call with its own tensors."""
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"), requires_grad=p.requires_grad)
            for p in unet.parameters()}
    return copy.deepcopy(unet, memo)


def _batch_frames(batch: TrainBatch, rank: int, n: int, device) -> TrainBatch:
    """View rank `rank` of `n`'s frames of the batch, on `device`."""
    return TrainBatch(*(frames_of(torch.as_tensor(getattr(batch, f.name)), rank, n, 1).to(device)
                        for f in fields(batch)))


def _whole_draw(batch: TrainBatch, draw: Draw):
    """The chunk's one draw and loss denominator, made once by the caller
    and cut by each rank."""
    t_idx, eps = draw(tuple(batch.latents.shape))
    t_idx = torch.as_tensor(t_idx).reshape(())
    eps = torch.as_tensor(eps)
    denominator = torch.clamp(torch.as_tensor(batch.loss_mask).float().sum(), min=1.0)
    return t_idx, eps, denominator


class _RankState:
    """One rank's training state: the structure it runs, its parameters (a
    replica or its shards), its optimizer over them and its EMA tensors."""

    def __init__(self, skeleton, params: dict, optimizer, ema: dict | None):
        self.skeleton = skeleton
        self.params = params
        self.optimizer = optimizer
        self.ema = ema


class _MeshTrainStep:
    """What the sharded and the FSDP step share: the draw and the forward of
    a rank's frames through its weights (the caller then runs one backward
    over every rank's graph)."""

    def __init__(self, unet, optimizer, num_frames, mesh, discretization, remat, ema_decay):
        if [id(p) for p in optimizer.params] != [id(p) for p in unet.parameters()]:
            raise ValueError("a mesh train step takes an optimizer over the UNet's parameters, in order")
        self.unet, self.optimizer, self.mesh = unet, optimizer, mesh
        self.num_frames, self.remat, self.ema_decay = num_frames, remat, ema_decay
        self.n_view = mesh.shape["view"]
        if num_frames % self.n_view:
            raise ValueError(f"num_frames={num_frames} must divide over the view axis ({self.n_view})")
        discretization = discretization or DDPMDiscretization()
        self.registered = torch.as_tensor(discretization.registered_sigmas(), dtype=torch.float32)
        self.names = [n for n, _ in unet.named_parameters()]
        self.default_draw: list[Draw] = []

    def _draw(self, draw):
        if draw is None:
            if not self.default_draw:
                device = next(self.unet.parameters()).device
                self.default_draw.append(torch_draw(torch.Generator(device=device).manual_seed(0)))
            draw = self.default_draw[0]
        return draw

    def _loss(self, ctx, st: _RankState, weights: dict, batch, drawn) -> torch.Tensor:
        """This rank's partial loss: its frames through `weights`."""
        t_idx, eps, denominator = drawn
        n, dev = self.n_view, ctx.device
        local = _batch_frames(batch, ctx.view, n, dev)
        eps_r = frames_of(eps, ctx.view, n, 1).to(dev)
        network = make_network_fn(st.skeleton, weights, ctx.comm if n > 1 else None)
        with remat_blocks(st.skeleton) if self.remat else contextlib.nullcontext():
            return diffusion_loss(network, local, lambda shape: (t_idx.to(dev), eps_r),
                                  self.registered.to(dev), self.num_frames // n, denominator.to(dev))


class ShardedTrainStep(_MeshTrainStep):
    """`step(batch, draw=None, ema_params=None) -> loss`, as `make_train_step`'s,
    with the frames over the mesh's "view" axis on its first data row (the
    other rows would repeat its work: JAX replicates the batch over "data").
    `replicas` holds every rank's state, made from the module, optimizer and
    EMA at the first call (so a resume before it is taken up)."""

    def __init__(self, unet, optimizer, num_frames, mesh, discretization=None, remat=False,
                 ema_decay=None):
        super().__init__(unet, optimizer, num_frames, mesh, discretization, remat, ema_decay)
        self.replicas: list[_RankState] = []

    def _replicate(self, ema_params) -> None:
        own = dict(self.unet.named_parameters())
        self.replicas = [_RankState(_skeleton(self.unet), own, self.optimizer, ema_params)]
        opt_state = self.optimizer.state_dict()
        for v in range(1, self.n_view):
            dev = self.mesh.device(self.mesh.rank(0, v))
            params = {n: p.detach().to(dev, copy=True).requires_grad_(p.requires_grad) for n, p in own.items()}
            opt = self.optimizer.replicate(list(params.values()))
            opt.load_state_dict(opt_state)
            ema = None if ema_params is None else {n: e.detach().to(dev, copy=True) for n, e in ema_params.items()}
            self.replicas.append(_RankState(_skeleton(self.unet), params, opt, ema))

    def loss_and_grads(self, batch: TrainBatch, draw: Draw | None = None, ema_params=None) -> torch.Tensor:
        """The loss, with the whole gradient (summed over the ranks) left in
        every replica's `.grad`, before any update."""
        if not self.replicas:
            self._replicate(ema_params)
        drawn = _whole_draw(batch, self._draw(draw))
        losses = run_ranks(self.mesh, lambda ctx: self._loss(ctx, self.replicas[ctx.view],
                                                             self.replicas[ctx.view].params, batch, drawn),
                           rows=[0])
        torch.autograd.backward(losses)

        def reduce(ctx):
            params = self.replicas[ctx.view].params
            for p in params.values():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = ctx.comm.all_reduce(g)
            return ctx.comm.all_reduce(losses[ctx.view].detach().float())

        return run_ranks(self.mesh, reduce, rows=[0])[0]

    def apply(self) -> None:
        """Every rank's optimizer update (and EMA) from the gradients
        `loss_and_grads` left."""

        def update(ctx):
            st = self.replicas[ctx.view]
            st.optimizer.step()
            if self.ema_decay is not None:
                ema_update(st.ema, st.params, self.ema_decay)

        run_ranks(self.mesh, update, rows=[0])

    def __call__(self, batch: TrainBatch, draw: Draw | None = None, ema_params=None) -> torch.Tensor:
        if self.ema_decay is not None and ema_params is None:
            raise ValueError("a step with ema_decay needs ema_params (training.train_step.ema_init)")
        loss = self.loss_and_grads(batch, draw, ema_params)
        self.apply()
        return loss


def make_sharded_train_step(
    unet: SevaUNet,
    optimizer,
    num_frames: int,
    mesh,
    discretization: DDPMDiscretization | None = None,
    remat: bool = False,
    ema_decay: float | None = None,
) -> ShardedTrainStep:
    """JAX's `make_sharded_train_step` (`training/train_step.py:194`): the
    batch's frames over the mesh's "view" axis, params and optimizer state
    replicated; `step(batch, draw=None, ema_params=None) -> loss` updates
    `unet`'s parameters (rank 0's replica), `optimizer` and `ema_params`
    in place, as `make_train_step`'s step."""
    return ShardedTrainStep(unet, optimizer, num_frames, mesh, discretization, remat, ema_decay)


def _restrided(t: torch.Tensor, stride: tuple[int, ...]) -> torch.Tensor:
    """t with exactly these strides (a copy where its own differ)."""
    if t.stride() == tuple(stride):
        return t
    return torch.empty_strided(t.shape, stride, dtype=t.dtype, device=t.device).copy_(t)


class FsdpState:
    """The FSDP step's state: `ranks[r]` is rank r's shards of every
    parameter (whole where the rule cuts none), its optimizer over them and
    its EMA shards; `cuts` the rule's (dim, shard length) by parameter."""

    def __init__(self, ranks: list[_RankState], cuts: dict, names: list[str], n_view: int):
        self.ranks, self.cuts, self.names, self.n_view = ranks, cuts, names, n_view

    def _rows(self) -> list[_RankState]:
        """View rank 0 of each data row, in data order."""
        return self.ranks[:: self.n_view]

    def _whole(self, tensors: list[dict]) -> dict:
        out = {}
        for n in self.names:
            cut = self.cuts[n]
            parts = [t[n].detach() for t in tensors]
            out[n] = parts[0] if cut is None else torch.cat([p.to(parts[0].device) for p in parts], cut[0])
        return out

    def params(self) -> dict[str, torch.Tensor]:
        """The whole parameters, gathered from the data rows' shards."""
        return self._whole([st.params for st in self._rows()])

    def ema(self) -> dict[str, torch.Tensor] | None:
        rows = self._rows()
        return None if rows[0].ema is None else self._whole([st.ema for st in rows])

    def optimizer_state(self) -> dict:
        """The whole optimizer `state_dict()`, in the unsharded format."""
        cuts = [self.cuts[n] for n in self.names]
        return concat_state([st.optimizer.state_dict() for st in self._rows()], cuts)

    def persistent_bytes(self, rank: int) -> int:
        """The bytes rank `rank` keeps between steps: its parameter shards,
        its optimizer's tensors and its EMA shards."""
        st = self.ranks[rank]
        total = sum(t.numel() * t.element_size() for t in st.params.values())
        total += sum(t.numel() * t.element_size() for t in (st.ema or {}).values())
        state = st.optimizer.state_dict()
        seen: list[torch.Tensor] = []
        map_param_state(state, lambda i, t: seen.append(t) or t)
        return total + sum(t.numel() * t.element_size() for t in seen)


class FsdpTrainStep(_MeshTrainStep):
    """`init(ema_params=None) -> FsdpState` cuts the module's parameters, the
    optimizer's state and the EMA over the mesh's "data" axis;
    `step(state, batch, draw=None) -> loss` runs one step on it."""

    def __init__(self, unet, optimizer, num_frames, mesh, discretization=None, remat=False,
                 ema_decay=None):
        super().__init__(unet, optimizer, num_frames, mesh, discretization, remat, ema_decay)
        self.n_data = mesh.shape["data"]
        self.cuts = tree_shardings(unet, self.n_data, "data")
        self.strides = {n: p.stride() for n, p in unet.named_parameters()}

    def _cut(self, t: torch.Tensor, name: str, d: int, device) -> torch.Tensor:
        cut = self.cuts[name]
        t = t.detach()
        if cut is not None:
            dim, size = cut
            t = t.narrow(dim, d * size, size)
        return t.to(device, copy=True, memory_format=torch.contiguous_format)

    def init(self, ema_params=None) -> FsdpState:
        if self.ema_decay is not None and ema_params is None:
            raise ValueError("an FSDP step with ema_decay needs ema_params (training.train_step.ema_init)")
        whole = dict(self.unet.named_parameters())
        opt_state = self.optimizer.state_dict()
        cuts = [self.cuts[n] for n in self.names]
        ranks = []
        for r in range(self.mesh.size):
            d = self.mesh.coords(r)[0]
            dev = self.mesh.device(r)
            params = {n: self._cut(p, n, d, dev).requires_grad_(p.requires_grad) for n, p in whole.items()}
            opt = self.optimizer.replicate(list(params.values()))
            opt.load_state_dict(slice_state(opt_state, cuts, d))
            ema = None if ema_params is None else {n: self._cut(e, n, d, dev) for n, e in ema_params.items()}
            ranks.append(_RankState(_skeleton(self.unet), params, opt, ema))
        return FsdpState(ranks, self.cuts, self.names, self.n_view)

    def _gather(self, ctx, st: _RankState) -> dict:
        """This rank's whole weights, gathered from the data ranks' shards
        (leaves that take the gradient), each with the module's own strides:
        the convs' weights are channels_last, and cuDNN picks its algorithm
        by the weight's strides (those of size-1 dims too, as a 1x1 conv's
        have), so only the same strides give the unsharded module's bits."""
        out = {}
        for n, shard in st.params.items():
            cut = self.cuts[n]
            if cut is None:
                w = shard.detach()
            else:
                w = torch.cat(ctx.data_comm.all_gather(shard.detach()), dim=cut[0])
            out[n] = _restrided(w, self.strides[n]).requires_grad_(shard.requires_grad)
        return out

    def loss_and_grads(self, state: FsdpState, batch: TrainBatch, draw: Draw | None = None) -> torch.Tensor:
        """The loss, with each rank's share of the gradient left in its
        shards' `.grad`: its cut of the whole gradient it computed itself.
        Every data rank runs the same frames with the same draw (JAX
        replicates the batch over "data"), so each already holds the whole
        gradient and no exchange over "data" is needed; a reduce-scatter
        sum would count it n_data times."""
        drawn = _whole_draw(batch, self._draw(draw))
        gathered: dict[int, dict] = {}

        def forward(ctx):
            st = state.ranks[ctx.rank]
            with torch.no_grad():
                gathered[ctx.rank] = self._gather(ctx, st)
            return self._loss(ctx, st, gathered[ctx.rank], batch, drawn)

        losses = run_ranks(self.mesh, forward)
        torch.autograd.backward(losses)

        def reduce(ctx):
            st = state.ranks[ctx.rank]
            for n, shard in st.params.items():
                w = gathered[ctx.rank][n]
                g = w.grad if w.grad is not None else torch.zeros_like(w)
                if self.n_view > 1:
                    g = ctx.comm.all_reduce(g)
                cut = self.cuts[n]
                if cut is not None:
                    dim, size = cut
                    g = g.narrow(dim, ctx.data * size, size)
                # a copy of the cut, so the whole gradient can go
                shard.grad = g.to(shard.dtype, copy=True, memory_format=torch.contiguous_format)
            gathered[ctx.rank] = None
            loss = losses[ctx.rank].detach().float()
            return ctx.comm.all_reduce(loss) if self.n_view > 1 else loss

        with torch.no_grad():
            return run_ranks(self.mesh, reduce)[0]

    def apply(self, state: FsdpState) -> None:
        """Every rank's optimizer update (and EMA) of its shards from the
        gradients `loss_and_grads` left."""

        def update(ctx):
            st = state.ranks[ctx.rank]
            st.optimizer.step()
            if self.ema_decay is not None:
                ema_update(st.ema, st.params, self.ema_decay)

        run_ranks(self.mesh, update)

    def __call__(self, state: FsdpState, batch: TrainBatch, draw: Draw | None = None) -> torch.Tensor:
        loss = self.loss_and_grads(state, batch, draw)
        self.apply(state)
        return loss


def make_fsdp_train_step(
    unet: SevaUNet,
    optimizer,
    num_frames: int,
    mesh,
    discretization: DDPMDiscretization | None = None,
    remat: bool = False,
    ema_decay: float | None = None,
):
    """JAX's `make_fsdp_train_step` (`training/train_step.py:248`): returns
    `(step, init)`. `init(ema_params=None)` cuts `unet`'s current
    parameters, `optimizer`'s state (over `unet.parameters()`, fresh or
    restored) and the EMA over the mesh's "data" axis into an `FsdpState`;
    `step(state, batch, draw=None) -> loss` updates it in place. The
    state's `params()`, `optimizer_state()` and `ema()` give the whole
    trees a checkpoint holds. The leaves shard over "data" with JAX's
    defaults (`shard_axis="data"`, `min_size=2`), which no caller changes."""
    step = FsdpTrainStep(unet, optimizer, num_frames, mesh, discretization, remat, ema_decay)
    return step, step.init


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
