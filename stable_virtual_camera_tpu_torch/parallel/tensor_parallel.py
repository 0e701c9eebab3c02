"""Tensor parallelism over a "model" mesh axis: the UNet's layers on weight
shards.

JAX gets tensor parallelism from GSPMD: `tree_shardings` annotates every
weight over the axis (parallel/param_sharding.py) and XLA partitions each
product and inserts the collectives (parallel/sharding.py:144-196,
sampling/sampler.py:417-424). The port writes the partition out, layer by
layer, on each rank's shards:
  * a dense or conv layer whose OUTPUT dimension is sharded computes its
    local product (with its slice of the bias) and all-gathers the channel
    slices, in rank order, into the whole activation;
  * one whose INPUT dimension is sharded computes a partial product on its
    slice of the input channels, all-reduces it (parallel/comm.py: in rank
    order in fp32, so every rank holds the same bits) and adds the bias
    once.
Every activation between layers is whole on every rank, so the attention
and the temporal mix run unchanged, kernels K1 and K2 included, at full
heads on every rank; a shard boundary of the fused qkv (3 x heads x 64
channels, 5 heads at level 0) never splits a head that attention sees.
Pairing a column-sharded layer with the row-sharded one after it, with no
gather between them (Megatron's form), is not done here.

Storage differs from JAX's in one way: the one-dimensional parameters
(norm scales and biases, 650 of the full UNet's 1018 leaves and under 0.1%
of its bytes) are held whole on every rank instead of sharded, so no
forward gathers them; each rank holds 1/n of every kernel the rule shards.

A rank's shard module (`shard_unet`) is a copy of the UNet whose sharded
kernels hold the rank's shard and whose layers know the sharded dimension
(`tp_dim`: 0, the output, or 1, the input, in the port's layout). The
model group's Comm reaches the layers through `model_group`, a
thread-local context that SevaUNet.forward(..., model_group=) enters:
rank threads each run their own forward. Without a group, or with one of
size 1, every layer computes as an unsharded one.

W8A8 under tensor parallelism is refused: the dynamic mode's per-row
activation scales and per-channel weight scales of an input-sharded layer
would need a cross-rank maximum before the int8 product, so the port's
sharded layers would not compute JAX's function (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import contextlib
import copy
import threading

import torch
import torch.nn.functional as F
from torch import nn

from stable_virtual_camera_tpu_torch.parallel.param_sharding import shard_tree, tree_shardings

_local = threading.local()


@contextlib.contextmanager
def model_group(comm):
    """Run the layers of shard modules on this thread with `comm` as their
    model group (None: unsharded)."""
    prev = getattr(_local, "comm", None)
    _local.comm = comm
    try:
        yield
    finally:
        _local.comm = prev


def _group(layer):
    """The model group of a sharded layer, or None to compute it whole."""
    comm = getattr(_local, "comm", None)
    if getattr(layer, "tp_dim", None) is None or comm is None:
        return None
    return comm


def _in_slice(x: torch.Tensor, dim: int, comm) -> torch.Tensor:
    """This rank's slice of x's channels on `dim`."""
    size = x.shape[dim] // comm.size
    return x.narrow(dim, comm.rank * size, size)


def _bias_slice(bias, comm):
    return None if bias is None else _in_slice(bias, 0, comm)


def _gather(y: torch.Tensor, dim: int, comm) -> torch.Tensor:
    return torch.cat(comm.all_gather(y), dim=dim)


def _reduce_add(y: torch.Tensor, bias, comm) -> torch.Tensor:
    y = comm.all_reduce(y)
    return y if bias is None else y + bias.to(y.dtype)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`F.linear(x, layer.weight, layer.bias)`, on the layer's shard when it
    has one and a model group is set."""
    comm = _group(layer)
    if comm is None:
        return F.linear(x, layer.weight, layer.bias)
    if layer.tp_dim == 0:
        return _gather(F.linear(x, layer.weight, _bias_slice(layer.bias, comm)), -1, comm)
    return _reduce_add(F.linear(_in_slice(x, -1, comm), layer.weight), layer.bias, comm)


def matmul_channels_first(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer.weight @ x^T` for x (B, S, C_in): the (B, C_out, S) layout
    the temporal kernel reads (no bias), on the layer's shard. Its one
    caller is the fused qkv, whose output (3 x its input) is the larger
    dimension and divides wherever the input does, so the rule shards the
    output or nothing."""
    y = torch.matmul(layer.weight, x.transpose(1, 2))
    comm = _group(layer)
    return y if comm is None else _gather(y, 1, comm)


def conv(layer, x: torch.Tensor, fn) -> torch.Tensor:
    """`fn(x, layer.weight, layer.bias)` for an NHWC conv `fn` (OIHW
    weight), on the layer's shard when it has one and a model group is
    set."""
    comm = _group(layer)
    if comm is None:
        return fn(x, layer.weight, layer.bias)
    if layer.tp_dim == 0:
        return _gather(fn(x, layer.weight, _bias_slice(layer.bias, comm)), -1, comm)
    return _reduce_add(fn(_in_slice(x, -1, comm), layer.weight, None), layer.bias, comm)


def shard_unet(unet: nn.Module, rank: int, n: int, device) -> nn.Module:
    """Rank `rank` of `n`'s shard module of `unet` on `device`: every
    kernel (2-D or 4-D weight) that `param_sharding`'s rule shards holds
    this rank's slice and its layer's `tp_dim` says which dimension; every
    other parameter is whole (param_sharding.shard_tree's cut of the 1-D
    ones goes unused). The unsharded kernels are not copied twice: the copy
    takes the shards in their place."""
    if getattr(unet, "quant", "0") != "0":
        raise NotImplementedError(
            "tensor parallelism with a W8A8 mode is not ported yet (ROADMAP queue 1, item 9)")
    cuts, shards = tree_shardings(unet, n), shard_tree(unet, rank, n)
    memo, dims = {}, {}
    for name, p in unet.named_parameters():
        if cuts[name] is not None and p.dim() >= 2:
            memo[id(p)] = nn.Parameter(shards[name].to(device), requires_grad=False)
            dims[name.rsplit(".", 1)[0]] = cuts[name][0]
    shard = copy.deepcopy(unet, memo).to(device)
    for name, layer in shard.named_modules():
        if name in dims:
            layer.tp_dim = dims[name]
    return shard.requires_grad_(False)
