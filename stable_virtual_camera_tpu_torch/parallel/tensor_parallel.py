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

W8A8 (ops/quant.py) under tensor parallelism computes GSPMD's partition of
JAX's int8 `dot_general` with `preferred_element_type=int32`
(`w8a8_linear`, `w8a8_conv`). Activations are whole on every rank,
so activation scales are the whole input's (per row, per sample for a
conv, or the calibrated per-tensor abs-max):
  * an output-sharded layer quantizes its weight rows over their full
    input, runs the int8 product and the rescale on its channels, then
    gathers them;
  * an input-sharded layer quantizes its slice of x and its weight shard
    with the scales of the whole weight (the dynamic mode's per-channel
    abs-max of the whole weight is taken once, at `shard_unet`, as
    `tp_amax`), and all-reduces the int32 partial products (exact, so the
    order does not matter) before the one rescale and the bias.
Every W8A8 layer's output is therefore bit-equal to the unsharded layer's
on the same device. A conv's im2col product cuts the input channels before
flattening the taps, so a shard's columns are its own channels. Static
W8A8 calibrates the whole UNet once, unsharded (the calibration forward
never runs on shards; JAX's GSPMD calibration may round `ax` otherwise in
the last bits), and `shard_unet` cuts each site's frozen int8 weight along
the layer's sharded dimension and its weight scales along the output where
the output is sharded; the activation abs-max stays whole.
"""

from __future__ import annotations

import contextlib
import copy
import threading

import torch
import torch.nn.functional as F
from torch import nn

from stable_virtual_camera_tpu_torch.ops.quant import (
    _MIN_SCALE,
    _QMAX,
    _finish,
    _int8_conv,
    _rescale,
    _round_to_int8,
    int8_matmul,
    quantize_persample,
    quantize_rowwise,
    quantize_static,
    quantized_conv,
    quantized_conv_static,
    quantized_dense,
    quantized_dense_static,
)
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


def _weight_amax(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel abs-max of a weight (out first), the statistic
    ops/quant.py's weight scales come from."""
    return torch.linalg.vector_norm(w.float(), ord=float("inf"), dim=tuple(range(1, w.dim())), keepdim=True)


def _w8a8_product(site, x: torch.Tensor, weight: torch.Tensor, conv, tp_dim: int, comm) -> torch.Tensor:
    """The rescaled fp32 W8A8 product of x (whole: (M, K) for a dense layer,
    NHWC for a conv) with `weight`, this rank's shard (out first), before
    the bias, in `site`'s mode. With `tp_dim` 0 its rows are this rank's
    output channels; with 1 its columns (input channels) are this rank's
    slice, and the int32 partial products are all-reduced. The operations,
    and so the bits, are those of ops/quant.py's unsharded forms."""
    view = (1, 1, 1, -1) if conv else (1, -1)
    if site.quant == "w8a8":
        xq, sx = quantize_persample(x) if conv else quantize_rowwise(x)
        amax = site.tp_amax if tp_dim == 1 else _weight_amax(weight)
        sw = torch.clamp(amax, min=_MIN_SCALE) / _QMAX
        wq, scales = _round_to_int8(weight.float() / sw), (sx, sw.reshape(view))
    else:
        wq, ws, ax = site.qsite.frozen()
        xq, sx = quantize_static(x, ax)
        scales = (sx * ws.reshape(view),)
    if tp_dim == 1:
        xq = _in_slice(xq, -1, comm)
    acc = _int8_conv(xq, wq, *conv) if conv else int8_matmul(xq, wq)
    if tp_dim == 1:
        acc = comm.all_reduce(acc)
    return _rescale(acc, *scales)


def w8a8_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A QuantLinear's W8A8 forward ("w8a8" or "w8a8-static"), on the
    layer's shard when it has one and a model group is set."""
    comm = _group(layer)
    if comm is None:
        if layer.quant == "w8a8":
            return quantized_dense(x, layer.weight, layer.bias)
        return quantized_dense_static(x, *layer.qsite.frozen(), bias=layer.bias)
    lead = x.shape[:-1]
    y = _w8a8_product(layer, x.reshape(-1, x.shape[-1]), layer.weight, None, layer.tp_dim, comm)
    bias = _bias_slice(layer.bias, comm) if layer.tp_dim == 0 else layer.bias
    y = _finish(y, bias, x.dtype).reshape(*lead, -1)
    return _gather(y, -1, comm) if layer.tp_dim == 0 else y


def w8a8_conv(layer, x: torch.Tensor, stride: int, padding: int, site=None, weight=None,
              bias=True, gather: bool = True) -> torch.Tensor:
    """A W8A8 conv's forward on NHWC x ("w8a8" or "w8a8-static" of `site`,
    the layer itself unless given), on the layer's shard when it has one and
    a model group is set. `weight` (the layer's own unless given) is the
    OIHW kernel the site quantizes, a function of the layer's shard (the
    Upsample's rearranged kernel); `bias` False leaves the bias out, and
    `gather` False leaves an output-sharded result on this rank's channels."""
    site = layer if site is None else site
    weight = layer.weight if weight is None else weight
    bias = layer.bias if bias is True else None
    comm = _group(layer)
    if comm is None:
        if site.quant == "w8a8":
            return quantized_conv(x, weight, bias, stride, padding)
        return quantized_conv_static(x, *site.qsite.frozen(), bias=bias, stride=stride, padding=padding)
    y = _w8a8_product(site, x, weight, (stride, padding), layer.tp_dim, comm)
    if layer.tp_dim == 0:
        y = _finish(y, _bias_slice(bias, comm), x.dtype)
        return _gather(y, -1, comm) if gather else y
    return _finish(y, bias, x.dtype)


def local_bias(layer, bias):
    """The part of `bias` that matches this rank's output channels of
    `layer` (all of it unless the layer is output-sharded under a group)."""
    comm = _group(layer)
    return _bias_slice(bias, comm) if comm is not None and layer.tp_dim == 0 else bias


def gather_channels(layer, y: torch.Tensor) -> torch.Tensor:
    """y's channels (last dim) gathered over the ranks where `layer` is
    output-sharded under a group, else y."""
    comm = _group(layer)
    return _gather(y, -1, comm) if comm is not None and layer.tp_dim == 0 else y


def _cut_site(site, tp_dim: int, rank: int, n: int, out_channels: int) -> None:
    """A static site's frozen int8 weight cut as its layer's weight of
    `out_channels` outputs is cut: with `tp_dim` 0 its rows of this rank's
    channels with their scales (in each phase-major group of rows, for the
    Upsample's rearranged kernel of four sub-pixel phases), with 1 its input
    columns; the activation abs-max stays whole."""
    if tp_dim == 0:
        size = out_channels // n

        def cut(t):
            return t.unflatten(0, (-1, out_channels)).narrow(1, rank * size, size).flatten(0, 1).clone()

        site.wq, site.ws = cut(site.wq), cut(site.ws)
    else:
        size = site.wq.shape[1] // n
        site.wq = site.wq.narrow(1, rank * size, size).clone()


def shard_unet(unet: nn.Module, rank: int, n: int, device) -> nn.Module:
    """Rank `rank` of `n`'s shard module of `unet` on `device`: every
    kernel (2-D or 4-D weight) that `param_sharding`'s rule shards holds
    this rank's slice and its layer's `tp_dim` says which dimension; every
    other parameter is whole (param_sharding.shard_tree's cut of the 1-D
    ones goes unused). The unsharded kernels are not copied twice: the copy
    takes the shards in their place.

    W8A8: an input-sharded quantized layer gets `tp_amax`, its whole
    weight's per-output-channel abs-max; a static site's frozen int8 weight
    and scales are cut as the layer's weight is (`_cut_site`). The
    calibration mode refuses: calibration runs on the whole UNet."""
    if getattr(unet, "quant", "0") == "w8a8-calib":
        raise ValueError("w8a8-calib runs on the whole UNet: calibrate before sharding it")
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
    names = {m: name for name, m in unet.named_modules()}
    for name, module in unet.named_modules():
        tp_dim = dims.get(names[module.sharded_layer]) if hasattr(module, "quant_weight") else None
        if tp_dim is None:
            continue
        copied = shard.get_submodule(name)
        if tp_dim == 1:
            with torch.no_grad():
                copied.tp_amax = _weight_amax(module.quant_weight()).to(device)
        if copied.site() is not None:
            _cut_site(copied.site(), tp_dim, rank, n, module.sharded_layer.weight.shape[0])
    return shard.requires_grad_(False)
