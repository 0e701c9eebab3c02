"""Parameter sharding over a "model" mesh axis (tensor parallelism).

Counterpart of stable_virtual_camera_tpu/parallel/param_sharding.py. JAX's
rule shards each leaf's largest dimension that divides over the axis, ties
going to the later dimension, and replicates a leaf where no dimension
leaves `min_size` elements a shard. `partition_spec` is that rule, shape
arithmetic only: it returns a tuple with the axis name at the sharded
dimension and None elsewhere (JAX's PartitionSpec; `()` replicates).

The rule depends on layout: a flax dense kernel is (in, out) and an
nn.Linear weight (out, in), a flax conv kernel HWIO and a Conv2d weight
OIHW, so on a square layer "ties go to the later dim" picks the output in
flax and would pick the input in the port. So `tree_partition_specs`
answers in the port's layout but runs the rule on each parameter's flax
shape, through the same layout maps as models/weights.to_flax_tree
(`weights.KERNEL_TO_FLAX`): every parameter gets the logical dimension
JAX's `tree_partition_specs` gives its flax leaf.
"""

from __future__ import annotations

import torch
from torch import nn

from stable_virtual_camera_tpu_torch.models.weights import KERNEL_TO_FLAX

Spec = tuple  # one axis name or None a dimension; () replicates


def partition_spec(shape, n: int, axis_name: str, min_size: int = 2) -> Spec:
    """JAX's rule: shard the largest dimension divisible by `n` with at
    least `min_size` elements a shard (ties -> the later dimension), else
    replicate."""
    best, best_size = None, 0
    for d, s in enumerate(shape):
        if s % n == 0 and s // n >= min_size and s >= best_size:
            best, best_size = d, s
    if best is None:
        return ()
    return tuple(axis_name if i == best else None for i in range(len(shape)))


def flax_shape(name: str, shape) -> tuple[int, ...]:
    """The flax shape of the port parameter `name`: a 2-D or 4-D `weight`
    is a dense or conv kernel, every other parameter keeps its shape."""
    shape = tuple(shape)
    if name.rsplit(".", 1)[-1] == "weight" and len(shape) in KERNEL_TO_FLAX:
        return tuple(shape[d] for d in KERNEL_TO_FLAX[len(shape)])
    return shape


def param_spec(name: str, shape, n: int, axis_name: str = "model", min_size: int = 2) -> Spec:
    """The port parameter's spec in the port's layout, chosen on its flax
    shape (see the module docstring)."""
    shape = tuple(shape)
    spec = partition_spec(flax_shape(name, shape), n, axis_name, min_size)
    if not spec or name.rsplit(".", 1)[-1] != "weight" or len(shape) not in KERNEL_TO_FLAX:
        return spec
    out = [None] * len(shape)
    for flax_dim, port_dim in enumerate(KERNEL_TO_FLAX[len(shape)]):
        out[port_dim] = spec[flax_dim]
    return tuple(out)


def sharded_dim(spec: Spec) -> int | None:
    """The dimension a spec shards, or None."""
    return next((d for d, a in enumerate(spec) if a is not None), None)


def tree_partition_specs(module: nn.Module, n: int, axis_name: str = "model",
                         min_size: int = 2) -> dict[str, Spec]:
    """{parameter name: spec} over `module`'s parameters (any device,
    `meta` included)."""
    return {name: param_spec(name, p.shape, n, axis_name, min_size)
            for name, p in module.named_parameters()}


def shard_cut(name: str, shape, n: int, axis_name: str = "model",
              min_size: int = 2) -> tuple[int, int] | None:
    """(dimension, shard length) of one parameter, or None (replicated)."""
    d = sharded_dim(param_spec(name, shape, n, axis_name, min_size))
    return None if d is None else (d, shape[d] // n)


def tree_shardings(module: nn.Module, n: int, axis_name: str = "model",
                   min_size: int = 2) -> dict[str, tuple[int, int] | None]:
    """{parameter name: `shard_cut`}: what `shard_tree` cuts."""
    return {name: shard_cut(name, p.shape, n, axis_name, min_size)
            for name, p in module.named_parameters()}


def shard_tree(module: nn.Module, rank: int, n: int, axis_name: str = "model",
               min_size: int = 2) -> dict[str, torch.Tensor]:
    """Rank `rank` of `n`'s shard of every parameter the rule shards
    (contiguous copies, in the port's layout), by name."""
    out = {}
    for name, p in module.named_parameters():
        cut = shard_cut(name, p.shape, n, axis_name, min_size)
        if cut is not None:
            d, size = cut
            out[name] = p.detach().narrow(d, rank * size, size).clone(memory_format=torch.contiguous_format)
    return out
