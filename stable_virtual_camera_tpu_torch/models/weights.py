"""Bridge from the JAX package's flax parameter trees to the port's modules.

The port's modules are named after the flax tree paths, so the bridge only
flattens and converts layouts:
  * Dense `kernel` (in, out)      -> Linear `weight` (out, in)
  * Conv  `kernel` HWIO           -> Conv2d `weight` OIHW
  * norm  `scale`                 -> `weight`
  * every other leaf (biases, CLIP embeddings and projection) as is.
Loading is strict both ways: every leaf of the tree must be consumed and
every parameter of the module filled, with matching shapes.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no numpy twin in torch
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def flax_to_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a nested flax param dict into torch names and layouts."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: tuple[str, ...]) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + (key,))
                continue
            t = _to_torch(val)
            name = key
            if key == "kernel":
                name = "weight"
                if t.dim() == 2:
                    t = t.t()
                elif t.dim() == 4:
                    t = t.permute(3, 2, 0, 1)
                else:
                    raise ValueError(f"unexpected kernel rank at {'.'.join(prefix)}: {tuple(t.shape)}")
            elif key == "scale":
                name = "weight"
            out[".".join(prefix + (name,))] = t.contiguous()

    walk(tree, ())
    return out


def to_flax_tree(module: nn.Module, like: Mapping) -> dict:
    """The inverse of `load_flax_params`: `module`'s parameters as a nested
    dict of fp32 numpy arrays with the names, nesting and layouts of the flax
    tree `like` (any tree of objects with a `.shape`, such as the output of
    `jax.eval_shape` on the JAX model's init)."""
    params = dict(module.named_parameters())

    def walk(node: Mapping, prefix: tuple[str, ...]) -> dict:
        out = {}
        for key, val in node.items():
            if isinstance(val, Mapping):
                out[key] = walk(val, prefix + (key,))
                continue
            name = ".".join(prefix + ({"kernel": "weight", "scale": "weight"}.get(key, key),))
            t = params[name].detach().float().cpu()
            if key == "kernel":
                t = t.t() if t.dim() == 2 else t.permute(2, 3, 1, 0)
            if tuple(t.shape) != tuple(val.shape):
                raise ValueError(f"{name}: module shape {tuple(t.shape)}, tree shape {tuple(val.shape)}")
            out[key] = np.ascontiguousarray(t.numpy())
        return out

    return walk(like, ())


def load_flax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax param tree into `module` (keeping the module's dtype and
    device). Raises if any leaf is left over, any parameter is missing, or a
    shape differs."""
    sd = flax_to_state_dict(tree)
    params = module.state_dict(keep_vars=True)
    missing = sorted(params.keys() - sd.keys())
    unexpected = sorted(sd.keys() - params.keys())
    if missing or unexpected:
        raise KeyError(
            f"flax tree does not match {type(module).__name__}: "
            f"missing {missing[:8]}{'...' if len(missing) > 8 else ''}, "
            f"unexpected {unexpected[:8]}{'...' if len(unexpected) > 8 else ''}"
        )
    for name, p in params.items():
        if tuple(p.shape) != tuple(sd[name].shape):
            raise ValueError(f"{name}: module shape {tuple(p.shape)}, tree shape {tuple(sd[name].shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(sd[name])
    return module
