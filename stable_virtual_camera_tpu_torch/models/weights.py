"""Bridge from the JAX package's flax parameter trees to the port's modules.

The port's modules are named after the flax tree paths, so the bridge only
flattens and converts layouts:
  * Dense `kernel` (in, out)      -> Linear `weight` (out, in)
  * Conv  `kernel` HWIO           -> Conv2d `weight` OIHW
  * ConvTranspose(transpose_kernel=True) `kernel` (kh, kw, out, in)
                                  -> ConvTranspose2d `weight` (in, out, kh, kw)
    (DUSt3R's `act1_up`/`act2_up`): the same (3, 2, 0, 1) permutation as a
    Conv, the inverse of the JAX converter's (2, 3, 1, 0). No spatial flip:
    flax and torch both define the op as the adjoint of the same
    correlation, so `flax_to_state_dict` of a JAX DUSt3R tree is the port
    module's state dict.
  * norm  `scale`                 -> `weight`
  * every other leaf (biases, CLIP embeddings and projection) as is.
Loading is strict both ways: every leaf of the tree must be consumed and
every parameter of the module filled, with matching shapes.

The static-W8A8 state, JAX's "quant" collection, crosses the bridge too
(`load_flax_quant`, `quant_to_flax_tree`): a site `{layer}_qsite` beside the
layer's params in JAX is the port layer's `qsite` (the Upsample's is
`conv_qsite`, the rearranged kernel's); dense `wq` (in, out) with `ws`
(1, out) is the port's (out, in) with (out,), conv `wq` HWIO with `ws`
(1, 1, 1, out) the port's OIHW with (out,), and `ax` is a scalar on both
sides. That loading is strict too, except that the temporal
self-attention's qkv/to_out sites may be absent: JAX quantizes them only
above 32 frames, so a calibration at T <= 32 never creates them.
"""

from __future__ import annotations

import re
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


# a kernel's port dimensions in flax order, by rank: the Linear weight
# (out, in) is the dense kernel (in, out), the Conv2d weight OIHW the conv
# kernel HWIO
KERNEL_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0)}


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
                t = t.permute(*KERNEL_TO_FLAX[t.dim()])
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


# sites a calibration at T <= 32 frames never reaches (JAX's time-kernel
# branch keeps these projections exact)
_OPTIONAL_SITE = re.compile(r"(^|\.)temporal_\d+\.attn1\.(qkv|to_out)$")


def _quant_layers(module: nn.Module) -> dict:
    """{JAX site path (tuple): port layer} for every quantized layer."""
    from stable_virtual_camera_tpu_torch.models.unet import Upsample, _Quantizable

    out = {}
    for name, layer in module.named_modules():
        if not isinstance(layer, _Quantizable):
            continue
        parts = tuple(name.split("."))
        key = parts + ("conv_qsite",) if isinstance(layer, Upsample) else parts[:-1] + (parts[-1] + "_qsite",)
        out[key] = (name, layer)
    return out


def _site_to_port(leaf: str, a) -> torch.Tensor:
    t = _to_torch(a)
    if leaf == "wq":
        return t.t() if t.dim() == 2 else t.permute(3, 2, 0, 1)
    return t.reshape(-1) if leaf == "ws" else t.reshape(())


def load_flax_quant(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX "quant" collection into the QuantSites of `module` (each
    made where missing) and mark them calibrated; the layers' modes are left
    as they are. Raises on a site of the tree the module lacks, a site of the
    module the tree lacks (but the optional temporal ones) or a shape that
    differs."""
    from stable_virtual_camera_tpu_torch.models.common import QuantSite

    layers = _quant_layers(module)
    flat: dict[tuple, Mapping] = {}

    def walk(node: Mapping, prefix: tuple) -> None:
        for key, val in node.items():
            if key.endswith("_qsite"):
                flat[prefix + (key,)] = val
            elif isinstance(val, Mapping):
                walk(val, prefix + (key,))
            else:
                raise KeyError(f"quant collection leaf outside a site: {'/'.join(prefix + (key,))}")

    walk(tree, ())
    unexpected = sorted("/".join(k) for k in flat.keys() - layers.keys())
    missing = sorted(layers[k][0] for k in layers.keys() - flat.keys()
                     if not _OPTIONAL_SITE.search(layers[k][0]))
    if missing or unexpected:
        raise KeyError(f"quant collection does not match {type(module).__name__}: "
                       f"missing {missing[:8]}, unexpected {unexpected[:8]}")
    with torch.no_grad():
        for key, leaves in flat.items():
            name, layer = layers[key]
            if sorted(leaves) != ["ax", "wq", "ws"]:
                raise KeyError(f"{name}: site leaves {sorted(leaves)}, expected ['ax', 'wq', 'ws']")
            site = layer.site()
            if site is None:
                layer.qsite = site = QuantSite(layer._site_shape(), device=layer.weight.device)
            for leaf in ("wq", "ws", "ax"):
                t = _site_to_port(leaf, leaves[leaf])
                dst = getattr(site, leaf)
                if tuple(t.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}.qsite.{leaf}: module shape {tuple(dst.shape)}, "
                                     f"tree shape {tuple(t.shape)}")
                dst.copy_(t)
            site.ready = True
    return module


def quant_to_flax_tree(module: nn.Module) -> dict:
    """The calibrated QuantSites of `module` as a JAX "quant" collection
    (nested dict of numpy arrays in JAX's names and layouts)."""
    out: dict = {}
    for key, (_, layer) in _quant_layers(module).items():
        site = layer.site()
        if site is None or not site.ready:
            continue
        wq = site.wq.cpu()
        wq = wq.t() if wq.dim() == 2 else wq.permute(2, 3, 1, 0)
        ws = site.ws.cpu().reshape((1,) * (wq.dim() - 1) + (-1,))
        node = out
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = {"wq": np.ascontiguousarray(wq.numpy()), "ws": ws.numpy().copy(),
                         "ax": np.asarray(site.ax.cpu().numpy())}
    return out
