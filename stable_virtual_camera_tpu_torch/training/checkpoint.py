"""Train-state checkpoint / resume: parameters, optimizer state, step and
EMA shadows in one `torch.save` file.

Counterpart of stable_virtual_camera_tpu/training/checkpoint.py (orbax
there): the same fixed 4-tuple on restore and the same overwrite-in-place
semantics (periodic saves to one path replace the previous save; the file is
written beside it and renamed over it, so a crash mid-save leaves the
previous checkpoint intact). Restoring needs no template: torch optimizers
load their state from a plain `state_dict`.
"""

from __future__ import annotations

import os

import torch


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_train_state(path: str, params: dict, opt_state: dict, step: int, ema_params=None) -> None:
    """Write `params` (name -> tensor, or a LoRA adapter dict), the
    optimizer's `state_dict()`, the step counter and (optionally) the EMA
    shadows to `path`, replacing what was there."""
    payload = {"params": _cpu(params), "opt_state": _cpu(opt_state), "step": int(step)}
    if ema_params is not None:
        payload["ema_params"] = _cpu(ema_params)
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str):
    """Returns the fixed 4-tuple (params, opt_state, step, ema_params);
    ema_params is None for checkpoints saved without an EMA, so caller arity
    never depends on checkpoint contents. Tensors land on the CPU; copying
    them into the parameters and `load_state_dict` move them to the device."""
    payload = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return payload["params"], payload["opt_state"], payload["step"], payload.get("ema_params")
