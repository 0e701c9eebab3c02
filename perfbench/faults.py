"""Faults planted in the program under the timed path, for the readings
that show what the comparison catches (`control.py --fault`, and the CPU
tests). Each is a context manager that patches one function of the port
and restores it on exit:

  state_unchanged   the sampler's Euler step returns its state unchanged
                    (render), or AdamW keeps its state (fine-tune)
  half_batch        the UNet computes only the unconditional half of the
                    CFG batch (render), or the loss keeps half the frames
                    and means over them (fine-tune)
  altered           an output altered where it is produced: a decoded
                    frame (render), a frame's VAE latents (fine-tune)
  update_doubled    AdamW applies twice the schedule's learning rate
                    (fine-tune): an update of the wrong size
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _euler_unchanged(step):
    def unchanged(network_fn, x, *args, **kwargs):
        step(network_fn, x, *args, **kwargs)
        return x
    return unchanged


def _adamw_unchanged(_step):
    def unchanged(self):
        self.opt.zero_grad(set_to_none=True)
    return unchanged


def _adamw_doubled(step):
    def doubled(self):
        # the schedule sets each update's rate afresh after the step
        for group in self.opt.param_groups:
            group["lr"] *= 2
        step(self)
    return doubled


def _unet_half(forward):
    def half(self, x, t, context, dense, num_frames, **kwargs):
        n = x.shape[0] // 2
        out = forward(self, x[:n], t[:n], context[:n], dense[:n], num_frames, **{**kwargs, "film": None})
        return torch.cat([out, out])
    return half


def _loss_half(loss):
    from stable_virtual_camera_tpu_torch.training.train_step import TrainBatch

    def half(network_fn, batch, *args, **kwargs):
        mask = batch.loss_mask.clone()
        mask[mask.shape[0] // 2:] = 0
        return loss(network_fn, TrainBatch(batch.latents, batch.concat, batch.crossattn, batch.dense, mask),
                    *args, **kwargs)
    return half


def _decoded_altered(forward):
    def altered(self, z):
        out = forward(self, z).clone()
        out[0] += 0.5
        return out
    return altered


def _latents_altered(build):
    def altered(*args, **kwargs):
        batch = build(*args, **kwargs)
        batch.latents[0] += 0.5
        return batch
    return altered


# (fault, driver) -> (module path, attribute, the patch)
TABLE = {
    ("state_unchanged", "render"): ("sampling.sampler", "euler_edm_step", _euler_unchanged),
    ("state_unchanged", "finetune"): ("training.optim:AdamW", "step", _adamw_unchanged),
    ("half_batch", "render"): ("models.unet:SevaUNet", "forward", _unet_half),
    ("half_batch", "finetune"): ("training.train_step", "diffusion_loss", _loss_half),
    ("altered", "render"): ("models.vae:VaeDecoder", "forward", _decoded_altered),
    ("altered", "finetune"): ("training.data", "train_batch_from_values", _latents_altered),
    ("update_doubled", "finetune"): ("training.optim:AdamW", "step", _adamw_doubled),
}
def faults_of(driver: str) -> list[str]:
    """The faults that a cell of `driver` can have."""
    return [f for f, d in TABLE if d == driver]


def plant(fault: str, driver: str):
    """The context manager of `fault` for a cell of `driver`."""
    import importlib

    path, name, patch = TABLE[fault, driver]
    module, _, cls = path.partition(":")
    owner = importlib.import_module(f"stable_virtual_camera_tpu_torch.{module}")
    return _patched(getattr(owner, cls) if cls else owner, name, patch)
