"""One-shot weight conversion: the released checkpoints -> the converted cache.

Counterpart of stable_virtual_camera_tpu/apps/convert_weights.py together
with the checks of scripts/convert_released_weights.py. The inputs are the
released files:
  * `--unet`: the Seva UNet, `stabilityai/stable-virtual-camera`
    `model.safetensors`;
  * `--vae`: the SD2.1 VAE (diffusers AutoencoderKL), e.g.
    `stabilityai/stable-diffusion-2-1-base` `vae/diffusion_pytorch_model.safetensors`;
  * `--clip`: the OpenCLIP ViT-H/14 `laion2b_s32b_b79k` tower,
    `open_clip_pytorch_model.bin` (or HF transformers' names);
  * `--dust3r`: `naver/DUSt3R_ViTLarge_BaseDecoder_512_dpt`, `.pth` or
    `.safetensors`.

For each it records the file's SHA-256 in `manifest.json` (compare with the
model card before trusting the outputs), converts strictly (no key missing,
none left over), holds every converted shape to the port module's own and
counts the parameters. The output directory is the cache that
`--checkpoint_dir` of apps/cli.py and apps/train_cli.py and
`models/io.load_bundle` read: `converted_<model>.safetensors` in the port's
names and `specs.json`. A run into a directory that already holds a cache
adds to it. DUSt3R stays fp32 (the preprocessor runs it in fp32); the
others are written in `--dtype`.

  python -m stable_virtual_camera_tpu_torch.apps.convert_weights \\
      --unet model.safetensors --vae vae.safetensors \\
      --clip open_clip_pytorch_model.bin --out converted/ [--dtype bfloat16] [--device cpu]
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import torch

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models import io as mio
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec, ClipVisionTower
from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
from stable_virtual_camera_tpu_torch.models.vae import AutoEncoderKL

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sha256(path, chunk: int = 1 << 24) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def _models(dtype: torch.dtype, device):
    """model name -> (load the released file, build the module, its
    specs.json entries)."""
    from stable_virtual_camera_tpu_torch.models.dust3r import AsymmetricCroCoStereo, Dust3rSpec

    def dust3r_state(path):
        return {k: v.to(device) for k, v in mio.load_dust3r_state(path, Dust3rSpec()).items()}

    return {
        "unet": (lambda p: mio.load_seva_state(p, SevaSpec(), dtype, device),
                 lambda: SevaUNet(SevaSpec()), {"seva": SevaSpec()}),
        "vae": (lambda p: mio.load_vae_state(p, dtype, device), AutoEncoderKL, {}),
        "clip": (lambda p: mio.load_clip_state(p, ClipVisionSpec(), dtype, device),
                 lambda: ClipVisionTower(ClipVisionSpec()), {"clip": ClipVisionSpec()}),
        "dust3r": (dust3r_state, lambda: AsymmetricCroCoStereo(Dust3rSpec()), {}),
    }


def main(unet: str | None = None, vae: str | None = None, clip: str | None = None,
         dust3r: str | None = None, out: str = "converted_ckpt", dtype: str = "bfloat16",
         device="cuda") -> dict:
    """Convert the given files into the cache at `out`, one model at a time
    (on `device`, the card unless the caller passes the CPU); returns the
    manifest."""
    inputs = {"unet": unet, "vae": vae, "clip": clip, "dust3r": dust3r}
    if not any(inputs.values()):
        raise SystemExit("nothing to convert: pass at least one of --unet/--vae/--clip/--dust3r")
    if dtype not in _DTYPES:
        raise SystemExit(f"--dtype must be one of {sorted(_DTYPES)}, not {dtype!r}")
    models = _models(_DTYPES[dtype], device)
    os.makedirs(out, exist_ok=True)
    manifest_path = os.path.join(out, "manifest.json")
    manifest: dict = {"inputs": {}, "totals": {}}
    if os.path.exists(manifest_path):  # a run into an existing cache keeps the others' records
        with open(manifest_path) as f:
            manifest = json.load(f)
    manifest["dtype"] = dtype
    for name, path in inputs.items():
        if not path:
            continue
        digest = sha256(path)
        print(f"[convert] {name} sha256={digest}")
        load, build, specs = models[name]
        state = load(path)
        with torch.device("meta"):
            n = mio.check_shapes(state, build(), name)
        mio.save_converted({name: state}, out, specs=specs)
        del state
        manifest["inputs"][name] = {"path": os.path.abspath(path), "sha256": digest}
        manifest["totals"][name] = n
        print(f"[convert] {name} converted: {n:,} parameters")
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"[convert] wrote {out} (manifest.json records the inputs' hashes)")
    return manifest


if __name__ == "__main__":
    from stable_virtual_camera_tpu_torch.apps.cli import _parse_argv

    main(**_parse_argv(sys.argv[1:]))
