"""CLI: ahead-of-time export of the denoise step for deployment.

Counterpart of stable_virtual_camera_tpu/apps/export_artifacts.py. Builds
the model bundle (converted weights or --random_model) on the card unless
`--device cpu` is given, and exports one `torch.export` step program per T
shape bucket plus a pinning manifest (models/export.py), ready for
`apps.server --artifact_dir`. The program runs on the device type it was
exported on, and computes in bf16 or fp32 as the bundle does (no --quant,
as in JAX).

  python -m stable_virtual_camera_tpu_torch.apps.export_artifacts \\
      --checkpoint_dir ckpts/ --out_dir artifacts/ \\
      [--num_steps 50] [--T "[21]"] [--H 576] [--W 576] [--attention flash]
  python -m stable_virtual_camera_tpu_torch.apps.export_artifacts \\
      --random_model full --out_dir artifacts/ --num_steps 50
"""

from __future__ import annotations

import sys


def main(
    out_dir,
    checkpoint_dir=None,
    random_model=False,
    H=None,
    W=None,
    T=None,
    num_steps=50,
    device="cuda",
    attention=None,
):
    from stable_virtual_camera_tpu_torch.apps.cli import _build_bundle
    from stable_virtual_camera_tpu_torch.config import VersionConfig
    from stable_virtual_camera_tpu_torch.models.export import export_denoise_buckets

    bundle, is_tiny = _build_bundle(checkpoint_dir, random_model, device, attention)
    version = VersionConfig(H=64, W=64, T=bundle.spec.num_frames) if is_tiny else VersionConfig()
    if H is not None:
        version.H = int(H)
    if W is not None:
        version.W = int(W)
    if T is not None:
        version.T = [int(x) for x in T] if isinstance(T, list) else int(T)
    export_denoise_buckets(
        bundle,
        bundle.spec,
        (version.H // version.f, version.W // version.f),
        version.T,
        int(num_steps),
        out_dir,
        device=device,
    )
    print(f"[export] wrote manifest + buckets to {out_dir}")


if __name__ == "__main__":
    from stable_virtual_camera_tpu_torch.apps.cli import _parse_argv

    main(**_parse_argv(sys.argv[1:]))
