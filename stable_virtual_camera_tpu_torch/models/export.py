"""Ahead-of-time exported denoise steps: ship a pinned program, never retrace.

Counterpart of stable_virtual_camera_tpu/models/export.py. A serving host
loads the UNet's weights and one `torch.export` program per shape bucket;
the program holds the traced step (one CFG-doubled UNet forward through the
kernels' custom ops, the replace conditioning, CFG blending and the Euler
update), so the served arithmetic is the one that was exported and checked,
whatever Python model code the host has.

JAX exports the whole 50-step `lax.scan` as one program. `torch.export` has
no scan, and 50 unrolled full-width forwards would make a graph 50 times
the UNet's, so the program here is ONE step of `sampling/sampler.py`'s
`euler_edm_step` and the loop over steps stays on the host (`run_steps`),
which keeps per-step progress and abort on both routes. Buckets are still
keyed by (T, h, w, steps), as in JAX.

Weights are NOT baked in: the program's signature is
`(params, x, eps, scalars, t_index, crossattn, concat, dense, replace,
scale) -> x_next`, where `params` is the UNet's tensors in the sorted order
of their names, run through `torch.func.functional_call`. The wrapper that
is exported holds the UNet outside `nn.Module` registration, so
`torch.export` lifts none of its parameters, and one artifact serves any
checkpoint with the same topology. A manifest pins the fingerprint of the
parameter names, shapes and dtypes (and any W8A8 mode), the torch version
and the device type each bucket was exported for; `load_denoise_artifacts`
checks them before a bucket is used.

Export:  python -m stable_virtual_camera_tpu_torch.apps.export_artifacts \\
             --checkpoint_dir ... --out_dir artifacts/ [--num_steps 50]
Serve:   python -m stable_virtual_camera_tpu_torch.apps.server \\
             --checkpoint_dir ... --artifact_dir artifacts/
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp

import torch

from stable_virtual_camera_tpu_torch.models.unet import SevaUNet, assemble_network_input
from stable_virtual_camera_tpu_torch.sampling.sampler import (
    STEP_SCALARS,
    ChunkConditioning,
    euler_edm_step,
    run_steps,
)

MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


def unet_state(unet: SevaUNet) -> dict[str, torch.Tensor]:
    """Every tensor the UNet's forward reads: its parameters and buffers
    (under w8a8-static, the sites' int8 weights and scales too)."""
    return {**dict(unet.named_parameters()), **dict(unet.named_buffers())}


def _fingerprint(params: dict[str, torch.Tensor], quant: str = "0") -> str:
    """Stable hash of the parameter names, shapes and dtypes in sorted order
    (NOT values: artifacts are weight-independent by design), and of the
    UNet's W8A8 mode when it has one: an exported program computes in the
    mode it was traced in."""
    h = hashlib.sha256()
    for name in sorted(params):
        t = params[name]
        h.update(name.encode())
        h.update(f"{tuple(t.shape)}:{t.dtype}".encode())
    if quant != "0":
        h.update(f"quant={quant}".encode())
    return h.hexdigest()[:32]


def _bucket_file(T: int, h: int, w: int, steps: int) -> str:
    return f"denoise_T{T}_{h}x{w}_s{steps}.pt2"


class _StepProgram(torch.nn.Module):
    """One step of one T bucket with tensors as its only inputs. The UNet
    sits in `__dict__`, not among the submodules, so nothing of it is a
    parameter or buffer of the exported program."""

    def __init__(self, unet: SevaUNet, names: list[str], num_frames: int):
        super().__init__()
        self.__dict__["unet"] = unet
        self.names = names
        self.num_frames = num_frames

    def forward(self, params, x, eps, scalars, t_index, crossattn, concat, dense, replace, scale):
        state = dict(zip(self.names, params))

        def network(xin, concat_, t_vec, crossattn_, dense_, num_frames):
            return torch.func.functional_call(
                self.unet, state, (assemble_network_input(xin, concat_), t_vec, crossattn_, dense_, num_frames)
            )

        cond = ChunkConditioning(crossattn, concat, dense, replace, scale)
        return euler_edm_step(network, x, eps, scalars, cond, t_index, self.num_frames)


def _example_args(spec, params: tuple, T: int, h: int, w: int, device: torch.device) -> tuple:
    """Example inputs of the step program with the engine's dtypes and
    devices: fp32 latents and conditioning (build_chunk_conditioning) on
    the device, the step's scalars as an fp32 host tensor, the timestep
    index as a 0-d int64 on the device."""

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return (params, z(T, h, w, 4), z(T, h, w, 4), torch.zeros(len(STEP_SCALARS)),
            torch.zeros((), dtype=torch.int64, device=device),
            z(2 * T, 1, spec.context_dim), z(2 * T, h, w, spec.in_channels - 4),
            z(2 * T, h, w, spec.dense_in_channels), z(2 * T, h, w, 5), z(T))


def export_denoise_buckets(
    bundle_or_unet,
    spec,
    latent_hw: tuple[int, int],
    Ts,
    num_steps: int,
    out_dir: str,
    device="cuda",
) -> dict:
    """Export one step program per T bucket of the UNet (a ModelBundle's or
    a SevaUNet, on `device`, in its exact mode) and write the manifest.
    Traces outside `inference_mode`, with no decomposition run, so the
    program holds the ops the eager step runs."""
    unet = getattr(bundle_or_unet, "unet", bundle_or_unet)
    if unet.quant != "0":
        raise ValueError(f"export traces the exact network; the UNet is in W8A8 mode {unet.quant!r}")
    device = torch.device(device)
    state = unet_state(unet)
    names = sorted(state)
    if any(state[n].device.type != device.type for n in names):
        raise ValueError(f"the UNet's tensors are not all on {device}")
    params = tuple(state[n].detach() for n in names)
    h, w = latent_hw
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    with torch.inference_mode(False):
        for T in dict.fromkeys(int(t) for t in (Ts if isinstance(Ts, (list, tuple)) else [Ts])):
            ep = torch.export.export(_StepProgram(unet, names, T), _example_args(spec, params, T, h, w, device))
            sig = ep.graph_signature
            if sig.parameters or sig.buffers:
                raise AssertionError(f"the exported step holds weights: {sig.parameters + sig.buffers}")
            ep.example_inputs = None  # they hold the weights
            fname = _bucket_file(T, h, w, num_steps)
            torch.export.save(ep, osp.join(out_dir, fname))
            entries.append({"file": fname, "T": T, "h": h, "w": w, "steps": num_steps,
                            "device": device.type})
            print(f"[export] {fname}: device={device.type}")
    manifest = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "param_fingerprint": _fingerprint(state),
        "buckets": entries,
    }
    with open(osp.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class DenoiseArtifact:
    """A loaded bucket: the exported step program, run by the host loop,
    and a count of its calls (one a step)."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self._module = program.module()
        self.calls = 0

    def step(self, params: tuple, x, eps, scalars, t_index, cond: ChunkConditioning) -> torch.Tensor:
        self.calls += 1
        return self._module(params, x, eps, scalars, t_index, cond.crossattn, cond.concat,
                            cond.dense, cond.replace, cond.scale)

    @torch.inference_mode()
    def sample(self, unet: SevaUNet, noise, plan, cond: ChunkConditioning, step_noise,
               progress_cb=None, abort_event=None) -> torch.Tensor | None:
        """`euler_edm_sample` through the program, with the UNet's tensors
        as its weights."""
        state = unet_state(unet)
        params = tuple(state[n] for n in sorted(state))

        def step(x, eps, scalars, t_index):
            return self.step(params, x, eps, scalars, t_index, cond)

        return run_steps(step, noise, plan, step_noise, progress_cb, abort_event)


def load_denoise_artifacts(artifact_dir: str, params=None, device="cuda", quant: str = "0") -> dict:
    """Load every manifest bucket exported for `device`'s type into the
    engine's artifact map {(T, h, w, steps): DenoiseArtifact}.

    With `params` given (`unet_state` of the serving UNet, and its W8A8
    `quant` mode), refuses a model whose parameter names, shapes, dtypes or
    mode differ from the exported one (the artifact is weight-independent
    but NOT topology-independent). Buckets exported for another device type
    are skipped with a printed line instead of failing at the first call."""
    with open(osp.join(artifact_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"artifact format {manifest.get('format_version')} != supported {_FORMAT_VERSION}"
        )
    if params is not None:
        fp = _fingerprint(params, quant)
        if fp != manifest["param_fingerprint"]:
            raise ValueError(
                "parameter tree does not match the exported artifact "
                f"(fingerprint {fp} != manifest {manifest['param_fingerprint']}): the artifact pins "
                "the model topology it was exported from"
            )
    dev = torch.device(device).type
    artifacts = {}
    for e in manifest["buckets"]:
        if e["device"] != dev:
            print(f"[export] skipping {e['file']}: exported for {e['device']!r}, device is {dev!r}")
            continue
        program = torch.export.load(osp.join(artifact_dir, e["file"]))
        artifacts[(e["T"], e["h"], e["w"], e["steps"])] = DenoiseArtifact(program)
    return artifacts
