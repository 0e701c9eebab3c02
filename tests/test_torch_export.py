"""Exported denoise steps (models/export.py, apps/export_artifacts.py, the
server's --artifact_dir) on the CPU at the tiny spec: the export and load
round trip, the topology fingerprint, device gating, the export CLI, the
engine's and the server's use of a loaded bucket, and the artifact held
against the JAX package's exported program on the same weights.

Deployment contract, as in tests/test_export_artifacts.py: a loaded
artifact run through the sampler gives the live program's latents, bit for
bit, while refusing mismatched models and foreign-device programs. The
program is one step (the host loop runs it `steps` times), so progress
ticks once a step on both routes, where JAX's pinned scan ticks once a
chunk.
"""

import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch.apps import server
from stable_virtual_camera_tpu_torch.config import VersionConfig
from stable_virtual_camera_tpu_torch.engine.runner import sample_latents
from stable_virtual_camera_tpu_torch.models.export import (
    MANIFEST,
    _fingerprint,
    export_denoise_buckets,
    load_denoise_artifacts,
    unet_state,
)
from stable_virtual_camera_tpu_torch.sampling import sampler as t_sampler
from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
from test_torch_sampler import _step_keys
from test_torch_weights import port_and_flax_params

STEPS = 2
H = W = 8


def _sample_inputs(spec, T, seed=0):
    """JAX's test inputs: standard normal noise and conditioning, CFG 2."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    noise = r(T, H, W, 4)
    cond = dict(
        crossattn=r(2 * T, 1, spec.context_dim),
        concat=r(2 * T, H, W, spec.in_channels - 4),
        dense=r(2 * T, H, W, spec.dense_in_channels),
        replace=r(2 * T, H, W, 5),
        scale=np.full((T,), 2.0, np.float32),
    )
    return noise, cond


def _torch_inputs(noise, cond):
    return (torch.from_numpy(noise),
            t_sampler.ChunkConditioning(**{k: torch.from_numpy(v) for k, v in cond.items()}))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny bucket exported once, by the export CLI (the artifact holds
    no weight, so any tiny bundle's export serves), and attached through
    the server's loader to the tiny bundle with its flax trees."""
    from stable_virtual_camera_tpu_torch.apps.export_artifacts import main

    out = str(tmp_path_factory.mktemp("export") / "artifacts")
    main(out, random_model=True, num_steps=STEPS, device="cpu")
    bundle, trees = port_and_flax_params(seed=0)
    server.attach_artifacts(bundle, out)
    return bundle, trees, out, json.load(open(osp.join(out, MANIFEST)))


def test_artifact_matches_live_program(exported):
    bundle, _, _, _ = exported
    T = bundle.spec.num_frames
    assert set(bundle.artifacts) == {(T, H, W, STEPS)}
    artifact = bundle.artifacts[(T, H, W, STEPS)]
    noise, cond = _sample_inputs(bundle.spec, T)
    noise, cond = _torch_inputs(noise, cond)
    plan = t_sampler.make_sampling_plan(DDPMDiscretization(), STEPS)
    eps = [torch.randn((T, H, W, 4), generator=torch.Generator().manual_seed(i)) for i in range(STEPS)]
    live = t_sampler.euler_edm_sample(bundle.network, noise, plan, cond, T, step_noise=lambda i: eps[i])
    calls = artifact.calls
    aot = sample_latents(bundle, noise, plan, cond, step_noise=lambda i: eps[i])
    assert artifact.calls == calls + STEPS
    # the artifact IS the live step (exported, saved and reloaded): bit-identical
    assert torch.equal(live, aot)


def test_artifact_holds_no_parameter(exported):
    """No weight of the UNet is in the program or its file: no parameter or
    buffer, constants of a few bytes (the FiLM resize matrices), and a file
    smaller than the weights."""
    bundle, _, out, manifest = exported
    program = next(iter(bundle.artifacts.values())).program
    assert not program.graph_signature.parameters and not program.graph_signature.buffers
    assert not program.state_dict
    weights = sum(t.nbytes for t in unet_state(bundle.unet).values())
    assert sum(c.nbytes for c in program.constants.values()) < 1e-3 * weights
    assert osp.getsize(osp.join(out, manifest["buckets"][0]["file"])) < weights
    # the graph runs the UNet through its inputs
    names = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"aten.conv2d.default", "aten.linear.default"} <= names


def test_fingerprint_pins_topology(exported):
    bundle, _, out, manifest = exported
    state = unet_state(bundle.unet)
    assert _fingerprint(state) == manifest["param_fingerprint"]
    # grow one leaf: same names, another shape -> must refuse
    name = sorted(state)[0]
    bad = dict(state, **{name: torch.zeros((3, *state[name].shape))})
    with pytest.raises(ValueError, match="fingerprint"):
        load_denoise_artifacts(out, params=bad, device="cpu")
    bad = dict(state, **{name: state[name].double()})
    with pytest.raises(ValueError, match="fingerprint"):
        load_denoise_artifacts(out, params=bad, device="cpu")


def test_foreign_device_bucket_skipped(exported, tmp_path, capsys):
    _, _, out, _ = exported
    manifest = json.load(open(osp.join(out, MANIFEST)))
    manifest["buckets"][0]["device"] = "cuda"
    json.dump(manifest, open(tmp_path / MANIFEST, "w"))
    assert load_denoise_artifacts(str(tmp_path), device="cpu") == {}
    assert "skipping" in capsys.readouterr().out


def test_export_cli_writes_manifest(exported):
    """apps/export_artifacts.main with --random_model True: the tiny
    bundle's bucket at 64x64 (latent 8x8), its T, the steps asked for."""
    bundle, _, out, manifest = exported
    assert manifest["buckets"], manifest
    e = manifest["buckets"][0]
    assert osp.exists(osp.join(out, e["file"]))
    assert (e["T"], e["h"], e["w"], e["steps"], e["device"]) == (bundle.spec.num_frames, H, W, STEPS, "cpu")
    assert manifest["torch_version"] == torch.__version__


def test_export_refuses_a_quantized_unet(tmp_path):
    from stable_virtual_camera_tpu_torch.models.io import random_bundle

    bundle = random_bundle(device="cpu", quant="w8a8")
    with pytest.raises(ValueError, match="W8A8"):
        export_denoise_buckets(bundle, bundle.spec, (H, W), 3, STEPS, str(tmp_path), device="cpu")


def test_server_uses_artifact_bucket(exported, capsys):
    """--artifact_dir wiring: the server's warmup and a sampled chunk run the
    loaded bucket, once a step, with a progress tick after every step (the
    host loop runs the one-step program; JAX's pinned scan ticks once a
    chunk)."""
    bundle, _, _, _ = exported
    T = bundle.spec.num_frames
    artifact = bundle.artifacts[(T, H, W, STEPS)]
    calls = artifact.calls
    server.warmup_buckets(bundle, VersionConfig(H=8 * H, W=8 * W, T=T), num_steps=STEPS)
    assert artifact.calls == calls + STEPS
    assert "(exported program)" in capsys.readouterr().out
    noise, cond = _torch_inputs(*_sample_inputs(bundle.spec, T, seed=1))
    ticks = []
    out = sample_latents(bundle, noise, bundle.plan(STEPS), cond,
                         step_noise=lambda i: torch.zeros((T, H, W, 4)),
                         progress_cb=lambda i, n: ticks.append((i, n)))
    assert out is not None and torch.isfinite(out).all()
    assert ticks == [(1, STEPS), (2, STEPS)]
    assert artifact.calls == calls + 2 * STEPS
    # another step count is another bucket: the live network
    sample_latents(bundle, noise, bundle.plan(STEPS + 1), cond, step_noise=lambda i: torch.zeros((T, H, W, 4)))
    assert artifact.calls == calls + 2 * STEPS


@pytest.mark.parametrize("quant", ["w8a8", "w8a8-static"])
def test_quant_with_artifact_dir_refuses(exported, quant):
    """A bf16/fp32 artifact does not serve a W8A8 model: the fingerprint
    covers the mode (and w8a8-static's site buffers), so the server refuses
    at start-up instead of serving the exact program under --quant."""
    _, _, out, _ = exported
    with pytest.raises(ValueError, match="fingerprint"):
        server.main(random_model=True, device="cpu", quant=quant, artifact_dir=out)


def test_artifact_matches_jax_exported_program(exported, tmp_path):
    """The port's loaded artifact against the JAX package's exported scan
    on the same weights (models/weights.py::to_flax_tree), conditioning,
    initial noise and churn draws (JAX's per-step keys replayed)."""
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.export import (
        export_denoise_buckets as jax_export,
        load_denoise_artifacts as jax_load,
    )
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet
    from stable_virtual_camera_tpu.sampling import sampler as j_sampler
    from stable_virtual_camera_tpu.sampling.discretization import DDPMDiscretization as JaxDisc

    bundle, trees, _, _ = exported
    T = bundle.spec.num_frames
    denoiser = j_sampler.UNetDenoiser(JaxUNet(JaxSevaSpec.tiny()), trees["unet"])
    jax_export(denoiser, JaxSevaSpec.tiny(), (H, W), T, STEPS, str(tmp_path))
    aot = j_sampler.UNetDenoiser(denoiser.unet, denoiser.params,
                                 artifacts=jax_load(str(tmp_path), params=denoiser.params))
    noise, cond = _sample_inputs(bundle.spec, T, seed=2)
    key = jax.random.PRNGKey(7)
    ref = aot.sample(jnp.asarray(noise), j_sampler.make_sampling_plan(JaxDisc(), STEPS),
                     j_sampler.ChunkConditioning(**{k: jnp.asarray(v) for k, v in cond.items()}), key)

    eps = [torch.from_numpy(np.array(jax.random.normal(k, noise.shape, jnp.float32)))
           for k in _step_keys(key, STEPS)]
    noise_t, cond_t = _torch_inputs(noise, cond)
    out = sample_latents(bundle, noise_t, bundle.plan(STEPS), cond_t, step_noise=lambda i: eps[i])
    # the JAX package's bar against the torch oracle (tests/test_midtier_parity.py)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)
