"""The slice as a whole: the port's SceneEngine and Basic-mode HeadlessRenderer
against the JAX package's, on the CPU in fp32.

Both sides hold the same tiny weights (bridged), and the port replays the JAX
engine's initial and churn noise for every (pass, chunk) through its
`noise_fn`. The JAX side writes PNGs, which are read back; the port keeps its
frames in memory (`save_path=None` / `work_dir=None`). Frames must agree
within one uint8 step.
"""

import glob
import os.path as osp

import imageio.v3 as iio
import numpy as np
import pytest

from stable_virtual_camera_tpu import config as jax_config
from stable_virtual_camera_tpu_torch.config import EngineOptions, VersionConfig
from test_torch_sampler import jax_noise
from test_torch_weights import port_and_flax_params

GOLDEN = osp.join(osp.dirname(__file__), "..", "assets", "golden_scene", "scene0")


@pytest.fixture(scope="module")
def bundles():
    """(port bundle, JAX bundle) holding the same tiny weights."""
    from stable_virtual_camera_tpu.engine.runner import ClipApplier, ModelBundle, VaeApplier
    from stable_virtual_camera_tpu.models.clip import ClipVisionSpec, ClipVisionTower
    from stable_virtual_camera_tpu.models.unet import SevaUNet
    from stable_virtual_camera_tpu.models.vae import AutoEncoderKL
    from stable_virtual_camera_tpu.sampling.sampler import UNetDenoiser

    port, trees = port_and_flax_params(seed=6)
    ref = ModelBundle(
        spec=jax_config.SevaSpec.tiny(),
        denoiser=UNetDenoiser(SevaUNet(jax_config.SevaSpec.tiny()), trees["unet"]),
        vae=VaeApplier(AutoEncoderKL(), trees["vae"]),
        clip=ClipApplier(ClipVisionTower(ClipVisionSpec.tiny()), trees["clip"]),
    )
    return port, ref


def _pngs(directory):
    return np.stack([iio.imread(p) for p in sorted(glob.glob(osp.join(directory, "*.png")))])


def _assert_frames_close(out, ref):
    assert out.dtype == np.uint8 and out.shape == ref.shape
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, f"{(diff > 1).sum()} values differ by more than one step"


def test_golden_scene_two_pass_matches_jax(bundles, tmp_path):
    """The on-disk golden scene (one input view, two targets, one anchor)
    through both SceneEngines with the options of test_golden_scene."""
    from stable_virtual_camera_tpu.data.parsers import ReconfusionParser
    from stable_virtual_camera_tpu.engine.runner import SceneEngine as JaxEngine
    from stable_virtual_camera_tpu_torch.engine.runner import SceneEngine

    port, ref = bundles
    parser = ReconfusionParser(GOLDEN)
    imgs = [iio.imread(p) for p in parser.image_paths]
    c2ws = np.asarray(parser.camtoworlds, np.float32)[:, :3]
    K = np.asarray(parser.Ks_dict[parser.camera_ids[0]], np.float32)
    options = dict(
        num_steps=2, cfg=[2.0, 2.0], guider_types=[1, 2], chunk_strategy="nearest",
        chunk_strategy_first_pass="gt", sampler_verbose=False, encoding_t=0,
        decoding_t=0, save_first_pass=False,
    )

    def scene():
        return dict(
            task="img2trajvid",
            image_cond={"img": list(imgs), "input_indices": [0], "prior_indices": [1.5]},
            camera_cond={"c2w": c2ws, "K": [K] * len(imgs), "input_indices": [0, 1, 2]},
            use_traj_prior=True, traj_prior_Ks=None, traj_prior_c2ws=c2ws[1:2], seed=23,
        )

    save = str(tmp_path / "jax")
    list(JaxEngine(ref, jax_config.VersionConfig(H=64, W=64, T=3),
                   jax_config.EngineOptions().update(options))
         .run_one_scene(save_path=save, **scene()))
    (frames,) = SceneEngine(
        port, VersionConfig(H=64, W=64, T=3), EngineOptions().update(options), noise_fn=jax_noise
    ).run_one_scene(save_path=None, **scene())
    assert frames.shape == (2, 64, 64, 3)
    _assert_frames_close(frames, _pngs(osp.join(save, "samples-rgb")))


def test_basic_render_matches_jax(bundles, tmp_path):
    """HeadlessRenderer in Basic mode: one image, the `orbit` preset with 6
    targets at T=4. The plan has dense-economy anchors with AUTO delivery,
    two autoregressive first-pass chunks and two second-pass chunks."""
    from stable_virtual_camera_tpu.apps.renderer import HeadlessRenderer as JaxRenderer
    from stable_virtual_camera_tpu.apps.renderer import preprocess_basic as jax_preprocess
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer, preprocess_basic

    port, ref = bundles
    img = np.random.default_rng(0).integers(0, 256, size=(80, 64, 3), dtype=np.uint8)
    kw = dict(preset_traj="orbit", num_frames=6, num_steps=2, seed=23)

    pre = preprocess_basic(img, shorter=64)
    pre_ref = jax_preprocess(img, shorter=64)
    np.testing.assert_allclose(pre["input_imgs"], pre_ref["input_imgs"], atol=1e-5)
    np.testing.assert_allclose(pre["input_Ks"], pre_ref["input_Ks"])

    jr = JaxRenderer(ref, work_dir=str(tmp_path))
    jr.version = jax_config.VersionConfig(H=64, W=64, T=4)
    jplan = jr.prepare(pre_ref, **kw)
    out_dir = osp.dirname(list(jr.run(jplan))[-1])

    r = HeadlessRenderer(port, work_dir=None, noise_fn=jax_noise)
    r.version = VersionConfig(H=64, W=64, T=4)
    plan = r.prepare(pre, **kw)
    assert plan["options"].get("deliver_anchors") is True
    assert (plan["first_pass_chunks"], plan["second_pass_chunks"]) == (2, 2)
    assert plan["image_cond"]["prior_indices"] == jplan["image_cond"]["prior_indices"]
    anchors, frames = list(r.run(plan))

    assert frames.shape == (6, 64, 64, 3)
    _assert_frames_close(anchors, _pngs(osp.join(out_dir, "first-pass", "samples-rgb")))
    _assert_frames_close(frames, _pngs(osp.join(out_dir, "samples-rgb")))
