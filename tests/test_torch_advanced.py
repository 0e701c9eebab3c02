"""The GUI's Advanced mode, port against the JAX package, on the CPU: the
Kochanek-Bartels splines and the keyframe trajectory core (to 1e-10), the
DUSt3R pipeline (tiny network, one synthetic checkpoint, three PNGs, 60
alignment steps; the aligner's bars: focal rtol 1e-3, camera centers atol
5e-3), `preprocess_advanced` on identical pipeline outputs (1e-6), the
decode batching by resolution, and one Advanced render at `SevaSpec.tiny()`
along the same `camera_traj_list` (frames within one uint8 step, the port
replaying JAX's noise).
"""

import os.path as osp

import numpy as np
import pytest

from stable_virtual_camera_tpu import config as jax_config
from stable_virtual_camera_tpu.apps import trajectory as jax_traj
from stable_virtual_camera_tpu.core import kb_splines as jax_kb
from stable_virtual_camera_tpu_torch.apps import trajectory
from stable_virtual_camera_tpu_torch.config import VersionConfig
from stable_virtual_camera_tpu_torch.core import kb_splines
from test_global_alignment import _lookat_c2w
from test_torch_dust3r import _few_threads  # noqa: F401 (autouse)

TIGHT = dict(rtol=1e-10, atol=1e-10)



def _arc_c2ws(n, radius=4.0, span=0.6):
    return np.stack([_lookat_c2w((radius * np.sin(t), 0.3 * np.sin(2 * t), -radius * np.cos(t)))
                     for t in np.linspace(-span, span, n)])


@pytest.mark.parametrize("end", ["natural", "closed"])
def test_kb_splines_match_jax(end):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5, 3))
    ts = np.linspace(-0.3, 5.3, 41)
    tcb = (0.2, -0.1, 0.3)
    np.testing.assert_allclose(kb_splines.KochanekBartels(pts, tcb, end).evaluate(ts),
                               jax_kb.KochanekBartels(pts, tcb, end).evaluate(ts), **TIGHT)
    vals = rng.normal(size=5)
    np.testing.assert_allclose(kb_splines.KochanekBartels(vals, tcb, end).evaluate(ts),
                               jax_kb.KochanekBartels(vals, tcb, end).evaluate(ts), **TIGHT)
    quats = jax_kb.quat_from_matrix(_arc_c2ws(5, span=1.2)[:, :3, :3])
    np.testing.assert_allclose(kb_splines.quat_from_matrix(_arc_c2ws(5, span=1.2)[:, :3, :3]), quats, **TIGHT)
    np.testing.assert_allclose(kb_splines.KochanekBartelsQuaternion(quats, tcb, end).evaluate(ts),
                               jax_kb.KochanekBartelsQuaternion(quats, tcb, end).evaluate(ts), **TIGHT)
    cumsum = np.array([0.0, 1.0, 2.5, 4.0, 4.5])
    secs = np.linspace(0, 4.5, 17)
    np.testing.assert_allclose(kb_splines.pchip_time_parameterization(cumsum, end == "closed")(secs),
                               jax_kb.pchip_time_parameterization(cumsum, end == "closed")(secs), **TIGHT)


def _fill_core(mod, c2ws, fovs, loop):
    core = mod.CameraTrajectoryCore()
    core.default_fov = float(fovs[0])
    core.loop = loop
    core.tension = 0.1
    core.set_keyframes_from_poses(c2ws, fovs, aspect=4 / 3)
    core.set_keyframe_fov_override(1, True, 0.7)
    core.set_keyframe_transition_override(2, True, 3.0)
    return core


@pytest.mark.parametrize("loop", [False, True])
def test_camera_traj_list_matches_jax(loop):
    c2ws, fovs = _arc_c2ws(4), np.array([0.9, 0.8, 0.85, 1.0])
    out = _fill_core(trajectory, c2ws, fovs, loop)
    ref = _fill_core(jax_traj, c2ws, fovs, loop)
    assert out.compute_duration() == ref.compute_duration()
    a, b = out.get_camera_traj_list((64, 48), num_frames=13), ref.get_camera_traj_list((64, 48), num_frames=13)
    assert len(a) == len(b) == 13
    for x, y in zip(a, b):
        np.testing.assert_allclose(x["w2c"], y["w2c"], **TIGHT)
        np.testing.assert_allclose(x["K"], y["K"], **TIGHT)
        assert tuple(x["img_wh"]) == tuple(y["img_wh"])
    np.testing.assert_allclose(out.spline_positions(9), ref.spline_positions(9), **TIGHT)
    np.testing.assert_allclose(trajectory.get_intrinsics(64, 48, 0.8), jax_traj.get_intrinsics(64, 48, 0.8), **TIGHT)


def _write_pngs(directory, n=3, wh=(80, 60)):
    import PIL.Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        p = str(directory / f"img_{i}.png")
        PIL.Image.fromarray(rng.integers(0, 256, (wh[1], wh[0], 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """(port pipeline, JAX pipeline, png paths): the tiny network from one
    synthetic released-layout checkpoint on both sides."""
    from stable_virtual_camera_tpu.apps.preprocessor import NativeDust3rPipeline as JaxPipeline
    from stable_virtual_camera_tpu.models.dust3r import Dust3rSpec as JaxSpec
    from stable_virtual_camera_tpu.models.io import load_dust3r_params
    from stable_virtual_camera_tpu_torch.apps.preprocessor import NativeDust3rPipeline
    from stable_virtual_camera_tpu_torch.models.dust3r import Dust3rSpec
    from test_torch_dust3r import save_checkpoint, synthetic_state

    tmp = tmp_path_factory.mktemp("advanced")
    path = save_checkpoint(tmp / "dust3r.pth", synthetic_state(seed=5))
    port = NativeDust3rPipeline(weight_path=path, spec=Dust3rSpec.tiny(), device="cpu")
    ref = JaxPipeline(params=load_dust3r_params(path, spec=JaxSpec.tiny()), spec=JaxSpec.tiny())
    return port, ref, _write_pngs(tmp)


def test_infer_cameras_and_points_matches_jax(pipelines):
    port, ref, paths = pipelines
    kw = dict(niter=60, min_conf_thr=1.5)
    imgs, Ks, c2ws, points, colors = port.infer_cameras_and_points(paths, **kw)
    r_imgs, r_Ks, r_c2ws, r_points, r_colors = ref.infer_cameras_and_points(paths, **kw)
    np.testing.assert_array_equal(imgs, r_imgs)
    assert imgs.shape == (3, 48, 64, 3) and Ks.shape == (3, 3, 3)
    np.testing.assert_allclose(Ks, r_Ks, rtol=1e-3)
    np.testing.assert_allclose(c2ws[:, :3, 3], r_c2ws[:, :3, 3], atol=5e-3)
    np.testing.assert_allclose(c2ws[:, :3, :3], r_c2ws[:, :3, :3], atol=5e-3)
    for p, c, rp in zip(points, colors, r_points):
        assert p.shape[1] == 3 and len(p) == len(c) > 0
        assert abs(len(p) - len(rp)) <= 0.01 * len(rp)  # masks may differ at the conf threshold


def _fixed_pipeline_outputs():
    """What a pipeline returns for 3 images: [0, 1] images, pixel Ks at the
    original 80x60 resolution, c2ws, points and colors per image."""
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 1, (3, 48, 64, 3)).astype(np.float32)
    Ks = np.stack([np.array([[70.0 + i, 0, 40.0], [0, 70.0 + i, 30.0], [0, 0, 1]]) for i in range(3)])
    c2ws = _arc_c2ws(3).astype(np.float32)
    points = [rng.normal(size=(50 + 10 * i, 3)).astype(np.float32) + [0, 0, 4] for i in range(3)]
    colors = [rng.uniform(0, 1, (len(p), 3)).astype(np.float32) for p in points]
    return imgs, Ks, c2ws, points, colors


class _Fixed:
    def infer_cameras_and_points(self, img_paths):
        return _fixed_pipeline_outputs()


def test_preprocess_advanced_matches_jax():
    from stable_virtual_camera_tpu.apps.renderer import preprocess_advanced as jax_preprocess
    from stable_virtual_camera_tpu_torch.apps.renderer import preprocess_advanced

    out = preprocess_advanced(["a", "b", "c"], _Fixed(), shorter=64)
    ref = jax_preprocess(["a", "b", "c"], _Fixed(), shorter=64)
    assert out["input_wh"] == ref["input_wh"] and out["input_imgs"].shape == ref["input_imgs"].shape
    for k in ("input_imgs", "input_Ks", "input_c2ws"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert out["scene_scale"] == pytest.approx(ref["scene_scale"], rel=1e-6)
    for a, b in zip(out["points"], ref["points"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw", [(576, 576), (576, 768), (768, 1024)])
def test_decode_batches_by_resolution_as_jax(hw):
    """The plan's `decoding_t`: one batch up to 576x576, JAX's grouped
    decode above it (9 frames at 768x576)."""
    from stable_virtual_camera_tpu.apps.renderer import HeadlessRenderer as JaxRenderer
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer, decoding_frames

    H, W = hw
    pre = {"input_imgs": np.zeros((1, H, W, 3), np.float32),
           "input_Ks": np.array([[[0.8, 0, 0.5], [0, 0.8 * W / H, 0.5], [0, 0, 1]]]),
           "input_c2ws": np.eye(4)[None], "input_wh": (W, H)}
    kw = dict(preset_traj="orbit", num_frames=20, num_steps=2)
    plan = HeadlessRenderer(None, work_dir=None).prepare(pre, **kw)
    ref = JaxRenderer(None).prepare(pre, **kw)
    assert plan["options"].decoding_t == ref["options"].decoding_t == decoding_frames(H, W)
    assert (plan["first_pass_chunks"], plan["second_pass_chunks"]) == (
        ref["first_pass_chunks"], ref["second_pass_chunks"])
    assert decoding_frames(H, W) == {(576, 576): 0, (576, 768): 9, (768, 1024): 5}[hw]


def test_advanced_render_matches_jax(tmp_path):
    """Three posed 64x64 inputs (the Advanced preprocess output format), a
    keyframe trajectory through their poses with 4 targets at T=6, both
    passes through each HeadlessRenderer."""
    from stable_virtual_camera_tpu.apps.renderer import HeadlessRenderer as JaxRenderer
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer
    from test_torch_engine import _assert_frames_close, _pngs
    from test_torch_sampler import jax_noise
    from test_torch_weights import port_and_flax_params

    port_bundle, trees = port_and_flax_params(seed=8)
    from stable_virtual_camera_tpu.engine.runner import ClipApplier, ModelBundle, VaeApplier
    from stable_virtual_camera_tpu.models.clip import ClipVisionSpec, ClipVisionTower
    from stable_virtual_camera_tpu.models.unet import SevaUNet
    from stable_virtual_camera_tpu.models.vae import AutoEncoderKL
    from stable_virtual_camera_tpu.sampling.sampler import UNetDenoiser

    ref_bundle = ModelBundle(
        spec=jax_config.SevaSpec.tiny(),
        denoiser=UNetDenoiser(SevaUNet(jax_config.SevaSpec.tiny()), trees["unet"]),
        vae=VaeApplier(AutoEncoderKL(), trees["vae"]),
        clip=ClipApplier(ClipVisionTower(ClipVisionSpec.tiny()), trees["clip"]),
    )
    rng = np.random.default_rng(1)
    c2ws = _arc_c2ws(3)
    fov = 0.9
    f = 0.5 / np.tan(fov / 2)
    pre = {"input_imgs": rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32),
           "input_Ks": np.repeat(np.array([[[f, 0, 0.5], [0, f, 0.5], [0, 0, 1]]]), 3, 0),
           "input_c2ws": c2ws, "input_wh": (64, 64)}
    core = trajectory.CameraTrajectoryCore()
    core.default_fov = fov
    core.set_keyframes_from_poses(c2ws, np.full(3, fov), aspect=1.0)
    traj = core.get_camera_traj_list((64, 64), num_frames=4)
    kw = dict(camera_traj_list=traj, num_steps=2, seed=23)

    jr = JaxRenderer(ref_bundle, work_dir=str(tmp_path))
    jr.version = jax_config.VersionConfig(H=64, W=64, T=6)
    jplan = jr.prepare(pre, **kw)
    out_dir = osp.dirname(list(jr.run(jplan))[-1])

    r = HeadlessRenderer(port_bundle, work_dir=None, noise_fn=jax_noise)
    r.version = VersionConfig(H=64, W=64, T=6)
    plan = r.prepare(pre, **kw)
    assert plan["image_cond"]["prior_indices"] == jplan["image_cond"]["prior_indices"]
    assert (plan["first_pass_chunks"], plan["second_pass_chunks"]) == (
        jplan["first_pass_chunks"], jplan["second_pass_chunks"])
    anchors, frames = list(r.run(plan))
    assert frames.shape == (4, 64, 64, 3)
    _assert_frames_close(anchors, _pngs(osp.join(out_dir, "first-pass", "samples-rgb")))
    _assert_frames_close(frames, _pngs(osp.join(out_dir, "samples-rgb")))
