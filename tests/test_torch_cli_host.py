"""The CLI slice's host code against the JAX package, on numpy-seeded inputs:
image loading (`load_img_and_K`), the B-spline keyframe path, the anchor
index maps, the transforms.json export and `parse_task` for every task and
`img2img` prior; and the two faults of the earlier slices, each with its
repair: PNGs are written without imageio, and the engine's
`use_traj_prior` default is JAX's."""

import inspect
import json
import os.path as osp
import sys

import cv2
import numpy as np
import pytest

from stable_virtual_camera_tpu import config as jax_config
from stable_virtual_camera_tpu_torch import config
from stable_virtual_camera_tpu_torch.core import trajectories, transforms
from stable_virtual_camera_tpu_torch.engine import prior, saving

from conftest import random_c2ws


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("size,kw", [
    (None, {}),                              # native size
    (64, {}),                                # up: shortest side 37 -> 64, ratio 1.73
    ((128, 96), {}),                         # up, both axes, then crop
    (20, {}),                                # down: 37 -> 20, ratio 0.54
    ((30, 22), {"size_stride": 2}),          # down, snapped to the stride
    ((40, 40), {"center_crop": True}),
])
def test_load_img_and_K_matches_jax(tmp_path, channels, size, kw):
    """RGB and RGBA (composited on white) PNGs read with OpenCV, resized by
    the port's area_resize, against the JAX package's PIL + cv2.INTER_AREA;
    pixel and normalised intrinsics."""
    from stable_virtual_camera_tpu.core.transforms import load_img_and_K as jax_load

    rng = np.random.default_rng(channels)
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, rng.integers(0, 256, (37, 53, channels), dtype=np.uint8))
    for K in (np.array([[40.0, 0, 26], [0, 40, 18], [0, 0, 1]]),
              np.array([[0.8, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]])):
        out, out_K = transforms.load_img_and_K(path, size, K=K, **kw)
        ref, ref_K = jax_load(path, size, K=K, **kw)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5)
        np.testing.assert_allclose(out_K, ref_K, atol=1e-9)


@pytest.mark.parametrize("hw", [(30, 40), (64, 64)])
def test_blank_frame_matches_jax(hw):
    """An (h, w) size instead of a path: PIL's transparent RGBA composited on
    white, in [-1, 1]."""
    from stable_virtual_camera_tpu.core.transforms import load_img_and_K as jax_load

    K = np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]])
    out, out_K = transforms.load_img_and_K(hw, None, K=K)
    ref, ref_K = jax_load(hw, None, K=K)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out_K, ref_K)


@pytest.mark.parametrize("hw_in,hw_out", [((8, 8), (72, 72)), ((7, 5), (13, 11)), ((20, 10), (10, 23))])
def test_area_resize_matches_opencv(hw_in, hw_out):
    """Enlarging (integer and fractional) and mixed shrink/enlarge, where
    cv2.INTER_AREA interpolates between two pixels instead of averaging."""
    img = np.random.default_rng(0).uniform(-1, 1, size=(2, *hw_in, 3)).astype(np.float32)
    ref = np.stack([cv2.resize(im, hw_out[::-1], interpolation=cv2.INTER_AREA) for im in img])
    np.testing.assert_allclose(transforms.area_resize(img, *hw_out), ref, atol=1e-6)


@pytest.mark.parametrize("n_keys,n_interp", [(3, 4), (6, 5)])
def test_interpolated_path_matches_jax(n_keys, n_interp):
    from stable_virtual_camera_tpu.core.trajectories import generate_interpolated_path as jax_path

    poses = random_c2ws(np.random.default_rng(n_keys), n_keys)[:, :3]
    np.testing.assert_allclose(trajectories.generate_interpolated_path(poses, n_interp),
                               jax_path(poses, n_interp), atol=1e-12)


@pytest.mark.parametrize("strategy,n,inputs,num_prior", [
    ("interp", 20, [0, 7], 5), ("interp-gt", 9, [3], 4), ("nearest", 15, [0, 14], 4), ("gt", 11, [5], 3),
])
def test_infer_prior_inds_matches_jax(strategy, n, inputs, num_prior):
    from stable_virtual_camera_tpu.engine.prior import infer_prior_inds as jax_inds

    c2ws = random_c2ws(np.random.default_rng(n), n)
    ours = prior.infer_prior_inds(c2ws, num_prior, inputs, config.EngineOptions(chunk_strategy=strategy))
    ref = jax_inds(c2ws, num_prior, inputs, jax_config.EngineOptions(chunk_strategy=strategy))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("source,target", [
    ([0, 2, 5, 9], [0, 5, 9]), ([3, 4, 8], [1, 6, 10]), ([2, 6, 7, 12], [4, 12, 13, 0]),
])
def test_compute_relative_inds_matches_jax(source, target):
    from stable_virtual_camera_tpu.engine.prior import compute_relative_inds as jax_rel

    ours = prior.compute_relative_inds(np.array(source), np.array(target))
    assert ours == jax_rel(np.array(source), np.array(target))


def test_create_transforms_simple_matches_jax(tmp_path):
    from stable_virtual_camera_tpu.engine.saving import create_transforms_simple as jax_export

    rng = np.random.default_rng(3)
    n = 4
    args = dict(img_paths=[str(tmp_path / f"samples-rgb/{i:03d}.png") for i in range(n - 1)] + [None],
                img_whs=np.array([[64, 48]] * n), c2ws=random_c2ws(rng, n),
                Ks=rng.uniform(10, 50, size=(n, 3, 3)))
    (tmp_path / "ours").mkdir()
    (tmp_path / "ref").mkdir()
    saving.create_transforms_simple(save_path=str(tmp_path / "ours"), **args)
    jax_export(save_path=str(tmp_path / "ref"), **args)
    assert (tmp_path / "ours" / "transforms.json").read_text() == (tmp_path / "ref" / "transforms.json").read_text()


def write_reconfusion_scene(root, n=8, hw=(48, 64)):
    """A reconfusion-format scene: PNG frames, OpenGL transforms with pixel
    intrinsics, near/far bounds, and a 1-input and a 2-input split."""
    rng = np.random.default_rng(23)
    (root / "images").mkdir(parents=True)
    c2ws = random_c2ws(rng, n)
    c2ws[:, :, [1, 2]] *= -1  # OpenCV -> OpenGL
    frames = []
    for i in range(n):
        name = f"images/frame_{i:03d}.png"
        cv2.imwrite(str(root / name), rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
        frames.append({"file_path": f"./{name}", "transform_matrix": c2ws[i].tolist(),
                       "fl_x": 60.0, "fl_y": 60.0, "cx": hw[1] / 2, "cy": hw[0] / 2,
                       "w": hw[1], "h": hw[0]})
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    np.save(root / "bounds.npy", np.stack([np.full(n, 1.0), np.full(n, 6.0)], -1))
    (root / "train_test_split_1.json").write_text(json.dumps({"train_ids": [2], "test_ids": [0, 4, 6, 7]}))
    (root / "train_test_split_2.json").write_text(json.dumps({"train_ids": [1, 5], "test_ids": [0, 3, 6]}))
    return str(root)


@pytest.mark.parametrize("task,num_inputs,opts", [
    ("img2img", 2, {}),
    ("img2img", 2, {"traj_prior": "spiral"}),
    ("img2img", 2, {"traj_prior": "interpolated"}),
    ("img2img", 1, {"traj_prior": "orbit"}),
    ("img2vid", 1, {}),
    ("img2vid", 2, {"chunk_strategy": "interp"}),
    ("img2trajvid", 1, {}),
    ("img2trajvid", 2, {"chunk_strategy": "interp-gt"}),
    ("img2trajvid_s-prob", None, {"traj_prior": "orbit", "num_targets": 6}),
    ("img2trajvid_s-prob", None, {"traj_prior": "spiral"}),
])
def test_parse_task_matches_jax(tmp_path, task, num_inputs, opts):
    """Both CLIs' `parse_task` on the same scene, with their own version and
    options objects (each may rewrite version.T in place)."""
    from stable_virtual_camera_tpu.apps import cli as jax_cli
    from stable_virtual_camera_tpu_torch.apps import cli

    scene = write_reconfusion_scene(tmp_path / "scene")
    if task == "img2trajvid_s-prob":
        scene = osp.join(scene, "images", "frame_003.png")
    results = []
    for mod, cfg in ((cli, config), (jax_cli, jax_config)):
        version = cfg.VersionConfig(H=64, W=64, T=5)
        options = mod._default_options().update(opts)
        results.append((mod.parse_task(task, scene, num_inputs, version.T, version, options), version.T))
    (ours, ours_T), (ref, ref_T) = results
    assert ours_T == ref_T
    for a, b in zip(ours, ref):
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert a == b


def test_png_writer_needs_no_imageio(tmp_path, monkeypatch):
    """save_output writes frames through OpenCV: with imageio unimportable
    the PNGs are written and decode to the frames bit for bit."""
    for name in [m for m in sys.modules if m.split(".")[0] == "imageio"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    frames = np.random.default_rng(0).integers(0, 256, (3, 24, 40, 3), dtype=np.uint8)
    saving.save_output({"samples-rgb/image": frames}, save_path=str(tmp_path), video_save_fps=2)
    for i, frame in enumerate(frames):
        back = cv2.imread(str(tmp_path / "samples-rgb" / f"{i:03d}.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back[..., ::-1], frame)
    assert (tmp_path / "samples-rgb.mp4").exists()


def test_run_one_scene_defaults_match_jax():
    """The engine's defaults are JAX's: without `use_traj_prior` a render is
    single-pass (the CLI's default)."""
    from stable_virtual_camera_tpu.engine.runner import SceneEngine as JaxEngine
    from stable_virtual_camera_tpu_torch.engine.runner import SceneEngine

    ours = inspect.signature(SceneEngine.run_one_scene).parameters
    ref = inspect.signature(JaxEngine._run_scene_impl).parameters
    for name in ("use_traj_prior", "traj_prior_Ks", "traj_prior_c2ws", "seed", "abort_event"):
        assert ours[name].default == ref[name].default, name
    assert ours["use_traj_prior"].default is False


@pytest.mark.parametrize("flag,value,item", [
    ("mesh_view", 2, "item 4"), ("mesh_data", 2, "item 4"), ("mesh_model", 2, "item 4"),
    ("platform", "cpu", "item 4"),
])
def test_cli_refuses_what_is_not_ported(flag, value, item):
    """Every flag of what was ROADMAP queue 1 item 4 is ported now
    (parallel/): the mesh's view, data and model axes and the platform. The
    CLI takes each, builds the bundle on a CPU mesh and finds no scene
    under "nowhere"; nothing is refused any more."""
    from stable_virtual_camera_tpu_torch.apps import cli

    assert cli.main("nowhere", device="cpu", random_model=True, **{flag: value}) == []


@pytest.mark.parametrize("opts", [
    {},
    {"L_short": 128, "transform_target": "pad"},
    {"transform_target": "stretch", "transform_scale": 0.9},
])
def test_prepare_images_matches_jax(tmp_path, opts):
    """The engine's image preparation from paths (input and target files,
    `None` blank targets), with and without `L_short` (which rewrites the
    version's W and H in place), and the anchor Ks derived from the size."""
    from stable_virtual_camera_tpu.engine.runner import SceneEngine as JaxEngine
    from stable_virtual_camera_tpu_torch.engine.runner import SceneEngine

    rng = np.random.default_rng(5)
    paths = []
    for i, hw in enumerate([(90, 120), (90, 120)]):
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    image_cond = {"img": paths + [None, None], "input_indices": [0]}
    Ks = [np.array([[100.0, 0, 60], [0, 100, 45], [0, 0, 1]])] * 3 + [np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]])]
    prior_Ks = np.stack([Ks[0], Ks[3]])
    results = []
    for engine_cls, cfg in ((SceneEngine, config), (JaxEngine, jax_config)):
        version = cfg.VersionConfig(H=64, W=64)
        engine = engine_cls(None, version, cfg.EngineOptions().update(opts))
        camera_cond = {"K": [k.copy() for k in Ks]}
        imgs, _, img_size = engine._prepare_images(dict(image_cond), camera_cond)
        results.append((imgs, np.stack(camera_cond["K"]), (version.W, version.H),
                        engine._prepare_prior_Ks(prior_Ks, img_size)))
    (imgs, K, wh, pK), (r_imgs, r_K, r_wh, r_pK) = results
    assert wh == r_wh and imgs.shape == r_imgs.shape
    np.testing.assert_allclose(imgs, r_imgs, atol=1e-5)
    np.testing.assert_allclose(K, r_K, atol=1e-9)
    np.testing.assert_allclose(pK, r_pK, atol=1e-9)
