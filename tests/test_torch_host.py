"""The port's copies of the JAX package's host code (config, camera math,
preset trajectories, Plücker rays, per-chunk values, the chunk planner and
anchor planning) against the originals, on numpy-seeded inputs. The port
keeps its own copies so that it imports nothing of the JAX package."""

import dataclasses

import numpy as np
import pytest

from stable_virtual_camera_tpu import config as jax_config
from stable_virtual_camera_tpu.core import trajectories as jax_traj
from stable_virtual_camera_tpu.engine import planner as jax_planner
from stable_virtual_camera_tpu.engine import prior as jax_prior
from stable_virtual_camera_tpu_torch import config
from stable_virtual_camera_tpu_torch.core import trajectories
from stable_virtual_camera_tpu_torch.engine import planner, prior

from conftest import random_c2ws


@pytest.mark.parametrize("name", ["SevaSpec", "VersionConfig", "EngineOptions"])
def test_config_defaults_match_jax(name):
    """Every field of the port's config classes has the JAX package's name and
    default (the port leaves out the TPU-only engine options)."""
    ours, theirs = getattr(config, name)(), getattr(jax_config, name)()
    theirs_d = {f.name: getattr(theirs, f.name) for f in dataclasses.fields(theirs)}
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == theirs_d[f.name], f.name
    if name != "EngineOptions":
        assert len(dataclasses.fields(ours)) == len(theirs_d)
    assert config.SevaSpec.tiny() == config.SevaSpec(**dataclasses.asdict(jax_config.SevaSpec.tiny()))


@pytest.mark.parametrize("preset", jax_traj.PRESETS)
def test_preset_trajectory_matches_jax(preset):
    args = (preset, 12, np.eye(4), np.array([0.0, 0.0, 10.0]), np.array([0.0, -1.0, 0.0]))
    poses, fovs = trajectories.get_preset_pose_fov(*args)
    ref_poses, ref_fovs = jax_traj.get_preset_pose_fov(*args)
    np.testing.assert_array_equal(poses, ref_poses)
    np.testing.assert_array_equal(fovs, ref_fovs)


@pytest.mark.parametrize(
    "strategy,task,m,n",
    [
        ("gt", "img2trajvid", 1, 7),
        ("gt-nearest", "img2trajvid", 3, 25),
        ("gt-ltr", "img2trajvid", 2, 30),
        ("nearest", "img2img", 4, 30),
        ("nearest-gt", "img2img", 8, 50),
        ("nearest-3", "img2img", 3, 10),
    ],
)
def test_planner_matches_jax(strategy, task, m, n):
    rng = np.random.default_rng(m * 100 + n)
    input_c2ws, test_c2ws = random_c2ws(rng, m), random_c2ws(rng, n)
    gt = list(range(m)) if strategy.startswith("gt") else list(range(min(2, m)))
    args = (9, input_c2ws, test_c2ws, list(range(m)), list(range(m, m + n)))
    kw = dict(task=task, chunk_strategy=strategy, gt_input_inds=gt, verbose=False)
    ours = planner.chunk_input_and_test(*args, options=config.EngineOptions(), **kw)
    theirs = jax_planner.chunk_input_and_test(*args, options=jax_config.EngineOptions(), **kw)
    assert list(ours) == list(theirs)


@pytest.mark.parametrize("strategy,task", [("interp", "img2img"), ("interp-gt", "img2trajvid")])
def test_interp_planner_and_padding_match_jax(strategy, task):
    rng = np.random.default_rng(3)
    anchor_ords = [0.0, 5.0, 11.0, 16.0, 23.0]
    input_ords = [0] + [o + 1 for o in anchor_ords] if task == "img2trajvid" else anchor_ords
    test_ords = list(np.linspace(0.5, 22.5, 15))
    args = (9, random_c2ws(rng, len(input_ords)), random_c2ws(rng, 15), input_ords, test_ords)
    kw = dict(task=task, chunk_strategy=strategy, gt_input_inds=[0], verbose=False)
    ours = planner.chunk_input_and_test(*args, options=config.EngineOptions(), **kw)
    theirs = jax_planner.chunk_input_and_test(*args, options=jax_config.EngineOptions(), **kw)
    assert list(ours) == list(theirs)
    frames = rng.normal(size=(30, 2)).astype(np.float32)
    for in_sels, te_sels in zip(ours.input_sels_per_chunk, ours.test_sels_per_chunk):
        padded = planner.pad_indices(in_sels, te_sels, T=9)
        ref = jax_planner.pad_indices(in_sels, te_sels, T=9)
        for a, b in zip(padded, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            planner.assemble(frames, frames, padded[2], padded[3]),
            jax_planner.assemble(frames, frames, ref[2], ref[3]),
        )


@pytest.mark.parametrize(
    "strategy,min_fill,deliver,num_inputs,num_targets",
    [
        ("interp-gt", False, None, 1, 20),   # Basic mode: dense economy, AUTO delivery
        ("interp-gt", False, None, 1, 134),
        ("interp", False, False, 3, 80),
        ("interp-gt", True, None, 1, 80),    # the reference's fill-to-T schedule
        ("interp", False, None, 9, 80),      # semi-dense inputs
        ("nearest", False, None, 2, 40),
    ],
)
def test_resolve_anchors_matches_jax(strategy, min_fill, deliver, num_inputs, num_targets):
    """Anchor count, placement, the rewritten window and the delivery flag."""
    results = []
    for cfg, pri in ((config, prior), (jax_config, jax_prior)):
        version = cfg.VersionConfig()
        options = cfg.EngineOptions(chunk_strategy=strategy, min_anchor_fill=min_fill,
                                    deliver_anchors=deliver)
        rel, dense = pri.resolve_anchors(version.T, num_inputs, num_targets, version, options)
        results.append((rel, dense, version.T, options.deliver_anchors))
    assert results[0] == results[1]


def test_chunk_values_match_jax():
    """Centring, scale normalisation and the Plücker map of one chunk."""
    from stable_virtual_camera_tpu.engine.value_dict import build_chunk_values as jax_values
    from stable_virtual_camera_tpu_torch.engine.value_dict import build_chunk_values

    rng = np.random.default_rng(4)
    T = 5
    imgs = rng.uniform(-1, 1, size=(T, 16, 16, 3)).astype(np.float32)
    c2ws = random_c2ws(rng, T)[:, :3].astype(np.float32)
    Ks = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (T, 1, 1))
    args = (imgs, imgs, [0, 2], c2ws, Ks, list(range(T)))
    kw = dict(all_c2ws=random_c2ws(rng, 9), camera_scale=2.0, latent_hw=(2, 2))
    ours, theirs = build_chunk_values(*args, **kw), jax_values(*args, **kw)
    for f in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(theirs, f.name), err_msg=f.name)


def _traj_list(n, W=64, H=48):
    """A GUI camera list (Advanced mode): w2c, pixel K and image size."""
    from stable_virtual_camera_tpu.core.trajectories import get_preset_pose_fov

    poses, _ = get_preset_pose_fov("lemniscate", n, np.eye(4), np.array([0.0, 0.0, 10.0]))
    K = [[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]]
    return [{"w2c": np.linalg.inv(p).ravel().tolist(), "K": K, "img_wh": (W, H)} for p in poses]


@pytest.mark.parametrize("case", [
    dict(preset_traj="orbit", num_frames=20),
    dict(preset_traj="spiral", num_frames=80, min_anchor_fill=True),
    dict(preset_traj="zoom-in", num_frames=30, deliver_anchors=False),
    dict(camera_traj_list=_traj_list(25), inputs=3),
    dict(camera_traj_list=_traj_list(40), inputs=12),  # > 10 inputs forces `interp`
])
def test_renderer_plan_matches_jax(case):
    """HeadlessRenderer.prepare without a render: targets, anchors, the
    options that decide the schedule, and both passes' chunk counts."""
    from stable_virtual_camera_tpu.apps.renderer import HeadlessRenderer as JaxRenderer
    from stable_virtual_camera_tpu_torch.apps.renderer import HeadlessRenderer

    case = dict(case)
    n_in = case.pop("inputs", 1)
    rng = np.random.default_rng(n_in)
    pre = {
        "input_imgs": rng.uniform(0, 1, size=(n_in, 48, 64, 3)).astype(np.float32),
        "input_Ks": np.tile(np.array([[0.8, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32), (n_in, 1, 1)),
        "input_c2ws": random_c2ws(rng, n_in),
        "input_wh": (64, 48),
    }
    ours = HeadlessRenderer(None, work_dir=None).prepare(pre, **case)
    theirs = JaxRenderer(None).prepare(pre, **case)
    for key in ("seed", "first_pass_steps", "second_pass_steps", "first_pass_chunks", "second_pass_chunks"):
        assert ours[key] == theirs[key], key
    assert ours["version"].T == theirs["version"].T
    for key in ("chunk_strategy", "cfg", "guider_types", "deliver_anchors", "num_steps", "cfg_min"):
        assert ours["options"].get(key) == theirs["options"].get(key), key
    assert ours["image_cond"]["prior_indices"] == theirs["image_cond"]["prior_indices"]
    np.testing.assert_array_equal(np.stack(ours["image_cond"]["img"]), np.stack(theirs["image_cond"]["img"]))
    for key in ("anchor_c2ws", "anchor_Ks"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours["camera_cond"]["c2w"], theirs["camera_cond"]["c2w"], atol=1e-6)
    np.testing.assert_allclose(np.stack(ours["camera_cond"]["K"]), np.stack(theirs["camera_cond"]["K"]), atol=1e-4)


def test_scene_engine_keeps_its_own_options():
    """Anchor planning rewrites `deliver_anchors` in place; the engine works on
    a copy, so a caller's options object never changes under it."""
    from stable_virtual_camera_tpu_torch.engine.runner import SceneEngine

    options = config.EngineOptions(chunk_strategy="interp-gt", deliver_anchors=None)
    engine = SceneEngine(None, config.VersionConfig(), options)
    prior.resolve_anchors(21, 1, 20, config.VersionConfig(), engine.options)
    assert engine.options.deliver_anchors is True and options.deliver_anchors is None


def test_plan_dense_anchors_refuses_the_window_that_never_ends():
    """T_second = 3 with no input leaves one target slot a chunk; without
    delivery the last gap samples its width plus the final target, so no
    anchor count fits (JAX's loop never returns): the port raises. With
    delivery every cap >= 1 fits, and the anchors equal JAX's."""
    with pytest.raises(ValueError, match=r"T_second=3 .*num_gt_inputs=0.*deliver=False"):
        prior.plan_dense_anchors(80, 3, 0, deliver=False)
    anchors = prior.plan_dense_anchors(80, 3, 0, deliver=True)
    assert anchors == jax_prior.plan_dense_anchors(80, 3, 0, deliver=True)
    assert anchors[0] == 0 and anchors[-1] == 79
    assert prior.plan_dense_anchors(2, 3, 0) == [0, 1]
