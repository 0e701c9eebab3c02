"""The CLI slice as a whole: `render_one_scene` of the port's CLI against the
JAX package's, on the CPU in fp32, with the same tiny weights (bridged) and
the JAX engine's noise replayed through the port's `noise_fn`.

Three runs with the demo's option defaults at 2 steps: `img2trajvid` with
the trajectory prior (two passes) on the golden scene, `img2img` in one
pass on the golden scene, and `img2trajvid_s-prob` from one seeded
non-square PNG along the orbit preset (two passes, blank target frames).
Both sides write their outputs; the PNGs are read back with OpenCV and
must agree within one uint8 step, and `transforms.json` to 1e-6.
"""

import json
import os.path as osp

import cv2
import numpy as np
import pytest

from stable_virtual_camera_tpu import config as jax_config
from stable_virtual_camera_tpu_torch import config
from test_torch_engine import _assert_frames_close, bundles  # noqa: F401 (fixture)
from test_torch_sampler import jax_noise

GOLDEN = osp.join(osp.dirname(__file__), "..", "assets", "golden_scene", "scene0")


def _pngs(directory):
    import glob

    paths = sorted(glob.glob(osp.join(directory, "*.png")))
    assert paths, directory
    return np.stack([cv2.imread(p, cv2.IMREAD_UNCHANGED)[..., ::-1] for p in paths])


def _assert_transforms_close(ours_dir, ref_dir):
    ours = json.loads(open(osp.join(ours_dir, "transforms.json")).read())
    ref = json.loads(open(osp.join(ref_dir, "transforms.json")).read())
    assert ours["orientation_override"] == ref["orientation_override"]
    assert len(ours["frames"]) == len(ref["frames"])
    for a, b in zip(ours["frames"], ref["frames"]):
        assert a["file_path"] == b["file_path"] and (a["w"], a["h"]) == (b["w"], b["h"])
        for key in ("fl_x", "fl_y", "cx", "cy"):
            assert abs(a[key] - b[key]) <= 1e-6, key
        np.testing.assert_allclose(a["transform_matrix"], b["transform_matrix"], atol=1e-6)


def _scene_png(tmp_path):
    path = str(tmp_path / "scene.png")
    img = np.random.default_rng(4).integers(0, 256, (80, 64, 3), dtype=np.uint8)
    cv2.imwrite(path, img)
    return path


@pytest.mark.parametrize("task,use_traj_prior,opts", [
    ("img2trajvid", True, {"guider_types": [1, 2], "cfg": [2.0, 2.0]}),
    ("img2img", False, {}),
    ("img2trajvid_s-prob", True, {"traj_prior": "orbit", "num_targets": 4, "guider_types": [1, 2],
                                  "cfg": [2.0, 2.0]}),
])
def test_render_one_scene_matches_jax(bundles, tmp_path, task, use_traj_prior, opts):  # noqa: F811
    from stable_virtual_camera_tpu.apps import cli as jax_cli
    from stable_virtual_camera_tpu_torch.apps import cli

    port, ref = bundles
    scene = _scene_png(tmp_path) if task == "img2trajvid_s-prob" else GOLDEN
    opts = dict(opts, num_steps=2, sampler_verbose=False)
    out_dirs = {}
    for name, mod, cfg, bundle, kw in (
        ("jax", jax_cli, jax_config, ref, {}),
        ("port", cli, config, port, {"noise_fn": jax_noise}),
    ):
        version = cfg.VersionConfig(H=64, W=64, T=3)
        options = mod._default_options().update(opts)
        out_dirs[name] = mod.render_one_scene(
            bundle, version, options, task, scene, str(tmp_path / name / task),
            use_traj_prior=use_traj_prior, seed=23, **kw,
        )
    ours, theirs = out_dirs["port"], out_dirs["jax"]
    n_targets = 4 if task == "img2trajvid_s-prob" else 2
    frames = _pngs(osp.join(ours, "samples-rgb"))
    assert frames.shape == (n_targets, 64, 64, 3) and frames.std() > 0
    _assert_frames_close(frames, _pngs(osp.join(theirs, "samples-rgb")))
    _assert_frames_close(_pngs(osp.join(ours, "input")), _pngs(osp.join(theirs, "input")))
    if use_traj_prior:
        _assert_frames_close(_pngs(osp.join(ours, "first-pass", "samples-rgb")),
                             _pngs(osp.join(theirs, "first-pass", "samples-rgb")))
    assert osp.exists(osp.join(ours, "samples-rgb.mp4"))
    _assert_transforms_close(ours, theirs)
