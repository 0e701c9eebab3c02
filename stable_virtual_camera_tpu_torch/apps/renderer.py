"""Headless renderer behind the GUI: Basic- and Advanced-mode preprocess + render.

Counterpart of `preprocess_basic`, `preprocess_advanced` and
`HeadlessRenderer` in stable_virtual_camera_tpu/apps/renderer.py. In Basic
mode one unposed image gets the identity pose and default intrinsics and a
preset trajectory gives the targets; in Advanced mode a DUSt3R pipeline
(apps/preprocessor.py) poses several images, the scene is normalized, and a
keyframe trajectory (apps/trajectory.py) gives the targets as a
`camera_traj_list`. `engine.prior.resolve_anchors` places the anchors, and
the two-pass engine renders them. With `work_dir=None` nothing is written and the render
generator yields uint8 frames (see engine/runner.py).
"""

from __future__ import annotations

import copy
import os.path as osp
from datetime import datetime

import numpy as np

from stable_virtual_camera_tpu_torch.config import EngineOptions, VersionConfig
from stable_virtual_camera_tpu_torch.core.camera import get_default_intrinsics
from stable_virtual_camera_tpu_torch.core.normalize import normalize_scene
from stable_virtual_camera_tpu_torch.core.trajectories import get_preset_pose_fov
from stable_virtual_camera_tpu_torch.core.transforms import transform_img_and_K
from stable_virtual_camera_tpu_torch.engine import planner
from stable_virtual_camera_tpu_torch.engine.prior import resolve_anchors
from stable_virtual_camera_tpu_torch.engine.runner import ModelBundle, SceneEngine
from stable_virtual_camera_tpu_torch.sampling.sampler import torch_noise


def preprocess_basic(img: np.ndarray, shorter: int = 576) -> dict:
    """Single unposed image -> identity pose + default K."""
    shorter = round(shorter / 64) * 64
    imgs = np.asarray(img, np.float32)[None, ..., :3] / (255.0 if img.dtype == np.uint8 else 1.0)
    imgs = imgs * 2.0 - 1.0
    imgs, _ = transform_img_and_K(imgs, shorter, K=None, size_stride=64)
    H, W = imgs.shape[1:3]
    return {
        "input_imgs": (imgs + 1.0) / 2.0,
        "input_Ks": get_default_intrinsics(aspect_ratio=W / H),
        "input_c2ws": np.eye(4)[None],
        "input_wh": (W, H),
        "points": [np.zeros((0, 3))],
        "point_colors": [np.zeros((0, 3))],
        "scene_scale": 1.0,
    }


def preprocess_advanced(img_paths: list[str], dust3r, shorter: int = 576) -> dict:
    """Unposed images -> DUSt3R poses and points (`dust3r`: a pipeline of
    apps/preprocessor.py) -> a normalized scene of unit scale, images and
    normalized intrinsics at the shorter side `shorter` snapped to /64."""
    shorter = round(shorter / 64) * 64
    input_imgs, input_Ks, input_c2ws, points, point_colors = dust3r.infer_cameras_and_points(img_paths)
    input_imgs = [im[..., :3] for im in input_imgs]
    point_indices = np.cumsum([p.shape[0] for p in points])[:-1]
    input_c2ws, pts, _ = normalize_scene(
        input_c2ws, np.concatenate(points, 0), camera_center_method="poses"
    )
    points = np.split(pts, point_indices, 0)
    scene_scale = np.median(np.ptp(np.concatenate([input_c2ws[:, :3, 3], *points], 0), -1))
    input_c2ws[:, :3, 3] /= scene_scale
    points = [p / scene_scale for p in points]

    new_imgs, new_Ks = [], []
    for im, K in zip(input_imgs, input_Ks):
        im4 = np.asarray(im, np.float32)[None] * 2.0 - 1.0
        im4, K = transform_img_and_K(im4, shorter, K=K[None], size_stride=64)
        new_imgs.append(im4)
        new_Ks.append(K[0] / np.array([im4.shape[2], im4.shape[1], 1.0])[:, None])
    imgs = np.concatenate(new_imgs, 0)
    return {
        "input_imgs": (imgs + 1.0) / 2.0,
        "input_Ks": np.stack(new_Ks),
        "input_c2ws": input_c2ws,
        "input_wh": (imgs.shape[2], imgs.shape[1]),
        "points": points,
        "point_colors": point_colors,
        "scene_scale": float(scene_scale),
    }


def decoding_frames(H: int, W: int) -> int:
    """Frames per VAE decode batch (0 = the whole chunk at once), by the JAX
    renderer's rule: one batch up to 576x576; above it, batches of about 60%
    of the frames that fit at 576x576, scaled by the pixel count, at least 4
    (9 at 768x576)."""
    if H * W <= 576 * 576:
        return 0
    return max(4, int(21 * (576 * 576) / (H * W) * 0.6))


class HeadlessRenderer:
    """The GUI's render path without the GUI."""

    def __init__(self, bundle: ModelBundle, work_dir: str | None = "work_dirs/gradio",
                 noise_fn=torch_noise):
        self.bundle = bundle
        self.work_dir = work_dir
        self.noise_fn = noise_fn
        self.version = VersionConfig()

    def target_cameras_from_traj_list(self, camera_traj_list: list[dict]):
        target_c2ws, target_Ks = [], []
        for item in camera_traj_list:
            W, H = item["img_wh"]
            w2c = np.array(item["w2c"]).reshape(4, 4)
            target_c2ws.append(np.linalg.inv(w2c))
            target_Ks.append(np.array(item["K"]).reshape(3, 3) / np.array([W, H, 1.0])[:, None])
        return np.stack(target_c2ws), np.stack(target_Ks)

    def target_cameras_from_preset(self, preprocessed: dict, preset_traj: str,
                                   num_frames: int, zoom_factor: float | None):
        W, H = preprocessed["input_wh"]
        poses, fovs = get_preset_pose_fov(
            preset_traj, num_frames, np.eye(4), np.array([0.0, 0.0, 10.0]),
            np.array([0.0, -1.0, 0.0]), zoom_factor=zoom_factor,
        )
        return poses, get_default_intrinsics(fovs, aspect_ratio=W / H)

    def prepare(
        self,
        preprocessed: dict,
        seed: int = 23,
        chunk_strategy: str = "interp-gt",
        cfg: float = 4.0,
        camera_traj_list: list[dict] | None = None,
        preset_traj: str | None = None,
        num_frames: int | None = None,
        zoom_factor: float | None = None,
        camera_scale: float = 2.0,
        num_steps: int = 50,
        min_anchor_fill: bool = False,
        deliver_anchors: bool | None = None,
    ) -> dict:
        """Resolve the render plan: targets, anchors (dense economy and AUTO
        delivery as in the JAX package), options and both passes' chunk
        counts. Each plan gets its own options object."""
        input_imgs = np.asarray(preprocessed["input_imgs"], np.float32)
        input_Ks = np.asarray(preprocessed["input_Ks"])
        input_c2ws = np.asarray(preprocessed["input_c2ws"])
        W, H = preprocessed["input_wh"]
        num_inputs = len(input_imgs)
        if num_inputs > 10:
            chunk_strategy = "interp"

        if preset_traj is None:
            assert camera_traj_list is not None
            target_c2ws, target_Ks = self.target_cameras_from_traj_list(camera_traj_list)
        else:
            assert num_frames is not None and num_inputs == 1
            input_c2ws = np.eye(4)[None]
            target_c2ws, target_Ks = self.target_cameras_from_preset(
                preprocessed, preset_traj, num_frames, zoom_factor
            )
        all_c2ws = np.concatenate([input_c2ws, target_c2ws], 0)
        all_Ks = np.concatenate([input_Ks, target_Ks], 0) * np.array([W, H, 1.0])[:, None]
        num_targets = len(target_c2ws)
        input_indices = list(range(num_inputs))

        version = copy.deepcopy(self.version)
        version.H, version.W = H, W
        options = EngineOptions(
            chunk_strategy=chunk_strategy,
            video_save_fps=30.0,
            guider_types=[1, 2],
            cfg=[float(cfg), 3.0 if num_inputs >= 9 else 2.0],
            camera_scale=camera_scale,
            num_steps=num_steps,
            cfg_min=1.2,
            encoding_t=0,
            decoding_t=decoding_frames(H, W),
            min_anchor_fill=min_anchor_fill,
        )
        if deliver_anchors is not None:
            options.set("deliver_anchors", bool(deliver_anchors))
        rel, _dense = resolve_anchors(version.T, num_inputs, num_targets, version, options)
        anchor_indices = [num_inputs + r for r in rel]
        anchor_rows = [round(ind) for ind in anchor_indices]

        first_chunks, second_chunks = self.chunk_counts(
            input_c2ws, all_c2ws[anchor_rows], target_c2ws, input_indices, anchor_rows,
            list(range(num_inputs, num_inputs + num_targets)), options, version.T,
        )
        all_imgs = (
            np.concatenate([input_imgs, np.zeros((num_targets,) + input_imgs.shape[1:])], 0) * 255.0
        ).astype(np.uint8)
        return {
            "version": version,
            "options": options,
            "seed": seed,
            "image_cond": {
                "img": list(all_imgs),
                "input_indices": input_indices,
                "prior_indices": anchor_indices,
            },
            "camera_cond": {
                "c2w": all_c2ws.astype(np.float32),
                "K": list(all_Ks.astype(np.float32)),
                "input_indices": list(range(num_inputs + num_targets)),
            },
            "anchor_c2ws": all_c2ws[anchor_rows],
            "anchor_Ks": all_Ks[anchor_rows],
            "first_pass_steps": first_chunks * num_steps,
            "second_pass_steps": second_chunks * num_steps,
            "first_pass_chunks": first_chunks,
            "second_pass_chunks": second_chunks,
        }

    def run(self, plan: dict, abort_event=None, first_pass_pbar=None, second_pass_pbar=None):
        """Execute a prepared plan; returns the engine's generator."""
        render_dir = None
        if self.work_dir is not None:
            render_dir = osp.join(self.work_dir, datetime.now().strftime("%Y%m%d_%H%M%S"))
        engine = SceneEngine(self.bundle, plan["version"], plan["options"], noise_fn=self.noise_fn)
        return engine.run_one_scene(
            "img2trajvid",
            plan["image_cond"],
            plan["camera_cond"],
            save_path=render_dir,
            use_traj_prior=True,
            traj_prior_Ks=plan["anchor_Ks"],
            traj_prior_c2ws=plan["anchor_c2ws"],
            seed=plan["seed"],
            abort_event=abort_event,
            first_pass_pbar=first_pass_pbar,
            second_pass_pbar=second_pass_pbar,
        )

    def render(self, preprocessed: dict, abort_event=None, first_pass_pbar=None,
               second_pass_pbar=None, **kwargs):
        """prepare + run in one call; returns the engine's generator."""
        plan = self.prepare(preprocessed, **kwargs)
        return self.run(plan, abort_event=abort_event, first_pass_pbar=first_pass_pbar,
                        second_pass_pbar=second_pass_pbar)

    def chunk_counts(self, input_c2ws, anchor_c2ws, target_c2ws, input_indices,
                     anchor_indices, target_indices, options, T) -> tuple[int, int]:
        """Both passes' chunk counts, for progress-bar sizing."""
        quiet = copy.deepcopy(options)
        quiet.sampler_verbose = False
        T_first = T[0] if isinstance(T, (list, tuple)) else T
        n0 = len(planner.chunk_input_and_test(
            T_first, input_c2ws, anchor_c2ws, input_indices, anchor_indices,
            options=quiet, task="img2trajvid",
            chunk_strategy=quiet.get("chunk_strategy_first_pass", "gt-nearest"),
            gt_input_inds=list(range(len(input_c2ws))),
        ).input_inds_per_chunk)
        argsort = np.argsort(list(input_indices) + list(anchor_indices), kind="stable").tolist()
        sorted_anchor_indices = np.array(list(input_indices) + list(anchor_indices))[argsort].tolist()
        gt_input_inds = [argsort.index(i) for i in range(len(input_c2ws))]
        anchor_c2ws_second = np.concatenate([input_c2ws, anchor_c2ws], 0)[argsort]
        T_second = T[1] if isinstance(T, (list, tuple)) else T
        if quiet.get("deliver_anchors", False):
            coincident = set(anchor_indices)
            keep = [j for j, t in enumerate(target_indices) if t not in coincident]
            target_c2ws = target_c2ws[keep]
            target_indices = [target_indices[j] for j in keep]
        n1 = len(planner.chunk_input_and_test(
            T_second, anchor_c2ws_second, target_c2ws, sorted_anchor_indices, target_indices,
            options=quiet, task="img2trajvid",
            chunk_strategy=quiet.get("chunk_strategy", "nearest"),
            gt_input_inds=gt_input_inds,
        ).input_inds_per_chunk)
        return n0, n1
