"""Per-chunk conditioning values.

Capability parity with reference seva/eval.py:1152-1215 (`get_value_dict`):
camera centering on the robust (quantile-filtered) scene mean, normalization
so the first camera's distance equals `camera_scale`, and the Plücker
embedding at latent resolution. Pure numpy; device transfer happens in the
runner. A copy of stable_virtual_camera_tpu/engine/value_dict.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from stable_virtual_camera_tpu_torch.core.camera import to_hom_pose
from stable_virtual_camera_tpu_torch.core.plucker import get_plucker_coordinates


@dataclass
class ChunkValues:
    imgs: np.ndarray  # (T, H, W, 3) in [-1, 1]
    imgs_clip: np.ndarray  # (T, H, W, 3) CLIP variant (usually identical)
    input_frame_mask: np.ndarray  # (T,) bool: latent-replace slots
    camera_mask: np.ndarray  # (T,) bool: camera-known slots
    c2w: np.ndarray  # (T, 4, 4) centered + scale-normalized
    K: np.ndarray  # (T, 3, 3) normalized intrinsics
    plucker: np.ndarray  # (T, h, w, 6) NHWC


def build_chunk_values(
    curr_imgs: np.ndarray,
    curr_imgs_clip: np.ndarray,
    curr_input_frame_indices: list[int],
    curr_c2ws: np.ndarray,  # (T, 3, 4) or (T, 4, 4)
    curr_Ks: np.ndarray,  # (T, 3, 3) normalized
    curr_input_camera_indices: list[int],
    all_c2ws: np.ndarray,  # (N, 3|4, 4): full scene cameras for centering
    camera_scale: float = 2.0,
    latent_hw: tuple[int, int] | None = None,
) -> ChunkValues:
    assert sorted(curr_input_camera_indices) == sorted(
        range(len(curr_input_camera_indices))
    )
    T = len(curr_imgs)
    H, W = curr_imgs.shape[1:3]
    if latent_hw is None:
        latent_hw = (H // 8, W // 8)

    input_frame_mask = np.zeros(T, dtype=bool)
    input_frame_mask[curr_input_frame_indices] = True
    camera_mask = np.zeros(T, dtype=bool)
    camera_mask[curr_input_camera_indices] = True

    c2w = to_hom_pose(np.asarray(curr_c2ws, dtype=np.float64))

    # Camera centering: subtract the mean of scene cameras within 10x the 97%
    # quantile of distance-to-median (reference seva/eval.py:1178-1188).
    ref = to_hom_pose(np.asarray(all_c2ws, dtype=np.float64))
    t_ref = ref[:, :3, 3]
    camera_dist_2med = np.linalg.norm(
        t_ref - np.median(t_ref, axis=0, keepdims=True), axis=-1
    )
    valid = camera_dist_2med <= min(np.quantile(camera_dist_2med, 0.97) * 10, 1e6)
    c2w[:, :3, 3] -= t_ref[valid].mean(0, keepdims=True)

    # Normalize so the first camera sits at distance `camera_scale`
    # (reference seva/eval.py:1191-1202).
    d0 = np.linalg.norm(c2w[0, :3, 3])
    factor = camera_scale if np.isclose(d0, 0.0, atol=1e-5) else camera_scale / d0
    c2w[:, :3, 3] *= factor

    w2c = np.linalg.inv(c2w)
    plucker = get_plucker_coordinates(
        extrinsics_src=w2c[0],
        extrinsics=w2c,
        intrinsics=np.asarray(curr_Ks, dtype=np.float64).copy(),
        target_size=latent_hw,
    )

    return ChunkValues(
        imgs=np.asarray(curr_imgs, np.float32),
        imgs_clip=np.asarray(curr_imgs_clip, np.float32),
        input_frame_mask=input_frame_mask,
        camera_mask=camera_mask,
        c2w=c2w.astype(np.float32),
        K=np.asarray(curr_Ks, np.float32),
        plucker=plucker,
    )
