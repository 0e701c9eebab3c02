"""Plücker-ray camera conditioning.

Capability parity with reference seva/geometry.py:119-165
(`get_plucker_coordinates`): per-pixel rays of each camera expressed in the
coordinate frame of the first (source) camera, packed as
(ray_direction, camera_center x ray_direction).

Host-side numpy (the tensor is tiny: T x h x w x 6 at latent resolution) in
the models' NHWC layout. A copy of stable_virtual_camera_tpu/core/plucker.py.
"""

from __future__ import annotations

import numpy as np

from stable_virtual_camera_tpu_torch.core.camera import (
    get_image_grid,
    normalize_Ks_if_needed,
    to_hom,
)


def get_plucker_coordinates(
    extrinsics_src: np.ndarray,  # (4, 4) w2c of the source (first) camera
    extrinsics: np.ndarray,  # (V, 4, 4) w2c of all cameras
    intrinsics: np.ndarray,  # (V, 3, 3) normalized K
    target_size: tuple[int, int] = (72, 72),  # latent (h, w)
) -> np.ndarray:
    """Returns (V, h, w, 6) float32: [unit ray dir | center x dir].

    Steps mirror reference seva/geometry.py:143-165:
      1. relative extrinsics w.r.t. the source camera,
      2. K scaled to the latent grid,
      3. pixel-center grid unprojected to the source frame,
      4. plucker = (normalize(ray), cross(center, ray)).
    """
    extrinsics_src = np.asarray(extrinsics_src, dtype=np.float64)
    extrinsics = np.asarray(extrinsics, dtype=np.float64)
    intrinsics = normalize_Ks_if_needed(
        np.asarray(intrinsics, dtype=np.float64), target_size
    )

    h, w = int(target_size[0]), int(target_size[1])
    V = extrinsics.shape[0]

    c2w_src = np.linalg.inv(extrinsics_src)
    # w2c of each camera relative to the source camera's frame
    # (reference seva/geometry.py:143-147).
    extrinsics_rel = extrinsics @ c2w_src[None]

    K = intrinsics.copy()
    K[:, 0] *= w
    K[:, 1] *= h

    grid = get_image_grid(h, w)  # (h*w, 3) homogeneous pixel centers
    # pixel -> camera coordinates (reference seva/geometry.py:92-93)
    grid_cam = grid[None] @ np.swapaxes(np.linalg.inv(K), -1, -2)  # (V, h*w, 3)
    # camera -> source-relative world coordinates (reference seva/geometry.py:96-116)
    c2w_rel = np.linalg.inv(extrinsics_rel)[:, :3, :4]  # (V, 3, 4)
    grid_world = to_hom(grid_cam) @ np.swapaxes(c2w_rel, -1, -2)
    centers = np.broadcast_to(c2w_rel[:, None, :3, 3], (V, h * w, 3))

    rays = grid_world - centers
    rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    moments = np.cross(centers, rays)
    plucker = np.concatenate([rays, moments], axis=-1)  # (V, h*w, 6)
    return plucker.reshape(V, h, w, 6).astype(np.float32)
