"""Camera math on the host: pure numpy, no accelerator. A copy of
stable_virtual_camera_tpu/core/camera.py (the port imports nothing of the JAX
package).

Behavioral parity targets (capability, not code): reference
seva/geometry.py:12-79 (`get_camera_dist`, `get_default_intrinsics`) and
homogeneous-coordinate helpers (seva/geometry.py:43-55).

All poses follow the reference's OpenCV convention: `c2w` maps camera
coordinates (x right, y down, z forward) to world; `w2c = inv(c2w)`.
"""

from __future__ import annotations

import numpy as np

DEFAULT_FOV_RAD = 0.9424777960769379  # 54 degrees (reference seva/geometry.py:9)


def to_hom(x: np.ndarray) -> np.ndarray:
    """Append a 1-column: (..., k) -> (..., k+1)."""
    return np.concatenate([x, np.ones_like(x[..., :1])], axis=-1)


def to_hom_pose(pose: np.ndarray) -> np.ndarray:
    """(..., 3, 4) -> (..., 4, 4) with a [0 0 0 1] bottom row; 4x4 passthrough."""
    if pose.shape[-2:] == (3, 4):
        bottom = np.zeros(pose.shape[:-2] + (1, 4), dtype=pose.dtype)
        bottom[..., 0, 3] = 1.0
        return np.concatenate([pose, bottom], axis=-2)
    return pose


def rt_to_mat4(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Stack rotation (..., 3, 3) and translation (..., 3) into (..., 4, 4)."""
    mat34 = np.concatenate([R, t[..., None]], axis=-1)
    bottom = np.zeros(mat34.shape[:-2] + (1, 4), dtype=mat34.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([mat34, bottom], axis=-2)


def rotation_distance_deg(source_c2ws: np.ndarray, target_c2ws: np.ndarray) -> np.ndarray:
    """Pairwise geodesic rotation distance in degrees, (N, M).

    Same metric as reference seva/geometry.py:17-31: arccos((tr(R_s R_t^T)-1)/2).
    """
    R_s = source_c2ws[:, None, :3, :3]
    R_t = np.swapaxes(target_c2ws[None, :, :3, :3], -1, -2)
    tr = np.einsum("nmij,nmji->nm", R_s, R_t)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.arccos(cos) * (180.0 / np.pi)


def translation_distance(source_c2ws: np.ndarray, target_c2ws: np.ndarray) -> np.ndarray:
    """Pairwise L2 distance between camera centers, (N, M)
    (reference seva/geometry.py:32-35)."""
    d = source_c2ws[:, None, :3, 3] - target_c2ws[None, :, :3, 3]
    return np.linalg.norm(d, axis=-1)


def get_camera_dist(
    source_c2ws: np.ndarray, target_c2ws: np.ndarray, mode: str = "translation"
) -> np.ndarray:
    if mode == "rotation":
        return rotation_distance_deg(source_c2ws, target_c2ws)
    if mode == "translation":
        return translation_distance(source_c2ws, target_c2ws)
    raise NotImplementedError(f"Mode {mode} is not implemented.")


def get_default_intrinsics(
    fov_rad: float | np.ndarray = DEFAULT_FOV_RAD,
    aspect_ratio: float = 1.0,
) -> np.ndarray:
    """Normalized pinhole K(s) from FOV (reference seva/geometry.py:58-79).

    The FOV applies to the *shorter* side; principal point at (0.5, 0.5).
    Returns (N, 3, 3) float32 with focals in normalized image units.
    """
    fov = np.atleast_1d(np.asarray(fov_rad, dtype=np.float64))
    if aspect_ratio >= 1.0:  # W >= H
        focal_x = 0.5 / np.tan(0.5 * fov)
        focal_y = focal_x * aspect_ratio
    else:
        focal_y = 0.5 / np.tan(0.5 * fov)
        focal_x = focal_y / aspect_ratio
    n = fov.shape[0]
    K = np.zeros((n, 3, 3), dtype=np.float64)
    K[:, 0, 0] = focal_x
    K[:, 1, 1] = focal_y
    K[:, 2, 2] = 1.0
    K[:, 0, 2] = 0.5
    K[:, 1, 2] = 0.5
    return K.astype(np.float32)


def get_image_grid(img_h: int, img_w: int) -> np.ndarray:
    """Homogeneous pixel-center grid, row-major (y outer, x inner): (H*W, 3).

    The +0.5 pixel-center offset is load-bearing at latent resolutions
    (reference seva/geometry.py:82-89).
    """
    y = np.arange(img_h, dtype=np.float64) + 0.5
    x = np.arange(img_w, dtype=np.float64) + 0.5
    Y, X = np.meshgrid(y, x, indexing="ij")
    grid = np.stack([X, Y], axis=-1).reshape(-1, 2)
    return to_hom(grid)


def normalize_Ks_if_needed(Ks: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """If principal points look unnormalized, divide rows 0/1 by (W*8, H*8).

    Mirrors the defensive renormalization at reference seva/geometry.py:128-141
    (there `target_size` is the latent grid, hence the *8 factor).
    """
    Ks = Ks.copy()
    cx_cy = Ks[:, :2, -1]
    if not (np.all(cx_cy >= 0) and np.all(cx_cy <= 1)):
        scale = np.array([hw[1], hw[0]], dtype=Ks.dtype).reshape(1, 2, 1) * 8
        Ks[:, :2] = Ks[:, :2] / scale
    cx_cy = Ks[:, :2, -1]
    assert np.all(cx_cy >= 0) and np.all(cx_cy <= 1), (
        "Intrinsics should be expressed in resolution-independent normalized "
        "image coordinates."
    )
    return Ks
