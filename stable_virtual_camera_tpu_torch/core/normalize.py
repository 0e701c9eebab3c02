"""Scene normalization: gravity alignment, recentering, rescaling.

Capability parity with reference seva/geometry.py:651-793
(`similarity_from_cameras`, `align_principle_axes`, `transform_points`,
`transform_cameras`, `normalize_scene`). Pure numpy. A copy of
stable_virtual_camera_tpu/core/normalize.py.
"""

from __future__ import annotations

import numpy as np


def similarity_from_cameras(
    c2w: np.ndarray, strict_scaling: bool = False, center_method: str = "focus"
) -> np.ndarray:
    """Similarity transform normalizing an OpenCV-convention camera set
    (reference seva/geometry.py:651-713)."""
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    # (1) rotate the world so that z+ is up (average camera up axis)
    ups = np.sum(R * np.array([0, -1.0, 0]), axis=-1)
    world_up = np.mean(ups, axis=0)
    world_up /= np.linalg.norm(world_up)

    up_camspace = np.array([0.0, -1.0, 0.0])
    c = (up_camspace * world_up).sum()
    cross = np.cross(world_up, up_camspace)
    skew = np.array(
        [
            [0.0, -cross[2], cross[1]],
            [cross[2], 0.0, -cross[0]],
            [-cross[1], cross[0], 0.0],
        ]
    )
    if c > -1:
        R_align = np.eye(3) + skew + (skew @ skew) / (1 + c)
    else:
        R_align = np.diag([-1.0, 1.0, 1.0])

    R = R_align @ R
    fwds = np.sum(R * np.array([0, 0.0, 1.0]), axis=-1)
    t = (R_align @ t[..., None])[..., 0]

    # (2) recenter
    if center_method == "focus":
        nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
        translate = -np.median(nearest, axis=0)
    elif center_method == "poses":
        translate = -np.median(t, axis=0)
    else:
        raise ValueError(f"Unknown center_method {center_method}")

    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = R_align

    # (3) rescale by camera distances
    scale_fn = np.max if strict_scaling else np.median
    inv_scale = scale_fn(np.linalg.norm(t + translate, axis=-1))
    if inv_scale == 0:
        inv_scale = 1.0
    transform[:3, :] *= 1.0 / inv_scale
    return transform


def align_principle_axes(point_cloud: np.ndarray) -> np.ndarray:
    """PCA alignment of a point cloud (reference seva/geometry.py:716-747)."""
    centroid = np.median(point_cloud, axis=0)
    translated = point_cloud - centroid
    cov = np.cov(translated, rowvar=False)
    eigenvalues, eigenvectors = np.linalg.eigh(cov)
    sort_indices = eigenvalues.argsort()[::-1]
    eigenvectors = eigenvectors[:, sort_indices]
    if np.linalg.det(eigenvectors) < 0:
        eigenvectors[:, 0] *= -1
    rotation = eigenvectors.T
    transform = np.eye(4)
    transform[:3, :3] = rotation
    transform[:3, 3] = -rotation @ centroid
    return transform


def transform_points(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    assert matrix.shape == (4, 4)
    assert points.ndim == 2 and points.shape[1] == 3
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def transform_cameras(matrix: np.ndarray, camtoworlds: np.ndarray) -> np.ndarray:
    """Apply a (possibly scaled) SE(4) to c2ws, re-orthonormalizing rotations
    (reference seva/geometry.py:765-780)."""
    assert matrix.shape == (4, 4)
    assert camtoworlds.ndim == 3 and camtoworlds.shape[1:] == (4, 4)
    camtoworlds = np.einsum("nij, ki -> nkj", camtoworlds, matrix)
    scaling = np.linalg.norm(camtoworlds[:, 0, :3], axis=1)
    camtoworlds[:, :3, :3] = camtoworlds[:, :3, :3] / scaling[:, None, None]
    return camtoworlds


def normalize_scene(
    camtoworlds: np.ndarray,
    points: np.ndarray | None = None,
    camera_center_method: str = "focus",
):
    """Normalize a scene's cameras (and optionally points)
    (reference seva/geometry.py:783-793)."""
    T1 = similarity_from_cameras(camtoworlds, center_method=camera_center_method)
    camtoworlds = transform_cameras(T1, camtoworlds)
    if points is not None:
        points = transform_points(T1, points)
        T2 = align_principle_axes(points)
        camtoworlds = transform_cameras(T2, camtoworlds)
        points = transform_points(T2, points)
        return camtoworlds, points, T2 @ T1
    return camtoworlds, T1
