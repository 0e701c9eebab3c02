"""Camera trajectory synthesis: the preset moves of the Basic-mode GUI.

A copy of stable_virtual_camera_tpu/core/trajectories.py (reference
seva/geometry.py:193-648): `get_preset_pose_fov`, look-at triangulation, the
NeRF-style spiral and the B-spline keyframe path
(`generate_interpolated_path`, which imports scipy when called). Pure numpy
on the host.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from stable_virtual_camera_tpu_torch.core.camera import (
    DEFAULT_FOV_RAD,
    rt_to_mat4,
)

PresetName = Literal[
    "orbit",
    "spiral",
    "lemniscate",
    "zoom-in",
    "zoom-out",
    "dolly zoom-in",
    "dolly zoom-out",
    "move-forward",
    "move-backward",
    "move-up",
    "move-down",
    "move-left",
    "move-right",
    "roll",
]

PRESETS: tuple[str, ...] = (
    "orbit",
    "spiral",
    "lemniscate",
    "zoom-in",
    "zoom-out",
    "dolly zoom-in",
    "dolly zoom-out",
    "move-forward",
    "move-backward",
    "move-up",
    "move-down",
    "move-left",
    "move-right",
    "roll",
)


def _normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def rotvec_to_rotmat(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues: (N, 3) rotation vectors -> (N, 3, 3) rotation matrices."""
    rotvec = np.asarray(rotvec, dtype=np.float64)
    theta = np.linalg.norm(rotvec, axis=-1, keepdims=True)
    small = theta[..., 0] < 1e-12
    axis = np.where(small[..., None], 0.0, rotvec / np.where(theta == 0, 1.0, theta))
    K = np.zeros(rotvec.shape[:-1] + (3, 3), dtype=np.float64)
    K[..., 0, 1] = -axis[..., 2]
    K[..., 0, 2] = axis[..., 1]
    K[..., 1, 0] = axis[..., 2]
    K[..., 1, 2] = -axis[..., 0]
    K[..., 2, 0] = -axis[..., 1]
    K[..., 2, 1] = axis[..., 0]
    eye = np.broadcast_to(np.eye(3), K.shape)
    s = np.sin(theta)[..., None]
    c = np.cos(theta)[..., None]
    R = eye + s * K + (1 - c) * (K @ K)
    return np.where(small[..., None, None], eye, R)


def get_lookat(origins: np.ndarray, viewdirs: np.ndarray) -> np.ndarray:
    """Least-squares triangulation of a look-at point from N rays
    (reference seva/geometry.py:330-351)."""
    d = _normalize(np.asarray(viewdirs, dtype=np.float64))
    o = np.asarray(origins, dtype=np.float64)
    eye = np.eye(3)
    I_min_cov = eye[None] - d[..., :, None] * d[..., None, :]  # (N, 3, 3)
    sum_proj = (I_min_cov @ o[..., :, None]).sum(axis=-3)  # (3, 1)
    A = I_min_cov.sum(axis=-3)
    lookat, *_ = np.linalg.lstsq(A, sum_proj, rcond=None)
    lookat = lookat[..., 0]
    assert not np.any(np.isnan(lookat))
    return lookat


def get_lookat_w2cs(
    positions: np.ndarray,
    lookat: np.ndarray,
    up: np.ndarray,
    face_off: bool = False,
) -> np.ndarray:
    """Look-at w2c construction (reference seva/geometry.py:354-380).

    OpenCV convention: camera x right, y down, z forward; R columns are
    (right, down, forward).
    """
    positions = np.asarray(positions, dtype=np.float64)
    forward = _normalize(lookat[None] - positions)
    if face_off:
        forward = -forward
    up = np.asarray(up, dtype=np.float64)
    if up.ndim == 1:
        up = up[None]
    right = _normalize(np.cross(forward, up))
    down = _normalize(np.cross(forward, right))
    Rs = np.stack([right, down, forward], axis=-1)
    return np.linalg.inv(rt_to_mat4(Rs, positions))


def get_arc_horizontal_w2cs(
    ref_w2c: np.ndarray,
    lookat: np.ndarray,
    up: np.ndarray | None,
    num_frames: int,
    clockwise: bool = True,
    face_off: bool = False,
    endpoint: bool = False,
    degree: float = 360.0,
    ref_up_shift: float = 0.0,
    ref_radius_scale: float = 1.0,
    **_,
) -> np.ndarray:
    """Orbit around `lookat` about the up axis (reference seva/geometry.py:383-420)."""
    ref_c2w = np.linalg.inv(np.asarray(ref_w2c, dtype=np.float64))
    ref_position = ref_c2w[:3, 3].copy()
    if up is None:
        up = -ref_c2w[:3, 1]
    up = np.asarray(up, dtype=np.float64)
    ref_position = (ref_position + up * ref_up_shift) * ref_radius_scale
    thetas = _theta_range(degree, num_frames, endpoint)
    if not clockwise:
        thetas = -thetas
    R = rotvec_to_rotmat(thetas[:, None] * up[None])
    positions = np.einsum("nij,j->ni", R, ref_position - lookat) + lookat
    return get_lookat_w2cs(positions, np.asarray(lookat, dtype=np.float64), up, face_off)


def _theta_range(degree: float, num_frames: int, endpoint: bool) -> np.ndarray:
    full = np.pi * degree / 180.0
    if endpoint:
        return np.linspace(0.0, full, num_frames)
    return np.linspace(0.0, full, num_frames + 1)[:-1]


def get_lemniscate_w2cs(
    ref_w2c: np.ndarray,
    lookat: np.ndarray,
    up: np.ndarray | None,
    num_frames: int,
    degree: float,
    endpoint: bool = False,
    **_,
) -> np.ndarray:
    """Lemniscate-of-Bernoulli trajectory (reference seva/geometry.py:423-455)."""
    ref_c2w = np.linalg.inv(np.asarray(ref_w2c, dtype=np.float64))
    lookat = np.asarray(lookat, dtype=np.float64)
    a = np.linalg.norm(ref_c2w[:3, 3] - lookat) * np.tan(degree / 360.0 * np.pi)
    thetas = (
        np.linspace(0, 2 * np.pi, num_frames)
        if endpoint
        else np.linspace(0, 2 * np.pi, num_frames + 1)[:-1]
    ) + np.pi / 2
    positions_cam = np.stack(
        [
            a * np.cos(thetas) / (1 + np.sin(thetas) ** 2),
            a * np.cos(thetas) * np.sin(thetas) / (1 + np.sin(thetas) ** 2),
            np.zeros(num_frames),
        ],
        axis=-1,
    )
    positions = np.einsum(
        "ij,nj->ni",
        ref_c2w[:3],
        np.concatenate([positions_cam, np.ones((num_frames, 1))], axis=-1),
    )
    if up is None:
        up = -ref_c2w[:3, 1]
    return get_lookat_w2cs(positions, lookat, np.asarray(up, dtype=np.float64))


def get_moving_w2cs(
    ref_w2c: np.ndarray,
    lookat: np.ndarray,
    up: np.ndarray | None,
    num_frames: int,
    endpoint: bool = False,
    direction: str = "forward",
    tilt_xy: np.ndarray | None = None,
) -> np.ndarray:
    """Linear moves toward/away/around the look-at point
    (reference seva/geometry.py:458-506)."""
    ref_c2w = np.linalg.inv(np.asarray(ref_w2c, dtype=np.float64))
    lookat = np.asarray(lookat, dtype=np.float64)
    ref_position = ref_c2w[:3, 3]
    if up is None:
        up = -ref_c2w[:3, 1]
    up = np.asarray(up, dtype=np.float64)

    direction_vectors = {
        "forward": lookat - ref_position,
        "backward": -(lookat - ref_position),
        "up": up,
        "down": -up,
        "right": np.cross(lookat - ref_position, up),
        "left": -np.cross(lookat - ref_position, up),
    }
    if direction not in direction_vectors:
        raise ValueError(f"Invalid direction: {direction}.")
    steps = (
        np.linspace(0, 0.99, num_frames)
        if endpoint
        else np.linspace(0, 1, num_frames + 1)[:-1]
    )
    positions = ref_position + _normalize(direction_vectors[direction]) * steps[:, None]
    if tilt_xy is not None:
        positions[:, :2] += tilt_xy
    return get_lookat_w2cs(positions, lookat, up)


def get_roll_w2cs(
    ref_w2c: np.ndarray,
    lookat: np.ndarray,
    up: np.ndarray | None,
    num_frames: int,
    endpoint: bool = False,
    degree: float = 360.0,
    **_,
) -> np.ndarray:
    """In-place camera roll about the direction of the look-at point
    (reference seva/geometry.py:509-543)."""
    ref_c2w = np.linalg.inv(np.asarray(ref_w2c, dtype=np.float64))
    lookat = np.asarray(lookat, dtype=np.float64)
    ref_position = ref_c2w[:3, 3]
    if up is None:
        up = -ref_c2w[:3, 1]
    up = np.asarray(up, dtype=np.float64)

    thetas = _theta_range(degree, num_frames, endpoint)[:, None]
    lookat_vector = _normalize(lookat[None])
    up_b = up[None]
    up_rot = (
        up_b * np.cos(thetas)
        + np.cross(lookat_vector, up_b) * np.sin(thetas)
        + lookat_vector
        * np.einsum("ij,ij->i", lookat_vector, up_b)[:, None]
        * (1 - np.cos(thetas))
    )
    positions = np.repeat(ref_position[None], num_frames, axis=0)
    return get_lookat_w2cs(positions, lookat, up_rot)


# ---------------------------------------------------------------------------
# NeRF-style spiral (reference seva/geometry.py:546-596)
# ---------------------------------------------------------------------------


def viewmatrix(
    lookdir: np.ndarray,
    up: np.ndarray,
    position: np.ndarray,
    subtract_position: bool = False,
) -> np.ndarray:
    """3x4 look-at view matrix with columns (x, y, z, position)
    (reference seva/geometry.py:551-557; OpenGL-ish handedness — callers flip
    axes with diag(1,-1,-1,1) as the reference does)."""
    vec2 = _normalize((lookdir - position) if subtract_position else lookdir)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    position = poses[:, :3, 3].mean(0)
    z_axis = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    return viewmatrix(z_axis, up, position)


def generate_spiral_path(
    poses: np.ndarray,
    bounds: np.ndarray,
    n_frames: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
    endpoint: bool = False,
    radii: np.ndarray | list[float] | None = None,
) -> np.ndarray:
    """Forward-facing spiral with disparity-weighted focus depth
    (reference seva/geometry.py:569-596)."""
    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1 / ((1 - dt) / close_depth + dt / inf_depth)

    positions = poses[:, :3, 3]
    if radii is None:
        radii = np.percentile(np.abs(positions), 90, 0)
    radii = np.concatenate([np.asarray(radii, dtype=np.float64), [1.0]])

    render_poses = []
    cam2world = poses_avg(poses)
    up = poses[:, :3, 1].mean(0)
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=endpoint):
        t = radii * np.array(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        )
        position = cam2world @ t
        lookat = cam2world @ np.array([0, 0, -focal, 1.0])
        z_axis = position - lookat
        render_poses.append(viewmatrix(z_axis, up, position))
    return np.stack(render_poses, axis=0)


def generate_interpolated_path(
    poses: np.ndarray,
    n_interp: int,
    spline_degree: int = 5,
    smoothness: float = 0.03,
    rot_weight: float = 0.1,
    endpoint: bool = False,
) -> np.ndarray:
    """Smooth B-spline path through keyframes in (pos, lookat, up) point space
    (reference seva/geometry.py:599-648). Returns (n_interp * (n-1), 3, 4)."""
    import scipy.interpolate

    def poses_to_points(poses: np.ndarray, dist: float) -> np.ndarray:
        pos = poses[:, :3, -1]
        lookat = poses[:, :3, -1] - dist * poses[:, :3, 2]
        up = poses[:, :3, -1] + dist * poses[:, :3, 1]
        return np.stack([pos, lookat, up], 1)

    def points_to_poses(points: np.ndarray) -> np.ndarray:
        return np.array([viewmatrix(p - l, u - p, p) for p, l, u in points])

    def interp(points: np.ndarray, n: int, k: int, s: float) -> np.ndarray:
        sh = points.shape
        pts = np.reshape(points, (sh[0], -1))
        k = min(k, sh[0] - 1)
        tck, _ = scipy.interpolate.splprep(pts.T, k=k, s=s)
        u = np.linspace(0, 1, n, endpoint=endpoint)
        new_points = np.array(scipy.interpolate.splev(u, tck))
        return np.reshape(new_points.T, (n, sh[1], sh[2]))

    points = poses_to_points(poses, dist=rot_weight)
    new_points = interp(points, n_interp * (points.shape[0] - 1), k=spline_degree, s=smoothness)
    return points_to_poses(new_points)


# ---------------------------------------------------------------------------
# Preset dispatch (reference seva/geometry.py:193-327)
# ---------------------------------------------------------------------------


def get_preset_pose_fov(
    option: PresetName,
    num_frames: int,
    start_w2c: np.ndarray,
    look_at: np.ndarray,
    up_direction: np.ndarray | None = None,
    fov: float = DEFAULT_FOV_RAD,
    spiral_radii: list[float] = [0.5, 0.5, 0.2],
    zoom_factor: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (c2w poses (N, 4, 4), per-frame FOVs (N,)) for 13 preset moves."""
    start_w2c = np.asarray(start_w2c, dtype=np.float64)
    look_at = np.asarray(look_at, dtype=np.float64)

    if option == "orbit":
        poses = np.linalg.inv(
            get_arc_horizontal_w2cs(
                start_w2c, look_at, up_direction, num_frames=num_frames, endpoint=False
            )
        )
        fovs = np.full((num_frames,), fov)
    elif option == "spiral":
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        poses34 = generate_spiral_path(
            np.linalg.inv(start_w2c)[None] @ flip,
            np.array([1, 5]),
            n_frames=num_frames,
            n_rots=2,
            zrate=0.5,
            radii=spiral_radii,
            endpoint=False,
        ) @ flip
        poses = np.concatenate(
            [
                poses34,
                np.repeat(np.array([0.0, 0.0, 0.0, 1.0])[None, None], len(poses34), 0),
            ],
            axis=1,
        )
        # re-anchor so the trajectory starts exactly at start_w2c
        # (reference seva/geometry.py:247-251)
        poses = np.linalg.inv(start_w2c)[None] @ np.linalg.inv(poses[:1]) @ poses
        fovs = np.full((num_frames,), fov)
    elif option == "lemniscate":
        poses = np.linalg.inv(
            get_lemniscate_w2cs(
                start_w2c, look_at, up_direction, num_frames, degree=60.0, endpoint=False
            )
        )
        fovs = np.full((num_frames,), fov)
    elif option == "roll":
        poses = np.linalg.inv(
            get_roll_w2cs(
                start_w2c, look_at, None, num_frames, degree=360.0, endpoint=False
            )
        )
        fovs = np.full((num_frames,), fov)
    elif option in ("dolly zoom-in", "dolly zoom-out", "zoom-in", "zoom-out"):
        if option.startswith("dolly"):
            direction = "backward" if option == "dolly zoom-in" else "forward"
            poses = np.linalg.inv(
                get_moving_w2cs(
                    start_w2c,
                    look_at,
                    up_direction,
                    num_frames,
                    endpoint=True,
                    direction=direction,
                )
            )
        else:
            poses = np.repeat(np.linalg.inv(start_w2c)[None], num_frames, axis=0)
        fov_rad_start = fov
        if zoom_factor is None:
            zoom_factor = 0.28 if option.endswith("zoom-in") else 1.5
        fov_rad_end = zoom_factor * fov
        fovs = np.linspace(0, 1, num_frames) * (fov_rad_end - fov_rad_start) + fov_rad_start
    elif option in (
        "move-forward",
        "move-backward",
        "move-up",
        "move-down",
        "move-left",
        "move-right",
    ):
        poses = np.linalg.inv(
            get_moving_w2cs(
                start_w2c,
                look_at,
                up_direction,
                num_frames,
                endpoint=True,
                direction=option.removeprefix("move-"),
            )
        )
        fovs = np.full((num_frames,), fov)
    else:
        raise ValueError(f"Unknown preset option {option}.")

    return poses.astype(np.float64), fovs.astype(np.float64)
