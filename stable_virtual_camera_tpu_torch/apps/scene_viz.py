"""Scene view of the GUI's 3D panel, computed without a GUI.

A copy of stable_virtual_camera_tpu/apps/scene_viz.py (numpy): one camera
frustum per input view, with the view's image as its texture, and the
DUSt3R point cloud, subsampled. `build_scene_viz` computes the geometry
(FOV, aspect and scale of each frustum, the points) so it is testable;
`populate_viser_scene` applies it to a live viser server, and
`viser_iframe_html` embeds a session's server in the page.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FrustumSpec:
    """Everything viser's add_camera_frustum needs, precomputed."""

    name: str
    fov_rad: float        # vertical fov
    aspect: float         # W / H
    scale: float          # frustum size in scene units
    wxyz: np.ndarray      # camera orientation quaternion (w, x, y, z)
    position: np.ndarray  # camera center, world
    image: np.ndarray | None = None  # (h, w, 3) uint8 thumbnail


@dataclass
class SceneViz:
    frustums: list[FrustumSpec] = field(default_factory=list)
    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    point_colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    point_size: float = 0.01


def rotmat_to_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z); Shepperd's method."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def fov_from_K(K: np.ndarray, img_wh: tuple[int, int]) -> float:
    """Vertical fov (radians) from a pixel-unit intrinsics matrix."""
    H = img_wh[1]
    fy = K[1, 1]
    return float(2.0 * np.arctan2(H / 2.0, fy))


def _thumbnail(img: np.ndarray, max_side: int = 128) -> np.ndarray:
    """Cheap strided downsample to bound the websocket payload
    (the reference sends K-scaled images, demo_gr.py:300-307)."""
    h, w = img.shape[:2]
    stride = max(1, int(np.ceil(max(h, w) / max_side)))
    thumb = img[::stride, ::stride]
    if thumb.dtype != np.uint8:
        thumb = (np.clip(thumb, 0.0, 1.0) * 255).astype(np.uint8)
    return thumb


def build_scene_viz(
    preprocessed: dict,
    max_points: int = 200_000,
    frustum_scale_ratio: float = 0.1,
) -> SceneViz:
    """Compute the full 3D panel content from a preprocess() result
    (reference demo_gr.py:247-355: per-camera frustum w/ image, point cloud,
    sizes tied to scene_scale)."""
    imgs = np.asarray(preprocessed["input_imgs"])
    Ks = np.asarray(preprocessed["input_Ks"])  # normalized
    c2ws = np.asarray(preprocessed["input_c2ws"])
    W, H = preprocessed["input_wh"]
    scene_scale = float(preprocessed.get("scene_scale", 1.0))

    viz = SceneViz(point_size=0.01 * scene_scale)
    for i, (img, K, c2w) in enumerate(zip(imgs, Ks, c2ws)):
        K_px = K * np.array([W, H, 1.0])[:, None]
        viz.frustums.append(
            FrustumSpec(
                name=f"/scene_assets/cameras/{i}",
                fov_rad=fov_from_K(K_px, (W, H)),
                aspect=W / H,
                scale=frustum_scale_ratio * scene_scale,
                wxyz=rotmat_to_wxyz(c2w[:3, :3]),
                position=c2w[:3, 3].copy(),
                image=_thumbnail(img),
            )
        )

    points = preprocessed.get("points")
    if points is not None and len(points):
        pts = np.concatenate([np.asarray(p) for p in points], 0)
        cols = preprocessed.get("point_colors")
        cols = (
            np.concatenate([np.asarray(c) for c in cols], 0)
            if cols is not None and len(cols)
            else np.full_like(pts, 0.5)
        )
        if len(pts) > max_points:
            sel = np.random.default_rng(0).choice(
                len(pts), max_points, replace=False
            )
            pts, cols = pts[sel], cols[sel]
        if cols.dtype != np.uint8:
            cols = (np.clip(cols, 0.0, 1.0) * 255).astype(np.uint8)
        viz.points, viz.point_colors = pts, cols
    return viz


def populate_viser_scene(server, viz: SceneViz) -> None:
    """Apply a SceneViz to a live viser server (import-gated by the caller;
    reference demo_gr.py:284-330)."""
    server.scene.reset()
    if len(viz.points):
        server.scene.add_point_cloud(
            "/scene_assets/points",
            points=viz.points,
            colors=viz.point_colors,
            point_size=viz.point_size,
        )
    for f in viz.frustums:
        server.scene.add_camera_frustum(
            f.name,
            fov=f.fov_rad,
            aspect=f.aspect,
            scale=f.scale,
            image=f.image,
            wxyz=f.wxyz,
            position=f.position,
        )


def viser_iframe_html(server, height: int = 500) -> str:
    """Per-session embedded viser viewport (reference demo_gr.py:752-777)."""
    host = server.get_host() if hasattr(server, "get_host") else "localhost"
    port = server.get_port()
    return (
        f'<iframe src="http://{host}:{port}" '
        f'style="display: block; margin: 20px auto; width: 100%; '
        f'height: {height}px; border: 1px solid black;"></iframe>'
    )
