"""Dependency-free reader for COLMAP *text-format* sparse models.

The reference reads COLMAP models through the gsplat-flavored `pycolmap`
package's `SceneManager` (reference seva/data_io.py:139-147), which is not
bundled in this image. This module implements the subset of that API that
`COLMAPParser` consumes, for text-format models (cameras.txt / images.txt /
points3D.txt — the `colmap model_converter --output_type TXT` layout), so
COLMAP workflows run with zero native dependencies. Binary models parse
natively too (data/colmap_binary.py).

Format reference: https://colmap.github.io/format.html (public spec).
A copy of stable_virtual_camera_tpu/data/colmap_text.py.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

# COLMAP camera model ids -> (name, param names)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", ("f", "cx", "cy")),
    1: ("PINHOLE", ("fx", "fy", "cx", "cy")),
    2: ("SIMPLE_RADIAL", ("f", "cx", "cy", "k1")),
    3: ("RADIAL", ("f", "cx", "cy", "k1", "k2")),
    4: ("OPENCV", ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2")),
    5: ("OPENCV_FISHEYE", ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4")),
}
_NAME_TO_ID = {name: i for i, (name, _) in CAMERA_MODELS.items()}


class Camera:
    """Intrinsics record with the gsplat-SceneManager attribute surface
    (fx/fy/cx/cy + distortion coefficients, defaulting to 0)."""

    def __init__(self, camera_type: int, width: int, height: int, params):
        self.camera_type = camera_type
        self.width = int(width)
        self.height = int(height)
        names = CAMERA_MODELS[camera_type][1]
        values = dict(zip(names, [float(p) for p in params]))
        if "f" in values:  # SIMPLE_* models: single focal length
            values["fx"] = values["fy"] = values.pop("f")
        for key in ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4", "p1", "p2"):
            setattr(self, key, values.get(key, 0.0))


class Image:
    """Extrinsics record: COLMAP stores world-to-camera as (qvec, tvec)."""

    def __init__(self, qvec, tvec, camera_id: int, name: str):
        self.qvec = np.asarray(qvec, np.float64)
        self.tvec = np.asarray(tvec, np.float64)
        self.camera_id = int(camera_id)
        self.name = name

    def R(self) -> np.ndarray:
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )


def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


class TextSceneManager:
    """Text-model drop-in for the gsplat pycolmap SceneManager subset used by
    COLMAPParser (load_cameras/load_images/load_points3D + the attributes)."""

    def __init__(self, colmap_dir: str):
        self.colmap_dir = colmap_dir
        self.cameras: dict[int, Camera] = {}
        self.images: dict[int, Image] = {}
        self.name_to_image_id: dict[str, int] = {}
        self.points3D = np.zeros((0, 3), np.float64)
        self.point3D_errors = np.zeros((0,), np.float64)
        self.point3D_colors = np.zeros((0, 3), np.uint8)
        self.point3D_id_to_point3D_idx: dict[int, int] = {}
        self.point3D_id_to_images: dict[int, list[tuple[int, int]]] = {}

    @staticmethod
    def is_text_model(colmap_dir: str) -> bool:
        return osp.exists(osp.join(colmap_dir, "cameras.txt"))

    def load_cameras(self) -> None:
        for line in _data_lines(osp.join(self.colmap_dir, "cameras.txt")):
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            model_id = _NAME_TO_ID[model] if not model.isdigit() else int(model)
            self.cameras[cam_id] = Camera(
                model_id, int(parts[2]), int(parts[3]), parts[4:]
            )

    def load_images(self) -> None:
        # images.txt alternates: header line, then the 2D-points line (which
        # may be empty when there are no observations — keep blank lines so
        # the alternation survives, drop only comments)
        with open(osp.join(self.colmap_dir, "images.txt")) as f:
            lines = [ln.rstrip("\n") for ln in f if not ln.lstrip().startswith("#")]
        for i in range(0, len(lines), 2):
            parts = lines[i].split()
            image_id = int(parts[0])
            qvec = [float(v) for v in parts[1:5]]
            tvec = [float(v) for v in parts[5:8]]
            camera_id = int(parts[8])
            name = parts[9]
            self.images[image_id] = Image(qvec, tvec, camera_id, name)
            self.name_to_image_id[name] = image_id

    def load_points3D(self) -> None:
        xyz, err, rgb = [], [], []
        for idx, line in enumerate(
            _data_lines(osp.join(self.colmap_dir, "points3D.txt"))
        ):
            parts = line.split()
            pid = int(parts[0])
            xyz.append([float(v) for v in parts[1:4]])
            rgb.append([int(v) for v in parts[4:7]])
            err.append(float(parts[7]))
            track = parts[8:]
            self.point3D_id_to_point3D_idx[pid] = idx
            self.point3D_id_to_images[pid] = [
                (int(track[j]), int(track[j + 1])) for j in range(0, len(track), 2)
            ]
        self.points3D = np.asarray(xyz, np.float64).reshape(-1, 3)
        self.point3D_errors = np.asarray(err, np.float64)
        self.point3D_colors = np.asarray(rgb, np.uint8).reshape(-1, 3)


def write_text_model(
    colmap_dir: str,
    cameras: dict[int, tuple[str, int, int, list[float]]],
    images: dict[int, tuple[np.ndarray, np.ndarray, int, str]],
    points: np.ndarray | None = None,
    point_colors: np.ndarray | None = None,
    point_tracks: list[list[tuple[int, int]]] | None = None,
) -> None:
    """Write a COLMAP text model (used by tests and export tools).

    cameras: {camera_id: (model_name, width, height, params)}
    images:  {image_id: (qvec wxyz, tvec, camera_id, name)}
    """
    import os

    os.makedirs(colmap_dir, exist_ok=True)
    with open(osp.join(colmap_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for cid, (model, w, h, params) in cameras.items():
            f.write(f"{cid} {model} {w} {h} " + " ".join(map(str, params)) + "\n")
    with open(osp.join(colmap_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for iid, (qvec, tvec, cid, name) in images.items():
            q = " ".join(f"{v:.17g}" for v in qvec)
            t = " ".join(f"{v:.17g}" for v in tvec)
            f.write(f"{iid} {q} {t} {cid} {name}\n")
            f.write("\n")  # no 2D observations
    with open(osp.join(colmap_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        if points is not None:
            for i, p in enumerate(np.asarray(points)):
                rgb = (
                    point_colors[i]
                    if point_colors is not None
                    else np.array([128, 128, 128])
                )
                track = point_tracks[i] if point_tracks is not None else []
                track_s = " ".join(f"{a} {b}" for a, b in track)
                f.write(
                    f"{i + 1} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g} "
                    f"{int(rgb[0])} {int(rgb[1])} {int(rgb[2])} 0.5 {track_s}\n"
                )
