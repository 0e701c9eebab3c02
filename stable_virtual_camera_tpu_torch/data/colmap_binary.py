"""Dependency-free reader/writer for COLMAP *binary* sparse models.

The reference can only read COLMAP models through the gsplat-flavored
`pycolmap` bindings (reference seva/data_io.py:139-147). This module parses
the binary layout (cameras.bin / images.bin / points3D.bin) natively so both
COLMAP encodings work with zero native dependencies — text models via
data/colmap_text.py, binary via this reader.

Binary layout (little-endian, https://colmap.github.io/format.html):
  cameras.bin:  u64 count; per camera: i32 id, i32 model, u64 w, u64 h,
                f64 params[n_params(model)]
  images.bin:   u64 count; per image: i32 id, f64 q[4] (w,x,y,z), f64 t[3],
                i32 camera_id, name (NUL-terminated), u64 n_pts2d,
                (f64 x, f64 y, i64 point3D_id) * n_pts2d
  points3D.bin: u64 count; per point: i64 id, f64 xyz[3], u8 rgb[3],
                f64 error, u64 track_len, (i32 image_id, i32 pt2d_idx) * len
A copy of stable_virtual_camera_tpu/data/colmap_binary.py.
"""

from __future__ import annotations

import os
import os.path as osp
import struct

import numpy as np

from stable_virtual_camera_tpu_torch.data.colmap_text import (
    CAMERA_MODELS,
    _NAME_TO_ID,
    Camera,
    Image,
)


class _Reader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        self.pos = 0

    def read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals

    def read_string(self) -> str:
        end = self.buf.index(b"\x00", self.pos)
        s = self.buf[self.pos : end].decode("utf-8")
        self.pos = end + 1
        return s


class BinarySceneManager:
    """Binary-model drop-in for the pycolmap SceneManager subset used by
    COLMAPParser (same attribute surface as colmap_text.TextSceneManager)."""

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
    def is_binary_model(colmap_dir: str) -> bool:
        return osp.exists(osp.join(colmap_dir, "cameras.bin"))

    def load_cameras(self) -> None:
        r = _Reader(osp.join(self.colmap_dir, "cameras.bin"))
        (n,) = r.read("Q")
        for _ in range(n):
            cam_id, model_id, width, height = r.read("iiQQ")
            n_params = len(CAMERA_MODELS[model_id][1])
            params = r.read(f"{n_params}d")
            self.cameras[cam_id] = Camera(model_id, width, height, params)

    def load_images(self) -> None:
        r = _Reader(osp.join(self.colmap_dir, "images.bin"))
        (n,) = r.read("Q")
        for _ in range(n):
            (image_id,) = r.read("i")
            qvec = r.read("4d")
            tvec = r.read("3d")
            (camera_id,) = r.read("i")
            name = r.read_string()
            (n_pts,) = r.read("Q")
            r.pos += n_pts * struct.calcsize("<ddq")  # skip 2D observations
            self.images[image_id] = Image(qvec, tvec, camera_id, name)
            self.name_to_image_id[name] = image_id

    def load_points3D(self) -> None:
        r = _Reader(osp.join(self.colmap_dir, "points3D.bin"))
        (n,) = r.read("Q")
        xyz = np.zeros((n, 3), np.float64)
        err = np.zeros((n,), np.float64)
        rgb = np.zeros((n, 3), np.uint8)
        for idx in range(n):
            (pid,) = r.read("q")
            xyz[idx] = r.read("3d")
            rgb[idx] = r.read("3B")
            (err[idx],) = r.read("d")
            (track_len,) = r.read("Q")
            track = r.read(f"{2 * track_len}i")
            self.point3D_id_to_point3D_idx[pid] = idx
            self.point3D_id_to_images[pid] = [
                (track[j], track[j + 1]) for j in range(0, len(track), 2)
            ]
        self.points3D = xyz
        self.point3D_errors = err
        self.point3D_colors = rgb


def write_binary_model(
    colmap_dir: str,
    cameras: dict[int, tuple[str, int, int, list[float]]],
    images: dict[int, tuple[np.ndarray, np.ndarray, int, str]],
    points: np.ndarray | None = None,
    point_colors: np.ndarray | None = None,
    point_tracks: list[list[tuple[int, int]]] | None = None,
) -> None:
    """Write a COLMAP binary model (same argument contract as
    colmap_text.write_text_model; used by tests and export tools)."""
    os.makedirs(colmap_dir, exist_ok=True)
    with open(osp.join(colmap_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, (model, w, h, params) in cameras.items():
            model_id = _NAME_TO_ID[model]
            f.write(struct.pack("<iiQQ", cid, model_id, w, h))
            f.write(struct.pack(f"<{len(params)}d", *[float(p) for p in params]))
    with open(osp.join(colmap_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, (qvec, tvec, cid, name) in images.items():
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<4d", *[float(v) for v in qvec]))
            f.write(struct.pack("<3d", *[float(v) for v in tvec]))
            f.write(struct.pack("<i", cid))
            f.write(name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D observations
    with open(osp.join(colmap_dir, "points3D.bin"), "wb") as f:
        pts = np.zeros((0, 3)) if points is None else np.asarray(points)
        f.write(struct.pack("<Q", len(pts)))
        for i, p in enumerate(pts):
            rgb = (
                point_colors[i]
                if point_colors is not None
                else np.array([128, 128, 128])
            )
            track = point_tracks[i] if point_tracks is not None else []
            f.write(struct.pack("<q", i + 1))
            f.write(struct.pack("<3d", *[float(v) for v in p]))
            f.write(struct.pack("<3B", *[int(v) for v in rgb]))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", len(track)))
            for a, b in track:
                f.write(struct.pack("<ii", a, b))
