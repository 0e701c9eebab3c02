"""Scene parsers: reconfusion benchmark format, COLMAP sparse reconstructions,
and direct in-memory scenes.

Field-contract parity with reference seva/data_io.py:29-428 (`BaseParser`,
`DirectParser`, `COLMAPParser`, `ReconfusionParser`): same attribute names,
shapes and conventions (OpenCV c2ws; reconfusion transforms.json is OpenGL and
gets its y/z columns flipped; per-split train/test id files keyed by #inputs).

COLMAP models parse with zero native dependencies in both encodings:
text via data/colmap_text.py, binary via data/colmap_binary.py (the
reference requires the pycolmap bindings for either, data_io.py:139-145).

A copy of stable_virtual_camera_tpu/data/parsers.py, except that OpenCV is
imported only where a distorted COLMAP camera needs its undistortion maps.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from stable_virtual_camera_tpu_torch.core.normalize import (
    align_principle_axes,
    similarity_from_cameras,
    transform_cameras,
    transform_points,
)


def _get_rel_paths(path_dir: str) -> List[str]:
    paths = []
    for dp, _, fn in os.walk(path_dir):
        for f in fn:
            paths.append(os.path.relpath(os.path.join(dp, f), path_dir))
    return paths


class BaseParser:
    """Common field contract (reference seva/data_io.py:29-62)."""

    def __init__(
        self,
        data_dir: str,
        factor: int = 1,
        normalize: bool = False,
        test_every: Optional[int] = 8,
    ):
        self.data_dir = data_dir
        self.factor = factor
        self.normalize = normalize
        self.test_every = test_every

        self.image_names: List[str] = []
        self.image_paths: List[str] = []
        self.camtoworlds: np.ndarray = np.zeros((0, 4, 4))
        self.camera_ids: List[int] = []
        self.Ks_dict: Dict[int, np.ndarray] = {}
        self.params_dict: Dict[int, np.ndarray] = {}
        self.imsize_dict: Dict[int, Tuple[int, int]] = {}
        self.points: np.ndarray = np.zeros((0, 3))
        self.points_err: np.ndarray = np.zeros((0,))
        self.points_rgb: np.ndarray = np.zeros((0, 3))
        self.point_indices: Dict[str, np.ndarray] = {}
        self.transform: np.ndarray = np.eye(4)

        self.mapx_dict: Dict[int, np.ndarray] = {}
        self.mapy_dict: Dict[int, np.ndarray] = {}
        self.roi_undist_dict: Dict[int, Tuple[int, int, int, int]] = {}
        self.scene_scale: float = 1.0

    def _finalize_scene_scale(self) -> None:
        camera_locations = self.camtoworlds[:, :3, 3]
        scene_center = np.mean(camera_locations, axis=0)
        self.scene_scale = float(
            np.max(np.linalg.norm(camera_locations - scene_center, axis=1))
        )

    def _normalize_world(self, points: np.ndarray | None = None) -> None:
        T1 = similarity_from_cameras(self.camtoworlds)
        self.camtoworlds = transform_cameras(T1, self.camtoworlds)
        if points is not None and len(points):
            self.points = transform_points(T1, points)
            T2 = align_principle_axes(self.points)
            self.camtoworlds = transform_cameras(T2, self.camtoworlds)
            self.points = transform_points(T2, self.points)
            self.transform = T2 @ T1
        else:
            self.transform = T1


class DirectParser(BaseParser):
    """In-memory scene (the GUI/preprocessor path, reference
    seva/data_io.py:65-117)."""

    def __init__(
        self,
        imgs: List[np.ndarray],
        c2ws: np.ndarray,
        Ks: np.ndarray,
        points: Optional[np.ndarray] = None,
        points_rgb: Optional[np.ndarray] = None,
        mono_disps: Optional[List[np.ndarray]] = None,
        normalize: bool = False,
        test_every: Optional[int] = None,
    ):
        super().__init__("", 1, normalize, test_every)
        self.image_names = [f"{i:06d}" for i in range(len(imgs))]
        self.image_paths = ["null" for _ in range(len(imgs))]
        self.camtoworlds = np.asarray(c2ws)
        self.camera_ids = list(range(len(imgs)))
        self.Ks_dict = {i: np.asarray(K) for i, K in enumerate(Ks)}
        self.imsize_dict = {
            i: (img.shape[1], img.shape[0]) for i, img in enumerate(imgs)
        }
        if points is not None:
            assert points_rgb is not None
            self.points = np.asarray(points)
            self.points_rgb = np.asarray(points_rgb)
            self.points_err = np.zeros((len(points),))
        self.imgs = imgs
        self.mono_disps = mono_disps
        if normalize:
            self._normalize_world(self.points if points is not None else None)
        self._finalize_scene_scale()


class ReconfusionParser(BaseParser):
    """The benchmark format (reference seva/data_io.py:330-428)."""

    def __init__(self, data_dir: str, normalize: bool = False):
        super().__init__(data_dir, 1, normalize, test_every=None)

        def split_key(path: str):
            tail = path.split("_")[-1].removesuffix(".json")
            return int(tail) if tail.isdigit() else tail

        self.splits_per_num_input_frames: dict = {}
        for path in sorted(glob(osp.join(data_dir, "train_test_split_*.json"))):
            with open(path) as f:
                self.splits_per_num_input_frames[split_key(path)] = json.load(f)

        with open(osp.join(data_dir, "transforms.json")) as f:
            metadata = json.load(f)

        image_names, image_paths, camtoworlds = [], [], []
        for frame in metadata["frames"]:
            if frame["file_path"] is None:
                image_path = image_name = None  # dummy target frame
            else:
                image_path = osp.join(data_dir, frame["file_path"])
                image_name = osp.basename(image_path)
            image_paths.append(image_path)
            image_names.append(image_name)
            c2w = np.array(frame["transform_matrix"])
            if "applied_transform" in metadata:
                applied = np.concatenate(
                    [metadata["applied_transform"], [[0, 0, 0, 1]]], axis=0
                )
                c2w = np.linalg.inv(applied) @ c2w
            camtoworlds.append(c2w)
        camtoworlds = np.array(camtoworlds)
        camtoworlds[:, :, [1, 2]] *= -1  # OpenGL -> OpenCV

        if normalize:
            self.camtoworlds = camtoworlds
            self._normalize_world(None)
            camtoworlds = self.camtoworlds

        self.image_names = image_names
        self.image_paths = image_paths
        self.camtoworlds = camtoworlds
        self.camera_ids = list(range(len(image_paths)))
        self.Ks_dict = {
            i: np.array(
                [
                    [metadata.get("fl_x", frame.get("fl_x")), 0.0,
                     metadata.get("cx", frame.get("cx"))],
                    [0.0, metadata.get("fl_y", frame.get("fl_y")),
                     metadata.get("cy", frame.get("cy"))],
                    [0.0, 0.0, 1.0],
                ]
            )
            for i, frame in enumerate(metadata["frames"])
        }
        self.imsize_dict = {
            i: (metadata.get("w", frame.get("w")), metadata.get("h", frame.get("h")))
            for i, frame in enumerate(metadata["frames"])
        }
        self._finalize_scene_scale()

        self.bounds = None
        if osp.exists(osp.join(data_dir, "bounds.npy")):
            self.bounds = np.load(osp.join(data_dir, "bounds.npy"))
            scaling = np.linalg.norm(self.transform[0, :3])
            self.bounds = self.bounds / scaling


class COLMAPParser(BaseParser):
    """COLMAP sparse reconstruction parser (reference seva/data_io.py:120-327)."""

    def __init__(
        self,
        data_dir: str,
        factor: int = 1,
        normalize: bool = False,
        test_every: Optional[int] = 8,
        image_folder: str = "images",
        colmap_folder: str = "sparse/0",
    ):
        super().__init__(data_dir, factor, normalize, test_every)
        colmap_dir = os.path.join(data_dir, colmap_folder)
        assert os.path.exists(colmap_dir), f"COLMAP directory {colmap_dir} missing."
        from stable_virtual_camera_tpu_torch.data.colmap_binary import BinarySceneManager
        from stable_virtual_camera_tpu_torch.data.colmap_text import TextSceneManager

        # both COLMAP encodings parse with zero native dependencies (the
        # reference needs pycolmap bindings for either, data_io.py:139-147)
        if TextSceneManager.is_text_model(colmap_dir):
            SceneManager = TextSceneManager
        elif BinarySceneManager.is_binary_model(colmap_dir):
            SceneManager = BinarySceneManager
        else:
            raise FileNotFoundError(
                f"No COLMAP model found in {colmap_dir}: expected cameras.txt "
                "(text) or cameras.bin (binary)"
            )

        manager = SceneManager(colmap_dir)
        manager.load_cameras()
        manager.load_images()
        manager.load_points3D()

        imdata = manager.images
        w2c_mats, camera_ids = [], []
        bottom = np.array([[0, 0, 0, 1]])
        for k in imdata:
            im = imdata[k]
            w2c = np.concatenate(
                [np.concatenate([im.R(), im.tvec.reshape(3, 1)], 1), bottom], axis=0
            )
            w2c_mats.append(w2c)
            camera_id = im.camera_id
            camera_ids.append(camera_id)
            cam = manager.cameras[camera_id]
            K = np.array(
                [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], dtype=np.float64
            )
            K[:2, :] /= factor
            self.Ks_dict[camera_id] = K
            type_ = cam.camera_type
            params, camtype = _colmap_distortion(cam, type_)
            assert camtype == "perspective", (
                f"Only perspective camera models supported, got {type_}"
            )
            self.params_dict[camera_id] = params
            self.imsize_dict[camera_id] = (cam.width // factor, cam.height // factor)

        if len(imdata) == 0:
            raise ValueError("No images found in COLMAP.")

        camtoworlds = np.linalg.inv(np.stack(w2c_mats, axis=0))
        image_names = [imdata[k].name for k in imdata]
        inds = np.argsort(image_names)
        image_names = [image_names[i] for i in inds]
        camtoworlds = camtoworlds[inds]
        camera_ids = [camera_ids[i] for i in inds]

        image_dir_suffix = f"_{factor}" if factor > 1 else ""
        colmap_image_dir = os.path.join(data_dir, image_folder)
        image_dir = os.path.join(data_dir, image_folder + image_dir_suffix)
        for d in (image_dir, colmap_image_dir):
            if not os.path.exists(d):
                raise ValueError(f"Image folder {d} does not exist.")
        colmap_files = sorted(_get_rel_paths(colmap_image_dir))
        image_files = sorted(_get_rel_paths(image_dir))
        colmap_to_image = dict(zip(colmap_files, image_files))
        image_paths = [os.path.join(image_dir, colmap_to_image[f]) for f in image_names]

        points = manager.points3D.astype(np.float32)
        points_err = manager.point3D_errors.astype(np.float32)
        points_rgb = manager.point3D_colors.astype(np.uint8)
        point_indices: dict = {}
        image_id_to_name = {v: k for k, v in manager.name_to_image_id.items()}
        for point_id, data in manager.point3D_id_to_images.items():
            for image_id, _ in data:
                image_name = image_id_to_name[image_id]
                point_idx = manager.point3D_id_to_point3D_idx[point_id]
                point_indices.setdefault(image_name, []).append(point_idx)
        point_indices = {
            k: np.array(v).astype(np.int32) for k, v in point_indices.items()
        }

        self.image_names = image_names
        self.image_paths = image_paths
        self.camtoworlds = camtoworlds
        self.camera_ids = camera_ids
        self.points = points
        self.points_err = points_err
        self.points_rgb = points_rgb
        self.point_indices = point_indices
        if normalize:
            self._normalize_world(points)

        # precompute undistortion maps for distorted cameras
        for camera_id, params in self.params_dict.items():
            if len(params) == 0:
                continue
            import cv2

            K = self.Ks_dict[camera_id]
            width, height = self.imsize_dict[camera_id]
            K_undist, roi_undist = cv2.getOptimalNewCameraMatrix(
                K, params, (width, height), 0
            )
            mapx, mapy = cv2.initUndistortRectifyMap(
                K, params, None, K_undist, (width, height), cv2.CV_32FC1
            )
            self.Ks_dict[camera_id] = K_undist
            self.mapx_dict[camera_id] = mapx
            self.mapy_dict[camera_id] = mapy
            self.roi_undist_dict[camera_id] = roi_undist
        self._finalize_scene_scale()


def _colmap_distortion(cam, type_):
    if type_ in (0, "SIMPLE_PINHOLE", 1, "PINHOLE"):
        return np.empty(0, dtype=np.float32), "perspective"
    if type_ in (2, "SIMPLE_RADIAL"):
        return np.array([cam.k1, 0.0, 0.0, 0.0], np.float32), "perspective"
    if type_ in (3, "RADIAL"):
        return np.array([cam.k1, cam.k2, 0.0, 0.0], np.float32), "perspective"
    if type_ in (4, "OPENCV"):
        return np.array([cam.k1, cam.k2, cam.p1, cam.p2], np.float32), "perspective"
    if type_ in (5, "OPENCV_FISHEYE"):
        return np.array([cam.k1, cam.k2, cam.k3, cam.k4], np.float32), "fisheye"
    raise ValueError(f"Unknown COLMAP camera type {type_}")


def get_parser(parser_type: str, **kwargs) -> BaseParser:
    if parser_type == "colmap":
        return COLMAPParser(**kwargs)
    if parser_type == "direct":
        return DirectParser(**kwargs)
    if parser_type == "reconfusion":
        return ReconfusionParser(**kwargs)
    raise ValueError(f"Unknown parser type: {parser_type}")
