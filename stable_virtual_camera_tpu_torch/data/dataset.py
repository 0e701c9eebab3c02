"""Dataset over a parser: split handling, on-the-fly undistortion, optional
patch crops and COLMAP-point depth supervision.

Behavior parity with reference seva/data_io.py:431-541, framework-free (plain
numpy dicts instead of torch tensors; works with any loader).

A copy of stable_virtual_camera_tpu/data/dataset.py, except for the image
reader: the JAX package reads with `imageio`, which the machine with the card
lacks, so `read_image` reads through OpenCV (imported when an image is read)
and returns the same RGB array.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from stable_virtual_camera_tpu_torch.data.parsers import (
    BaseParser,
    DirectParser,
    ReconfusionParser,
)


def read_image(path: str) -> np.ndarray:
    """An image file as `imageio.v3.imread` reads it, cut with `[..., :3]`:
    (H, W, 3) RGB, 8 bits for a colour file (a 16-bit one keeps its high
    byte, as imageio's reader does), a gray file in its own dtype."""
    import cv2

    image = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if image is None:
        raise FileNotFoundError(f"cannot read image {path}")
    if image.ndim == 3:
        if image.dtype == np.uint16:
            image = (image >> 8).astype(np.uint8)
        return np.ascontiguousarray(image[..., 2::-1])  # BGR(A) -> RGB
    return image[..., :3]


class Dataset:
    def __init__(
        self,
        parser: BaseParser,
        split: str = "train",
        num_input_frames: Optional[int] = None,
        patch_size: Optional[int] = None,
        load_depths: bool = False,
        load_mono_disps: bool = False,
    ):
        self.parser = parser
        self.split = split
        self.num_input_frames = num_input_frames
        self.patch_size = patch_size
        self.load_depths = load_depths
        self.load_mono_disps = load_mono_disps
        if load_mono_disps:
            assert isinstance(parser, DirectParser)
            assert parser.mono_disps is not None
        if isinstance(parser, ReconfusionParser):
            ids_per_split = parser.splits_per_num_input_frames[num_input_frames]
            self.indices = ids_per_split[
                "train_ids" if split == "train" else "test_ids"
            ]
        else:
            indices = np.arange(len(parser.image_names))
            if parser.test_every is None:
                self.indices = indices
            elif split == "train":
                self.indices = indices[indices % parser.test_every != 0]
            else:
                self.indices = indices[indices % parser.test_every == 0]

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, item: int) -> Dict[str, Any]:
        index = self.indices[item]
        if isinstance(self.parser, DirectParser):
            image = self.parser.imgs[index]
        else:
            image = read_image(self.parser.image_paths[index])
        camera_id = self.parser.camera_ids[index]
        K = self.parser.Ks_dict[camera_id].copy()
        params = self.parser.params_dict.get(camera_id, None)
        camtoworlds = self.parser.camtoworlds[index]

        x, y = 0, 0
        if params is not None and len(params) > 0:
            import cv2

            mapx = self.parser.mapx_dict[camera_id]
            mapy = self.parser.mapy_dict[camera_id]
            image = cv2.remap(image, mapx, mapy, cv2.INTER_LINEAR)
            x, y, w, h = self.parser.roi_undist_dict[camera_id]
            image = image[y : y + h, x : x + w]

        if self.patch_size is not None:
            h, w = image.shape[:2]
            x = np.random.randint(0, max(w - self.patch_size, 1))
            y = np.random.randint(0, max(h - self.patch_size, 1))
            image = image[y : y + self.patch_size, x : x + self.patch_size]
            K[0, 2] -= x
            K[1, 2] -= y

        data = {
            "K": K.astype(np.float32),
            "camtoworld": camtoworlds.astype(np.float32),
            "image": image.astype(np.float32),
            "image_id": item,
        }

        if self.load_depths:
            worldtocams = np.linalg.inv(camtoworlds)
            image_name = self.parser.image_names[index]
            point_indices = self.parser.point_indices[image_name]
            points_world = self.parser.points[point_indices]
            points_cam = (
                worldtocams[:3, :3] @ points_world.T + worldtocams[:3, 3:4]
            ).T
            points_proj = (K @ points_cam.T).T
            points = points_proj[:, :2] / points_proj[:, 2:3]
            depths = points_cam[:, 2]
            if self.patch_size is not None:
                points[:, 0] -= x
                points[:, 1] -= y
            selector = (
                (points[:, 0] >= 0)
                & (points[:, 0] < image.shape[1])
                & (points[:, 1] >= 0)
                & (points[:, 1] < image.shape[0])
                & (depths > 0)
            )
            data["points"] = points[selector].astype(np.float32)
            data["depths"] = depths[selector].astype(np.float32)
        if self.load_mono_disps:
            data["mono_disps"] = np.asarray(
                self.parser.mono_disps[index], np.float32
            )
        return data
