"""Resize/crop/pad of image batches with the matching intrinsics update.

Counterpart of `transform_img_and_K` in stable_virtual_camera_tpu/core/
transforms.py, which imports OpenCV and PIL. The port's main path needs no
image library (the H100 machine has no imageio), so it holds its own: the
resize is an exact area-overlap average (cv2.INTER_AREA's box filter when
shrinking, a plain box average for integer factors), and `transform_K`
gives the intrinsics update alone, without an image.
"""

from __future__ import annotations

import functools

import numpy as np


def get_resizing_factor(
    target_shape: tuple[int, int],  # (H, W)
    current_shape: tuple[int, int],  # (H, W)
    cover_target: bool = True,
) -> float:
    """Scale factor so the rescaled image covers (or fits inside) the target,
    by the same aspect-ratio case analysis as the JAX package."""
    r_bound = target_shape[1] / target_shape[0]
    aspect_r = current_shape[1] / current_shape[0]
    if r_bound >= 1.0:
        if cover_target:
            if aspect_r >= r_bound:
                return min(target_shape) / min(current_shape)
            if aspect_r < 1.0:
                return max(target_shape) / min(current_shape)
            return max(target_shape) / max(current_shape)
        if aspect_r >= r_bound:
            return max(target_shape) / max(current_shape)
        if aspect_r < 1.0:
            return min(target_shape) / max(current_shape)
        return min(target_shape) / min(current_shape)
    if cover_target:
        if aspect_r <= r_bound:
            return min(target_shape) / min(current_shape)
        if aspect_r > 1.0:
            return max(target_shape) / min(current_shape)
        return max(target_shape) / max(current_shape)
    if aspect_r <= r_bound:
        return max(target_shape) / max(current_shape)
    if aspect_r > 1.0:
        return min(target_shape) / max(current_shape)
    return min(target_shape) / min(current_shape)


def get_wh_with_fixed_shortest_side(w: int, h: int, size: int | None):
    if size is None or size <= 0:
        return w, h
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


def _snap(v: float, stride: int) -> int:
    return int(np.floor(v / stride + 0.5) * stride)


@functools.lru_cache(maxsize=None)
def area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) weights of an area resize along one axis: output
    pixel i averages the input interval [i, i + 1) * in_size / out_size,
    weighting each input pixel by its overlap."""
    edges = np.arange(out_size + 1, dtype=np.float64) * (in_size / out_size)
    lo, hi = edges[:-1, None], edges[1:, None]
    px = np.arange(in_size, dtype=np.float64)[None, :]
    overlap = np.clip(np.minimum(hi, px + 1) - np.maximum(lo, px), 0.0, None)
    return overlap / overlap.sum(axis=1, keepdims=True)


def area_resize(img: np.ndarray, rh: int, rw: int) -> np.ndarray:
    """NHWC float32 area resize."""
    if img.shape[1] == rh and img.shape[2] == rw:
        return img
    Ah = area_matrix(img.shape[1], rh)
    Aw = area_matrix(img.shape[2], rw)
    out = np.einsum("oh,bhwc->bowc", Ah, img.astype(np.float64))
    out = np.einsum("ow,bhwc->bhoc", Aw, out)
    return out.astype(np.float32)


def _layout(h, w, size, scale, center, size_stride, mode):
    """Resize target and crop/pad offsets of `transform_img_and_K`."""
    assert mode in ("crop", "pad", "stretch")
    if isinstance(size, (tuple, list)):
        W, H = size
    else:
        W, H = get_wh_with_fixed_shortest_side(w, h, size)
    W, H = _snap(W, size_stride), _snap(H, size_stride)
    if mode == "stretch":
        rh, rw = H, W
    else:
        rfs = get_resizing_factor((H, W), (h, w), cover_target=(mode != "pad"))
        rh, rw = [int(np.ceil(rfs * s)) for s in (h, w)]
    rh, rw = int(rh / scale), int(rw / scale)
    cy_center, cx_center = int(center[1] * rh), int(center[0] * rw)
    if mode != "pad":
        ct = min(max(0, cy_center - H // 2), rh - H)
        cl = min(max(0, cx_center - W // 2), rw - W)
        pads = None
    else:
        pt, pl = max(0, H // 2 - cy_center), max(0, W // 2 - cx_center)
        pads = (pt, max(0, H - pt - rh), pl, max(0, W - pl - rw))
        ct = cl = 0
    return W, H, rh, rw, ct, cl, pads


def _update_K(K, h, w, rh, rw, ct, cl, pads):
    K = K.copy().astype(np.float64)
    pt, pl = (pads[0], pads[2]) if pads else (0, 0)
    cxcy = K[:, :2, -1]
    norm_row = np.all((cxcy >= 0) & (cxcy <= 1), axis=-1)  # per-K classification
    scale_norm = np.array([rw, rh], dtype=np.float64)[:, None]
    scale_pix = np.array([rw / w, rh / h], dtype=np.float64)[:, None]
    K[:, :2] *= np.where(norm_row[:, None, None], scale_norm, scale_pix)
    K[:, :2, 2] += np.array([pl - cl, pt - ct], dtype=np.float64)
    return K


def transform_img_and_K(
    image: np.ndarray,  # (B, H, W, 3) in [-1, 1]
    size,
    scale: float = 1.0,
    center: tuple[float, float] = (0.5, 0.5),
    K: np.ndarray | None = None,  # (B, 3, 3)
    size_stride: int = 1,
    mode: str = "crop",
):
    """Resize + crop/pad/stretch a batch of images, updating per-view K."""
    h, w = image.shape[1:3]
    W, H, rh, rw, ct, cl, pads = _layout(h, w, size, scale, center, size_stride, mode)
    image = area_resize(image, rh, rw)
    if pads is None:
        image = image[:, ct : ct + H, cl : cl + W]
    else:
        pt, pb, pl, pr = pads
        image = np.pad(image, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    if K is not None:
        K = _update_K(K, h, w, rh, rw, ct, cl, pads)
    return image, K


def transform_K(
    image_hw: tuple[int, int],
    size,
    K: np.ndarray,  # (B, 3, 3)
    scale: float = 1.0,
    center: tuple[float, float] = (0.5, 0.5),
    size_stride: int = 1,
    mode: str = "crop",
) -> np.ndarray:
    """The intrinsics update of `transform_img_and_K` for an image of size
    `image_hw`, without the image."""
    h, w = image_hw
    _, _, rh, rw, ct, cl, pads = _layout(h, w, size, scale, center, size_stride, mode)
    return _update_K(K, h, w, rh, rw, ct, cl, pads)
