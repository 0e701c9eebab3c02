"""Image loading and the resize/crop/pad of image batches with the matching
intrinsics update.

Counterpart of stable_virtual_camera_tpu/core/transforms.py, which imports
OpenCV and PIL at module level. The port needs no image library to import
(the H100 machine has no imageio): `load_image` imports OpenCV when it
reads a file, and the resize is the port's own `area_resize`, which
computes what cv2.INTER_AREA computes: an exact area-overlap average when
neither axis grows, and OpenCV's two-tap "area" interpolation when one does.
`transform_K` gives the intrinsics update alone, without an image.
"""

from __future__ import annotations

import functools
import math

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


@functools.lru_cache(maxsize=None)
def area_enlarge_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) weights of cv2.INTER_AREA along one axis when the
    image grows along either axis: OpenCV then interpolates between two
    input pixels with the fraction of the output pixel that lies past the
    first one's edge (imgproc/src/resize.cpp, `area_mode` of the linear
    resize)."""
    inv = out_size / in_size
    scale = 1.0 / inv
    M = np.zeros((out_size, in_size), np.float64)
    for dx in range(out_size):
        sx = math.floor(dx * scale)
        fx = float(np.float32((dx + 1) - (sx + 1) * inv))
        fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        if sx >= in_size - 1:
            fx, sx = 0.0, in_size - 1
        M[dx, sx] += 1.0 - fx
        if fx:
            M[dx, sx + 1] += fx
    return M


def area_resize(img: np.ndarray, rh: int, rw: int) -> np.ndarray:
    """NHWC float32 resize as cv2.INTER_AREA computes it."""
    h, w = img.shape[1:3]
    if h == rh and w == rw:
        return img
    if rh <= h and rw <= w:
        Ah, Aw = area_matrix(h, rh), area_matrix(w, rw)
    else:
        Ah, Aw = area_enlarge_matrix(h, rh), area_enlarge_matrix(w, rw)
    # two matrix products (BLAS): np.einsum evaluates these contractions in
    # a plain loop, ~25x slower for a 384x512 -> 576x768 image
    b, c = img.shape[0], img.shape[3]
    out = np.matmul(Ah, img.astype(np.float64).reshape(b, h, w * c)).reshape(b, rh, w, c)
    return np.matmul(Aw, out).astype(np.float32)


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


def load_image(image_path_or_size, context_rgb: np.ndarray | None = None) -> np.ndarray:
    """An image file (read with OpenCV, RGBA composited on white or on
    `context_rgb`), or for an (h, w) size a blank white frame, as
    (1, h, w, 3) float32 in [0, 1] (reference seva/eval.py:172-189)."""
    if isinstance(image_path_or_size, (tuple, list)):
        h, w = image_path_or_size
        # PIL's Image.new("RGBA") is transparent black: white once composited
        arr = np.zeros((int(h), int(w), 4), np.float32)
    else:
        import cv2

        raw = cv2.imread(str(image_path_or_size), cv2.IMREAD_UNCHANGED)
        if raw is None:
            raise IOError(f"Could not read image {image_path_or_size}")
        if raw.ndim == 2:
            raw = cv2.cvtColor(raw, cv2.COLOR_GRAY2BGRA)
        elif raw.shape[-1] == 3:
            raw = cv2.cvtColor(raw, cv2.COLOR_BGR2BGRA)
        arr = cv2.cvtColor(raw, cv2.COLOR_BGRA2RGBA).astype(np.float32) / 255.0
    rgb, alpha = arr[..., :3], arr[..., 3:]
    if context_rgb is not None:
        out = rgb * alpha + np.asarray(context_rgb, np.float32) * (1 - alpha)
    else:
        out = rgb * alpha + (1 - alpha)
    return out[None]


def _is_normalized_K(K: np.ndarray) -> bool:
    cxcy = K[..., :2, -1]
    return bool(np.all(cxcy >= 0) and np.all(cxcy <= 1))


def load_img_and_K(
    image_path_or_size,
    size,
    scale: float = 1.0,
    center: tuple[float, float] = (0.5, 0.5),
    K: np.ndarray | None = None,
    size_stride: int = 1,
    center_crop: bool = False,
    context_rgb: np.ndarray | None = None,
):
    """Load + rescale + crop one image, updating K (reference
    seva/eval.py:160-246). Returns ((1, H, W, 3) in [-1, 1], K)."""
    image = load_image(image_path_or_size, context_rgb)  # (1, h, w, 3) in [0,1]
    h, w = image.shape[1:3]
    if size is None:
        size = (w, h)

    if isinstance(size, (tuple, list)):
        W, H = size
    else:
        W, H = get_wh_with_fixed_shortest_side(w, h, size)
    W, H = _snap(W, size_stride), _snap(H, size_stride)

    rfs = get_resizing_factor((math.floor(H * scale), math.floor(W * scale)), (h, w))
    rh, rw = [int(np.ceil(rfs * s)) for s in (h, w)]
    image = area_resize(image, rh, rw)
    if scale < 1.0:
        pw = math.ceil((W - rw) * 0.5)
        ph = math.ceil((H - rh) * 0.5)
        image = np.pad(image, ((0, 0), (ph, ph), (pw, pw), (0, 0)), constant_values=1.0)

    cy_center = int(center[1] * image.shape[1])
    cx_center = int(center[0] * image.shape[2])
    if center_crop:
        side = min(H, W)
        ct = max(0, cy_center - side // 2)
        cl = max(0, cx_center - side // 2)
        ct = min(ct, image.shape[1] - side)
        cl = min(cl, image.shape[2] - side)
        image = image[:, ct : ct + side, cl : cl + side]
    else:
        ct = max(0, cy_center - H // 2)
        cl = max(0, cx_center - W // 2)
        ct = min(ct, image.shape[1] - H)
        cl = min(cl, image.shape[2] - W)
        image = image[:, ct : ct + H, cl : cl + W]

    if K is not None:
        K = K.copy().astype(np.float64)
        if _is_normalized_K(K):
            K[:2] *= np.array([rw, rh], dtype=np.float64)[:, None]
        else:
            K[:2] *= np.array([rw / w, rh / h], dtype=np.float64)[:, None]
        K[:2, 2] -= np.array([cl, ct], dtype=np.float64)

    return image * 2.0 - 1.0, K
