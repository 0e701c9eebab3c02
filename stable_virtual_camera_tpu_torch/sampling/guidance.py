"""Classifier-free guidance scale rules.

A copy of stable_virtual_camera_tpu/sampling/guidance.py: that module is
numpy-only, but importing it runs the JAX package's sampling/__init__.py,
which imports jax.

The reference implements three guiders (seva/sampling.py:216-298): VanillaCFG,
MultiviewCFG (camera-aware: frames at input poses get cfg_min) and
MultiviewTemporalCFG (scale additionally ramps with temporal distance to the
nearest input frame).

TPU-first observation: for all three, the per-frame scale vector is a pure
function of (poses, intrinsics, input mask, num_frames) — constant across the
denoising loop. So we compute the (T,) scale vector ONCE on the host and the
jitted sampler only does the `uncond + scale * (cond - uncond)` blend. This
removes every camera-math op from the hot loop.
"""

from __future__ import annotations

import numpy as np

from stable_virtual_camera_tpu_torch.core.camera import get_camera_dist

GUIDER_VANILLA = 0
GUIDER_MULTIVIEW = 1
GUIDER_MULTIVIEW_TEMPORAL = 2


def close_frame_mask(
    c2w: np.ndarray, K: np.ndarray, input_frame_mask: np.ndarray
) -> np.ndarray:
    """Frames whose pose ~= an input view: rotation diff < 10 deg, translation
    diff < 1e-5, identical K (reference seva/sampling.py:160-187)."""
    c2w_input = c2w[input_frame_mask]
    rotation_diff = get_camera_dist(c2w, c2w_input, mode="rotation").min(-1)
    translation_diff = get_camera_dist(c2w, c2w_input, mode="translation").min(-1)
    K_diff = (
        (K[:, None] - K[input_frame_mask][None]).reshape(K.shape[0], -1, 9) == 0
    ).all(-1).any(-1)
    return (rotation_diff < 10.0) & (translation_diff < 1e-5) & K_diff


def compute_scale_vector(
    guider_type: int,
    scale: float,
    num_frames: int,
    c2w: np.ndarray | None = None,
    K: np.ndarray | None = None,
    input_frame_mask: np.ndarray | None = None,
    cfg_min: float = 1.0,
) -> np.ndarray:
    """(T,) float32 per-frame CFG scale.

    - GUIDER_VANILLA: constant `scale` (seva/sampling.py:216-229).
    - GUIDER_MULTIVIEW: `cfg_min` at close frames (seva/sampling.py:245-265).
    - GUIDER_MULTIVIEW_TEMPORAL: temporal ramp then close-frame override
      (seva/sampling.py:268-298).
    """
    T = num_frames
    if guider_type == GUIDER_VANILLA:
        return np.full((T,), scale, dtype=np.float32)

    assert c2w is not None and K is not None and input_frame_mask is not None
    input_frame_mask = np.asarray(input_frame_mask, dtype=bool)

    if guider_type == GUIDER_MULTIVIEW:
        scales = np.full((T,), scale, dtype=np.float64)
    elif guider_type == GUIDER_MULTIVIEW_TEMPORAL:
        ar = np.arange(T)
        distance_matrix = np.abs(ar[None] - ar[:, None])  # (T, T)
        min_distance = (distance_matrix + (~input_frame_mask)[None] * T).min(-1)
        denom = max(min_distance.max(), 1)
        min_distance = min_distance / denom
        scales = min_distance * (scale - cfg_min) + cfg_min
    else:
        raise ValueError(f"Invalid guider type {guider_type}.")

    close = close_frame_mask(np.asarray(c2w), np.asarray(K), input_frame_mask)
    scales = np.where(close, cfg_min, scales)
    return scales.astype(np.float32)
