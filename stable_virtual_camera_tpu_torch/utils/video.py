"""MP4 read and write through OpenCV.

Counterpart of stable_virtual_camera_tpu/utils/video.py. OpenCV is imported
inside each function, so the engine, which imports `write_video` through
engine/saving.py, runs on a machine without it as long as it writes no
video.
"""

from __future__ import annotations

import numpy as np


def write_video(path: str, frames: np.ndarray, fps: float) -> None:
    """frames: (N, H, W, 3) uint8 RGB."""
    import cv2

    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) frames, got {frames.shape}")
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), max(float(fps), 1.0), (w, h))
    if not writer.isOpened():
        raise IOError(f"Could not open video writer for {path}")
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def read_video(path: str) -> np.ndarray:
    """Returns (N, H, W, 3) uint8 RGB."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"Could not open video {path}")
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)
