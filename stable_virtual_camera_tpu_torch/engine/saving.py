"""Output writers, the transforms.json export and media-keyed sample-dict
helpers.

Counterpart of stable_virtual_camera_tpu/engine/saving.py. The helpers are
the same numpy code; the writers (mp4 through utils/video.py, and PNG)
import OpenCV only when called, so the engine runs, and keeps its frames in
memory, on a machine without it. PNGs are lossless, so OpenCV's files
decode to the same pixels as the JAX package's imageio ones.

`StreamingFrameWriter` writes frame PNGs on a background thread while the
render goes on (JAX's `StreamingFrameWriter`); `save_output(...,
skip_png_keys=)` then leaves out the PNGs it already wrote.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import queue
import threading

import numpy as np

from stable_virtual_camera_tpu_torch.utils.video import write_video


def to_uint8(value: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) [-1, 1] float -> uint8; uint8 frames pass through."""
    value = np.asarray(value)
    if value.dtype == np.uint8:
        return value
    v = (value.astype(np.float32) + 1.0) / 2.0
    return np.clip(v * 255.0, 0, 255).astype(np.uint8)


def write_png(path: str, frame: np.ndarray) -> None:
    """One (H, W, 3) uint8 RGB frame as a PNG, through OpenCV."""
    import cv2

    if not cv2.imwrite(path, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)):
        raise IOError(f"Could not write {path}")


class StreamingFrameWriter:
    """Frame PNGs written by one daemon thread, in the order submitted, as
    `<dir>/<index:03d>.png`: the same files `save_output` writes for an
    "image" entry, written while the render goes on instead of after it.
    `drain()` ends the thread once the queue is empty and re-raises the
    first error the thread met; it may be called more than once."""

    def __init__(self, dir_path: str):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._run, name="svc-frame-writer", daemon=True)
        self._t.start()

    def submit(self, indices, frames) -> None:
        """Queue `frames` (any layout `to_uint8` takes) under `indices`."""
        for i, frame in zip(indices, to_uint8(frames)):
            self._q.put((int(i), frame))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                i, frame = item
                write_png(osp.join(self.dir, f"{i:03d}.png"), frame)
            except BaseException as e:  # noqa: BLE001 - re-raised by drain
                if self._err is None:
                    self._err = e

    def drain(self) -> None:
        if self._t.is_alive():
            self._q.put(None)
            self._t.join()
        if self._err is not None:
            raise self._err


def save_output(samples: dict, save_path: str, video_save_fps: float = 2,
                skip_png_keys: tuple = ()) -> None:
    """Write each "name/image" entry as name.mp4 plus name/NNN.png (no PNGs
    for a name in `skip_png_keys`: a StreamingFrameWriter wrote them), each
    "name/video" as name.mp4 and each "name/raw" as name.npy."""
    os.makedirs(save_path, exist_ok=True)
    for sample, value in samples.items():
        name, media = sample.split("/") if "/" in sample else (sample, "video")
        value = np.asarray(value)
        if media in ("image", "video"):
            frames = to_uint8(value)
            write_video(
                osp.join(save_path, f"{name}.mp4") if name else f"{save_path}.mp4",
                frames,
                fps=video_save_fps,
            )
            if media == "image" and name not in skip_png_keys:
                os.makedirs(osp.join(save_path, name), exist_ok=True)
                for i, frame in enumerate(frames):
                    write_png(osp.join(save_path, name, f"{i:03d}.png"), frame)
        elif media == "raw":
            np.save(osp.join(save_path, f"{name}.npy"), value)


def create_transforms_simple(save_path, img_paths, img_whs, c2ws, Ks) -> None:
    """nerfstudio-style transforms.json for generated cameras
    (reference seva/eval.py:1010-1034)."""
    out_frames = []
    for img_path, img_wh, c2w, K in zip(img_paths, img_whs, c2ws, Ks):
        K = np.asarray(K)
        out_frames.append(
            {
                "fl_x": float(K[0][0]),
                "fl_y": float(K[1][1]),
                "cx": float(K[0][2]),
                "cy": float(K[1][2]),
                "w": int(img_wh[0]),
                "h": int(img_wh[1]),
                "file_path": f"./{osp.relpath(img_path, start=save_path)}"
                if img_path is not None
                else None,
                "transform_matrix": np.asarray(c2w).tolist(),
            }
        )
    out = {"orientation_override": "none", "frames": out_frames}
    with open(osp.join(save_path, "transforms.json"), "w") as of:
        json.dump(out, of, indent=5)


def get_k_from_dict(d: dict, k: str) -> np.ndarray:
    media_d = {}
    for key, value in d.items():
        if key == k:
            return value
        if key.startswith(k):
            media = key.split("/")[-1]
            if media == "raw":
                return value
            media_d[media] = value
    if len(media_d) == 0:
        return np.zeros((0,))
    assert len(media_d) == 1, f"multiple media found for key {k}: {media_d.keys()}"
    return next(iter(media_d.values()))


def update_kv_for_dict(d: dict, k: str, v) -> dict:
    for key in d:
        if key.startswith(k):
            d[key] = v
    return d


def extend_dict(ds: dict, d: dict) -> dict:
    for key, value in d.items():
        if key in ds:
            ds[key] = np.concatenate([ds[key], value], axis=0)
        else:
            ds[key] = value
    return ds


def replace_or_include_input_for_dict(
    samples: dict, test_indices, imgs: np.ndarray, c2w: np.ndarray, K: np.ndarray
) -> dict:
    """Splice ground-truth input frames back into output sequences."""
    samples_new = {}
    for sample, value in samples.items():
        if "rgb" in sample:
            imgs = to_uint8(imgs) if value.dtype == np.uint8 else imgs.copy()
            imgs[test_indices] = value[test_indices] if value.shape[0] == imgs.shape[0] else value
            samples_new[sample] = imgs
        elif "c2w" in sample:
            c2w = c2w.copy()
            c2w[test_indices] = value[test_indices] if value.shape[0] == c2w.shape[0] else value
            samples_new[sample] = c2w
        elif "intrinsics" in sample:
            K = K.copy()
            K[test_indices] = value[test_indices] if value.shape[0] == K.shape[0] else value
            samples_new[sample] = K
        else:
            samples_new[sample] = value
    return samples_new


def decode_output(samples, T: int, indices=None) -> dict:
    """Sampler output as a media-keyed dict, selecting the test frames."""
    samples = np.asarray(samples)
    if indices is not None and samples.shape[0] == T:
        samples = samples[indices]
    return {"samples-rgb/image": samples}
