"""DUSt3R preprocessing of unposed images: the GUI's Advanced mode.

Counterpart of stable_virtual_camera_tpu/apps/preprocessor.py. A stereo
network regresses pointmaps for every ordered image pair, global alignment
(core/global_alignment.py, Adam on the card) recovers per-image intrinsics,
c2w poses and confidence-masked point clouds, and the intrinsics are scaled
back to each original image's resolution.

`NativeDust3rPipeline` runs the port's own network (models/dust3r.py) on
the card; `estimate_poses_fallback` gives the identity-pose geometry of
Basic mode. PIL is imported where images are read.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stable_virtual_camera_tpu_torch.core.camera import get_default_intrinsics
from stable_virtual_camera_tpu_torch.core.global_alignment import (
    edges_from_dust3r_output,
    global_align,
)


def _finalize_scene(img_list, img_paths, scene, num_img, min_conf_thr):
    """The post-alignment tail of infer_cameras_and_points: mask the
    per-image pointmaps by confidence, undo the single-image duplication, and
    scale the intrinsics back to each original image's resolution."""
    import PIL.Image

    Ks = scene.Ks.copy()
    c2ws = scene.c2ws
    # mixed-size image sets: the aligner's maps are padded to a common
    # extent; crop each image's points and masks back to its real size
    def crop(arrs):
        return [a[: im.shape[0], : im.shape[1]] for a, im in zip(arrs, img_list)]

    pts3d = crop(list(scene.pts3d))
    masks = crop(scene.masks(min_conf_thr))
    uniform = len({im.shape for im in img_list}) == 1
    imgs = np.stack(img_list) if uniform else img_list

    if num_img == 1:
        imgs, Ks, c2ws = imgs[:1], Ks[:1], c2ws[:1]
        pts3d, masks = pts3d[:1], masks[:1]

    out_Ks = []
    for i, path in enumerate(img_paths[: len(Ks)]):
        with PIL.Image.open(path) as im:
            W, H = im.size
        hs, ws = imgs[i].shape[:2]
        K = Ks[i].copy()
        K[0] *= W / ws
        K[1] *= H / hs
        out_Ks.append(K)

    points = [p[m] for p, m in zip(pts3d, masks)]
    colors = [img[m] for img, m in zip(imgs, masks)]
    return imgs, np.stack(out_Ks), c2ws, points, colors


def load_and_preprocess_images(img_paths: list[str], size: int = 512, patch: int = 16) -> list[np.ndarray]:
    """dust3r's loader for size=512: resize the long side to `size`
    (LANCZOS), center-crop each dimension down to a multiple of `patch`,
    normalize to [-1, 1]. Returns HWC fp32 arrays (shapes vary with the
    aspect ratio)."""
    import PIL.Image

    out = []
    for path in img_paths:
        with PIL.Image.open(path) as im:
            im = im.convert("RGB")
            W, H = im.size
            scale = size / max(W, H)
            W2, H2 = max(patch, round(W * scale)), max(patch, round(H * scale))
            im = im.resize((W2, H2), PIL.Image.LANCZOS)
            arr = np.asarray(im, dtype=np.float32)
        h0 = (H2 - H2 // patch * patch) // 2
        w0 = (W2 - W2 // patch * patch) // 2
        arr = arr[h0 : h0 + H2 // patch * patch, w0 : w0 + W2 // patch * patch]
        out.append(arr / 127.5 - 1.0)
    return out


class NativeDust3rPipeline:
    """The preprocessing path with the port's own stereo network on `device`
    (the card unless the caller passes the CPU) and the port's aligner.

    Weights come from `state_dict=` (the port's names, e.g. from
    models/io.load_dust3r_state or a bridged JAX tree), `weight_path=` (the
    released `.pth` or `.safetensors`, or a converted-cache directory from
    apps/convert_weights.py --dust3r), or, with neither, flax-default random
    weights drawn from `generator` (tests and smoke runs). Pairs follow the
    complete symmetric scene graph and run in buckets of equal (shape1,
    shape2), in `batch_size` chunks, under `torch.inference_mode()`.
    """

    def __init__(self, state_dict: dict | None = None, spec=None, weight_path: str | None = None,
                 generator: torch.Generator | None = None, device="cuda",
                 dtype: torch.dtype = torch.float32):
        from stable_virtual_camera_tpu_torch.models.dust3r import AsymmetricCroCoStereo, Dust3rSpec
        from stable_virtual_camera_tpu_torch.models import io as mio

        self.spec = spec or Dust3rSpec()
        self.device = torch.device(device)
        if state_dict is None and weight_path is not None:
            if os.path.isdir(weight_path):
                state_dict = mio.load_converted(weight_path, "dust3r", device="cpu")
            else:
                state_dict = mio.load_dust3r_state(weight_path, self.spec)
        if state_dict is None and generator is None:
            raise ValueError(
                "NativeDust3rPipeline needs weights (state_dict= or weight_path=); "
                "pass generator= for random weights."
            )
        with torch.device(self.device):
            model = AsymmetricCroCoStereo(self.spec)
        if state_dict is None:
            mio.init_flax_defaults(model, generator)
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(dtype=dtype, memory_format=torch.channels_last).eval()

    def infer_cameras_and_points(self, img_paths: list[str], batch_size: int = 16,
                                 schedule: str = "cosine", lr: float = 0.01, niter: int = 500,
                                 min_conf_thr: int = 3):
        """Returns (imgs [0..1], Ks, c2ws, points per image, colors per image)."""
        num_img = len(img_paths)
        imgs_pm1 = load_and_preprocess_images(img_paths, self.spec.img_size, self.spec.patch_size)
        if num_img == 1:  # duplicate a single image into a stereo pair
            imgs_pm1 = [imgs_pm1[0], imgs_pm1[0].copy()]
        scene = global_align(edges_from_dust3r_output(self.pairwise(imgs_pm1, batch_size)),
                             niter=niter, lr=lr, schedule=schedule, same_focals=True,
                             device=self.device)
        img_list = [((im + 1.0) / 2.0).astype(np.float32) for im in imgs_pm1]
        return _finalize_scene(img_list, img_paths, scene, num_img, min_conf_thr)

    def pairwise(self, imgs_pm1: list[np.ndarray], batch_size: int = 16) -> dict:
        """The network over every ordered pair (i, j), i != j, as a dust3r
        inference dict of per-edge numpy maps."""
        n = len(imgs_pm1)
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        by_shape: dict = {}
        for e, (i, j) in enumerate(pairs):
            by_shape.setdefault((imgs_pm1[i].shape, imgs_pm1[j].shape), []).append(e)
        E = len(pairs)
        p1, c1, p2, c2 = [None] * E, [None] * E, [None] * E, [None] * E

        def batch(chunk, side):
            return torch.from_numpy(np.stack([imgs_pm1[pairs[e][side]] for e in chunk])).to(self.device)

        with torch.inference_mode():
            for idxs in by_shape.values():
                for s in range(0, len(idxs), batch_size):
                    chunk = idxs[s : s + batch_size]
                    out = self.model(batch(chunk, 0), batch(chunk, 1))
                    P1, C1 = (out["pred1"][k].float().cpu().numpy() for k in ("pts3d", "conf"))
                    P2, C2 = (out["pred2"][k].float().cpu().numpy() for k in ("pts3d_in_other_view", "conf"))
                    for bi, e in enumerate(chunk):
                        p1[e], c1[e], p2[e], c2[e] = P1[bi], C1[bi], P2[bi], C2[bi]
        return {
            "view1": {"idx": [i for i, _ in pairs]},
            "view2": {"idx": [j for _, j in pairs]},
            "pred1": {"pts3d": p1, "conf": c1},
            "pred2": {"pts3d_in_other_view": p2, "conf": c2},
        }


def estimate_poses_fallback(img_hw_list: list[tuple[int, int]]) -> tuple[np.ndarray, np.ndarray]:
    """Basic-mode geometry: identity pose and default-FOV pixel intrinsics
    per image."""
    n = len(img_hw_list)
    c2ws = np.repeat(np.eye(4)[None], n, axis=0)
    Ks = []
    for h, w in img_hw_list:
        K = get_default_intrinsics(aspect_ratio=w / h)[0].copy()
        K[0] *= w
        K[1] *= h
        Ks.append(K)
    return c2ws, np.stack(Ks)
