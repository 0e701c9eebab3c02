"""Scene -> TrainBatch data pipeline.

Counterpart of stable_virtual_camera_tpu/training/data.py: sample a T-frame
chunk from a `data.Dataset`, build the same conditioning tensors the
sampler consumes at inference (engine/value_dict.py):

  concat    = input-frame mask map ++ Plücker embedding   (T, h, w, 7)
  dense     = Plücker FiLM map                            (T, h, w, 6)
  crossattn = averaged CLIP embedding of the input views  (T, 1, ctx)

and supervise epsilon-prediction on the clean VAE latents of all frames,
with the input views masked out of the loss by default.

Image work is host-side numpy (the port's own exact area resize,
core/transforms.py); VAE and CLIP run on the model's device.
`device_prefetch` overlaps building the next batches with the train step
in a background thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np

from stable_virtual_camera_tpu_torch.core.transforms import transform_img_and_K
from stable_virtual_camera_tpu_torch.data.dataset import Dataset
from stable_virtual_camera_tpu_torch.engine.value_dict import ChunkValues, build_chunk_values
from stable_virtual_camera_tpu_torch.training.train_step import TrainBatch
from stable_virtual_camera_tpu_torch.utils import profiling


def train_batch_from_values(
    vae,
    clip,
    values: ChunkValues,
    encoding_t: int | None = 0,
    mask_inputs: bool = True,
) -> TrainBatch:
    """ChunkValues -> TrainBatch (numpy, host): clean latents of all frames
    as the regression space, conditioning tensors exactly as the sampler
    sees them. `encoding_t` frames per VAE call (0: all at once)."""
    T = values.imgs.shape[0]
    h, w = values.plucker.shape[1:3]
    mask = values.input_frame_mask

    latents = np.asarray(vae.encode(values.imgs, encoding_t), np.float32)
    clip_emb = np.asarray(clip.embed(values.imgs_clip[mask]), np.float32).mean(0)
    crossattn = np.tile(clip_emb[None, None], (T, 1, 1)).astype(np.float32)

    mask_map = np.broadcast_to(mask[:, None, None, None].astype(np.float32), (T, h, w, 1))
    plucker = values.plucker.astype(np.float32)
    concat = np.concatenate([mask_map, plucker], axis=-1)

    loss_mask = (~mask).astype(np.float32) if mask_inputs else np.ones(T, np.float32)
    return TrainBatch(
        latents=latents, concat=concat, crossattn=crossattn, dense=plucker, loss_mask=loss_mask
    )


class SceneChunkSampler:
    """Random T-frame training chunks from a parsed scene.

    Each sample draws `num_frames` distinct views, places `num_input_frames`
    of them first (the engine's chunk layout: camera-known slots lead, and
    the Plücker source is slot 0), resizes everything to the model
    resolution with intrinsics tracking, and centers/scale-normalizes the
    cameras against the full scene exactly as the engine does per chunk."""

    def __init__(
        self,
        dataset: Dataset,
        num_frames: int,
        num_input_frames: int,
        image_size: tuple[int, int],  # (W, H) model resolution
        camera_scale: float = 2.0,
    ):
        if not 0 < num_input_frames < num_frames:
            raise ValueError(f"need 0 < num_input_frames ({num_input_frames}) < num_frames ({num_frames})")
        self.dataset = dataset
        self.num_frames = num_frames
        self.num_input_frames = num_input_frames
        self.image_size = image_size
        self.camera_scale = camera_scale
        self.all_c2ws = np.asarray(dataset.parser.camtoworlds)

    def _load_view(self, item: int):
        d = self.dataset[item]
        img = np.asarray(d["image"], np.float32)
        if img.max() > 1.5:  # Dataset returns raw 0..255 floats
            img = img / 255.0
        img = img * 2.0 - 1.0
        W, H = self.image_size
        img, K = transform_img_and_K(img[None], (W, H), K=d["K"][None])
        K = K[0].copy()
        K[0] /= W
        K[1] /= H
        return img[0], K, d["camtoworld"]

    def sample(self, rng: np.random.Generator) -> ChunkValues:
        n = len(self.dataset)
        idx = np.sort(rng.choice(n, size=self.num_frames, replace=n < self.num_frames))
        # input views lead the chunk (slot 0 is the Plücker source frame)
        input_pos = np.sort(rng.choice(self.num_frames, size=self.num_input_frames, replace=False))
        order = np.concatenate([input_pos, np.setdiff1d(np.arange(self.num_frames), input_pos)])
        imgs, Ks, c2ws = [], [], []
        for i in idx[order]:
            img, K, c2w = self._load_view(int(i))
            imgs.append(img)
            Ks.append(K)
            c2ws.append(c2w)
        k = self.num_input_frames
        return build_chunk_values(
            np.stack(imgs), np.stack(imgs), list(range(k)), np.stack(c2ws), np.stack(Ks),
            list(range(k)), self.all_c2ws, camera_scale=self.camera_scale,
        )

    def batches(
        self, vae, clip, seed: int = 0, encoding_t: int | None = 0, mask_inputs: bool = True
    ) -> Iterator[TrainBatch]:
        """Infinite TrainBatch stream (host-side; wrap in device_prefetch)."""
        rng = np.random.default_rng(seed)
        while True:
            yield train_batch_from_values(
                vae, clip, self.sample(rng), encoding_t=encoding_t, mask_inputs=mask_inputs
            )


def device_prefetch(batches: Iterable[TrainBatch], device, size: int = 2) -> Iterator[TrainBatch]:
    """Overlap host batch construction with device compute: a background
    thread builds batches and moves them to `device`, `size` deep ahead of
    consumption. The bounded queue bounds host memory; an exception in the
    producer re-raises at the consumer. Spans: `data.batch` on the
    producer, around each batch's build and move (the thread serves every
    step, so it carries no step's request); `data.wait` at the consumer,
    around the wait for the next batch."""
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()

    def produce():
        try:
            it = iter(batches)
            while True:
                with profiling.span("data.batch"):
                    b = next(it, end)
                    if b is not end:
                        b = b.to(device)
                q.put(b)
                if b is end:
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
            q.put(_ProducerError(e))

    threading.Thread(target=produce, daemon=True).start()
    while True:
        with profiling.span("data.wait"):
            item = q.get()
        if item is end:
            return
        if isinstance(item, _ProducerError):
            raise item.error
        yield item


class _ProducerError:
    def __init__(self, error: BaseException):
        self.error = error
