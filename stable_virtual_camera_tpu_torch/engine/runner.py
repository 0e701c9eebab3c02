"""The scene engine: chunked, single- or two-pass, autoregressive sampling.

Counterpart of stable_virtual_camera_tpu/engine/runner.py (`VaeApplier`,
`ClipApplier`, `ModelBundle`, `build_chunk_conditioning`, `sample_chunk`,
`SceneEngine.run_one_scene`): the single-pass render (`use_traj_prior=False`,
the CLI's default) and the two-pass trajectory-prior render, with the same
chunk plans (engine/planner.py, engine/prior.py and engine/value_dict.py,
copies of the JAX package's host code), the same conditioning,
dense-economy anchors and anchor delivery. Scene images may be paths (read
with OpenCV), `None` (a blank frame of the previous image's size) or
arrays, as in JAX.

Differences by design: VAE/CLIP en/decode chunk with a Python loop over
`encoding_t`/`decoding_t` (0 = one batch); chunks run one after another
unless a mesh or `chunk_batch` groups the second pass's; files are written
only when a `save_path` is given. Without one, `run_one_scene` yields each
pass's uint8 frames instead of file paths. Initial and churn noise come from
`noise_fn` (sampling/sampler.py). JAX's `SVC_FUSED_DECODE` (the VAE decode
traced into the jitted sampling scan, to save a TPU program switch) has no
counterpart: eager PyTorch has no program to fuse into, and a chunk's decode
already queues on the device behind its last step.

The second pass's conditioning prefetch window (the `prefetch_chunks`
option, JAX's default of 3, where JAX reads SVC_PREFETCH_CHUNKS): the serial
loop builds the first `prefetch_chunks` chunks' conditioning before it
dispatches any, and after dispatching chunk `pos` builds chunk
`pos + prefetch_chunks`, dropping each slot once used, as JAX does. A build
that synchronized the device would make the loop wait for the chunk in
flight, so the window's builds do not: before the loop, every chunk's VAE
encode and CLIP embed run in chunk order (`prime_chunk_conditioning`: the
same calls the builds make, so the same batches and bits), which leaves the
builds in the loop cache hits, and the uploads go through pinned host
buffers with `non_blocking=True`. The one synchronization left in a build
is the priming's own `.cpu()`, before the loop.

Streamed writes (the `stream_save` option, on by default and off under
`replace_or_include_input`, as in JAX): a two-pass render with a
`save_path` writes the first pass's PNGs and the second pass's final PNGs
on `StreamingFrameWriter` threads (engine/saving.py) while it goes on, and
the final save writes only the mp4 and the rest. Each second-pass chunk's
flush (the decoded frames' host copy on a side stream, `decode_output`, the
optional per-chunk save, `extend_dict`, the index bookkeeping and the
writer's submit) runs on ONE worker thread, so it overlaps the next
chunk's dispatch; a FIFO of one worker keeps the serial order. The flush
worker runs with or without streamed writes. Every exit (the end, an
abort, an exception, a generator closed early) stops the flush worker
first, cancelling the flushes not yet started, then drains the writers,
and re-raises the first error a worker met unless another is already on
its way.

Under static W8A8 (`bundle.unet.set_quant("w8a8-static")`, ops/quant.py) the
bundle's first `sample_chunk` calibrates the UNet on that chunk's own
conditioning (`ensure_quant_calibrated`), as JAX's
`UNetDenoiser.ensure_quant_calibrated` does.

`bundle.artifacts` maps (T, h, w, steps) buckets to exported step programs
(models/export.py): a chunk whose bucket is there runs the pinned program,
any other the live step, as JAX's `UNetDenoiser.sample` does. Both routes
are the same host loop, so progress and abort stay per step on both.

`bundle.mesh` (parallel/mesh.py, a ("data", "view") grid) shards sampling
as JAX's `UNetDenoiser(mesh=...)` does: a chunk whose T divides the view
axis runs view-sharded (parallel/sharding.make_sharded_sampler, on the
mesh's first data row), any other unsharded after a warning once per T; an
exported bucket runs its program unsharded, as JAX runs the artifact. The
second pass builds every chunk's work first and, without a per-step
progress callback, fans the chunks out in groups of the data axis
(`sample_many`), the last group padded by repeating its last chunk and the
padding dropped; without a data axis, the `chunk_batch` option groups them
on one device. Static W8A8 calibrates before a group runs.
"""

from __future__ import annotations

import concurrent.futures
import copy
import functools
import hashlib
import os.path as osp
import threading
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Iterator

import numpy as np
import torch

from stable_virtual_camera_tpu_torch.config import EngineOptions, SevaSpec, VersionConfig
from stable_virtual_camera_tpu_torch.core.transforms import (
    load_img_and_K,
    transform_img_and_K,
    transform_K,
)
from stable_virtual_camera_tpu_torch.engine import planner
from stable_virtual_camera_tpu_torch.engine.saving import (
    StreamingFrameWriter,
    decode_output,
    extend_dict,
    get_k_from_dict,
    replace_or_include_input_for_dict,
    save_output,
    to_uint8,
    update_kv_for_dict,
)
from stable_virtual_camera_tpu_torch.engine.value_dict import ChunkValues, build_chunk_values
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionTower, preprocess
from stable_virtual_camera_tpu_torch.models.unet import SevaUNet, assemble_network_input
from stable_virtual_camera_tpu_torch.models.vae import DOWNSAMPLE, AutoEncoderKL
from stable_virtual_camera_tpu_torch.parallel.mesh import Mesh
from stable_virtual_camera_tpu_torch.parallel.sharding import (
    make_batched_sampler,
    make_data_parallel_sampler,
    make_sharded_sampler,
)
from stable_virtual_camera_tpu_torch.parallel.tensor_parallel import shard_unet
from stable_virtual_camera_tpu_torch.sampling import guidance
from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
from stable_virtual_camera_tpu_torch.sampling.sampler import (
    ChunkConditioning,
    NoiseFn,
    SamplingPlan,
    euler_edm_capture,
    euler_edm_sample,
    make_sampling_plan,
    torch_noise,
)
from stable_virtual_camera_tpu_torch.utils import profiling


# every chunk of at most this many frames samples on its FiLM cache
# (`ModelBundle.chunk_film`), a longer one recomputes its FiLM maps every
# step: the cache grows with T (JAX's SVC_FILM_CACHE_MAX_T default). JAX
# keeps the cache off unless SVC_FILM_CACHE asks; the port keeps it on:
# on an H100 80GB HBM3 (700 W) the seeded 576x576 T=21 bf16 chunk gave
# bit-equal latents in 0.934x the time, its peak memory 2.14 GB higher
# (chip_smoke.py, film_cache)
FILM_CACHE_MAX_T = 48


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _frame_keys(imgs: np.ndarray) -> list[bytes]:
    return [hashlib.md5(np.ascontiguousarray(im).tobytes()).digest() for im in imgs]


def _chunked(fn, x: torch.Tensor, chunk_size: int | None) -> torch.Tensor:
    step = chunk_size or x.shape[0]
    return torch.cat([fn(x[i : i + step]) for i in range(0, x.shape[0], step)])


class VaeApplier:
    """VAE encode/decode over numpy or device batches, optionally chunked,
    with a per-scene content cache for encodes."""

    def __init__(self, module: AutoEncoderKL):
        self.module = module
        self._enc_cache: dict[bytes, np.ndarray] = {}

    @torch.inference_mode()
    def encode(self, imgs: np.ndarray, chunk_size: int | None = None) -> np.ndarray:
        """(N, H, W, 3) in [-1, 1] -> (N, H/8, W/8, 4) latents."""
        N, H, W, _ = imgs.shape
        if N == 0:
            return np.zeros((0, H // DOWNSAMPLE, W // DOWNSAMPLE, 4), np.float32)
        x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(_device(self.module))
        return _chunked(self.module.encode, x, chunk_size).cpu().numpy()

    def encode_cached(self, imgs: np.ndarray, chunk_size: int | None = None) -> np.ndarray:
        """`encode`, reusing the latents of frames already encoded this scene
        (input and anchor frames recur across chunks)."""
        if imgs.shape[0] == 0:
            return self.encode(imgs, chunk_size)
        keys = _frame_keys(imgs)
        missing = [i for i, k in enumerate(keys) if k not in self._enc_cache]
        if missing:
            lat = self.encode(imgs[missing], chunk_size)
            for j, i in enumerate(missing):
                self._enc_cache[keys[i]] = lat[j]
        return np.stack([self._enc_cache[k] for k in keys])

    def clear_cache(self) -> None:
        self._enc_cache.clear()

    @torch.inference_mode()
    def decode(self, z: torch.Tensor, chunk_size: int | None = None, uint8: bool = False,
               host: bool = True):
        """Latents -> (N, H, W, 3) images: fp32 in [-1, 1], or uint8 with the
        host writer's quantisation; a numpy array, or with `host=False` the
        device tensor (no synchronisation)."""
        fn = self.module.decode_uint8 if uint8 else self.module.decode
        out = _chunked(fn, torch.as_tensor(z).to(_device(self.module)), chunk_size)
        return out.cpu().numpy() if host else out


class ClipApplier:
    """CLIP image embedding (preprocess + tower) with a per-scene cache."""

    def __init__(self, module: ClipVisionTower):
        self.module = module
        self._emb_cache: dict[bytes, np.ndarray] = {}

    @torch.inference_mode()
    def embed(self, imgs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(_device(self.module))
        return self.module(preprocess(x, self.module.spec.image_size)).cpu().numpy()

    def embed_cached(self, imgs: np.ndarray) -> np.ndarray:
        if imgs.shape[0] == 0:
            return self.embed(imgs)
        keys = _frame_keys(imgs)
        missing = [i for i, k in enumerate(keys) if k not in self._emb_cache]
        if missing:
            emb = self.embed(imgs[missing])
            for j, i in enumerate(missing):
                self._emb_cache[keys[i]] = emb[j]
        return np.stack([self._emb_cache[k] for k in keys])

    def clear_cache(self) -> None:
        self._emb_cache.clear()


@dataclass
class ModelBundle:
    """Everything the engine needs to run a scene."""

    spec: SevaSpec
    unet: SevaUNet
    vae: VaeApplier
    clip: ClipApplier
    discretization: DDPMDiscretization = field(default_factory=DDPMDiscretization)
    # (T, h, w, steps) -> models/export.DenoiseArtifact
    artifacts: dict = field(default_factory=dict)
    # view-sharded chunks, data-parallel second passes, and with a "model"
    # axis tensor-parallel chunks
    mesh: Mesh | None = None

    _plans: dict[int, SamplingPlan] = field(default_factory=dict)
    # device -> ((W8A8 mode, calibrated), the UNet's copy there); rank
    # threads may ask for one at once
    _replicas: dict = field(default_factory=dict)
    # (device, model rank, model size) -> ((W8A8 mode, calibrated), the
    # rank's shard module)
    _shards: dict = field(default_factory=dict)
    _replica_lock: threading.Lock = field(default_factory=threading.Lock)
    _warned_unsharded: set = field(default_factory=set)

    @property
    def device(self) -> torch.device:
        return _device(self.unet)

    def unet_on(self, device) -> SevaUNet:
        """The UNet on `device`: the bundle's own there, else its replica
        (a copy made when first asked for, and again after the bundle's
        W8A8 mode or calibration changed). Ranks that share a device share
        one module."""
        device = torch.device(device)
        if device == self.device:
            return self.unet
        key = (self.unet.quant, self.unet.quant_calibrated)
        with self._replica_lock:
            held = self._replicas.get(device)
            if held is None or held[0] != key:
                self._replicas.pop(device, None)
                self._replicas[device] = (key, copy.deepcopy(self.unet).to(device))
            return self._replicas[device][1]

    def unet_shard(self, device, rank: int, n: int) -> SevaUNet:
        """Model rank `rank` of `n`'s shard module of the UNet on `device`
        (parallel/tensor_parallel.shard_unet), built when first asked for and
        again after the bundle's W8A8 mode or calibration changed. Ranks
        that share a device and a model coordinate share one module."""
        device = torch.device(device)
        key = (self.unet.quant, self.unet.quant_calibrated)
        with self._replica_lock:
            held = self._shards.get((device, rank, n))
            if held is None or held[0] != key:
                self._shards.pop((device, rank, n), None)
                self._shards[device, rank, n] = (key, shard_unet(self.unet, rank, n, device))
            return self._shards[device, rank, n][1]

    def replicate(self) -> None:
        """A UNet replica on every device of the mesh that does not hold the
        bundle's, and on a mesh with a "model" axis every rank's shard."""
        mesh = self.mesh
        for dev in dict.fromkeys(mesh.devices if mesh is not None else []):
            self.unet_on(dev)
        if mesh is not None and mesh.n_model > 1:
            for r in range(mesh.size):
                self.unet_shard(mesh.device(r), mesh.coords(r)[2], mesh.n_model)

    def module_for(self, device, model_group=None) -> SevaUNet:
        """The UNet a rank on `device` runs: its model rank's shard under a
        model group of more than one rank, else `unet_on(device)`."""
        if model_group is not None and model_group.size > 1:
            return self.unet_shard(device, model_group.rank, model_group.size)
        return self.unet_on(device)

    def chunk_film(self, dense, num_frames, group=None, model_group=None):
        """The chunk's FiLM cache for the rank that holds `dense` (this
        rank's CFG-doubled Plücker maps, `num_frames` frames a scene), or
        None when the chunk has more than FILM_CACHE_MAX_T frames. Computed
        at half the batch, whose halves share one Plücker map (the
        ChunkConditioning contract), and broadcast over the CFG halves; at
        the whole batch under a view group of more than one rank, as JAX
        computes it under view sharding."""
        n = 1 if group is None else group.size
        if num_frames * n > FILM_CACHE_MAX_T:
            return None
        batch = dense if n > 1 else dense[: dense.shape[0] // 2]
        with torch.inference_mode():
            return self.module_for(dense.device, model_group).film(batch, model_group=model_group)

    def plan(self, num_steps: int) -> SamplingPlan:
        if num_steps not in self._plans:
            self._plans[num_steps] = make_sampling_plan(self.discretization, num_steps)
        return self._plans[num_steps]

    def network(self, x, concat, t_vec, crossattn, dense, num_frames, group=None, model_group=None,
                film=None):
        """The UNet on x's device; with a view `group`, one rank's share
        (`num_frames` frames a scene, models/unet.py); with a `model_group`
        of more than one rank, on this rank's weight shards; with `film`,
        on the chunk's FiLM cache (`chunk_film`)."""
        return self.module_for(x.device, model_group)(
            assemble_network_input(x, concat), t_vec, crossattn, dense, num_frames, group=group,
            film=film, model_group=model_group)


def build_chunk_conditioning(
    bundle: ModelBundle,
    values: ChunkValues,
    *,
    cfg: float,
    guider_type: int,
    cfg_min: float,
    encoding_t: int | None = None,
    latent_downsample: int = 8,
) -> tuple[ChunkConditioning, tuple[int, int, int, int]]:
    """One chunk's CFG-doubled conditioning on the device: VAE-encoded input
    views, the mean CLIP embedding, mask/Plücker maps and the per-frame
    guidance scale. Returns (cond, (T, h, w, C))."""
    T, H, W = values.imgs.shape[:3]
    h, w = H // latent_downsample, W // latent_downsample
    mask = values.input_frame_mask

    latents = bundle.vae.encode_cached(values.imgs[mask], encoding_t)
    clip_emb = bundle.clip.embed_cached(values.imgs_clip[mask]).mean(0)

    C = latents.shape[-1]
    replace_c = np.zeros((T, h, w, C + 1), np.float32)
    replace_c[mask] = np.concatenate([latents, np.ones((*latents.shape[:-1], 1), np.float32)], axis=-1)
    crossattn_c = np.tile(clip_emb[None, None], (T, 1, 1)).astype(np.float32)
    mask_map = np.broadcast_to(mask[:, None, None, None].astype(np.float32), (T, h, w, 1))
    plucker = np.asarray(values.plucker, np.float32)
    concat_c = np.concatenate([mask_map, plucker], axis=-1)
    concat_u = np.concatenate([np.zeros_like(mask_map), plucker], axis=-1)
    scale_vec = guidance.compute_scale_vector(
        guider_type, cfg, T, values.c2w, values.K, mask, cfg_min
    )

    def dev(a):
        # pinned and non-blocking on a card, so a build queued behind a
        # chunk in flight does not wait for it
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if bundle.device.type == "cuda":
            t = t.pin_memory()
        return t.to(bundle.device, non_blocking=True)

    cond = ChunkConditioning(
        crossattn=dev(np.concatenate([np.zeros_like(crossattn_c), crossattn_c], 0)),
        concat=dev(np.concatenate([concat_u, concat_c], 0)),
        dense=dev(np.concatenate([plucker, plucker], 0)),
        replace=dev(np.concatenate([np.zeros_like(replace_c), replace_c], 0)),
        scale=dev(scale_vec),
    )
    return cond, (T, h, w, C)


def prime_chunk_conditioning(bundle: ModelBundle, values: ChunkValues,
                             encoding_t: int | None = None) -> None:
    """The VAE encode and CLIP embed of one chunk's input frames, into the
    scene's caches: the calls `build_chunk_conditioning` makes, so a later
    build of the same chunk only reads the caches (and, primed in chunk
    order, the encodes run in the same batches as the builds would)."""
    mask = values.input_frame_mask
    bundle.vae.encode_cached(values.imgs[mask], encoding_t)
    bundle.clip.embed_cached(values.imgs_clip[mask])


def calibration_points(num_steps: int, num_points: int = 6) -> np.ndarray:
    """The steps of a trajectory the static calibration runs the UNet at:
    `num_points` spread over the schedule (JAX's choice)."""
    return np.unique(
        np.linspace(0, num_steps - 1, min(num_points, num_steps)).round().astype(np.int32)
    )


@torch.inference_mode()
def calibrate_unet(unet: SevaUNet, net_xs: torch.Tensor, t_vecs: torch.Tensor,
                   cond: ChunkConditioning, num_frames: int, points) -> None:
    """Run the UNet in calibration mode on the captured network inputs at
    `points` (steps of the capture), one serving-sized forward each: every
    site quantizes its weight and raises its activation abs-max to the
    largest seen, the max over points JAX's merge takes. Leaves the UNet in
    "w8a8-static"."""
    unet.set_quant("w8a8-calib")
    try:
        for k in points:
            unet(assemble_network_input(net_xs[int(k)], cond.concat), t_vecs[int(k)],
                 cond.crossattn, cond.dense, num_frames)
    except BaseException:
        unet.clear_quant_state()
        raise
    finally:
        unet.set_quant("w8a8-static")


def ensure_quant_calibrated(bundle: "ModelBundle", shape, plan: SamplingPlan,
                            cond: ChunkConditioning, num_points: int = 6) -> bool:
    """Static-W8A8 calibration on this chunk's own conditioning; a no-op
    in every other mode and once calibrated (returns whether it ran).

    One exact sampling trajectory on the serving schedule captures every
    step's network inputs (`euler_edm_capture`), then the UNet runs in
    calibration mode at `calibration_points` of it. The trajectory's noise
    is the port's own draw from a generator seeded with 0 on the bundle's
    device (initial noise, then each step's churn noise), not JAX's
    `PRNGKey(0)` draw, so the calibrated scales are the port's."""
    unet = bundle.unet
    if getattr(unet, "quant", "0") != "w8a8-static" or unet.quant_calibrated:
        return False
    dev = bundle.device
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(_step=None):
        return torch.randn(tuple(shape), generator=g, device=dev, dtype=torch.float32)

    with unet.quant_mode("0"):
        net_xs, t_vecs = euler_edm_capture(bundle.network, draw(), plan, cond, shape[0], draw)
    calibrate_unet(unet, net_xs, t_vecs, cond, shape[0],
                   calibration_points(plan.num_steps, num_points))
    return True


def sample_latents(bundle: ModelBundle, noise: torch.Tensor, plan: SamplingPlan,
                   cond: ChunkConditioning, step_noise, progress_cb=None,
                   abort_event=None) -> torch.Tensor | None:
    """One chunk's denoising loop: through the bundle's exported step
    program when its bucket (T, h, w, steps) is loaded, else through the
    live network, view-sharded over the bundle's mesh when T divides its
    view axis. Returns None when aborted."""
    T, h, w, _ = noise.shape
    artifact = getattr(bundle, "artifacts", {}).get((T, h, w, plan.num_steps))
    if artifact is not None:
        return artifact.sample(bundle.unet, noise, plan, cond, step_noise, progress_cb, abort_event)
    mesh = getattr(bundle, "mesh", None)
    film_fn = getattr(bundle, "chunk_film", None)
    if mesh is not None:
        n_view = mesh.shape["view"]
        if T % n_view == 0:
            return make_sharded_sampler(bundle.network, mesh, T, film_fn=film_fn)(
                noise, plan, cond, step_noise, progress_cb, abort_event)
        # as in JAX, such a bucket runs on one device: no view and no model shards
        if T not in bundle._warned_unsharded:
            bundle._warned_unsharded.add(T)
            print(f"[sampler] WARNING: T={T} does not divide the mesh view axis ({n_view}); "
                  "this shape bucket runs UNSHARDED on one device")
    film = None if film_fn is None else film_fn(cond.dense, T)
    network = bundle.network if film is None else partial(bundle.network, film=film)
    return euler_edm_sample(network, noise, plan, cond, T, step_noise=step_noise,
                            progress_cb=progress_cb, abort_event=abort_event)


def sample_many(bundle: ModelBundle, noises, plan: SamplingPlan, conds, step_noises) -> torch.Tensor:
    """N independent chunks (JAX's `UNetDenoiser.sample_many`): over the
    bundle's mesh, its data rows taking N / n_data chunks each
    (parallel/sharding.make_data_parallel_sampler; N a multiple of the data
    axis), else as one batch on the bundle's device. `noises[c]`, `conds[c]`
    and `step_noises[c]` are chunk c's; returns (N, T, h, w, C)."""
    T = noises[0].shape[0]
    film_fn = getattr(bundle, "chunk_film", None)
    if getattr(bundle, "mesh", None) is not None:
        return make_data_parallel_sampler(bundle.network, bundle.mesh, T, film_fn=film_fn)(
            noises, plan, conds, step_noises)
    return make_batched_sampler(bundle.network, T, film_fn=film_fn)(noises, plan, conds, step_noises)


def sample_chunk(
    bundle: ModelBundle,
    values: ChunkValues,
    *,
    num_steps: int,
    cfg: float,
    guider_type: int,
    cfg_min: float,
    noise_fn: NoiseFn,
    pass_id: int = 0,
    chunk_id: int = 0,
    encoding_t: int | None = None,
    decoding_t: int | None = None,
    latent_downsample: int = 8,
    progress_cb=None,
    abort_event=None,
    output_uint8: bool = False,
    defer: bool = False,
    prebuilt=None,
):
    """One chunk: conditioning, denoising loop (`sample_latents`), decode.
    `noise_fn(pass_id, chunk_id, step, shape, device)` supplies the noise.
    `prebuilt`, an already built `(cond, shape)` of this chunk
    (`build_chunk_conditioning`), takes the place of the build. Returns the
    decoded frames (uint8 with `output_uint8`; with `defer` the device
    tensor, not yet copied to the host), or None when aborted. Under static
    W8A8 the bundle's first chunk calibrates first
    (`ensure_quant_calibrated`)."""
    if prebuilt is not None:
        cond, shape = prebuilt
    else:
        cond, shape = build_chunk_conditioning(
            bundle, values, cfg=cfg, guider_type=guider_type, cfg_min=cfg_min,
            encoding_t=encoding_t, latent_downsample=latent_downsample,
        )
    dev = bundle.device
    ensure_quant_calibrated(bundle, shape, bundle.plan(num_steps), cond)

    def draw(step):
        return noise_fn(pass_id, chunk_id, step, shape, dev).to(dev, torch.float32)

    x = sample_latents(bundle, draw(None), bundle.plan(num_steps), cond, draw,
                       progress_cb=progress_cb, abort_event=abort_event)
    if x is None:
        return None
    return bundle.vae.decode(x, decoding_t, uint8=output_uint8, host=not defer)


# a device's side stream for the flush worker's host copies, one a device
# for the process: the caching allocator keeps a stream's freed blocks for
# that stream alone, so a new stream each render would cache blocks apart
# each render
_FLUSH_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
_FLUSH_STREAMS_LOCK = threading.Lock()


def _host_copy_later(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """A function, to be called on another thread, that returns `t` as a
    numpy array. On a card the copy runs on the device's flush stream after
    an event recorded here, on the producer's stream, so that it waits for
    the work that wrote `t` and for nothing queued later; `t` is recorded
    on the flush stream for the caching allocator. The caller must not
    write `t` again."""
    if t.device.type != "cuda":
        return lambda: t.numpy()
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(t.device))

    def fetch() -> np.ndarray:
        with _FLUSH_STREAMS_LOCK:
            side = _FLUSH_STREAMS.get(t.device)
            if side is None:
                side = _FLUSH_STREAMS[t.device] = torch.cuda.Stream(device=t.device)
        side.wait_event(ready)
        with torch.cuda.stream(side):
            out = t.cpu()
        t.record_stream(side)
        return out.numpy()

    return fetch


def _close(cleanup: list, quiet: bool = False) -> None:
    """Run the render's teardown steps, last registered first, every one of
    them; then raise the first error one raised, unless `quiet`."""
    first = None
    while cleanup:
        try:
            cleanup.pop()()
        except BaseException as e:  # noqa: BLE001 - raised below, after every step ran
            first = first or e
    if first is not None and not quiet:
        raise first


def _torn_down(render):
    """`render`'s generator, with the teardown steps it registers in its
    `cleanup` list (its flush worker, its frame writers) run on every exit:
    at the end, on an abort, on an exception and when the caller closes the
    generator early. No worker thread outlives the render, and a worker's
    error is raised unless another error is already on its way."""

    @functools.wraps(render)
    def run(*args, **kwargs):
        cleanup: list[Callable[[], None]] = []
        try:
            yield from render(*args, cleanup=cleanup, **kwargs)
        except BaseException:
            with profiling.span("engine.teardown"):
                _close(cleanup, quiet=True)
            raise
        with profiling.span("engine.teardown"):
            _close(cleanup)

    return run


# the engine's stages, under the JAX engine's names: what a `timer` gets
STAGES = frozenset({
    "prepare_images", "first_pass_build", "first_pass_sample", "first_pass_decode_extend", "first_pass_save",
    "second_pass_plan", "second_pass_build", "second_pass_conditioning", "second_pass_sample",
    "second_pass_sample_many", "second_pass_flush", "second_pass_flush_join", "final_save",
})


def _resolve_guiders(guider_types) -> list[int]:
    if not isinstance(guider_types, (list, tuple)):
        return [int(guider_types)]
    return [int(g) for g in guider_types]


def _cfg_at(cfg, i: int) -> float:
    if isinstance(cfg, (list, tuple)):
        return float(cfg[i]) if len(cfg) > i else float(cfg[0])
    return float(cfg)


class SceneEngine:
    """Runs `run_one_scene` over a ModelBundle. The options are copied, so a
    run never sees later changes to the caller's object (engine/prior.py
    rewrites `deliver_anchors` in place)."""

    def __init__(
        self,
        bundle: ModelBundle,
        version: VersionConfig,
        options: EngineOptions,
        noise_fn: NoiseFn = torch_noise,
    ):
        self.bundle = bundle
        self.version = version
        self.options = copy.deepcopy(options)
        self.noise_fn = noise_fn

    def _prepare_images(self, image_cond, camera_cond):
        """Load and transform all scene images to the render size and
        normalise their Ks (reference seva/eval.py:1352-1424). A path is read
        and transformed alone, with the input or target transform options;
        `None` is a blank frame of the previous image's size. With
        `L_short`, the render size follows the images and `version.W/H` are
        rewritten in place, as in JAX. Arrays (uint8, or float in [-1, 1] /
        [0, 255]) are transformed one batch per input size."""
        options, version = self.options, self.version
        W, H = version.W, version.H
        imgs: list = []
        pending: dict = {}
        img_size = None
        for i, (img, K) in enumerate(zip(image_cond["img"], camera_cond["K"])):
            if isinstance(img, str) or img is None:
                img_arr, K = load_img_and_K(img or img_size, None, K=np.asarray(K))
                img_size = img_arr.shape[1:3]
                is_input = i in image_cond["input_indices"]
                mode = options.get("transform_input" if is_input else "transform_target", "crop")
                scale = 1.0 if is_input else options.get("transform_scale", 1.0)
                if options.get("L_short", -1) == -1:
                    img_arr, K = transform_img_and_K(img_arr, (W, H), K=K[None], mode=mode, scale=scale)
                else:
                    stride = version.f * 2**3
                    assert options.get("L_short") % stride == 0, (
                        f"--L_short must be a multiple of the latent stride {stride}"
                    )
                    img_arr, K = transform_img_and_K(
                        img_arr, options.get("L_short"), K=K[None], size_stride=stride,
                        mode=mode, scale=scale,
                    )
                    version.W = W = img_arr.shape[2]
                    version.H = H = img_arr.shape[1]
                K = K[0]
                K[0] /= W
                K[1] /= H
                camera_cond["K"][i] = K
                imgs.append(img_arr)
                continue
            if not isinstance(img, np.ndarray):
                raise TypeError(f"Unsupported image type {type(img)}")
            img_size = img.shape[:2]
            if img.dtype == np.uint8:
                arr = img.astype(np.float32)[None] / 255.0 * 2.0 - 1.0
            else:
                arr = np.asarray(img, np.float32)[None]
                if arr.max() > 1.5:  # 0..255 float
                    arr = arr / 255.0 * 2.0 - 1.0
            pending.setdefault(arr.shape[1:3], []).append((i, arr, np.asarray(K)))
            imgs.append(None)
        for items in pending.values():
            batch = np.concatenate([a for _, a, _ in items], 0)
            Ks_in = np.stack([k for _, _, k in items], 0)
            batch_t, Ks_t = transform_img_and_K(batch, (W, H), K=Ks_in)
            for j, (i, _, _) in enumerate(items):
                imgs[i] = batch_t[j : j + 1]
                Kj = Ks_t[j]
                Kj[0] /= W
                Kj[1] /= H
                camera_cond["K"][i] = Kj
        if profiling.enabled():
            profiling.count("engine.frames_transformed", len(imgs))
            profiling.count("engine.frames_blank", sum(
                img is None or (isinstance(img, np.ndarray) and not img.any()) for img in image_cond["img"]))
        out = np.concatenate(imgs, 0)
        return out, out.copy(), img_size

    def _prepare_prior_Ks(self, traj_prior_Ks, img_size):
        """Anchor Ks as the JAX engine derives them from a blank image of the
        scene's size (load, then transform), computed without the image."""
        opts, W, H = self.options, self.version.W, self.version.H
        h, w = img_size
        out = []
        for prior_k in traj_prior_Ks:
            K = np.asarray(prior_k, np.float64).copy()
            cxcy = K[:2, -1]
            if np.all(cxcy >= 0) and np.all(cxcy <= 1):  # normalised: to pixels
                K[:2] *= np.array([w, h], np.float64)[:, None]
            K = transform_K(
                (h, w), (W, H), K[None],
                mode=opts.get("transform_target", "crop"),
                scale=opts.get("transform_scale", 1.0),
            )[0]
            K[0] /= W
            K[1] /= H
            out.append(K)
        return np.stack(out)

    @_torn_down
    def run_one_scene(
        self,
        task: str,
        image_cond: dict,
        camera_cond: dict,
        save_path: str | None = None,
        use_traj_prior: bool = False,
        traj_prior_Ks: np.ndarray | None = None,
        traj_prior_c2ws: np.ndarray | None = None,
        seed: int = 23,
        abort_event=None,
        first_pass_pbar: Callable | None = None,
        second_pass_pbar: Callable | None = None,
        timer: profiling.StageTimer | None = None,
        cleanup: list | None = None,
    ) -> Iterator[str | np.ndarray]:
        """Render a scene. With `use_traj_prior`, two passes: anchors first,
        then every target conditioned on inputs and anchors. Without it (the
        default, as in JAX), one pass renders the targets chunk by chunk,
        conditioned on the inputs and the targets generated so far. Yields
        after a saved first pass and at the end: file paths with a
        `save_path`, else the uint8 frames (anchors, then all targets in
        order). The render's stages are spans (utils/profiling.span) under
        the JAX engine's stage names (`STAGES`); with a `timer`
        (utils/profiling.StageTimer) they are recorded, and the timer gets
        their host seconds when the render ends, however it ends. No stage
        synchronizes the device. `cleanup` is `_torn_down`'s list, filled
        here with the teardown of the worker threads the render starts."""
        options, version, bundle = self.options, self.version, self.bundle
        if timer is not None:
            # registered first, so it closes last: after the flush worker's stop
            cleanup.append(profiling.recording(
                lambda rec: timer.add(s for s in rec.spans if s.name in STAGES)).close)
        # PNGs on writer threads while the render goes on (engine/saving.py)
        stream_save = (save_path is not None and options.get("stream_save", True)
                       and not options.get("replace_or_include_input", False))
        fp_writer = sp_writer = None
        T = version.T
        F = version.f
        noise = partial(self.noise_fn, seed)
        bundle.vae.clear_cache()
        bundle.clip.clear_cache()

        camera_cond = dict(camera_cond)
        camera_cond["K"] = [np.asarray(k) for k in camera_cond["K"]]
        with profiling.span("prepare_images"):
            imgs, imgs_clip, img_size = self._prepare_images(image_cond, camera_cond)
        # the scene's frames and cameras split into inputs and targets: not a
        # stage of the JAX engine, but host work of a request
        with profiling.span("engine.split_frames"):
            camera_cond["K"] = np.stack(camera_cond["K"]).astype(np.float32)
            all_c2ws = np.asarray(camera_cond["c2w"], np.float32)
            if traj_prior_Ks is not None:
                traj_prior_Ks = self._prepare_prior_Ks(traj_prior_Ks, img_size)

            input_indices = list(image_cond["input_indices"])
            input_imgs, input_imgs_clip = imgs[input_indices], imgs_clip[input_indices]
            input_c2ws, input_Ks = all_c2ws[input_indices], camera_cond["K"][input_indices]
            test_indices = [i for i in range(len(imgs)) if i not in input_indices]
            test_imgs, test_imgs_clip = imgs[test_indices], imgs_clip[test_indices]
            test_c2ws, test_Ks = all_c2ws[test_indices], camera_cond["K"][test_indices]

        if save_path is not None and options.get("save_input", True):
            save_output({"/image": input_imgs}, save_path=osp.join(save_path, "input"), video_save_fps=2)

        guiders = _resolve_guiders(options.get("guider_types", 1))
        num_steps = options.get("num_steps", 50)
        cfg_min = options.get("cfg_min", 1.0)
        cfg_opt = options.get("cfg", 2.0)
        camera_scale = options.get("camera_scale", 2.0)
        enc_t = options.get("encoding_t", 1)
        dec_t = options.get("decoding_t", 1)

        def chunk_values_for(curr_imgs, curr_imgs_clip, frame_inds, curr_c2ws, curr_Ks, cam_inds):
            return build_chunk_values(
                curr_imgs, curr_imgs_clip, frame_inds, curr_c2ws, curr_Ks, cam_inds,
                all_c2ws=all_c2ws, camera_scale=camera_scale,
                latent_hw=(version.H // F, version.W // F),
            )

        if not use_traj_prior:
            # ---------------- one pass: all targets ----------------
            strategy = options.get("chunk_strategy", "gt")
            T_run = T[0] if isinstance(T, (list, tuple)) else T
            plan = planner.chunk_input_and_test(
                T_run, input_c2ws, test_c2ws, input_indices, test_indices,
                options=options, task=task, chunk_strategy=strategy,
                gt_input_inds=list(range(input_c2ws.shape[0])),
            )
            print(
                f"One pass - chunking with `{strategy}` strategy: total "
                f"{len(plan.input_inds_per_chunk)} forward(s) ..."
            )
            all_samples = {}
            all_test_inds = []
            for i, (c_in_inds, c_in_sels, c_test_inds, c_test_sels) in enumerate(
                zip(plan.input_inds_per_chunk, plan.input_sels_per_chunk,
                    plan.test_inds_per_chunk, plan.test_sels_per_chunk)
            ):
                curr_input_sels, curr_test_sels, curr_input_maps, curr_test_maps = planner.pad_indices(
                    c_in_sels, c_test_sels, T=T_run,
                    padding_mode=options.get("t_padding_mode", "last"),
                )
                gen = get_k_from_dict(all_samples, "samples-rgb")
                pool_imgs = np.concatenate([input_imgs, gen.reshape((-1,) + input_imgs.shape[1:])], 0)
                pool_clip = np.concatenate([input_imgs_clip, gen.reshape((-1,) + input_imgs.shape[1:])], 0)
                curr_imgs, curr_imgs_clip, curr_c2ws, curr_Ks = [
                    planner.assemble(input=x[c_in_inds], test=y[c_test_inds],
                                     input_maps=curr_input_maps, test_maps=curr_test_maps)
                    for x, y in zip(
                        [pool_imgs, pool_clip, np.concatenate([input_c2ws, test_c2ws[all_test_inds]], 0),
                         np.concatenate([input_Ks, test_Ks[all_test_inds]], 0)],
                        [test_imgs, test_imgs_clip, test_c2ws, test_Ks],
                    )
                ]
                # a test slot whose frame is one of the inputs is conditioned on too
                extra_sels = [
                    sel
                    for ind, sel in zip(
                        np.array(c_test_inds)[curr_test_maps[curr_test_maps != -1]], curr_test_sels
                    )
                    if test_indices[ind] in image_cond["input_indices"]
                ]
                values = chunk_values_for(
                    curr_imgs, curr_imgs_clip, curr_input_sels + extra_sels, curr_c2ws, curr_Ks,
                    curr_input_sels + extra_sels,
                )
                samples = sample_chunk(
                    bundle, values, num_steps=num_steps, cfg=_cfg_at(cfg_opt, 0),
                    guider_type=guiders[0], cfg_min=cfg_min, noise_fn=noise, pass_id=0,
                    chunk_id=i, encoding_t=enc_t, decoding_t=dec_t, latent_downsample=F,
                    abort_event=abort_event,
                )
                if samples is None:
                    return
                samples = decode_output(samples, len(curr_imgs), c_test_sels)
                if save_path is not None and options.get("save_first_pass", False):
                    save_output(
                        replace_or_include_input_for_dict(samples, c_test_sels, curr_imgs, curr_c2ws, curr_Ks),
                        save_path=osp.join(save_path, "first-pass", f"forward_{i}"),
                        video_save_fps=2,
                    )
                extend_dict(all_samples, samples)
                all_test_inds.extend(c_test_inds)
        else:
            assert traj_prior_c2ws is not None, "`traj_prior_c2ws` must be set for 2-pass sampling."
            traj_prior_c2ws = np.asarray(traj_prior_c2ws, np.float32)
            if traj_prior_Ks is None:
                traj_prior_Ks = np.repeat(test_Ks[:1], traj_prior_c2ws.shape[0], 0)
            traj_prior_imgs = np.zeros((traj_prior_c2ws.shape[0],) + imgs.shape[1:], np.float32)
            traj_prior_imgs_clip = traj_prior_imgs.copy()
            T_first, T_second = (T[0], T[1]) if isinstance(T, (list, tuple)) else (T, T)

            # ---------------- first pass: generate anchors ----------------
            strategy1 = options.get("chunk_strategy_first_pass", "gt-nearest")
            plan1 = planner.chunk_input_and_test(
                T_first, input_c2ws, traj_prior_c2ws, input_indices, image_cond["prior_indices"],
                options=options, task=task, chunk_strategy=strategy1,
                gt_input_inds=list(range(input_c2ws.shape[0])),
            )
            print(
                f"Two passes (first) - chunking with `{strategy1}` strategy: total "
                f"{len(plan1.input_inds_per_chunk)} forward(s) ..."
            )
            all_samples: dict = {}
            all_prior_inds: list[int] = []
            for i, (c_in_inds, c_in_sels, c_pri_inds, c_pri_sels) in enumerate(
                zip(plan1.input_inds_per_chunk, plan1.input_sels_per_chunk,
                    plan1.test_inds_per_chunk, plan1.test_sels_per_chunk)
            ):
                with profiling.span("first_pass_build"):
                    curr_input_sels, _, curr_input_maps, curr_prior_maps = planner.pad_indices(
                        c_in_sels, c_pri_sels, T=T_first,
                        padding_mode=options.get("t_padding_mode", "last"),
                    )
                    gen = get_k_from_dict(all_samples, "samples-rgb")
                    pool_imgs = np.concatenate([input_imgs, gen.reshape((-1,) + input_imgs.shape[1:])], 0)
                    pool_clip = np.concatenate([input_imgs_clip, gen.reshape((-1,) + input_imgs.shape[1:])], 0)
                    pool_c2ws = np.concatenate([input_c2ws, traj_prior_c2ws[all_prior_inds]], 0)
                    pool_Ks = np.concatenate([input_Ks, traj_prior_Ks[all_prior_inds]], 0)
                    curr_imgs, curr_imgs_clip, curr_c2ws, curr_Ks = [
                        planner.assemble(input=x[c_in_inds], test=y[c_pri_inds],
                                         input_maps=curr_input_maps, test_maps=curr_prior_maps)
                        for x, y in zip(
                            [pool_imgs, pool_clip, pool_c2ws, pool_Ks],
                            [traj_prior_imgs, traj_prior_imgs_clip, traj_prior_c2ws, traj_prior_Ks],
                        )
                    ]
                    values = chunk_values_for(
                        curr_imgs, curr_imgs_clip, curr_input_sels, curr_c2ws, curr_Ks, list(range(T_first))
                    )
                use_second_sampler = (
                    len(guiders) > 1 and options.get("ltr_first_pass", False)
                    and strategy1 != "gt" and i > 0
                )
                with profiling.span("first_pass_sample"):
                    samples = sample_chunk(
                        bundle, values, num_steps=num_steps, cfg=_cfg_at(cfg_opt, 0),
                        guider_type=guiders[1] if use_second_sampler else guiders[0],
                        cfg_min=cfg_min, noise_fn=noise, pass_id=1, chunk_id=i,
                        encoding_t=enc_t, decoding_t=dec_t, latent_downsample=F,
                        abort_event=abort_event, progress_cb=first_pass_pbar,
                    )
                if samples is None:
                    return
                with profiling.span("first_pass_decode_extend"):
                    extend_dict(all_samples, decode_output(samples, T_first, c_pri_sels))
                all_prior_inds.extend(c_pri_inds)

            if options.get("save_first_pass", True):
                with profiling.span("first_pass_save"):
                    if save_path is None:
                        first_pass = to_uint8(get_k_from_dict(all_samples, "samples-rgb"))
                    else:
                        if stream_save:
                            fp_writer = StreamingFrameWriter(osp.join(save_path, "first-pass", "samples-rgb"))
                            cleanup.append(fp_writer.drain)
                            fp_frames = get_k_from_dict(all_samples, "samples-rgb")
                            fp_writer.submit(range(len(fp_frames)), fp_frames)
                        save_output(all_samples, save_path=osp.join(save_path, "first-pass"), video_save_fps=5,
                                    skip_png_keys=("samples-rgb",) if stream_save else ())
                        first_pass = osp.join(save_path, "first-pass", "samples-rgb.mp4")
                yield first_pass

            # ------------- second pass: interpolate all targets -------------
            prior_indices = image_cond["prior_indices"]
            assert prior_indices is not None
            prior_argsort = np.argsort(list(input_indices) + list(prior_indices), kind="stable").tolist()
            prior_indices = np.array(list(input_indices) + list(prior_indices))[prior_argsort].tolist()
            gt_input_inds = [prior_argsort.index(i) for i in range(input_c2ws.shape[0])]

            gen = get_k_from_dict(all_samples, "samples-rgb")
            traj_prior_imgs = np.concatenate([input_imgs, gen], axis=0)[prior_argsort]
            traj_prior_imgs_clip = np.concatenate([input_imgs_clip, gen], axis=0)[prior_argsort]
            traj_prior_c2ws = np.concatenate([input_c2ws, traj_prior_c2ws], axis=0)[prior_argsort]
            traj_prior_Ks = np.concatenate([input_Ks, traj_prior_Ks], axis=0)[prior_argsort]
            update_kv_for_dict(all_samples, "samples-rgb", traj_prior_imgs)
            update_kv_for_dict(all_samples, "samples-c2ws", traj_prior_c2ws)
            update_kv_for_dict(all_samples, "samples-intrinsics", traj_prior_Ks)

            strategy2 = options.get("chunk_strategy", "nearest")
            keep, delivered = list(range(len(test_indices))), []
            if options.get("deliver_anchors", False) and strategy2.startswith("interp"):
                # a target whose pose and K equal an anchor's is delivered from
                # the first pass instead of being denoised again
                prior_rows = {
                    int(round(p)): j for j, p in enumerate(prior_indices) if abs(p - round(p)) < 1e-9
                }
                keep = []
                for j, t in enumerate(test_indices):
                    r = prior_rows.get(t)
                    if (
                        r is not None
                        and np.allclose(traj_prior_c2ws[r], test_c2ws[j], atol=1e-5)
                        and np.allclose(traj_prior_Ks[r], test_Ks[j], atol=1e-5)
                    ):
                        delivered.append((j, r))
                    else:
                        keep.append(j)
            test_indices2 = [test_indices[j] for j in keep]
            test_imgs2, test_imgs_clip2 = test_imgs[keep], test_imgs_clip[keep]
            test_c2ws2, test_Ks2 = test_c2ws[keep], test_Ks[keep]
            with profiling.span("second_pass_plan"):
                plan2 = planner.chunk_input_and_test(
                    T_second, traj_prior_c2ws, test_c2ws2, prior_indices, test_indices2,
                    options=options, task=task, chunk_strategy=strategy2,
                    gt_input_inds=gt_input_inds,
                )
            print(
                f"Two passes (second) - chunking with `{strategy2}` strategy: total "
                f"{len(plan2.input_inds_per_chunk)} forward(s) ..."
            )
            guider2 = guiders[1] if len(guiders) > 1 else guiders[0]
            cfg2 = _cfg_at(cfg_opt, 1)
            all_samples = {}
            all_test_inds: list[int] = []
            # every chunk's work first: second-pass chunks depend only on the
            # fixed anchors, so they can run one by one or in groups
            work = []
            with profiling.span("second_pass_build"):
                for i, (c_pri_inds, c_pri_sels, c_test_inds, c_test_sels) in enumerate(
                    zip(plan2.input_inds_per_chunk, plan2.input_sels_per_chunk,
                        plan2.test_inds_per_chunk, plan2.test_sels_per_chunk)
                ):
                    curr_prior_sels, _, curr_prior_maps, curr_test_maps = planner.pad_indices(
                        c_pri_sels, c_test_sels, T=T_second, padding_mode="last"
                    )
                    curr = [
                        planner.assemble(input=x[c_pri_inds], test=y[c_test_inds],
                                         input_maps=curr_prior_maps, test_maps=curr_test_maps)
                        for x, y in zip(
                            [traj_prior_imgs, traj_prior_imgs_clip, traj_prior_c2ws, traj_prior_Ks],
                            [test_imgs2, test_imgs_clip2, test_c2ws2, test_Ks2],
                        )
                    ]
                    values = chunk_values_for(
                        curr[0], curr[1], curr_prior_sels, curr[2], curr[3], list(range(T_second))
                    )
                    work.append((i, c_test_sels, c_test_inds, curr, values))

            if stream_save:
                sp_writer = StreamingFrameWriter(osp.join(save_path, "samples-rgb"))
                cleanup.append(sp_writer.drain)
            # every chunk's flush on one worker thread, in submission order
            flush_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="svc-flush")
            flush_futs: list[concurrent.futures.Future] = []

            def stop_flushes():
                # registered after the writer's drain, so it runs first: the
                # flushes submit to the writer
                flush_pool.shutdown(wait=True, cancel_futures=True)
                for f in flush_futs:
                    if f.done() and not f.cancelled() and f.exception() is not None:
                        raise f.exception()

            cleanup.append(stop_flushes)
            def flush(fetch, i, c_test_sels, c_test_inds, curr):
                with profiling.span("second_pass_flush"):
                    curr_imgs, _, curr_c2ws, curr_Ks = curr
                    samples = decode_output(fetch(), T_second, c_test_sels)
                    if save_path is not None and options.get("save_second_pass", False):
                        save_output(
                            replace_or_include_input_for_dict(samples, c_test_sels, curr_imgs, curr_c2ws, curr_Ks),
                            save_path=osp.join(save_path, "second-pass", f"forward_{i}"),
                            video_save_fps=2,
                        )
                    extend_dict(all_samples, samples)
                    # a chunk's final frame indices are known here, so its
                    # PNGs encode while the next chunk samples
                    final_inds = [keep[k] for k in c_test_inds]
                    all_test_inds.extend(final_inds)
                    if sp_writer is not None:
                        sp_writer.submit(final_inds, samples["samples-rgb/image"])

            def submit_flush(frames, *item):
                flush_futs.append(flush_pool.submit(profiling.carry(flush), _host_copy_later(frames), *item))

            # without per-step progress, independent chunks run in groups:
            # the mesh's data rows take one each (sample_many), or without a
            # data axis `chunk_batch` of them batch on one device; a last
            # partial group is padded with its last chunk, whose repeats are
            # dropped. Each chunk keeps its own noise, as in the serial loop
            mesh = getattr(bundle, "mesh", None)
            n_data = mesh.shape["data"] if mesh is not None else 1
            chunk_batch = int(options.get("chunk_batch", 0) or 0)
            width = 0
            if len(work) > 1 and second_pass_pbar is None:
                width = n_data if n_data > 1 else chunk_batch if chunk_batch > 1 else 0
            n_grouped = len(work) if width else 0
            dev = bundle.device
            for g in range(0, n_grouped, max(width, 1)):
                if abort_event is not None and abort_event.is_set():
                    return
                group = work[g : g + width]
                padded = group + [group[-1]] * (width - len(group))
                with profiling.span("second_pass_conditioning"):
                    conds, shape = [], None
                    for item in padded:
                        cond, shape = build_chunk_conditioning(
                            bundle, item[4], cfg=cfg2, guider_type=guider2, cfg_min=cfg_min,
                            encoding_t=enc_t, latent_downsample=F,
                        )
                        conds.append(cond)
                    ensure_quant_calibrated(bundle, shape, bundle.plan(num_steps), conds[0])
                    draws = [
                        lambda step, _i=item[0]: noise(2, _i, step, shape, dev).to(dev, torch.float32)
                        for item in padded
                    ]
                with profiling.span("second_pass_sample_many"):
                    xs = sample_many(bundle, [d(None) for d in draws], bundle.plan(num_steps), conds, draws)
                for item, x in zip(group, xs):
                    submit_flush(bundle.vae.decode(x, dec_t, uint8=True, host=False), *item[:4])
            # the rest run one by one behind a window of prebuilt
            # conditioning (see the module docstring): the encodes first, in
            # chunk order, then `prefetch` builds, then one build after each
            # dispatch; a slot is dropped once its chunk is dispatched
            serial = work[n_grouped:]
            prefetch = max(1, int(options.get("prefetch_chunks", 3) or 1))
            def build(values):
                return build_chunk_conditioning(
                    bundle, values, cfg=cfg2, guider_type=guider2, cfg_min=cfg_min,
                    encoding_t=enc_t, latent_downsample=F,
                )

            with profiling.span("second_pass_conditioning"):
                for item in serial:
                    prime_chunk_conditioning(bundle, item[4], enc_t)
                staged = [build(item[4]) for item in serial[:prefetch]]
            for pos, (i, c_test_sels, c_test_inds, curr, values) in enumerate(serial):
                prebuilt, staged[pos] = staged[pos], None
                with profiling.span("second_pass_sample"):
                    samples = sample_chunk(
                        bundle, values, num_steps=num_steps, cfg=cfg2, guider_type=guider2,
                        cfg_min=cfg_min, noise_fn=noise, pass_id=2, chunk_id=i,
                        encoding_t=enc_t, decoding_t=dec_t, latent_downsample=F,
                        abort_event=abort_event, progress_cb=second_pass_pbar, output_uint8=True,
                        defer=True, prebuilt=prebuilt,
                    )
                del prebuilt
                if samples is None:
                    return
                submit_flush(samples, i, c_test_sels, c_test_inds, curr)
                if pos + prefetch < len(serial):
                    with profiling.span("second_pass_conditioning"):
                        staged.append(build(serial[pos + prefetch][4]))
            with profiling.span("second_pass_flush_join"):
                for f in flush_futs:
                    f.result()  # in order; re-raises a flush's error
                flush_pool.shutdown(wait=True)
            if delivered:
                rows = [r for _, r in delivered]
                spliced = to_uint8(traj_prior_imgs[rows])
                extend_dict(all_samples, {"samples-rgb/image": spliced})
                all_test_inds.extend(j for j, _ in delivered)
                if sp_writer is not None:
                    sp_writer.submit([j for j, _ in delivered], spliced)
            order = np.argsort(all_test_inds, kind="stable")
            all_samples = {key: value[order] for key, value in all_samples.items()}

        with profiling.span("final_save"):
            if options.get("replace_or_include_input", False):
                all_samples = replace_or_include_input_for_dict(
                    all_samples, test_indices, imgs.copy(),
                    np.asarray(camera_cond["c2w"]).copy(), camera_cond["K"].copy(),
                )
            if save_path is None:
                final = to_uint8(all_samples["samples-rgb/image"])
            else:
                skip_pngs = ()
                if sp_writer is not None:
                    sp_writer.drain()
                    if fp_writer is not None:
                        fp_writer.drain()
                    skip_pngs = ("samples-rgb",)
                save_output(all_samples, save_path=save_path, video_save_fps=options.get("video_save_fps", 2),
                            skip_png_keys=skip_pngs)
                final = osp.join(save_path, "samples-rgb.mp4")
        yield final
