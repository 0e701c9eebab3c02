"""Model bundles: the released checkpoints, the converted cache, or random
weights at any spec.

Counterpart of stable_virtual_camera_tpu/models/io.py.
  * `read_safetensors` / `write_safetensors`: the safetensors format, read
    and written here (the card's machine has no `safetensors` package).
  * `load_seva_state`, `load_vae_state`, `load_clip_state`,
    `load_dust3r_state`: a released checkpoint as the port's state dict
    (models/convert.py, models/convert_dust3r.py).
  * `save_converted` / `load_converted`: the converted cache, one
    safetensors file a model in the port's names plus `specs.json`, written
    by apps/convert_weights.py and by the train CLI's `--save_merged`.
  * `load_bundle`: a ModelBundle from a directory holding either layout.
  * `random_bundle`: flax's default initialisers as the JAX package uses
    them: lecun-normal (truncated) kernels, zero biases, unit norm scales,
    and normal(0.02) CLIP class/positional embeddings and projection.
"""

from __future__ import annotations

import dataclasses
import json
import math
import mmap
import os
import pickle
import struct
from collections.abc import Mapping

import torch
from torch import nn

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models import convert
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec, ClipVisionTower
from stable_virtual_camera_tpu_torch.models.unet import Affine, SevaUNet
from stable_virtual_camera_tpu_torch.models.vae import AutoEncoderKL
from stable_virtual_camera_tpu_torch.ops.quant import serving_mode

# flax's lecun_normal draws from a normal truncated at +-2 std and rescales
# by this constant so the truncated distribution keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std^2) truncated to +-2 std, by the inverse CDF (one uniform draw
    per element)."""
    cdf = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Phi(-2)
    w.uniform_(2.0 * cdf - 1.0, 1.0 - 2.0 * cdf, generator=generator)
    w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def init_flax_defaults(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise `module` in place as flax's default initialisers would."""
    for sub in module.modules():
        if isinstance(sub, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = sub.weight
            _trunc_normal_(w, math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD, generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, Affine):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        if isinstance(sub, ClipVisionTower):
            for p in (sub.class_embedding, sub.positional_embedding, sub.proj):
                p.normal_(0.0, 0.02, generator=generator)
    return module


def _finish(module: nn.Module, dtype: torch.dtype, device) -> nn.Module:
    # channels_last conv weights let the NHWC activations convolve in place
    return module.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()


def attention_backend(attention: str | None, dtype: torch.dtype, device) -> str:
    """The UNet's self-attention backend (models/unet.py) for a model in
    `dtype` on `device`: `attention`, or "upstream" where None. The kernels
    take bf16 and fp32 on the card (as JAX's Pallas kernels do), so every
    model there runs the kernel routes unless "plain" is asked for."""
    return "upstream" if attention is None else attention


def _modules(spec: SevaSpec, clip_spec: ClipVisionSpec, device, attention: str):
    if clip_spec.embed_dim != spec.context_dim:
        raise ValueError("CLIP embed_dim must equal the UNet context_dim")
    with torch.device(device):
        unet, vae, clip = SevaUNet(spec, attention), AutoEncoderKL(), ClipVisionTower(clip_spec)
    return [_finish(m, torch.float32, device) for m in (unet, vae, clip)]


def build_models(spec: SevaSpec, clip_spec: ClipVisionSpec, device, dtype,
                 attention: str | None = None):
    """Uninitialised (unet, vae, clip) on `device` in `dtype`; `attention` is
    the UNet's self-attention backend (`attention_backend`)."""
    models = _modules(spec, clip_spec, device, attention_backend(attention, dtype, device))
    return tuple(_finish(m, dtype, device) for m in models)


def _bundle(spec, unet, vae, clip, mesh=None):
    from stable_virtual_camera_tpu_torch.engine.runner import (
        ClipApplier,
        ModelBundle,
        VaeApplier,
    )

    bundle = ModelBundle(spec=spec, unet=unet, vae=VaeApplier(vae), clip=ClipApplier(clip), mesh=mesh)
    bundle.replicate()
    return bundle


def random_bundle(
    spec: SevaSpec | None = None,
    clip_spec: ClipVisionSpec | None = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    generator: torch.Generator | None = None,
    attention: str | None = None,
    quant=None,
    mesh=None,
):
    """A ModelBundle with flax-default random weights (tests, smoke runs),
    on the card unless `device` says otherwise. Weights are drawn in fp32 on
    `device` from `generator` (seed 0 on that device when omitted), then
    cast to `dtype`. `attention` is the UNet's self-attention backend
    (`attention_backend`) and `quant` its W8A8 mode (`load_bundle`); the
    weights depend on neither. `mesh` (parallel/mesh.py) shards the
    bundle's sampling (engine/runner.py); ranks on `device` share its UNet,
    a rank on another device gets a replica."""
    spec = spec or SevaSpec.tiny()
    clip_spec = clip_spec or ClipVisionSpec.tiny()
    mode = serving_mode(quant)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    models = _modules(spec, clip_spec, device, attention_backend(attention, dtype, device))
    models = [_finish(init_flax_defaults(m, generator), dtype, device) for m in models]
    models[0].set_quant(mode)
    return _bundle(spec, *models, mesh=mesh)


# ---------------------------------------------------------------------------
# The safetensors format: an 8-byte little-endian header length, a JSON
# header {name: {"dtype", "shape", "data_offsets": [begin, end]}} with an
# optional "__metadata__" of strings, then the tensors' bytes (offsets count
# from the end of the header)
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _st_entries(header, data_len: int, path) -> list[tuple[str, torch.dtype, list[int], int, int]]:
    """The header's tensors as (name, dtype, shape, begin, end), in file
    order; raises ValueError for a malformed, overlapping or truncated one."""
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is not a JSON object")
    entries = []
    for name, e in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = _ST_DTYPES[e["dtype"]]
            shape = [int(d) for d in e["shape"]]
            begin, end = (int(o) for o in e["data_offsets"])
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"{path}: bad header entry for {name!r}: {e!r}") from err
        nbytes = math.prod(shape) * dtype.itemsize
        if min(shape, default=0) < 0 or begin < 0 or end - begin != nbytes:
            raise ValueError(f"{path}: {name!r} has offsets [{begin}, {end}] for {nbytes} bytes "
                             f"of {e['dtype']} {shape}")
        if end > data_len:
            raise ValueError(f"{path}: {name!r} ends at byte {end} of a {data_len}-byte data "
                             "section: the file is truncated or its header is wrong")
        entries.append((name, dtype, shape, begin, end))
    entries.sort(key=lambda x: (x[3], x[4]))
    for (a, _, _, _, a_end), (b, _, _, b_begin, _) in zip(entries, entries[1:]):
        if b_begin < a_end:
            raise ValueError(f"{path}: the bytes of {a!r} and {b!r} overlap")
    return entries


def read_safetensors(path, dtype: torch.dtype | None = None, device="cpu") -> dict[str, torch.Tensor]:
    """A safetensors file as {name: tensor}. Each tensor is read from a
    memory map, cast to `dtype` (floating-point tensors only; None keeps the
    file's) and moved to `device` before the next is read, so a checkpoint
    never sits twice in host memory. Every returned tensor owns its memory.
    Raises ValueError for a header that is malformed, runs past the file, or
    gives two tensors overlapping bytes."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors file")
        (n,) = struct.unpack("<Q", f.read(8))
        if n > size - 8:
            raise ValueError(f"{path}: the header claims {n} bytes, past the end of a "
                             f"{size}-byte file")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as err:
            raise ValueError(f"{path}: the safetensors header is not JSON") from err
        entries = _st_entries(header, size - 8 - n, path)
        out = {}
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as mm:
            for name, st_dtype, shape, begin, end in entries:
                target = dtype if dtype is not None and st_dtype.is_floating_point else st_dtype
                if begin == end:
                    out[name] = torch.empty(shape, dtype=target, device=device)
                    continue
                raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin, offset=8 + n + begin)
                if (8 + n + begin) % st_dtype.itemsize:
                    raw = raw.clone()  # an aligned copy before viewing as wider elements
                t = raw.view(st_dtype).reshape(shape).to(device=device, dtype=target)
                # the map is closed on return: nothing returned may point into it
                out[name] = t.clone() if t.data_ptr() == raw.data_ptr() else t
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path,
                      metadata: Mapping[str, str] | None = None) -> None:
    """Write `tensors` (any device; moved to the host one at a time) as a
    safetensors file, the header padded with spaces to 8 bytes. The file is
    written beside `path` and renamed over it once complete."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.partial"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)


def read_state_file(path, dtype: torch.dtype | None = None, device="cpu") -> dict[str, torch.Tensor]:
    """A checkpoint file as {name: tensor}: `.safetensors` through
    `read_safetensors`, anything else through `torch.load` (a `.bin` or
    `.pth` state dict, unwrapped from a "state_dict" or "model" entry),
    floating-point tensors cast to `dtype` and each moved to `device`."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(path, dtype, device)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except pickle.UnpicklingError:
        # the released DUSt3R .pth keeps an argparse.Namespace under
        # ckpt["args"], which weights_only refuses
        sd = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
    out = {}
    for k, v in sd.items():
        target = dtype if dtype is not None and v.is_floating_point() else v.dtype
        out[k] = v.to(device=device, dtype=target)
    return out


# ---------------------------------------------------------------------------
# Released checkpoints -> the port's state dicts
# ---------------------------------------------------------------------------


def load_seva_state(path, spec: SevaSpec | None = None, dtype: torch.dtype = torch.bfloat16,
                    device="cuda") -> dict[str, torch.Tensor]:
    """The released UNet (`model.safetensors`, torch names) as the port's
    `SevaUNet` state dict in `dtype` on `device` (bf16 by default, as the
    reference loads it, seva/utils.py:50-51)."""
    return convert.convert_seva_state_dict(read_state_file(path, dtype, device), spec or SevaSpec())


def load_vae_state(path, dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict[str, torch.Tensor]:
    """The diffusers AutoencoderKL checkpoint as the port's state dict; the
    `first_stage_model.` or `vae.` wrapper prefix is stripped if present."""
    sd = read_state_file(path, dtype, device)
    for prefix in ("first_stage_model.", "vae."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return convert.convert_vae_state_dict(sd)


def load_clip_state(path, spec: ClipVisionSpec | None = None, dtype: torch.dtype = torch.bfloat16,
                    device="cuda") -> dict[str, torch.Tensor]:
    """The CLIP image tower, in HF names when `vision_model.` keys are
    present and in open_clip names otherwise, as the port's state dict."""
    sd = read_state_file(path, dtype, device)
    spec = spec or ClipVisionSpec()
    if any(k.startswith("vision_model.") for k in sd):
        return convert.convert_clip_hf(sd, spec)
    return convert.convert_clip_open_clip(sd, spec)


def load_dust3r_state(weight_path, spec=None) -> dict[str, torch.Tensor]:
    """The released DUSt3R checkpoint (`naver/DUSt3R_ViTLarge_BaseDecoder_512_dpt`,
    a torch `.pth`, or the same keys in a `.safetensors` file) as the port's
    `AsymmetricCroCoStereo` state dict, fp32 on the CPU."""
    from stable_virtual_camera_tpu_torch.models.convert_dust3r import convert_dust3r_state_dict

    return convert_dust3r_state_dict(read_state_file(weight_path), spec)


def check_shapes(state: Mapping[str, torch.Tensor], module: nn.Module, what: str) -> int:
    """Raise unless `state` names every parameter of `module` and nothing
    else, each with the module's shape; returns the parameter count."""
    params = dict(module.named_parameters())
    missing, extra = sorted(params.keys() - state.keys()), sorted(state.keys() - params.keys())
    if missing or extra:
        raise KeyError(f"{what}: missing {missing[:5]}, unexpected {extra[:5]}")
    for name, p in params.items():
        if tuple(state[name].shape) != tuple(p.shape):
            raise ValueError(f"{what}: {name} has shape {tuple(state[name].shape)}, "
                             f"the model's is {tuple(p.shape)}")
    return sum(p.numel() for p in params.values())


def _loaded(build, state: Mapping[str, torch.Tensor], what: str, dtype, device) -> nn.Module:
    """`build()` on the meta device, given `state`'s tensors as its
    parameters (no random init is drawn), then cast and laid out."""
    with torch.device("meta"):
        module = build()
    check_shapes(state, module, what)
    module.load_state_dict(state, strict=True, assign=True)
    return _finish(module, dtype, device)


# ---------------------------------------------------------------------------
# The converted cache: converted_<model>.safetensors in the port's names and
# specs.json (the JAX package writes orbax here, a JAX-only format)
# ---------------------------------------------------------------------------

CACHE_MODELS = ("unet", "vae", "clip", "dust3r")


def cache_file(checkpoint_dir, model: str) -> str:
    if model not in CACHE_MODELS:
        raise KeyError(f"the converted cache holds {CACHE_MODELS}, not {model!r}")
    return os.path.join(checkpoint_dir, f"converted_{model}.safetensors")


def save_converted(states: Mapping[str, Mapping[str, torch.Tensor]], out_dir,
                   specs: Mapping | None = None) -> None:
    """Write converted state dicts ({"unet": ..., "vae": ..., "clip": ...,
    "dust3r": ...}) into `out_dir`, one file each, with `specs`
    ({"seva": SevaSpec, "clip": ClipVisionSpec}) in `specs.json` so that
    `load_bundle` builds the matching architectures. Models and specs
    already in the directory stay unless given anew."""
    os.makedirs(out_dir, exist_ok=True)
    for model, state in states.items():
        write_safetensors(state, cache_file(out_dir, model))
    stored = load_checkpoint_specs(out_dir)
    stored.update({k: dataclasses.asdict(v) for k, v in (specs or {}).items() if v is not None})
    if stored:
        with open(os.path.join(out_dir, "specs.json"), "w") as f:
            json.dump(stored, f, indent=1)


def load_converted(checkpoint_dir, model: str, dtype: torch.dtype | None = None,
                   device="cuda") -> dict[str, torch.Tensor]:
    """One model's state dict from the converted cache."""
    return read_safetensors(cache_file(checkpoint_dir, model), dtype, device)


def load_checkpoint_specs(checkpoint_dir) -> dict:
    """The `specs.json` manifest of a checkpoint directory ({} if absent)."""
    path = os.path.join(checkpoint_dir, "specs.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _spec_from_dict(cls, d: dict):
    """A spec dataclass from its JSON dict: lists back to tuples, unknown
    keys dropped."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})


def load_bundle(
    checkpoint_dir,
    spec: SevaSpec | None = None,
    clip_spec: ClipVisionSpec | None = None,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    attention: str | None = None,
    quant=None,
    mesh=None,
):
    """A ModelBundle from `checkpoint_dir`, which holds either the converted
    cache (`converted_{unet,vae,clip}.safetensors`) or the released files
    (`model.safetensors`, `vae.safetensors`, `clip.safetensors`). The specs
    come from the arguments, else from `specs.json`, else the released
    model's. Weights are cast to `dtype` (bf16, as the reference loads
    them) on `device`; `attention` is the UNet's self-attention backend
    (`attention_backend`). `quant` is the UNet's W8A8 serving mode
    (ops/quant.py): None or "0" exact, "w8a8" dynamic, "w8a8-static"
    calibrated on the bundle's first chunk (engine/runner.py); anything else
    raises ValueError. `mesh` as for `random_bundle`."""
    mode = serving_mode(quant)
    stored = load_checkpoint_specs(checkpoint_dir)
    if spec is None and "seva" in stored:
        spec = _spec_from_dict(SevaSpec, stored["seva"])
    if clip_spec is None and "clip" in stored:
        clip_spec = _spec_from_dict(ClipVisionSpec, stored["clip"])
    spec, clip_spec = spec or SevaSpec(), clip_spec or ClipVisionSpec()
    if clip_spec.embed_dim != spec.context_dim:
        raise ValueError("CLIP embed_dim must equal the UNet context_dim")
    backend = attention_backend(attention, dtype, device)
    if os.path.exists(cache_file(checkpoint_dir, "unet")):
        unet_sd, vae_sd, clip_sd = (load_converted(checkpoint_dir, m, dtype, device)
                                    for m in ("unet", "vae", "clip"))
    else:
        def path(name):
            return os.path.join(checkpoint_dir, name)

        unet_sd = load_seva_state(path("model.safetensors"), spec, dtype, device)
        vae_sd = load_vae_state(path("vae.safetensors"), dtype, device)
        clip_sd = load_clip_state(path("clip.safetensors"), clip_spec, dtype, device)
    unet = _loaded(lambda: SevaUNet(spec, backend), unet_sd, "UNet", dtype, device).set_quant(mode)
    vae = _loaded(AutoEncoderKL, vae_sd, "VAE", dtype, device)
    clip = _loaded(lambda: ClipVisionTower(clip_spec), clip_sd, "CLIP", dtype, device)
    return _bundle(spec, unet, vae, clip, mesh=mesh)
