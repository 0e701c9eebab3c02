"""Weight loading in the port (models/convert.py, models/io.py,
apps/convert_weights.py and the `--checkpoint_dir` entry points) against the
JAX package's, on the CPU.

The released checkpoints are not in the repository, so the checkpoints here
are synthetic: seeded numpy values over the released key layout and shapes,
which come from the JAX package's own key maps (`seva_key_map`,
`vae_key_map`) over the shapes of its flax trees (`jax.eval_shape` of the
models' `init`), and are written with this image's `safetensors`. The bars:
  * the port's safetensors reader gives bit for bit what
    `safetensors.torch.load_file` gives, for every dtype it takes, and a
    file from the port's writer opens bit for bit in `safe_open`;
  * each port converter equals the JAX converter, bridged
    (`flax_to_state_dict`), exactly; each port inverse fed through the JAX
    converter gives back `to_flax_tree` of the port module exactly;
  * at full width (`SevaSpec()`, the VAE, ViT-H CLIP), on `meta`, the
    released key set and shapes equal those implied by the JAX maps and
    trees, and the converted set fills every parameter of the port module;
  * `load_bundle` on a released-layout directory equals JAX's
    `load_bundle`, bridged, exactly, and one render from each agrees within
    one uint8 step (the bar of tests/test_torch_engine.py).
"""

import functools
import hashlib
import json
import os
import os.path as osp
import struct

import imageio.v3 as iio
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu import config as jax_config
from stable_virtual_camera_tpu.models import convert as jax_convert
from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models import convert
from stable_virtual_camera_tpu_torch.models import io as mio
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec, ClipVisionTower
from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
from stable_virtual_camera_tpu_torch.models.vae import AutoEncoderKL
from stable_virtual_camera_tpu_torch.models.weights import flax_to_state_dict, to_flax_tree
from test_torch_weights import jax_abstract_trees

GOLDEN = osp.join(osp.dirname(__file__), "..", "assets", "golden_scene", "scene0")
TINY, CLIP_TINY = SevaSpec.tiny(), ClipVisionSpec.tiny()


@functools.lru_cache(maxsize=None)
def jax_full_trees() -> dict:
    """Shapes of the JAX package's full-width UNet, VAE and ViT-H CLIP trees
    (tracing only, ~2 s)."""
    from stable_virtual_camera_tpu.models.clip import ClipVisionSpec as JaxClipSpec
    from stable_virtual_camera_tpu.models.clip import ClipVisionTower as JaxClip
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet
    from stable_virtual_camera_tpu.models.vae import AutoEncoderKL as JaxVae

    key, z = jax.random.PRNGKey(0), jnp.zeros
    unet = JaxUNet(jax_config.SevaSpec())
    return {
        "unet": jax.eval_shape(lambda: unet.init(
            key, z((2, 8, 8, 11)), z((2,), jnp.int32), z((2, 1, 1024)), z((2, 8, 8, 6)), num_frames=1
        ))["params"],
        "vae": jax.eval_shape(lambda: JaxVae().init(key, z((1, 16, 16, 3))))["params"],
        "clip": jax.eval_shape(lambda: JaxClip(JaxClipSpec()).init(key, z((1, 224, 224, 3))))["params"],
    }


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _torch_shape(flax_leaf: str, shape) -> tuple:
    """A flax leaf's shape in torch's layout (Dense (in, out) -> (out, in),
    Conv HWIO -> OIHW)."""
    shape = tuple(shape)
    if flax_leaf == "kernel":
        return shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
    return shape


def _released_shapes(key_map, tree) -> dict[str, tuple]:
    """Released key -> shape implied by a JAX key map over a flax tree: the
    fused self-attention qkv split into to_q/to_k/to_v, and the UNet's dead
    cross-attention to_q (C, C) and to_k (C, context) added."""
    out = {}
    for tp, fp, kind in key_map:
        for suffix, (leaf, _) in jax_convert._KIND_LEAVES[kind].items():
            shape = _torch_shape(leaf, _leaf(tree, fp + (leaf,)).shape)
            if tp.endswith(".attn1.qkv"):
                for n in "qkv":
                    out[f"{tp[:-3]}to_{n}.{suffix}"] = (shape[0] // 3, shape[1])
                continue
            out[f"{tp}.{suffix}"] = shape
            if tp.endswith(".attn2.to_v"):
                out[f"{tp[:-4]}to_q.{suffix}"] = (shape[0], shape[0])
                out[f"{tp[:-4]}to_k.{suffix}"] = shape
    return out


def _port_shapes(tree, prefix=()) -> dict[str, tuple]:
    """The port's parameter name -> shape implied by a flax tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_port_shapes(v, prefix + (k,)))
        else:
            name = {"kernel": "weight", "scale": "weight"}.get(k, k)
            out[".".join(prefix + (name,))] = _torch_shape(k, v.shape)
    return out


def _seeded(shapes: dict, seed: int) -> dict[str, np.ndarray]:
    """Seeded fp32 values in the ranges of trained weights: 1-D weights
    (norm scales) near 1, biases and embeddings near 0, matrices with
    variance 1 / fan-in."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        x = rng.standard_normal(shape, dtype=np.float32)
        if name.endswith("weight") and len(shape) == 1:
            x = 1.0 + 0.1 * x
        elif len(shape) >= 2 and not name.endswith("embedding"):
            x = x / np.float32(np.sqrt(np.prod(shape[1:])))
        else:
            x = 0.02 * x
        out[name] = x
    return out


def released_unet(seed: int = 0) -> dict[str, np.ndarray]:
    return _seeded(_released_shapes(jax_convert.seva_key_map(jax_config.SevaSpec.tiny()),
                                    jax_abstract_trees()["unet"]), seed)


def released_vae(seed: int = 1) -> dict[str, np.ndarray]:
    return _seeded(_released_shapes(jax_convert.vae_key_map(), jax_abstract_trees()["vae"]), seed)


def released_clip(layout: str, seed: int = 2) -> dict[str, np.ndarray]:
    """The tiny CLIP tower in open_clip names (`visual.` prefixed or bare)
    or HF names, through the port's inverses from seeded values."""
    port = {k: torch.from_numpy(v) for k, v in
            _seeded(_port_shapes(jax_abstract_trees()["clip"]), seed).items()}
    if layout == "hf":
        sd = convert.clip_to_hf(port, CLIP_TINY)
        sd["vision_model.embeddings.position_ids"] = torch.arange(5)[None]
    else:
        sd = convert.clip_to_open_clip(port, CLIP_TINY, prefix="visual." if layout == "visual" else "")
    return {k: v.numpy() for k, v in sd.items()}


def _equal_state(ours: dict, ref: dict) -> None:
    assert ours.keys() == ref.keys(), (sorted(ours.keys() - ref.keys())[:4],
                                       sorted(ref.keys() - ours.keys())[:4])
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k], ref[k]), k


def _module_state(module) -> dict:
    return {k: v.detach() for k, v in module.state_dict().items()}


def _jax_tree_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# The safetensors reader and writer
# ---------------------------------------------------------------------------

_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64, torch.int64, torch.int32,
           torch.int16, torch.int8, torch.uint8, torch.bool)


def _every_dtype(seed: int = 0) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    out = {"odd_bytes": torch.randint(0, 255, (3,), generator=g, dtype=torch.uint8)}
    for i, dt in enumerate(_DTYPES):
        shape = [(2, 3, 5), (7,), ()][i % 3]
        if dt.is_floating_point:
            t = torch.randn(shape, generator=g).to(dt)
        elif dt == torch.bool:
            t = torch.randint(0, 2, shape, generator=g).bool()
        else:
            info = torch.iinfo(dt)
            t = torch.randint(max(info.min, -2**31), min(info.max, 2**31 - 1), shape, generator=g,
                              dtype=torch.int64).to(dt)
        out[f"t_{str(dt).split('.')[1]}"] = t
    out["empty"] = torch.zeros((0, 4), dtype=torch.float32)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def test_reader_matches_safetensors_for_every_dtype(tmp_path):
    from safetensors.torch import load_file, save_file

    tensors = _every_dtype()
    path = str(tmp_path / "all.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    ref, ours = load_file(path), mio.read_safetensors(path)
    assert ours.keys() == ref.keys() == tensors.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert torch.equal(_bits(ours[k]), _bits(ref[k])), k
    cast = mio.read_safetensors(path, dtype=torch.bfloat16)
    for k, t in ref.items():  # floating-point tensors are cast, the others kept
        want = t.to(torch.bfloat16) if t.is_floating_point() else t
        assert cast[k].dtype == want.dtype and torch.equal(_bits(cast[k]), _bits(want)), k


def test_writer_opens_in_safe_open(tmp_path):
    """The port's writer keeps the given order (so a 3-byte tensor puts the
    next one off its alignment, which the reader copies) and pads its header
    to 8 bytes; `safe_open` and the port's reader both read it bit for bit."""
    from safetensors import safe_open

    tensors = _every_dtype(seed=1)
    path = str(tmp_path / "port.safetensors")
    mio.write_safetensors(tensors, path, metadata={"origin": "test"})
    with open(path, "rb") as f:
        assert struct.unpack("<Q", f.read(8))[0] % 8 == 0
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"origin": "test"} and set(f.keys()) == tensors.keys()
        for k, t in tensors.items():
            assert torch.equal(_bits(f.get_tensor(k)), _bits(t)), k
    back = mio.read_safetensors(path)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(_bits(back[k]), _bits(t)), k


def _raw_file(path, header: dict, data: bytes, claimed: int | None = None) -> str:
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob) if claimed is None else claimed) + blob + data)
    return str(path)


@pytest.mark.parametrize("case,match", [
    ("truncated", "truncated"),
    ("overlapping", "overlap"),
    ("oversized_header", "past the end"),
    ("wrong_size", "offsets"),
    ("too_short", "too short"),
])
def test_reader_refuses_bad_files(tmp_path, case, match):
    path = tmp_path / f"{case}.safetensors"
    a = {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}
    if case == "truncated":
        mio.write_safetensors({"a": torch.ones(4), "b": torch.ones(8)}, str(path))
        data = path.read_bytes()
        path.write_bytes(data[:-8])
    elif case == "overlapping":
        _raw_file(path, {"a": a, "b": {"dtype": "F32", "shape": [4], "data_offsets": [8, 24]}},
                  bytes(24))
    elif case == "oversized_header":
        _raw_file(path, {"a": a}, bytes(16), claimed=1 << 40)
    elif case == "wrong_size":
        _raw_file(path, {"a": {"dtype": "F32", "shape": [5], "data_offsets": [0, 16]}}, bytes(16))
    else:
        path.write_bytes(b"\x01\x00")
    with pytest.raises(ValueError, match=match):
        mio.read_safetensors(str(path))


# ---------------------------------------------------------------------------
# The converters and their inverses, against the JAX package's converters
# ---------------------------------------------------------------------------


def _to_legacy_vae(sd: dict) -> dict:
    """The pre-0.15 diffusers spelling: query/key/value/proj_attn, with the
    attention weights as 1x1 convolutions."""
    out = {}
    for k, v in sd.items():
        for new, old in jax_convert._VAE_LEGACY_ATTN.items():
            if f".attentions.0.{new}." in k:
                k = k.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
                v = v[:, :, None, None] if v.ndim == 2 else v
        out[k] = v
    return out


def _convert_both(model: str):
    """(released state dict, port conversion, JAX conversion bridged)."""
    if model == "unet":
        sd = released_unet()
        return sd, convert.convert_seva_state_dict(sd, TINY), jax_convert.convert_seva_state_dict(
            sd, jax_config.SevaSpec.tiny())
    if model in ("vae", "vae_legacy"):
        sd = released_vae() if model == "vae" else _to_legacy_vae(released_vae())
        return sd, convert.convert_vae_state_dict(sd), jax_convert.convert_vae_state_dict(sd)
    from stable_virtual_camera_tpu.models.clip import ClipVisionSpec as JaxClipSpec

    layout = model.split("_", 1)[1]
    sd = released_clip(layout)
    if layout == "hf":
        return sd, convert.convert_clip_hf(sd, CLIP_TINY), jax_convert.convert_clip_hf(sd, JaxClipSpec.tiny())
    return sd, convert.convert_clip_open_clip(sd, CLIP_TINY), jax_convert.convert_clip_open_clip(
        sd, JaxClipSpec.tiny())


MODELS = ["unet", "vae", "vae_legacy", "clip_visual", "clip_bare", "clip_hf"]


@pytest.mark.parametrize("model", MODELS)
def test_converter_matches_jax(model):
    _, ours, ref = _convert_both(model)
    _equal_state(ours, flax_to_state_dict(ref))


def _module(model: str):
    if model == "unet":
        return SevaUNet(TINY, "plain")
    return AutoEncoderKL() if model.startswith("vae") else ClipVisionTower(CLIP_TINY)


def _inverse(model: str, port_sd: dict) -> dict:
    if model == "unet":
        return convert.seva_to_released(port_sd, TINY)
    if model.startswith("vae"):
        sd = convert.vae_to_released(port_sd)
        return _to_legacy_vae(sd) if model == "vae_legacy" else sd
    if model == "clip_hf":
        return convert.clip_to_hf(port_sd, CLIP_TINY)
    return convert.clip_to_open_clip(port_sd, CLIP_TINY, prefix="visual." if model == "clip_visual" else "")


@pytest.mark.parametrize("model", MODELS)
def test_inverse_through_jax_converter(model):
    """The port module's state dict -> the port's inverse -> the JAX
    converter gives `to_flax_tree` of the module bit for bit."""
    _, ours, _ = _convert_both(model)
    module = _module(model)
    module.load_state_dict(ours, strict=True)
    released = {k: v.numpy() for k, v in _inverse(model, _module_state(module)).items()}
    if model == "unet":
        ref = jax_convert.convert_seva_state_dict(released, jax_config.SevaSpec.tiny())
    elif model.startswith("vae"):
        ref = jax_convert.convert_vae_state_dict(released)
    else:
        from stable_virtual_camera_tpu.models.clip import ClipVisionSpec as JaxClipSpec

        fn = jax_convert.convert_clip_hf if model == "clip_hf" else jax_convert.convert_clip_open_clip
        ref = fn(released, JaxClipSpec.tiny())
    tree = jax_abstract_trees()[model.split("_")[0]]
    want, got = _jax_tree_leaves(to_flax_tree(module, tree)), _jax_tree_leaves(ref)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", ["missing", "leftover", "wrong_shape", "dead_keys", "text_tower"])
def test_converters_are_strict(case):
    sd = {k: torch.from_numpy(v) for k, v in released_unet().items()}
    if case == "missing":
        del sd["out.2.bias"]
        with pytest.raises(KeyError, match="out.2.bias"):
            convert.convert_seva_state_dict(sd, TINY)
    elif case == "leftover":
        sd["input_blocks.1.1.transformer_blocks.0.attn1.extra.weight"] = torch.zeros(2)
        with pytest.raises(KeyError, match="no place"):
            convert.convert_seva_state_dict(sd, TINY)
        vae = dict(released_vae(), **{"decoder.unknown.weight": np.zeros(2, np.float32)})
        with pytest.raises(KeyError, match="no place"):
            convert.convert_vae_state_dict(vae)
    elif case == "wrong_shape":
        sd["out.2.weight"] = sd["out.2.weight"][:, :, :2]
        state = convert.convert_seva_state_dict(sd, TINY)
        with torch.device("meta"):
            module = SevaUNet(TINY)
        with pytest.raises(ValueError, match="out_conv.weight"):
            mio.check_shapes(state, module, "UNet")
    elif case == "dead_keys":
        dead = [k for k in sd if k.endswith((".attn2.to_q.weight", ".attn2.to_k.weight"))]
        assert len(dead) == 2 * sum(1 for k in sd if k.endswith(".attn2.to_v.weight")) > 0
        with_dead = convert.convert_seva_state_dict(sd, TINY)
        without = convert.convert_seva_state_dict({k: v for k, v in sd.items() if k not in dead}, TINY)
        _equal_state(with_dead, without)
    else:
        # a whole open_clip checkpoint: the text tower's unprefixed
        # `positional_embedding` and `transformer.resblocks.*` are not read
        clip = released_clip("visual")
        whole = dict(clip, positional_embedding=np.zeros((77, 32), np.float32),
                     **{"transformer.resblocks.0.ln_1.weight": np.zeros(32, np.float32),
                        "token_embedding.weight": np.zeros((10, 32), np.float32)})
        _equal_state(convert.convert_clip_open_clip(whole, CLIP_TINY),
                     convert.convert_clip_open_clip(clip, CLIP_TINY))
        with pytest.raises(KeyError, match="no place"):
            convert.convert_clip_open_clip(dict(clip, **{"visual.extra": np.zeros(1)}), CLIP_TINY)


@pytest.mark.parametrize("model", ["unet", "vae", "clip"])
def test_full_width_key_sets_on_meta(model):
    """At full width, without allocating: the released key set from the
    port's inverse equals the one implied by the JAX key map and tree
    (UNet, VAE), and converting it fills every parameter of the port module
    with the JAX tree's shapes."""
    trees = jax_full_trees()
    with torch.device("meta"):
        module = {"unet": lambda: SevaUNet(SevaSpec()), "vae": AutoEncoderKL,
                  "clip": lambda: ClipVisionTower(ClipVisionSpec())}[model]()
    port_sd = dict(module.named_parameters())
    if model == "unet":
        released = convert.seva_to_released(port_sd, SevaSpec())
        jax_released = _released_shapes(jax_convert.seva_key_map(jax_config.SevaSpec()), trees["unet"])
        state = convert.convert_seva_state_dict(released, SevaSpec())
        lo, hi = 1.2e9, 1.5e9
    elif model == "vae":
        released = convert.vae_to_released(port_sd)
        jax_released = _released_shapes(jax_convert.vae_key_map(), trees["vae"])
        state = convert.convert_vae_state_dict(released)
        lo, hi = 8.0e7, 9.0e7
    else:
        released = convert.clip_to_open_clip(port_sd, ClipVisionSpec())
        jax_released = None  # the JAX package has no CLIP key map, only its converters
        state = convert.convert_clip_open_clip(released, ClipVisionSpec())
        hf = convert.convert_clip_hf(convert.clip_to_hf(port_sd, ClipVisionSpec()), ClipVisionSpec())
        assert {k: tuple(v.shape) for k, v in hf.items()} == {k: tuple(v.shape) for k, v in state.items()}
        lo, hi = 6.0e8, 6.5e8
    assert all(t.is_meta for t in state.values())
    if jax_released is not None:
        assert {k: tuple(v.shape) for k, v in released.items()} == jax_released
    assert {k: tuple(v.shape) for k, v in state.items()} == _port_shapes(trees[model])
    n = mio.check_shapes(state, module, model)
    assert lo < n < hi, n


# ---------------------------------------------------------------------------
# load_bundle and the converted cache
# ---------------------------------------------------------------------------


def write_released(directory, clip_layout: str = "visual", specs: bool = True) -> str:
    """A released-layout directory at the tiny specs, written by the
    `safetensors` package: model/vae/clip.safetensors (+ specs.json)."""
    from safetensors.numpy import save_file

    os.makedirs(directory, exist_ok=True)
    save_file(released_unet(), osp.join(directory, "model.safetensors"))
    save_file(released_vae(), osp.join(directory, "vae.safetensors"))
    save_file(released_clip(clip_layout), osp.join(directory, "clip.safetensors"))
    if specs:
        mio.save_converted({}, directory, specs={"seva": TINY, "clip": CLIP_TINY})
    return str(directory)


def _bundle_states(bundle) -> dict:
    return {"unet": _module_state(bundle.unet), "vae": _module_state(bundle.vae.module),
            "clip": _module_state(bundle.clip.module)}


@pytest.fixture(scope="module")
def released_dir(tmp_path_factory):
    return write_released(tmp_path_factory.mktemp("released"))


@pytest.fixture(scope="module")
def loaded(released_dir):
    """(port fp32 bundle, JAX fp32 bundle) loaded from the same directory."""
    from stable_virtual_camera_tpu.models.io import load_bundle as jax_load_bundle

    ours = mio.load_bundle(released_dir, dtype=torch.float32, device="cpu")
    ref = jax_load_bundle(released_dir, dtype=jnp.float32, param_dtype=jnp.float32, use_pallas=False)
    return ours, ref


def test_load_bundle_matches_jax(loaded):
    ours, ref = loaded
    assert ours.spec == TINY and ours.clip.module.spec == CLIP_TINY
    states = _bundle_states(ours)
    for name, tree in (("unet", ref.denoiser.params), ("vae", ref.vae.params), ("clip", ref.clip.params)):
        _equal_state(states[name], flax_to_state_dict(tree))


def test_load_bundle_defaults_to_bf16_of_the_fp32_load(released_dir, loaded):
    bf16 = mio.load_bundle(released_dir, device="cpu")
    fp32 = _bundle_states(loaded[0])
    for name, state in _bundle_states(bf16).items():
        _equal_state(state, {k: v.to(torch.bfloat16) for k, v in fp32[name].items()})
    assert bf16.unet.input_blocks_0_0.weight.is_contiguous(memory_format=torch.channels_last)


def test_loaded_render_matches_jax(loaded, tmp_path):
    """One render of the golden scene (one input view, two targets, two
    passes) from the loaded weights through both SceneEngines."""
    from stable_virtual_camera_tpu.data.parsers import ReconfusionParser
    from stable_virtual_camera_tpu.engine.runner import SceneEngine as JaxEngine
    from stable_virtual_camera_tpu_torch.config import EngineOptions, VersionConfig
    from stable_virtual_camera_tpu_torch.engine.runner import SceneEngine
    from test_torch_engine import _assert_frames_close, _pngs
    from test_torch_sampler import jax_noise

    ours, ref = loaded
    parser = ReconfusionParser(GOLDEN)
    imgs = [iio.imread(p) for p in parser.image_paths]
    c2ws = np.asarray(parser.camtoworlds, np.float32)[:, :3]
    K = np.asarray(parser.Ks_dict[parser.camera_ids[0]], np.float32)
    options = dict(num_steps=2, cfg=[2.0, 2.0], guider_types=[1, 2], chunk_strategy="nearest",
                   chunk_strategy_first_pass="gt", sampler_verbose=False, encoding_t=0,
                   decoding_t=0, save_first_pass=False)
    scene = dict(task="img2trajvid",
                 image_cond={"img": list(imgs), "input_indices": [0], "prior_indices": [1.5]},
                 camera_cond={"c2w": c2ws, "K": [K] * len(imgs), "input_indices": [0, 1, 2]},
                 use_traj_prior=True, traj_prior_Ks=None, traj_prior_c2ws=c2ws[1:2], seed=23)
    save = str(tmp_path / "jax")
    list(JaxEngine(ref, jax_config.VersionConfig(H=64, W=64, T=3),
                   jax_config.EngineOptions().update(options)).run_one_scene(save_path=save, **scene))
    (frames,) = SceneEngine(ours, VersionConfig(H=64, W=64, T=3), EngineOptions().update(options),
                            noise_fn=jax_noise).run_one_scene(save_path=None, **scene)
    assert frames.shape == (2, 64, 64, 3) and frames.std() > 0
    _assert_frames_close(frames, _pngs(osp.join(save, "samples-rgb")))


def test_converted_cache_round_trips_and_merges(tmp_path, loaded):
    from stable_virtual_camera_tpu_torch.models.dust3r import AsymmetricCroCoStereo, Dust3rSpec

    states = _bundle_states(loaded[0])
    out = str(tmp_path / "cache")
    mio.save_converted({"unet": states["unet"], "clip": states["clip"]}, out,
                       specs={"seva": TINY, "clip": CLIP_TINY})
    dust3r = _module_state(AsymmetricCroCoStereo(Dust3rSpec.tiny()))
    mio.save_converted({"vae": states["vae"], "dust3r": dust3r}, out)
    for name in ("unet", "vae", "clip"):
        _equal_state(mio.load_converted(out, name, device="cpu"), states[name])
    _equal_state(mio.load_converted(out, "dust3r", device="cpu"), dust3r)
    assert set(mio.load_checkpoint_specs(out)) == {"seva", "clip"}
    back = mio.load_bundle(out, dtype=torch.float32, device="cpu")
    for name, state in _bundle_states(back).items():
        _equal_state(state, states[name])
    with pytest.raises(KeyError, match="lpips"):
        mio.save_converted({"lpips": {}}, out)


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------


def _sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_convert_weights_writes_manifest_and_cache(tmp_path, loaded, monkeypatch):
    """apps.convert_weights on the released files (the CLIP tower as an
    open_clip `.bin`, as released), at the tiny specs: hashes, totals,
    specs.json, and a cache that loads to the released directory's bundle;
    a second run adds DUSt3R to the same cache."""
    from stable_virtual_camera_tpu_torch.apps import convert_weights
    from stable_virtual_camera_tpu_torch.models.dust3r import Dust3rSpec
    from test_torch_dust3r import save_checkpoint, synthetic_state

    monkeypatch.setattr(convert_weights, "SevaSpec", SevaSpec.tiny)
    monkeypatch.setattr(convert_weights, "ClipVisionSpec", ClipVisionSpec.tiny)
    dust3r_spec = Dust3rSpec.tiny()
    monkeypatch.setattr("stable_virtual_camera_tpu_torch.models.dust3r.Dust3rSpec", lambda: dust3r_spec)
    src = write_released(tmp_path / "released", specs=False)
    clip_bin = str(tmp_path / "open_clip_pytorch_model.bin")
    torch.save({k: torch.from_numpy(v) for k, v in released_clip("visual").items()}, clip_bin)
    out = str(tmp_path / "converted")
    files = {"unet": osp.join(src, "model.safetensors"), "vae": osp.join(src, "vae.safetensors"),
             "clip": clip_bin}
    manifest = convert_weights.main(**files, out=out, dtype="float32", device="cpu")
    states = _bundle_states(loaded[0])
    for name, path in files.items():
        assert manifest["inputs"][name]["sha256"] == _sha256(path)
        assert manifest["totals"][name] == sum(v.numel() for v in states[name].values())
    assert mio.load_checkpoint_specs(out) == json.loads(json.dumps(
        {"seva": TINY.__dict__, "clip": CLIP_TINY.__dict__}))
    for name, state in _bundle_states(mio.load_bundle(out, dtype=torch.float32, device="cpu")).items():
        _equal_state(state, states[name])

    pth = save_checkpoint(tmp_path / "dust3r.pth", synthetic_state())
    manifest = convert_weights.main(dust3r=pth, out=out, device="cpu")
    with open(osp.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert set(manifest["inputs"]) == {"unet", "vae", "clip", "dust3r"}
    _equal_state(mio.load_converted(out, "dust3r", device="cpu"),
                 mio.load_dust3r_state(pth, dust3r_spec))


def test_cli_builds_its_bundle_from_checkpoint_dir(tmp_path, released_dir, monkeypatch):
    """cli.main --checkpoint_dir on the released-layout directory: the bundle
    is load_bundle's (bf16), and the scene's frames and transforms.json are
    written."""
    from stable_virtual_camera_tpu_torch.apps import cli

    built = []
    real = mio.load_bundle
    monkeypatch.setattr(mio, "load_bundle", lambda *a, **kw: built.append(real(*a, **kw)) or built[-1])
    (out_dir,) = cli.main(osp.dirname(GOLDEN), data_items=["scene0"], task="img2img",
                          checkpoint_dir=released_dir, device="cpu", H=64, W=64, T=3, num_steps=2,
                          work_dir=str(tmp_path / "work"), sampler_verbose=False)
    (bundle,) = built
    for name, state in _bundle_states(real(released_dir, device="cpu")).items():
        _equal_state(_bundle_states(bundle)[name], state)
    with open(osp.join(out_dir, "transforms.json")) as f:
        assert len(json.load(f)["frames"]) == 3
    pngs = sorted(os.listdir(osp.join(out_dir, "samples-rgb")))
    assert len([p for p in pngs if p.endswith(".png")]) == 2


def test_dust3r_pipeline_loads_cache_dir_and_safetensors(tmp_path):
    from safetensors.torch import save_file

    from stable_virtual_camera_tpu_torch.apps.preprocessor import NativeDust3rPipeline
    from stable_virtual_camera_tpu_torch.models.dust3r import Dust3rSpec
    from test_torch_dust3r import synthetic_state

    spec = Dust3rSpec.tiny()
    state = synthetic_state(seed=5)
    st = str(tmp_path / "dust3r.safetensors")
    save_file({k: torch.from_numpy(v).clone() for k, v in state.items()}, st)
    want = mio.load_dust3r_state(st, spec)
    cache = str(tmp_path / "cache")
    mio.save_converted({"dust3r": want}, cache)
    for weight_path in (st, cache):
        pipe = NativeDust3rPipeline(weight_path=weight_path, spec=spec, device="cpu")
        _equal_state(_module_state(pipe.model), want)
