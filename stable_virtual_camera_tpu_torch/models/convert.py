"""Key maps from the released checkpoints to the port's parameter names.

Counterpart of stable_virtual_camera_tpu/models/convert.py. The released
weights are torch state dicts: the Seva UNet (`model.safetensors`, keyed by
the reference's module tree), the SD2.1 AutoencoderKL (diffusers names,
modern `to_q` or legacy `query` attention) and the OpenCLIP ViT-H/14 image
tower (open_clip names, or HF transformers' `vision_model.` names). The
port's modules are named after the JAX package's flax paths but keep torch
layouts (models/weights.py), so converting renames keys and transposes
nothing, apart from three fusions and one transpose:
  * the UNet's self-attention `attn1.to_{q,k,v}` become one `attn1.qkv`
    (rows q | k | v);
  * HF CLIP's `self_attn.{q,k,v}_proj` become one `qkv`, and its
    `visual_projection.weight` (embed, width) becomes `proj` (width, embed);
  * the legacy VAE's 1x1-conv attention weights (C, C, 1, 1) become (C, C).

Each key map is generated by replaying the model's topology walk and yields
(released prefix, port prefix, kind); the kind names the leaves an entry
has. The converters take torch tensors (on any device, `meta` included) or
numpy arrays, and are strict both ways: a released key the map needs and
does not find raises, and so does a released key left over, apart from
the UNet's dead cross-attention `attn2.to_q`/`to_k` (the context is one
token, so the softmax is 1 and only `to_v` and `to_out` act), HF CLIP's
`position_ids` buffer and a whole CLIP checkpoint's text tower. Each map
has an inverse, the port's state dict in the released layout, for tests
and smoke runs that write checkpoints.
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping

import torch

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec
from stable_virtual_camera_tpu_torch.models.weights import _to_torch

# kind -> the (released leaf, port leaf) pairs of one entry; "" is the
# prefix itself (a bare parameter)
_LEAVES = {
    "conv": (("weight", "weight"), ("bias", "bias")),
    "linear": (("weight", "weight"), ("bias", "bias")),
    "norm": (("weight", "weight"), ("bias", "bias")),
    "linear_nobias": (("weight", "weight"),),
    "conv_nobias": (("weight", "weight"),),
    "in_proj": (("in_proj_weight", "weight"), ("in_proj_bias", "bias")),
    "param": (("", ""),),
    "transposed": (("weight", ""),),  # released (out, in) -> port (in, out)
}
_DEAD_UNET = (".attn2.to_q.weight", ".attn2.to_k.weight")
_HF_BUFFERS = ("vision_model.embeddings.position_ids",)

KeyMap = Iterator[tuple[str, str, str]]


def _join(prefix: str, leaf: str) -> str:
    return f"{prefix}.{leaf}" if leaf else prefix


def _tensors(state_dict: Mapping) -> dict[str, torch.Tensor]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else _to_torch(v)
            for k, v in state_dict.items()}


def _rename(sd: dict[str, torch.Tensor], key_map: KeyMap, what: str, legacy=None):
    """(port state dict, leftover released keys). `legacy(prefix, leaf)` gives
    an older spelling of a released key to try when the key is absent."""
    left = dict(sd)
    out = {}
    for tp, pp, kind in key_map:
        for t_leaf, p_leaf in _LEAVES[kind]:
            key = _join(tp, t_leaf)
            if key not in left and legacy is not None and legacy(tp, t_leaf) in left:
                key = legacy(tp, t_leaf)
            if key not in left:
                raise KeyError(f"{what}: the checkpoint lacks {key!r}")
            t = left.pop(key)
            if kind == "transposed":
                t = t.t().contiguous()
            out[_join(pp, p_leaf)] = t
    return out, left


def _refuse_leftovers(left, what: str) -> None:
    if left:
        raise KeyError(f"{what}: {len(left)} checkpoint keys have no place in the model, "
                       f"e.g. {sorted(left)[:5]}")


def _unrename(port_sd: Mapping[str, torch.Tensor], key_map: KeyMap, what: str) -> dict:
    left = dict(port_sd)
    out = {}
    for tp, pp, kind in key_map:
        for t_leaf, p_leaf in _LEAVES[kind]:
            t = left.pop(_join(pp, p_leaf))
            out[_join(tp, t_leaf)] = t.t().contiguous() if kind == "transposed" else t
    if left:
        raise KeyError(f"{what}: {len(left)} parameters outside the key map, e.g. {sorted(left)[:5]}")
    return out


# ---------------------------------------------------------------------------
# Seva UNet (reference seva/model.py)
# ---------------------------------------------------------------------------


def _attention_entries(tp: str, pp: str):
    # attn1 is self-attention with one fused qkv (`_fuse_self_attention_qkv`
    # synthesizes the released key); attn2's to_q/to_k are dead weights
    yield (f"{tp}.attn1.qkv", f"{pp}.attn1.qkv", "linear_nobias")
    yield (f"{tp}.attn1.to_out.0", f"{pp}.attn1.to_out", "linear")
    yield (f"{tp}.attn2.to_v", f"{pp}.attn2.to_v", "linear_nobias")
    yield (f"{tp}.attn2.to_out.0", f"{pp}.attn2.to_out", "linear")


def _ff_entries(tp: str, pp: str, ff: str):
    yield (f"{tp}.{ff}.net.0.proj", f"{pp}.{ff}.proj_gate", "linear")
    yield (f"{tp}.{ff}.net.2", f"{pp}.{ff}.proj_out", "linear")


def _spatial_block_entries(tp: str, pp: str):
    yield from _attention_entries(tp, pp)
    yield from _ff_entries(tp, pp, "ff")
    for n in ("norm1", "norm2", "norm3"):
        yield (f"{tp}.{n}", f"{pp}.{n}.ln", "norm")


def _temporal_block_entries(tp: str, pp: str):
    yield (f"{tp}.norm_in", f"{pp}.norm_in.ln", "norm")
    yield from _ff_entries(tp, pp, "ff_in")
    yield from _spatial_block_entries(tp, pp)


def _resblock_entries(tp: str, pp: str, has_skip: bool):
    yield (f"{tp}.in_layers.0", f"{pp}.in_gn.gn", "norm")
    yield (f"{tp}.in_layers.2", f"{pp}.in_conv", "conv")
    yield (f"{tp}.emb_layers.1", f"{pp}.emb_proj", "linear")
    yield (f"{tp}.dense_emb_layers.0", f"{pp}.dense_proj", "conv")
    yield (f"{tp}.out_layers.0", f"{pp}.out_gn.gn", "norm")
    yield (f"{tp}.out_layers.3", f"{pp}.out_conv", "conv")
    if has_skip:
        yield (f"{tp}.skip_connection", f"{pp}.skip", "conv")


def _mvt_entries(tp: str, pp: str, depth: int):
    yield (f"{tp}.norm", f"{pp}.norm.gn", "norm")
    yield (f"{tp}.proj_in", f"{pp}.proj_in", "linear")
    yield (f"{tp}.proj_out", f"{pp}.proj_out", "linear")
    for d in range(depth):
        yield from _spatial_block_entries(f"{tp}.transformer_blocks.{d}", f"{pp}.spatial_{d}")
        yield from _temporal_block_entries(f"{tp}.time_mix_blocks.{d}", f"{pp}.temporal_{d}")


def seva_key_map(spec: SevaSpec) -> KeyMap:
    """(released prefix, port prefix, kind) for every UNet entry, by the
    topology walk of reference seva/model.py:40-174."""
    mc = spec.model_channels
    yield ("time_embed.0", "time_embed_0", "linear")
    yield ("time_embed.2", "time_embed_2", "linear")
    yield ("input_blocks.0.0", "input_blocks_0_0", "conv")

    ch, ds, block_idx = mc, 1, 1
    for level, mult in enumerate(spec.channel_mult):
        for _ in range(spec.num_res_blocks):
            has_skip = ch != mult * mc
            yield from _resblock_entries(f"input_blocks.{block_idx}.0",
                                         f"input_blocks_{block_idx}_0", has_skip)
            ch = mult * mc
            if ds in spec.attention_resolutions:
                yield from _mvt_entries(f"input_blocks.{block_idx}.1", f"input_blocks_{block_idx}_1",
                                        spec.transformer_depth[level])
            block_idx += 1
        if level != len(spec.channel_mult) - 1:
            yield (f"input_blocks.{block_idx}.0.op", f"input_blocks_{block_idx}_0.conv", "conv")
            ds *= 2
            block_idx += 1

    yield from _resblock_entries("middle_block.0", "middle_block_0", False)
    yield from _mvt_entries("middle_block.1", "middle_block_1", spec.transformer_depth[-1])
    yield from _resblock_entries("middle_block.2", "middle_block_2", False)

    # decoder: the skip concat changes input channels, so ResBlocks project
    input_block_chans = [mc]
    for level, mult in enumerate(spec.channel_mult):
        input_block_chans += [mult * mc] * spec.num_res_blocks
        if level != len(spec.channel_mult) - 1:
            input_block_chans.append(mult * mc)
    block_idx = 0
    for level, mult in list(enumerate(spec.channel_mult))[::-1]:
        for i in range(spec.num_res_blocks + 1):
            has_skip = (ch + input_block_chans.pop()) != mult * mc
            yield from _resblock_entries(f"output_blocks.{block_idx}.0",
                                         f"output_blocks_{block_idx}_0", has_skip)
            ch = mult * mc
            layer_idx = 1
            if ds in spec.attention_resolutions:
                yield from _mvt_entries(f"output_blocks.{block_idx}.{layer_idx}",
                                        f"output_blocks_{block_idx}_{layer_idx}",
                                        spec.transformer_depth[level])
                layer_idx += 1
            if level and i == spec.num_res_blocks:
                yield (f"output_blocks.{block_idx}.{layer_idx}.conv",
                       f"output_blocks_{block_idx}_{layer_idx}.conv", "conv")
                ds //= 2
            block_idx += 1

    yield ("out.0", "out_gn.gn", "norm")
    yield ("out.2", "out_conv", "conv")


def _fuse_self_attention_qkv(sd: dict) -> dict:
    """Concatenate every `*.attn1.to_{q,k,v}.weight` triple into
    `*.attn1.qkv.weight` ((3 out, in), rows q | k | v)."""
    out = dict(sd)
    for key in sd:
        if key.endswith(".attn1.to_q.weight"):
            base = key[: -len("to_q.weight")]
            q, k, v = (out.pop(f"{base}to_{n}.weight") for n in ("q", "k", "v"))
            out[f"{base}qkv.weight"] = torch.cat([q, k, v], dim=0)
    return out


def convert_seva_state_dict(state_dict: Mapping, spec: SevaSpec) -> dict[str, torch.Tensor]:
    """The released UNet state dict -> the port's `SevaUNet` state dict, in
    the tensors' own dtype and device."""
    out, left = _rename(_fuse_self_attention_qkv(_tensors(state_dict)), seva_key_map(spec), "UNet")
    _refuse_leftovers({k for k in left if not k.endswith(_DEAD_UNET)}, "UNet")
    return out


def seva_to_released(port_sd: Mapping[str, torch.Tensor], spec: SevaSpec) -> dict[str, torch.Tensor]:
    """The inverse of `convert_seva_state_dict`: `attn1.qkv` split into
    `to_q`/`to_k`/`to_v`, and the dead `attn2.to_q` (C, C) and `attn2.to_k`
    (C, context) written as zeros, the shapes the release has."""
    sd = _unrename(port_sd, seva_key_map(spec), "UNet")
    out = {}
    for key, t in sd.items():
        if key.endswith(".attn1.qkv.weight"):
            base = key[: -len("qkv.weight")]
            for name, part in zip("qkv", t.chunk(3, dim=0)):
                out[f"{base}to_{name}.weight"] = part.contiguous()
            continue
        out[key] = t
        if key.endswith(".attn2.to_v.weight"):
            base = key[: -len("to_v.weight")]
            out[f"{base}to_q.weight"] = t.new_zeros((t.shape[0], t.shape[0]))
            out[f"{base}to_k.weight"] = torch.zeros_like(t)
    return out


# ---------------------------------------------------------------------------
# VAE (diffusers AutoencoderKL, SD2.1)
# ---------------------------------------------------------------------------

_VAE_BLOCKS = (128, 256, 512, 512)
# the pre-0.15 diffusers spelling of the attention layers
_VAE_LEGACY_ATTN = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def _vae_resnet_entries(tp: str, pp: str, has_skip: bool):
    yield (f"{tp}.norm1", f"{pp}.norm1.gn", "norm")
    yield (f"{tp}.conv1", f"{pp}.conv1", "conv")
    yield (f"{tp}.norm2", f"{pp}.norm2.gn", "norm")
    yield (f"{tp}.conv2", f"{pp}.conv2", "conv")
    if has_skip:
        yield (f"{tp}.conv_shortcut", f"{pp}.conv_shortcut", "conv")


def _vae_mid_entries(tp: str, pp: str):
    yield from _vae_resnet_entries(f"{tp}.resnets.0", f"{pp}.resnet_0", False)
    yield (f"{tp}.attentions.0.group_norm", f"{pp}.attn.group_norm.gn", "norm")
    for t_name, p_name in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                           ("to_out.0", "to_out")):
        yield (f"{tp}.attentions.0.{t_name}", f"{pp}.attn.{p_name}", "linear")
    yield from _vae_resnet_entries(f"{tp}.resnets.1", f"{pp}.resnet_1", False)


def vae_key_map() -> KeyMap:
    """(released prefix, port prefix, kind) for the SD2.1 AutoencoderKL."""
    yield ("encoder.conv_in", "encoder.conv_in", "conv")
    ch = _VAE_BLOCKS[0]
    for i, out in enumerate(_VAE_BLOCKS):
        for j in range(2):
            yield from _vae_resnet_entries(f"encoder.down_blocks.{i}.resnets.{j}",
                                           f"encoder.down_{i}_resnet_{j}", ch != out)
            ch = out
        if i < len(_VAE_BLOCKS) - 1:
            yield (f"encoder.down_blocks.{i}.downsamplers.0.conv", f"encoder.down_{i}_downsample.conv",
                   "conv")
    yield from _vae_mid_entries("encoder.mid_block", "encoder.mid")
    yield ("encoder.conv_norm_out", "encoder.conv_norm_out.gn", "norm")
    yield ("encoder.conv_out", "encoder.conv_out", "conv")
    yield ("quant_conv", "quant_conv", "conv")
    yield ("post_quant_conv", "post_quant_conv", "conv")
    yield ("decoder.conv_in", "decoder.conv_in", "conv")
    yield from _vae_mid_entries("decoder.mid_block", "decoder.mid")
    rev = _VAE_BLOCKS[::-1]
    ch = rev[0]
    for i, out in enumerate(rev):
        for j in range(3):
            yield from _vae_resnet_entries(f"decoder.up_blocks.{i}.resnets.{j}",
                                           f"decoder.up_{i}_resnet_{j}", ch != out)
            ch = out
        if i < len(rev) - 1:
            yield (f"decoder.up_blocks.{i}.upsamplers.0.conv", f"decoder.up_{i}_upsample.conv", "conv")
    yield ("decoder.conv_norm_out", "decoder.conv_norm_out.gn", "norm")
    yield ("decoder.conv_out", "decoder.conv_out", "conv")


def convert_vae_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """The diffusers AutoencoderKL state dict (modern or legacy attention
    names) -> the port's `AutoEncoderKL` state dict."""

    def legacy(prefix: str, leaf: str) -> str | None:
        for new, old in _VAE_LEGACY_ATTN.items():
            if prefix.endswith(f".attentions.0.{new}"):
                return f"{prefix[: -len(new)]}{old}.{leaf}"
        return None

    out, left = _rename(_tensors(state_dict), vae_key_map(), "VAE", legacy)
    _refuse_leftovers(left, "VAE")
    for name, t in out.items():
        if t.dim() == 4 and ".attn.to_" in name:  # legacy 1x1-conv attention weights
            out[name] = t[:, :, 0, 0]
    return out


def vae_to_released(port_sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The inverse of `convert_vae_state_dict`, in the modern names."""
    return _unrename(port_sd, vae_key_map(), "VAE")


# ---------------------------------------------------------------------------
# CLIP image tower (open_clip `visual.` names, or HF transformers names)
# ---------------------------------------------------------------------------


def clip_open_clip_key_map(spec: ClipVisionSpec) -> KeyMap:
    """(released prefix, port prefix, kind) for open_clip's image tower,
    without its `visual.` prefix."""
    for name in ("class_embedding", "positional_embedding", "proj"):
        yield (name, name, "param")  # proj is (width, embed) on both sides
    yield ("conv1", "patch_embed", "conv_nobias")
    yield ("ln_pre", "ln_pre.ln", "norm")
    for i in range(spec.layers):
        tp, pp = f"transformer.resblocks.{i}", f"block_{i}"
        yield (f"{tp}.ln_1", f"{pp}.ln_1.ln", "norm")
        yield (f"{tp}.attn", f"{pp}.qkv", "in_proj")
        yield (f"{tp}.attn.out_proj", f"{pp}.out_proj", "linear")
        yield (f"{tp}.ln_2", f"{pp}.ln_2.ln", "norm")
        yield (f"{tp}.mlp.c_fc", f"{pp}.c_fc", "linear")
        yield (f"{tp}.mlp.c_proj", f"{pp}.c_proj", "linear")
    yield ("ln_post", "ln_post.ln", "norm")


def clip_hf_key_map(spec: ClipVisionSpec) -> KeyMap:
    """(released prefix, port prefix, kind) for HF transformers'
    CLIPVisionModelWithProjection; `self_attn.qkv_proj` is the fusion of
    `self_attn.{q,k,v}_proj` (`_fuse_hf_qkv`)."""
    vp = "vision_model"
    yield (f"{vp}.embeddings.class_embedding", "class_embedding", "param")
    yield (f"{vp}.embeddings.position_embedding.weight", "positional_embedding", "param")
    yield ("visual_projection", "proj", "transposed")
    yield (f"{vp}.embeddings.patch_embedding", "patch_embed", "conv_nobias")
    yield (f"{vp}.pre_layrnorm", "ln_pre.ln", "norm")
    for i in range(spec.layers):
        tp, pp = f"{vp}.encoder.layers.{i}", f"block_{i}"
        yield (f"{tp}.layer_norm1", f"{pp}.ln_1.ln", "norm")
        yield (f"{tp}.self_attn.qkv_proj", f"{pp}.qkv", "linear")
        yield (f"{tp}.self_attn.out_proj", f"{pp}.out_proj", "linear")
        yield (f"{tp}.layer_norm2", f"{pp}.ln_2.ln", "norm")
        yield (f"{tp}.mlp.fc1", f"{pp}.c_fc", "linear")
        yield (f"{tp}.mlp.fc2", f"{pp}.c_proj", "linear")
    yield (f"{vp}.post_layernorm", "ln_post.ln", "norm")


def convert_clip_open_clip(state_dict: Mapping, spec: ClipVisionSpec) -> dict[str, torch.Tensor]:
    """open_clip image-tower weights -> the port's `ClipVisionTower` state
    dict. Keys may carry the `visual.` prefix; when they do, only those keys
    are read (a whole open_clip checkpoint also holds the text tower, whose
    `positional_embedding` and `transformer.resblocks.*` would otherwise
    collide with the image tower's)."""
    sd = _tensors(state_dict)
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    out, left = _rename(sd, clip_open_clip_key_map(spec), "CLIP (open_clip)")
    _refuse_leftovers(left, "CLIP (open_clip)")
    return out


def _fuse_hf_qkv(sd: dict) -> dict:
    out = dict(sd)
    for key in sd:
        if key.endswith(".self_attn.q_proj.weight"):
            base = key[: -len("q_proj.weight")]
            for leaf in ("weight", "bias"):
                parts = [out.pop(f"{base}{n}_proj.{leaf}") for n in "qkv"]
                out[f"{base}qkv_proj.{leaf}"] = torch.cat(parts, dim=0)
    return out


def convert_clip_hf(state_dict: Mapping, spec: ClipVisionSpec) -> dict[str, torch.Tensor]:
    """HF transformers CLIPVisionModelWithProjection weights -> the port's
    `ClipVisionTower` state dict (q/k/v fused, the projection transposed;
    either spelling of the pre-LayerNorm, `pre_layrnorm` or `pre_layernorm`).
    Only the image tower's keys are read, as for open_clip."""
    sd = {k.replace(".pre_layernorm.", ".pre_layrnorm."): v for k, v in _tensors(state_dict).items()
          if k.startswith(("vision_model.", "visual_projection.")) and k not in _HF_BUFFERS}
    out, left = _rename(_fuse_hf_qkv(sd), clip_hf_key_map(spec), "CLIP (HF)")
    _refuse_leftovers(left, "CLIP (HF)")
    return out


def clip_to_open_clip(port_sd: Mapping[str, torch.Tensor], spec: ClipVisionSpec,
                      prefix: str = "visual.") -> dict[str, torch.Tensor]:
    """The inverse of `convert_clip_open_clip`, with `prefix` on every key."""
    return {prefix + k: v for k, v in _unrename(port_sd, clip_open_clip_key_map(spec), "CLIP").items()}


def clip_to_hf(port_sd: Mapping[str, torch.Tensor], spec: ClipVisionSpec) -> dict[str, torch.Tensor]:
    """The inverse of `convert_clip_hf`: `qkv` split into q/k/v projections."""
    out = {}
    for key, t in _unrename(port_sd, clip_hf_key_map(spec), "CLIP").items():
        if ".self_attn.qkv_proj." in key:
            for n, part in zip("qkv", t.chunk(3, dim=0)):
                out[key.replace(".qkv_proj.", f".{n}_proj.")] = part.contiguous()
        else:
            out[key] = t
    return out
