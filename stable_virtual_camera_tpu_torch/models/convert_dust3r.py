"""Key map from the released DUSt3R checkpoint to the port's module names.

Counterpart of stable_virtual_camera_tpu/models/convert_dust3r.py. The
released `naver/DUSt3R_ViTLarge_BaseDecoder_512_dpt` checkpoint is a torch
state dict over the CroCo/dust3r module tree; models/dust3r.py is named
after the JAX package's flax tree instead. Both are torch layouts (Linear
(out, in), Conv2d (out, in, kh, kw), ConvTranspose2d (in, out, kh, kw),
LayerNorm weight/bias), so converting renames keys and transposes nothing.

The checkpoint also carries leftovers the inference graph never uses, which
are skipped as in the JAX converter: `mask_token`, `prediction_head`, the
`.act_postprocess.` ModuleList aliases of the `act_{i}_postprocess` modules,
and refinenet4's `resConfUnit1` (instantiated but unused: refinenet4 has no
skip input).
"""

from __future__ import annotations

import re

import torch

from stable_virtual_camera_tpu_torch.models.dust3r import Dust3rSpec

_DPT = {
    "act_1_postprocess.0": "act1_proj",
    "act_1_postprocess.1": "act1_up",
    "act_2_postprocess.0": "act2_proj",
    "act_2_postprocess.1": "act2_up",
    "act_3_postprocess.0": "act3_proj",
    "act_4_postprocess.0": "act4_proj",
    "act_4_postprocess.1": "act4_down",
    "head.0": "head_conv1",
    "head.2": "head_conv2",
    "head.4": "head_out",
}
_NORMS = ("norm1", "norm2", "norm3", "norm_y")
_BLOCK_LAYERS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2", "cross_attn.projq",
                 "cross_attn.projk", "cross_attn.projv", "cross_attn.proj")


def _skipped(key: str) -> bool:
    return (
        key.startswith(("mask_token", "prediction_head"))
        or ".act_postprocess." in key
        or ".refinenet4.resConfUnit1." in key
    )


def port_key(key: str) -> str | None:
    """The port's parameter name for a released checkpoint key, or None for
    a key the inference graph does not use. Raises KeyError for a key it
    does not know."""
    if _skipped(key):
        return None
    module, _, leaf = key.rpartition(".")
    if module == "patch_embed.proj":
        return f"patch_embed.{leaf}"
    if module in ("enc_norm", "dec_norm"):
        return f"{module}.ln.{leaf}"
    if module == "decoder_embed":
        return key
    m = re.fullmatch(r"(enc_blocks|dec_blocks|dec_blocks2)\.(\d+)\.(.+)", module)
    if m:
        side, i, rest = m.groups()
        block = {"enc_blocks": "enc_block", "dec_blocks": "dec_block", "dec_blocks2": "dec2_block"}[side]
        if rest in _NORMS:
            return f"{block}_{i}.{rest}.ln.{leaf}"
        if rest in _BLOCK_LAYERS:
            return f"{block}_{i}.{rest}.{leaf}"
    m = re.fullmatch(r"downstream_head([12])\.dpt\.(.+)", module)
    if m:
        n, rest = m.groups()
        if rest in _DPT:
            return f"head{n}.{_DPT[rest]}.{leaf}"
        m2 = re.fullmatch(r"scratch\.(layer[1-4]_rn)", rest)
        if m2:
            return f"head{n}.{m2.group(1)}.{leaf}"
        m2 = re.fullmatch(r"scratch\.(refinenet[1-4])\.(resConfUnit([12])\.(conv[12])|out_conv)", rest)
        if m2:
            rn, tail, unit, conv = m2.groups()
            tail = f"rcu{unit}.{conv}" if unit else tail
            return f"head{n}.{rn}.{tail}.{leaf}"
    raise KeyError(f"unknown DUSt3R checkpoint key {key!r}")


def convert_dust3r_state_dict(state: dict, spec: Dust3rSpec | None = None) -> dict[str, torch.Tensor]:
    """Released checkpoint state dict (name -> tensor or array) -> the
    port's `AsymmetricCroCoStereo` state dict, in fp32. Raises KeyError if
    a key the graph needs is missing."""
    spec = spec or Dust3rSpec()
    out = {}
    for key, val in state.items():
        name = port_key(key)
        if name is not None:
            out[name] = torch.as_tensor(val).float()
    missing = sorted(set(expected_torch_keys(spec)) - set(state))
    if missing:
        raise KeyError(f"DUSt3R checkpoint lacks {len(missing)} keys, e.g. {missing[:8]}")
    return out


def expected_torch_keys(spec: Dust3rSpec) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every released checkpoint key the graph uses: a
    manifest to synthesize a checkpoint-shaped dict in tests and to check a
    real checkpoint before conversion."""
    E, D = spec.enc_dim, spec.dec_dim
    P = spec.patch_size
    keys: dict[str, tuple[int, ...]] = {
        "patch_embed.proj.weight": (E, 3, P, P),
        "patch_embed.proj.bias": (E,),
        "enc_norm.weight": (E,),
        "enc_norm.bias": (E,),
        "decoder_embed.weight": (D, E),
        "decoder_embed.bias": (D,),
        "dec_norm.weight": (D,),
        "dec_norm.bias": (D,),
    }

    def ln(p, dim):
        keys[p + ".weight"] = (dim,)
        keys[p + ".bias"] = (dim,)

    def dense(p, o, i):
        keys[p + ".weight"] = (o, i)
        keys[p + ".bias"] = (o,)

    def conv(p, o, i, k, bias=True):
        keys[p + ".weight"] = (o, i, k, k)
        if bias:
            keys[p + ".bias"] = (o,)

    def convT(p, i, o, k):
        keys[p + ".weight"] = (i, o, k, k)
        keys[p + ".bias"] = (o,)

    hidden_e, hidden_d = int(E * spec.mlp_ratio), int(D * spec.mlp_ratio)
    for i in range(spec.enc_depth):
        p = f"enc_blocks.{i}"
        ln(p + ".norm1", E)
        dense(p + ".attn.qkv", 3 * E, E)
        dense(p + ".attn.proj", E, E)
        ln(p + ".norm2", E)
        dense(p + ".mlp.fc1", hidden_e, E)
        dense(p + ".mlp.fc2", E, hidden_e)
    for side in ("dec_blocks", "dec_blocks2"):
        for i in range(spec.dec_depth):
            p = f"{side}.{i}"
            ln(p + ".norm1", D)
            dense(p + ".attn.qkv", 3 * D, D)
            dense(p + ".attn.proj", D, D)
            ln(p + ".norm_y", D)
            ln(p + ".norm2", D)
            for q in ("projq", "projk", "projv", "proj"):
                dense(p + f".cross_attn.{q}", D, D)
            ln(p + ".norm3", D)
            dense(p + ".mlp.fc1", hidden_d, D)
            dense(p + ".mlp.fc2", D, hidden_d)

    ld, fd = spec.dpt_layer_dims, spec.dpt_feature_dim
    dims_in = (E, D, D, D)
    for n in (1, 2):
        p = f"downstream_head{n}.dpt"
        conv(p + ".act_1_postprocess.0", ld[0], dims_in[0], 1)
        convT(p + ".act_1_postprocess.1", ld[0], ld[0], 4)
        conv(p + ".act_2_postprocess.0", ld[1], dims_in[1], 1)
        convT(p + ".act_2_postprocess.1", ld[1], ld[1], 2)
        conv(p + ".act_3_postprocess.0", ld[2], dims_in[2], 1)
        conv(p + ".act_4_postprocess.0", ld[3], dims_in[3], 1)
        conv(p + ".act_4_postprocess.1", ld[3], ld[3], 3)
        for i in range(1, 5):
            conv(p + f".scratch.layer{i}_rn", fd, ld[i - 1], 3, bias=False)
            for unit in ("resConfUnit1", "resConfUnit2"):
                if i == 4 and unit == "resConfUnit1":
                    continue  # unused in the graph
                conv(p + f".scratch.refinenet{i}.{unit}.conv1", fd, fd, 3)
                conv(p + f".scratch.refinenet{i}.{unit}.conv2", fd, fd, 3)
            conv(p + f".scratch.refinenet{i}.out_conv", fd, fd, 1)
        conv(p + ".head.0", fd // 2, fd, 3)
        conv(p + ".head.2", spec.dpt_last_dim, fd // 2, 3)
        conv(p + ".head.4", spec.out_channels, spec.dpt_last_dim, 1)
    return keys
