"""The port's LPIPS (models/lpips.py) against the JAX package's.

Seeded numpy state dicts in the released layouts (torchvision vgg16 and the
lpips package's heads) go through both converters; both score the same
64x64 pairs on the CPU in fp32 and agree to 1e-5 relative.
"""

import jax
import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu.models import lpips as jax_lpips
from stable_virtual_camera_tpu_torch.models import lpips as port_lpips

REL = 1e-5


def _released_state_dicts(seed: int = 0):
    """torchvision `features.{idx}.weight/bias` (OIHW, He-scaled so the
    activations stay O(1) through 13 convs) and lpips `lin{i}.model.1.weight`
    ((1, C, 1, 1), non-negative as the released heads are), as numpy."""
    rng = np.random.default_rng(seed)
    vgg, c_in = {}, 3
    for idx, c_out in port_lpips._VGG16_CONVS:
        vgg[f"features.{idx}.weight"] = rng.normal(
            0, np.sqrt(2.0 / (9 * c_in)), (c_out, c_in, 3, 3)).astype(np.float32)
        vgg[f"features.{idx}.bias"] = rng.normal(0, 0.05, (c_out,)).astype(np.float32)
        c_in = c_out
    lin = {f"lin{i}.model.1.weight": rng.uniform(0, 0.2, (1, c, 1, 1)).astype(np.float32)
           for i, c in enumerate((64, 128, 256, 512, 512))}
    return vgg, lin


@pytest.fixture(scope="module")
def scorers():
    vgg, lin = _released_state_dicts()
    jax_score = jax_lpips.lpips_apply_fn(jax_lpips.convert_lpips(vgg, lin))
    port_score = port_lpips.lpips_apply_fn(port_lpips.convert_lpips(vgg, lin), device="cpu")
    return jax_score, port_score


@pytest.mark.parametrize("pair", ["random", "nudged"])
def test_scores_match_jax(scorers, pair):
    jax_score, port_score = scorers
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    if pair == "random":
        b = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    else:
        b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    want, got = jax_score(a, b), port_score(a, b)
    assert want > 0
    assert abs(got - want) <= REL * abs(want), (got, want)


def test_identity_scores_zero(scorers):
    _, port_score = scorers
    x = np.random.default_rng(2).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    assert port_score(x, x) == 0.0


def test_converter_layout_and_refusals():
    vgg, lin = _released_state_dicts()
    params = port_lpips.convert_lpips(vgg, lin)
    flax_params = jax_lpips.convert_lpips(vgg, lin)
    for idx, _ in port_lpips._VGG16_CONVS:
        np.testing.assert_array_equal(
            params[f"vgg.conv{idx}.weight"].numpy(),
            np.transpose(flax_params["vgg"][f"conv{idx}"]["kernel"], (3, 2, 0, 1)))
    for i in range(5):
        np.testing.assert_array_equal(
            params[f"lin{i}.weight"].numpy(),
            np.transpose(flax_params[f"lin{i}"]["kernel"], (3, 2, 0, 1)))
    vgg["features.0.weight"] = vgg["features.0.weight"][:32]
    with pytest.raises(ValueError, match="features.0.weight"):
        port_lpips.convert_lpips(vgg, lin)


def test_synthetic_params_have_the_jax_topology():
    ours = port_lpips.synthetic_lpips_params(seed=3)
    theirs = jax.eval_shape(jax_lpips.synthetic_lpips_params)
    assert len(ours) == len(jax.tree_util.tree_leaves(theirs))
    for idx, _ in port_lpips._VGG16_CONVS:
        h, w, i, o = theirs["vgg"][f"conv{idx}"]["kernel"].shape
        assert tuple(ours[f"vgg.conv{idx}.weight"].shape) == (o, i, h, w)
        assert not ours[f"vgg.conv{idx}.bias"].any()
    assert torch.equal(ours["vgg.conv0.weight"], port_lpips.synthetic_lpips_params(seed=3)["vgg.conv0.weight"])


def test_save_load_roundtrip_is_bit_equal(tmp_path):
    params = port_lpips.synthetic_lpips_params(seed=3)
    path = str(tmp_path / "lpips.safetensors")
    port_lpips.save_lpips(params, path)
    loaded = port_lpips.load_lpips(path)
    assert loaded.keys() == params.keys()
    for k, v in params.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
