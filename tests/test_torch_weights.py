"""The flax -> PyTorch weight bridge of the port (models/weights.py) and the
port's flax-default random initialisation (models/io.py), on the CPU.

The flax trees have exactly the JAX package's structure: their names and
shapes come from `jax.eval_shape` of the JAX models' `init` (tracing only;
a real init of the tiny UNet compiles for about a minute on a CPU), and
their values from the port's seeded `random_bundle`. The other
test_torch_*.py files share these trees through `port_and_flax_params`.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec
from stable_virtual_camera_tpu_torch.models.io import build_models, random_bundle
from stable_virtual_camera_tpu_torch.models.weights import (
    flax_to_state_dict,
    load_flax_params,
    to_flax_tree,
)


@functools.lru_cache(maxsize=None)
def jax_abstract_trees() -> dict:
    """Shapes of the JAX package's tiny UNet, VAE and tiny CLIP param trees."""
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.clip import ClipVisionSpec as JaxClipSpec
    from stable_virtual_camera_tpu.models.clip import ClipVisionTower
    from stable_virtual_camera_tpu.models.unet import SevaUNet
    from stable_virtual_camera_tpu.models.vae import AutoEncoderKL

    key, T = jax.random.PRNGKey(0), 3
    unet = SevaUNet(JaxSevaSpec.tiny())
    z = jnp.zeros
    return {
        "unet": jax.eval_shape(lambda: unet.init(
            key, z((T, 8, 8, 11)), z((T,), jnp.int32), z((T, 1, 64)), z((T, 8, 8, 6)), num_frames=T
        ))["params"],
        "vae": jax.eval_shape(lambda: AutoEncoderKL().init(key, z((1, 16, 16, 3))))["params"],
        "clip": jax.eval_shape(
            lambda: ClipVisionTower(JaxClipSpec.tiny()).init(key, z((1, 28, 28, 3)))
        )["params"],
    }


def port_and_flax_params(seed: int = 0):
    """A tiny fp32 CPU port bundle and the same weights as JAX-package flax
    trees {"unet", "vae", "clip"}."""
    bundle = random_bundle(device="cpu", generator=torch.Generator().manual_seed(seed))
    modules = {"unet": bundle.unet, "vae": bundle.vae.module, "clip": bundle.clip.module}
    trees = jax_abstract_trees()
    return bundle, {k: to_flax_tree(modules[k], trees[k]) for k in modules}


@pytest.fixture(scope="module")
def trees():
    return port_and_flax_params(seed=1)[1]


@pytest.fixture()
def modules():
    unet, vae, clip = build_models(SevaSpec.tiny(), ClipVisionSpec.tiny(), "cpu", torch.float32)
    return {"unet": unet, "vae": vae, "clip": clip}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("name", ["unet", "vae", "clip"])
def test_bridge_fills_every_parameter_from_every_leaf(trees, modules, name):
    module = load_flax_params(modules[name], trees[name])
    params = dict(module.named_parameters())
    leaves = list(_leaves(trees[name]))
    assert len(leaves) == len(params)
    for path, leaf in leaves:
        key = ".".join(path[:-1] + ({"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1]),))
        got = params[key].detach().numpy()
        if path[-1] == "kernel":
            got = got.T if got.ndim == 2 else got.transpose(2, 3, 1, 0)  # back to (in,out) / HWIO
        np.testing.assert_array_equal(got, leaf, err_msg=key)


def test_unused_time_mix_norm2_is_carried(trees, modules):
    """TransformerBlockTimeMix.norm2 is in the tree but unused by the forward;
    the bridge still carries it."""
    unet = load_flax_params(modules["unet"], trees["unet"])
    leaf = trees["unet"]["input_blocks_1_1"]["temporal_0"]["norm2"]["ln"]["scale"]
    np.testing.assert_array_equal(unet.input_blocks_1_1.temporal_0.norm2.ln.weight.detach().numpy(), leaf)


def _copy(tree):
    return {k: _copy(v) if hasattr(v, "items") else v for k, v in tree.items()}


def test_bridge_rejects_a_missing_leaf(trees, modules):
    tree = _copy(trees["unet"])
    del tree["out_conv"]["bias"]
    with pytest.raises(KeyError, match="missing.*out_conv.bias"):
        load_flax_params(modules["unet"], tree)


def test_bridge_rejects_a_leftover_leaf(trees, modules):
    tree = _copy(trees["clip"])
    tree["block_0"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unexpected.*block_0.extra.weight"):
        load_flax_params(modules["clip"], tree)


def test_bridge_rejects_a_wrong_shape(trees, modules):
    tree = _copy(trees["vae"])
    tree["quant_conv"]["bias"] = np.zeros((7,), np.float32)
    with pytest.raises(ValueError, match="quant_conv.bias"):
        load_flax_params(modules["vae"], tree)


def test_bridge_reads_bfloat16_leaves(trees):
    kernel = jnp.asarray(trees["unet"]["time_embed_0"]["kernel"]).astype(jnp.bfloat16)
    w = flax_to_state_dict({"time_embed_0": {"kernel": kernel}})["time_embed_0.weight"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(), np.asarray(kernel.astype(jnp.float32)).T)


def test_random_bundle_follows_flax_defaults():
    b1 = random_bundle(device="cpu", generator=torch.Generator().manual_seed(3))
    b2 = random_bundle(device="cpu", generator=torch.Generator().manual_seed(3))
    for (n1, p1), (_, p2) in zip(b1.unet.named_parameters(), b2.unet.named_parameters()):
        assert torch.equal(p1, p2), n1  # seeded: reproducible
    unet = b1.unet
    assert torch.all(unet.out_gn.gn.weight == 1) and torch.all(unet.out_gn.gn.bias == 0)
    assert torch.all(unet.time_embed_2.bias == 0)
    # lecun normal: std 1/sqrt(fan_in), truncated at 2 std
    for w in (b1.vae.module.decoder.up_0_resnet_0.conv1.weight, unet.time_embed_2.weight):
        fan_in = w[0].numel()
        assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
        assert w.abs().max().item() <= 2.0 / 0.8796256610342398 / np.sqrt(fan_in) * (1 + 1e-6)
    clip = b1.clip.module
    assert abs(clip.positional_embedding.std().item() - 0.02) < 0.005
