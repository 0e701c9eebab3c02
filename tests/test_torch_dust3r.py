"""The port's DUSt3R network (models/dust3r.py), its checkpoint key map
(models/convert_dust3r.py) and loader (models/io.py `load_dust3r_state`)
against the JAX package's, on the CPU in fp32, at `Dust3rSpec.tiny()`.

The released checkpoint is not in the repository, so a synthetic checkpoint
with its key layout (the JAX package's `expected_torch_keys`, values drawn
as in tests/test_dust3r.py) is saved with `torch.save` and loaded by both
packages. The two forwards at mixed aspects (a 32x48 view against a 48x32
view) agree at rtol 2e-3, atol 2e-4, the bar the JAX package holds its
network to against a torch mirror (tests/test_dust3r.py).
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu.models import convert_dust3r as jax_convert
from stable_virtual_camera_tpu.models import dust3r as jax_dust3r
from stable_virtual_camera_tpu_torch.models import convert_dust3r, dust3r
from stable_virtual_camera_tpu_torch.models.io import load_dust3r_state
from stable_virtual_camera_tpu_torch.models.weights import flax_to_state_dict, to_flax_tree

SPEC = dust3r.Dust3rSpec.tiny()
JAX_SPEC = jax_dust3r.Dust3rSpec.tiny()
TOL = dict(rtol=2e-3, atol=2e-4)
JAX_MODEL = jax_dust3r.AsymmetricCroCoStereo(JAX_SPEC)
# one compiled forward for every test (eager flax dispatch takes ~20 s here)
jax_forward = jax.jit(lambda params, a, b: JAX_MODEL.apply({"params": params}, a, b))


@pytest.fixture(autouse=True)
def _few_threads():
    """Small CPU ops: two intra-op threads each avoid oversubscribing the
    cores that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)



def synthetic_state(seed: int = 0) -> dict[str, np.ndarray]:
    """A checkpoint-shaped dict over the released key names (the scheme of
    tests/test_dust3r.py), plus the leftovers the converters skip."""
    rng = np.random.RandomState(seed)
    state = {}
    for k, shape in jax_convert.expected_torch_keys(JAX_SPEC).items():
        if k.endswith(".bias"):
            state[k] = rng.randn(*shape).astype(np.float32) * 0.01
        elif "norm" in k and k.endswith(".weight") and len(shape) == 1:
            state[k] = 1.0 + rng.randn(*shape).astype(np.float32) * 0.01
        else:
            state[k] = rng.randn(*shape).astype(np.float32) * 0.05
    state["mask_token"] = np.zeros((1, 1, SPEC.enc_dim), np.float32)
    state["downstream_head1.dpt.act_postprocess.0.0.weight"] = state[
        "downstream_head1.dpt.act_1_postprocess.0.weight"]
    return state


def save_checkpoint(path, state, with_args: bool = True) -> str:
    """torch.save in the released layout: {"model": state dict, "args": ...};
    the released file pickles an argparse.Namespace, which weights_only
    loading refuses."""
    ckpt = {"model": {k: torch.from_numpy(v) for k, v in state.items()}}
    if with_args:
        ckpt["args"] = argparse.Namespace(model="AsymmetricCroCo3DStereo")
    torch.save(ckpt, str(path))
    return str(path)


def _images(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, 32, 48, 3).astype(np.float32) * 2 - 1,
            rng.rand(2, 48, 32, 3).astype(np.float32) * 2 - 1)


def _assert_outputs_close(out, ref):
    for pred, keys in (("pred1", ("pts3d", "conf")), ("pred2", ("pts3d_in_other_view", "conf"))):
        for k in keys:
            np.testing.assert_allclose(out[pred][k].detach().numpy(), np.asarray(ref[pred][k]),
                                       err_msg=f"{pred}.{k}", **TOL)


def test_rope_2d_matches_jax():
    """Non-square grid positions, two heads, head dim 16 (two 8-wide halves)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 2, 12, 16)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(3), np.arange(4), indexing="ij")
    pos = np.stack([yy.ravel(), xx.ravel()], -1)
    ref = np.asarray(jax_dust3r.rope_2d(jnp.asarray(x), jnp.asarray(pos), 100.0))
    out = dust3r.rope_2d(torch.from_numpy(x), torch.from_numpy(pos), 100.0).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_state_dict_names_and_shapes_match_the_released_layout():
    """Every parameter of the port's module is one released key, mapped
    through convert_dust3r, with the released shape, and nothing else."""
    module = dust3r.AsymmetricCroCoStereo(SPEC)
    want = {convert_dust3r.port_key(k): shape
            for k, shape in jax_convert.expected_torch_keys(JAX_SPEC).items()}
    got = {n: tuple(t.shape) for n, t in module.state_dict().items()}
    assert got == want
    assert convert_dust3r.expected_torch_keys(SPEC) == jax_convert.expected_torch_keys(JAX_SPEC)


def test_key_map_skips_leftovers_and_refuses_unknown_keys():
    assert convert_dust3r.port_key("mask_token") is None
    assert convert_dust3r.port_key("downstream_head2.dpt.act_postprocess.3.1.weight") is None
    assert convert_dust3r.port_key(
        "downstream_head1.dpt.scratch.refinenet4.resConfUnit1.conv1.weight") is None
    assert convert_dust3r.port_key(
        "downstream_head2.dpt.scratch.refinenet3.resConfUnit1.conv2.bias") == "head2.refinenet3.rcu1.conv2.bias"
    assert convert_dust3r.port_key("dec_blocks2.3.norm_y.weight") == "dec2_block_3.norm_y.ln.weight"
    with pytest.raises(KeyError):
        convert_dust3r.port_key("enc_blocks.0.attn.unknown.weight")
    state = synthetic_state()
    del state["dec_norm.bias"]
    with pytest.raises(KeyError, match="dec_norm.bias"):
        convert_dust3r.convert_dust3r_state_dict(state, SPEC)


def test_synthetic_checkpoint_forward_matches_jax(tmp_path):
    """The same .pth through both loaders, then both forwards at mixed
    aspects: converter, ConvTranspose orientation, RoPE on non-square grids,
    the odd /32 grid of act4_down and the path4 crop."""
    from stable_virtual_camera_tpu.models.io import load_dust3r_params

    path = save_checkpoint(tmp_path / "dust3r.pth", synthetic_state())
    module = dust3r.AsymmetricCroCoStereo(SPEC)
    module.load_state_dict(load_dust3r_state(path, SPEC), strict=True)
    params = load_dust3r_params(path, spec=JAX_SPEC)

    i1, i2 = _images()
    with torch.no_grad():
        out = module(torch.from_numpy(i1), torch.from_numpy(i2))
    ref = jax_forward(params, jnp.asarray(i1), jnp.asarray(i2))
    assert out["pred1"]["pts3d"].shape == (2, 32, 48, 3)
    assert out["pred2"]["conf"].shape == (2, 48, 32)
    _assert_outputs_close(out, ref)


def test_load_dust3r_state_reads_a_plain_state_dict_and_refuses_safetensors(tmp_path):
    state = synthetic_state(seed=3)
    path = str(tmp_path / "plain.pt")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    sd = load_dust3r_state(path, SPEC)
    torch.testing.assert_close(sd["head1.act1_up.weight"],
                               torch.from_numpy(state["downstream_head1.dpt.act_1_postprocess.1.weight"]))
    with pytest.raises(NotImplementedError, match="item 2"):
        load_dust3r_state(str(tmp_path / "dust3r.safetensors"), SPEC)


def test_flax_bridge_round_trip_is_exact_and_forwards_agree():
    """A tree of the JAX model's structure (names and shapes from
    `jax.eval_shape` of its init, seeded values) -> flax_to_state_dict -> the
    port's module -> to_flax_tree gives the tree back bit for bit; the two
    forwards agree."""
    i1, i2 = _images(seed=2)
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(JAX_MODEL.init, jax.random.PRNGKey(0), jnp.asarray(i1), jnp.asarray(i2))
    tree = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.05).astype(np.float32), shapes["params"])
    module = dust3r.AsymmetricCroCoStereo(SPEC)
    module.load_state_dict(flax_to_state_dict(tree), strict=True)
    back = to_flax_tree(module, tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=jax.tree_util.keystr(path))
    with torch.no_grad():
        out = module(torch.from_numpy(i1), torch.from_numpy(i2))
    _assert_outputs_close(out, jax_forward(tree, jnp.asarray(i1), jnp.asarray(i2)))


def test_postprocess_clips_as_jax():
    xyz = np.array([[0.0, 0.0, 0.0], [1e-9, 0.0, 0.0], [50.0, 60.0, 70.0], [0.3, -0.4, 1.2]], np.float32)
    c = np.array([-100.0, -2.0, 0.5, 100.0], np.float32)
    np.testing.assert_allclose(dust3r.reg_dense_pts3d(torch.from_numpy(xyz)).numpy(),
                               np.asarray(jax_dust3r.reg_dense_pts3d(jnp.asarray(xyz))), rtol=1e-6)
    np.testing.assert_allclose(dust3r.reg_dense_conf(torch.from_numpy(c)).numpy(),
                               np.asarray(jax_dust3r.reg_dense_conf(jnp.asarray(c))), rtol=1e-6)
