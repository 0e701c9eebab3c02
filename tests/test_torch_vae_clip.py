"""The port's SD2.1 VAE and CLIP tower against the JAX package's, on the CPU in
fp32, with the same (bridged) weights and numpy-seeded inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_weights import port_and_flax_params


@pytest.fixture(scope="module")
def bridged():
    return port_and_flax_params(seed=4)


def _jax_vae():
    from stable_virtual_camera_tpu.models.vae import AutoEncoderKL

    return AutoEncoderKL()


def test_vae_encode_matches_jax(bridged):
    bundle, trees = bridged
    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 32, 24, 3)).astype(np.float32)
    ref = _jax_vae().apply({"params": trees["vae"]}, jnp.asarray(x), method="encode")
    with torch.inference_mode():
        out = bundle.vae.module.encode(torch.from_numpy(x))
    assert out.shape == (2, 4, 3, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_vae_decode_and_uint8_match_jax(bridged):
    """decode in fp32, and decode_uint8 with the writer's op order: bytes may
    differ only where the fp32 values straddle an integer."""
    bundle, trees = bridged
    z = np.random.default_rng(1).normal(size=(2, 3, 4, 4)).astype(np.float32)
    vae = _jax_vae()
    ref = np.asarray(vae.apply({"params": trees["vae"]}, jnp.asarray(z), method="decode"))
    ref_u8 = np.asarray(vae.apply({"params": trees["vae"]}, jnp.asarray(z), method="decode_uint8"))
    with torch.inference_mode():
        out = bundle.vae.module.decode(torch.from_numpy(z))
        out_u8 = bundle.vae.module.decode_uint8(torch.from_numpy(z))
    assert out.shape == (2, 24, 32, 3) and out_u8.dtype == torch.uint8
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    diff = np.abs(out_u8.numpy().astype(np.int16) - ref_u8.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


def test_vae_applier_chunks_and_caches(bridged):
    """The engine's applier: chunked encodes equal one batch, and the
    content-keyed cache returns the same latents without re-encoding."""
    bundle, _ = bridged
    vae = bundle.vae
    imgs = np.random.default_rng(2).uniform(-1, 1, size=(3, 16, 16, 3)).astype(np.float32)
    vae.clear_cache()
    full = vae.encode(imgs)
    np.testing.assert_allclose(vae.encode(imgs, chunk_size=2), full, atol=1e-6)
    calls = []
    orig = vae.encode
    vae.encode = lambda x, c=None: calls.append(len(x)) or orig(x, c)
    try:
        first = vae.encode_cached(imgs[:2])
        again = vae.encode_cached(imgs[[1, 2, 0]])
    finally:
        del vae.encode
    assert calls == [2, 1]  # the second call encodes only the unseen frame
    np.testing.assert_allclose(again[[2, 0]], first, atol=0)
    np.testing.assert_allclose(again, full[[1, 2, 0]], atol=1e-6)


def test_tiny_clip_tower_matches_jax(bridged):
    from stable_virtual_camera_tpu.models.clip import ClipVisionSpec, ClipVisionTower

    bundle, trees = bridged
    pixels = np.random.default_rng(3).normal(size=(2, 28, 28, 3)).astype(np.float32)
    ref = ClipVisionTower(ClipVisionSpec.tiny()).apply({"params": trees["clip"]}, jnp.asarray(pixels))
    with torch.inference_mode():
        out = bundle.clip.module(torch.from_numpy(pixels))
    assert out.shape == (2, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_clip_applier_matches_jax_preprocess_and_tower(bridged):
    """ClipApplier.embed: [-1, 1] images through the bicubic preprocess and
    the tower, as the JAX engine's ClipApplier computes them."""
    from stable_virtual_camera_tpu.models.clip import ClipVisionSpec, ClipVisionTower, preprocess

    bundle, trees = bridged
    imgs = np.random.default_rng(5).uniform(-1, 1, size=(2, 64, 48, 3)).astype(np.float32)
    ref = ClipVisionTower(ClipVisionSpec.tiny()).apply(
        {"params": trees["clip"]}, preprocess(jnp.asarray(imgs), 28)
    )
    np.testing.assert_allclose(bundle.clip.embed(imgs), np.asarray(ref), atol=1e-4, rtol=1e-4)
