"""The PyTorch port's plain ops against their JAX counterparts, on the CPU.

Inputs come from numpy with a fixed seed and go through both sides in fp32.
The kernel wrappers (K1 flash attention, K2 temporal attention) take their
plain versions here because the tensors lie on the CPU; the JAX side runs its
Pallas kernels in interpret mode, as the JAX package's own tests do.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.ops import attention as t_attn
from stable_virtual_camera_tpu_torch.ops.flash_upstream import flash_attention_upstream_bhld
from stable_virtual_camera_tpu_torch.ops.norms import group_norm_nhwc, layer_norm_fp32
from stable_virtual_camera_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
    upsample_2x_conv3x3,
)
from stable_virtual_camera_tpu_torch.ops.time_attention import time_attention_bhds


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("L", [1296, 1100])  # 1100 is padded and masked on the JAX side
def test_flash_plain_matches_upstream_kernel(L):
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.ops.flash_upstream import flash_attention_upstream_bhld as jax_fa

    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, (1, 2, L, 64)) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = flash_attention_upstream_bhld(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_time_plain_matches_pallas_kernel():
    from stable_virtual_camera_tpu.ops.time_attention import time_attention_bhds as jax_ta

    rng = np.random.default_rng(7)
    b, T, S, H, D = 2, 21, 81, 2, 64
    q, k, v = (_normal(rng, (b * T, H, D, S)) for _ in range(3))
    ref = np.asarray(jax_ta(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), T, s_block=128, interpret=True))
    out = time_attention_bhds(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), T)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("S", [300, 5000])  # einsum path, and the chunked path past 4096 keys
def test_sdpa_packed_matches_jax(S):
    from stable_virtual_camera_tpu.ops.attention import sdpa_packed as jax_sdpa

    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, (1, S, 2 * 32)) for _ in range(3))
    ref = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2))
    out = t_attn.sdpa_packed(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_attention_chunked_matches_jax():
    from stable_virtual_camera_tpu.ops.attention import attention_chunked as jax_chunked

    rng = np.random.default_rng(2)
    q, k, v = (_normal(rng, (2, 1500, 2, 64)) for _ in range(3))
    ref = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_chunk=512))
    out = t_attn.attention_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_chunk=512)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape,groups,eps", [((2, 9, 9, 64), 32, 1e-5), ((3, 50, 96), 32, 1e-6)])
def test_group_norm_matches_jax(shape, groups, eps):
    from stable_virtual_camera_tpu.ops.norms import group_norm_nhwc as jax_gn

    rng = np.random.default_rng(5)
    x = _normal(rng, shape, 3.0) + 2.0
    g, b = _normal(rng, shape[-1:]), _normal(rng, shape[-1:])
    ref = np.asarray(jax_gn(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups, eps))
    out = group_norm_nhwc(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), groups, eps)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_layer_norm_matches_jax():
    from stable_virtual_camera_tpu.ops.norms import layer_norm_fp32 as jax_ln

    rng = np.random.default_rng(6)
    x = _normal(rng, (4, 33, 320), 2.0) + 1.0
    g, b = _normal(rng, (320,)), _normal(rng, (320,))
    ref = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    out = layer_norm_fp32(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("hw_in,hw_out", [((72, 72), (36, 36)), ((72, 72), (9, 9)), ((5, 7), (13, 3))])
def test_align_corners_resize_matches_jax(hw_in, hw_out):
    from stable_virtual_camera_tpu.ops.resize import resize_bilinear_align_corners as jax_resize

    x = _normal(np.random.default_rng(3), (2, *hw_in, 6))
    ref = np.asarray(jax_resize(jnp.asarray(x), hw_out))
    out = resize_bilinear_align_corners(torch.from_numpy(x), hw_out)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_upsample_conv_matches_jax():
    from stable_virtual_camera_tpu.ops.resize import upsample_2x_conv3x3 as jax_up

    rng = np.random.default_rng(4)
    x = _normal(rng, (2, 9, 7, 16))
    w_hwio = _normal(rng, (3, 3, 16, 8), 0.2)
    bias = _normal(rng, (8,))
    ref = np.asarray(jax_up(jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(bias)))
    w_oihw = torch.from_numpy(w_hwio).permute(3, 2, 0, 1).contiguous()
    out = upsample_2x_conv3x3(torch.from_numpy(x), w_oihw, torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("hw,size", [((576, 576), 224), ((64, 64), 28), ((48, 80), 224)])
def test_clip_preprocess_matches_jax_bicubic(hw, size):
    """The explicit antialiased Keys-cubic matrices equal jax.image.resize's
    bicubic (torch's own bicubic uses a = -0.75 and does not antialias)."""
    from stable_virtual_camera_tpu.models.clip import preprocess as jax_pre
    from stable_virtual_camera_tpu_torch.models.clip import preprocess

    x = np.random.default_rng(8).uniform(-1, 1, size=(2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax_pre(jnp.asarray(x), size))
    out = preprocess(torch.from_numpy(x), size)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("hw,size,mode", [
    ((96, 128), (64, 64), "crop"),   # integer shrink (2x) then crop
    ((100, 75), (64, 48), "crop"),   # fractional shrink
    ((64, 64), (64, 64), "crop"),    # identity
    ((80, 64), (64, 64), "pad"),
])
def test_transform_img_and_K_matches_jax(hw, size, mode):
    """The port's area resize (no OpenCV) against the JAX package's
    cv2.INTER_AREA path, with the same K update; `transform_K` gives the K
    update without the image."""
    from stable_virtual_camera_tpu.core.transforms import transform_img_and_K as jax_t
    from stable_virtual_camera_tpu_torch.core.transforms import transform_img_and_K, transform_K

    rng = np.random.default_rng(9)
    img = rng.uniform(-1, 1, size=(2, *hw, 3)).astype(np.float32)
    K = np.array([[[50.0, 0, hw[1] / 2], [0, 50.0, hw[0] / 2], [0, 0, 1]],
                  [[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]]])
    ref_img, ref_K = jax_t(img, size, K=K, mode=mode)
    out_img, out_K = transform_img_and_K(img, size, K=K, mode=mode)
    assert out_img.shape == ref_img.shape
    np.testing.assert_allclose(out_img, ref_img, atol=1e-5)
    np.testing.assert_allclose(out_K, ref_K, atol=1e-9)
    np.testing.assert_allclose(transform_K(hw, size, K, mode=mode), ref_K, atol=1e-9)
