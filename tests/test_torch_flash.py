"""The port's K3 and K4 modules against the JAX package on the CPU, in fp32:
the plain twins against the in-repo Pallas kernels in interpret mode, K3's
recompute gradient against JAX's custom VJP, the `supported` predicates,
SelfAttention with attention="flash" / "packed" against the JAX Attention
with the SVC_UPSTREAM_FLASH / SVC_PACKED_ATTENTION knobs set, and the
attention backends of SevaUNet against the JAX UNet.

Inputs are numpy draws with fixed seeds. Tolerances: 2e-4 where both sides
compute the same fp32 online softmax (the order of the key chunks differs);
atol 5e-4 / rtol 1e-3 for the gradient, as tests/test_flash_attention.py
holds the JAX recompute VJP; SelfAttention and the UNet as
tests/test_torch_unet.py holds the K1 route.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.ops import attention as t_attn
from stable_virtual_camera_tpu_torch.ops import flash_attention as t_fa
from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as t_fap


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 1296, 3, 64), (1, 1500, 2, 64)])
def test_k3_plain_matches_pallas_kernel(shape):
    """K3's plain twin against `_flash_kernel` in interpret mode; L=1500 is
    padded to the JAX kernel's blocks and masked."""
    from stable_virtual_camera_tpu.ops import flash_attention as jax_fa

    rng = np.random.default_rng(shape[1])
    q, k, v = (_normal(rng, shape) for _ in range(3))
    ref = np.asarray(jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    out = t_fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("B,L,heads", [(2, 1701, 4), (1, 1200, 2)])
def test_k4_plain_matches_pallas_kernel(B, L, heads):
    from stable_virtual_camera_tpu.ops.flash_attention_packed import flash_attention_packed as jax_fap

    rng = np.random.default_rng(L + heads)
    q, k, v = (_normal(rng, (B, L, heads * 64)) for _ in range(3))
    ref = np.asarray(jax_fap(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, interpret=True))
    out = t_fap.flash_attention_packed(*map(torch.from_numpy, (q, k, v)), heads)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)


def test_k3_trainable_gradient_matches_jax_vjp():
    """FlashAttentionTrainableFn's recompute backward against jax.grad of
    flash_attention_trainable (Pallas forward in interpret mode, VJP through
    attention_chunked)."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.ops.attention import flash_attention_trainable as jax_trainable

    rng = np.random.default_rng(21)
    q, k, v = (_normal(rng, (1, 1280, 2, 64)) for _ in range(3))
    w = _normal(rng, (1, 1280, 2, 64))

    def loss(q, k, v):
        return jnp.sum(jax_trainable(q, k, v) * w)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (t_fa.flash_attention_trainable(*leaves) * torch.from_numpy(w)).sum().backward()
    for t, r in zip(leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 1024, 3, 64), "float32"), ((2, 1023, 3, 64), "float32"), ((1, 2048, 2, 32), "float32"),
    ((1, 1296, 5, 64), "bfloat16"), ((1, 1296, 5, 64), "float16"),
])
def test_k3_supported_matches_jax(shape, dtype):
    from stable_virtual_camera_tpu.ops import flash_attention as jax_fa

    x = np.zeros(shape, np.float32)
    ours = t_fa.supported(*(torch.from_numpy(x).to(getattr(torch, dtype)),) * 3)
    theirs = jax_fa.supported(*(jnp.asarray(x, getattr(jnp, dtype)),) * 3)
    assert ours == theirs


@pytest.mark.parametrize("L,S,heads,W,dtype", [
    (1024, 1024, 2, 128, "float32"), (1296, 1296, 5, 320, "float32"), (1023, 1023, 2, 128, "float32"),
    (1296, 1296, 2, 64, "float32"), (1200, 1000, 2, 128, "float32"), (1296, 1296, 10, 640, "bfloat16"),
    (1296, 1296, 10, 640, "float16"),
])
def test_k4_supported_matches_jax(L, S, heads, W, dtype):
    from stable_virtual_camera_tpu.ops import flash_attention_packed as jax_fap

    q, k = np.zeros((1, L, W), np.float32), np.zeros((1, S, W), np.float32)
    ours = t_fap.supported(torch.from_numpy(q).to(getattr(torch, dtype)), torch.from_numpy(k), heads)
    theirs = jax_fap.supported(jnp.asarray(q, getattr(jnp, dtype)), jnp.asarray(k), heads)
    assert ours == theirs


@pytest.mark.parametrize("backend,heads", [("flash", 2), ("flash", 5), ("packed", 2), ("packed", 5)])
def test_self_attention_backends_match_jax(monkeypatch, backend, heads):
    """SelfAttention(attention=backend) against the JAX Attention with
    use_pallas and the knobs that select the same kernel: heads 2 (W=128)
    takes K4 under "packed", heads 5 (W=320) falls back to K3."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.models.unet import Attention
    from stable_virtual_camera_tpu_torch.models import unet as t_unet
    from stable_virtual_camera_tpu_torch.models.weights import load_flax_params

    monkeypatch.setenv("SVC_UPSTREAM_FLASH", "0")
    monkeypatch.setenv("SVC_PACKED_ATTENTION", "1" if backend == "packed" else "0")
    calls = []
    for mod, name in ((t_fa, "flash_attention"), (t_fap, "flash_attention_packed")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    rng = np.random.default_rng(heads)
    C = heads * 64
    x = (rng.normal(size=(2, 1100, C)) * 0.3).astype(np.float32)
    params = Attention(heads=heads, dim_head=64).init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = t_unet.SelfAttention(C, heads, 64, attention=backend)
    load_flax_params(port, params["params"])
    with pltpu.force_tpu_interpret_mode():
        ref = Attention(heads=heads, dim_head=64, use_pallas=True).apply(params, jnp.asarray(x))
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert calls == ["flash_attention_packed" if backend == "packed" and heads == 2 else "flash_attention"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-2)


def test_backend_names_are_checked():
    from stable_virtual_camera_tpu_torch.models import unet as t_unet

    with pytest.raises(ValueError, match="attention backend"):
        t_unet.SelfAttention(128, 2, 64, attention="xla")
    x = torch.zeros((1, 8, 128))
    with pytest.raises(ValueError, match="attention backend"):
        t_attn.sdpa_packed(x, x, x, 2, backend="pallas")
