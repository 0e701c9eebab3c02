"""The port's SevaUNet and its attention dispatch against the JAX package, on
the CPU, with the same weights (bridged) and numpy-seeded inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models import unet as t_unet
from stable_virtual_camera_tpu_torch.models.weights import load_flax_params
from test_torch_weights import port_and_flax_params

T = 3


@pytest.fixture(scope="module")
def bridged():
    return port_and_flax_params(seed=2)


def _unet_inputs(rng, n, hw=8, ctx=64):
    return (
        rng.normal(size=(n, hw, hw, 11)).astype(np.float32),
        rng.integers(0, 1000, size=(n,)).astype(np.int32),
        rng.normal(size=(n, 1, ctx)).astype(np.float32),
        rng.normal(size=(n, hw, hw, 6)).astype(np.float32),
    )


def test_tiny_unet_matches_jax_fp32(bridged):
    """Tiny SevaUNet (every block kind, joint and per-frame attention,
    time-mix) against JAX SevaUNet(use_pallas=False), fp32."""
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet

    bundle, trees = bridged
    x, t, c, d = _unet_inputs(np.random.default_rng(0), 2 * T)
    ref = JaxUNet(JaxSevaSpec.tiny()).apply(
        {"params": trees["unet"]}, *map(jnp.asarray, (x, t, c, d)), num_frames=T
    )
    with torch.inference_mode():
        out = bundle.unet(*map(torch.from_numpy, (x, t, c, d)), T)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_tiny_unet_bf16_smoke(bridged):
    """The same UNet in bf16: finite fp32 output near the fp32 result."""
    bundle, _ = bridged
    x, t, c, d = map(torch.from_numpy, _unet_inputs(np.random.default_rng(1), 2 * T))
    with torch.inference_mode():
        ref = bundle.unet(x, t, c, d, T)
        unet16 = t_unet.SevaUNet(SevaSpec.tiny())
        unet16.load_state_dict(bundle.unet.state_dict())
        out = unet16.to(torch.bfloat16)(x, t, c, d, T)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 5e-2


def _attention_pair(heads, dim_head, query_dim, x, **call):
    """A JAX Attention's params and the port SelfAttention holding them."""
    from stable_virtual_camera_tpu.models.unet import Attention

    params = Attention(heads=heads, dim_head=dim_head).init(jax.random.PRNGKey(0), jnp.asarray(x), **call)
    port = t_unet.SelfAttention(query_dim, heads, dim_head)
    load_flax_params(port, params["params"])
    return params, port


def test_flash_path_attention_matches_jax_kernel():
    """Self-attention at dim_head 64, L=1296 takes the flash (K1) route on both
    sides: JAX's upstream Pallas kernel in interpret mode, the port's plain
    twin on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.models.unet import Attention

    rng = np.random.default_rng(17)
    x = (rng.normal(size=(2, 1296, 128)) * 0.3).astype(np.float32)
    params, port = _attention_pair(2, 64, 128, x)
    with pltpu.force_tpu_interpret_mode():
        ref = Attention(heads=2, dim_head=64, use_pallas=True).apply(params, jnp.asarray(x))
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-2)


def test_time_path_attention_matches_jax_kernel(monkeypatch):
    """Temporal attention (T=21 frames, dim_head 64) takes the K2 route on both
    sides: JAX's Pallas kernel in interpret mode, the port's plain twin."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.models.unet import Attention

    monkeypatch.setenv("SVC_TIME_PALLAS", "1")  # past the JAX platform gate
    rng = np.random.default_rng(9)
    b, frames, S, C = 2, 21, 81, 128
    x = rng.normal(size=(b * frames, S, C)).astype(np.float32)
    params, port = _attention_pair(2, 64, C, x, time_frames=frames)
    with pltpu.force_tpu_interpret_mode():
        ref = Attention(heads=2, dim_head=64, use_pallas=True).apply(
            params, jnp.asarray(x), time_frames=frames
        )
    with torch.inference_mode():
        out = port(torch.from_numpy(x), time_frames=frames)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-2)


_ROUTES = [
    # (backend, L, dim_head, time_frames, route[, id]); the upstream cases
    # keep the ids they had before the backend option, and the head-dim-16
    # temporal case the id it had before K2 took every head dim
    ("upstream", 1024, 64, None, "flash"),   # shortest flash sequence
    ("upstream", 1023, 64, None, "plain"),   # one token short
    ("upstream", 2048, 32, None, "plain"),   # head dim the kernel does not take
    ("upstream", 16, 64, 4, "time"),         # temporal, T <= 32
    ("upstream", 16, 64, 33, "plain"),       # temporal past the kernel's frame cap
    ("flash", 1024, 64, None, "k3"),
    ("flash", 1023, 64, None, "plain"),
    ("flash", 2048, 32, None, "plain"),
    ("flash", 16, 64, 4, "time"),
    ("flash", 16, 64, 33, "plain"),
    ("packed", 1024, 64, None, "k4"),        # 2 heads: W = 128
    ("packed", 1023, 64, None, "plain"),
    ("packed", 2048, 32, None, "plain"),     # W = 64: neither K4 nor K3
    ("packed", 16, 64, 4, "time"),
    ("packed", 16, 64, 33, "plain"),
    ("plain", 1024, 64, None, "plain"),      # no kernel
    ("plain", 16, 64, 4, "plain"),
    ("upstream", 16, 32, 4, "time", "16-32-4-plain"),  # K2 takes every head dim
]


@pytest.mark.parametrize(
    "backend,L,dim_head,time_frames,route",
    [pytest.param(*case[:5], id=case[5] if len(case) > 5
                  else "-".join(map(str, case[1:] if case[0] == "upstream" else case)))
     for case in _ROUTES],
)
def test_attention_dispatch_follows_jax(monkeypatch, backend, L, dim_head, time_frames, route):
    """Which route each shape takes under each backend: "upstream" sends
    dim_head 64 and L >= 1024 to K1; "flash" sends them to K3 and "packed"
    to K4 (W % 128 == 0) through sdpa_packed; K2 takes T <= 32 frames under
    every backend; plain SDPA/einsum otherwise (models/unet.py:252-453,
    ops/attention.py:126-194)."""
    from stable_virtual_camera_tpu_torch.ops import flash_attention as t_fa
    from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as t_fap

    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(t_unet, "flash_attention_upstream_bhld",
                        spy("flash", t_unet.flash_attention_upstream_bhld))
    monkeypatch.setattr(t_unet, "time_attention_bhds", spy("time", t_unet.time_attention_bhds))
    monkeypatch.setattr(t_fa, "flash_attention", spy("k3", t_fa.flash_attention))
    monkeypatch.setattr(t_fap, "flash_attention_packed", spy("k4", t_fap.flash_attention_packed))
    heads = 2
    attn = t_unet.SelfAttention(heads * dim_head, heads, dim_head, attention=backend)
    n = 2 * time_frames if time_frames else 1
    x = torch.randn(n, L, heads * dim_head)
    with torch.inference_mode():
        attn(x, time_frames=time_frames)
    assert calls == ([] if route == "plain" else [route])


@pytest.mark.parametrize("dtype,approximate", [(torch.bfloat16, "tanh"), (torch.float32, "none")])
def test_geglu_uses_tanh_gelu_in_bf16_and_erf_in_fp32(dtype, approximate):
    """The JAX package's GELU policy (models/unet.py:489-495): an erf GELU in
    bf16 would differ from the tanh one the JAX side computes there."""
    torch.manual_seed(0)
    ff = t_unet.FeedForward(16).to(dtype)
    x = torch.randn(3, 5, 16).to(dtype)
    with torch.inference_mode():
        val, gate = ff.proj_gate(x).chunk(2, dim=-1)
        ref = ff.proj_out(val * torch.nn.functional.gelu(gate, approximate=approximate))
        assert torch.equal(ff(x), ref)
