"""The inputs JAX's Pallas kernels take besides bf16 at head dim 64, on the
CPU: K2 at head dims 16 and 32 in fp32 and bf16 against the JAX kernel in
interpret mode, and what the port's launch routes pick for each input
(which needs no card: the routes read shapes, dtypes and strides only).

K2's op on CPU tensors runs its plain version, all arithmetic in fp32 as in
the JAX kernel, so fp32 agrees to fp32 rounding (rtol 1e-5) and bf16, where
both sides round only the output, to one bf16 step at the output's
magnitude. K1's, K3's and K4's fp32 entries compute the plain versions'
function, which tests/test_torch_ops.py and tests/test_torch_flash.py hold
against the JAX kernels in fp32 already; here only their routes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu
from stable_virtual_camera_tpu_torch.ops import time_attention as ta


def _bf16_steps(out: np.ndarray, ref: np.ndarray) -> float:
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-10))) - 7)
    return float((np.abs(out - ref) / step).max())


@pytest.mark.parametrize("T", [3, 21])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 32])
def test_k2_at_any_head_dim_matches_jax(D, dtype, T):
    """The op at head dims the Hopper K2 does not take, against JAX's
    `time_attention_bhds(..., interpret=True)` at 200 positions."""
    from stable_virtual_camera_tpu.ops.time_attention import time_attention_bhds as jax_ta

    rng = np.random.default_rng(D + T)
    b, H, S = 2, 2, 200
    q, k, v = (rng.normal(size=(b * T, H, D, S)).astype(np.float32) for _ in range(3))
    jdt = getattr(jnp, dtype)
    ref = np.asarray(jax_ta(*(jnp.asarray(a, jdt) for a in (q, k, v)), T, s_block=128, interpret=True),
                     np.float32)
    tdt = getattr(torch, dtype)
    ops = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    assert ta.k2_route(*ops, T) == "any"
    out = ta.time_attention_bhds(*ops, T)
    assert out.dtype == tdt and out.shape == (b * T, H, D, S)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    else:
        assert _bf16_steps(out.float().numpy(), ref) <= 1.0


def _views(D, dtype, S=9, T=3, b=2, H=2):
    return torch.zeros((b * T, 3, H, D, S), dtype=dtype).unbind(1)


@pytest.mark.parametrize("D,dtype,strided,route", [
    (64, torch.bfloat16, False, "hopper"),   # the model's case
    (16, torch.bfloat16, False, "any"),      # the tiny spec's head dim
    (64, torch.float32, False, "any"),       # an fp32 model
    (64, torch.float16, False, "any"),
    (64, torch.bfloat16, True, "any"),       # S not contiguous
    (7, torch.float32, True, "any"),
])
def test_k2_route_follows_dtype_head_dim_and_strides(D, dtype, strided, route):
    q, k, v = _views(D, dtype, S=18 if strided else 9)
    if strided:
        q, k, v = (t[..., ::2] for t in (q, k, v))
    assert ta.k2_route(q, k, v, 3) == route


def test_k2_route_refuses_only_what_jax_refuses():
    """Frames outside 1..32 or not dividing b*T, operands that differ in
    shape or dtype, and non-float dtypes; nothing about the head dim, the
    float dtype or the strides."""
    q, k, v = _views(16, torch.float32)
    with pytest.raises(ValueError):
        ta.k2_route(q, k, v, 4)  # 6 frames are not scenes of 4
    big = torch.zeros((33, 1, 8, 4))
    with pytest.raises(ValueError):
        ta.k2_route(big, big, big, 33)
    with pytest.raises(ValueError):
        ta.k2_route(q, k[:, :1], v, 3)
    with pytest.raises(ValueError):
        ta.k2_route(q, k.double(), v, 3)
    with pytest.raises(TypeError):
        ta.k2_route(q.int(), k.int(), v.int(), 3)
    with pytest.raises(ValueError):
        ta.k2_route(q, k, v, 3, out=torch.zeros_like(q).transpose(2, 3).contiguous().transpose(2, 3))
    for D in (1, 16, 48, 64, 100):
        for dtype in ta.DTYPES:
            assert ta.k2_route(*_views(D, dtype), 3) in ("hopper", "any")


@pytest.mark.parametrize("dtype,fwd,dkv,dq", [
    (torch.bfloat16, None, "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
    (torch.float32, "flash_attention_fp32", "flash_attention_bwd_dkv_fp32", "flash_attention_bwd_dq_fp32"),
])
def test_flash_launches_pick_the_kernel_by_dtype(dtype, fwd, dkv, dq):
    """K1, K3 and K4 launch their own Hopper tile for bf16 and the one fp32
    entry for fp32; K1's backward the Hopper pair or its fp32 entries."""
    q = torch.zeros((1, 2, 64, 64), dtype=dtype)
    for tile in (_kernels.FLASH_ATTENTION, _kernels.FLASH_ATTENTION_BLHD, _kernels.FLASH_ATTENTION_PACKED):
        assert fu.fwd_kernel(q, tile).name == (fwd or tile.name)
    assert [k.name for k in fu.bwd_kernels(q)] == [dkv, dq]


def test_flash_wrappers_take_bf16_and_fp32_and_refuse_the_rest():
    """The K1 checks take bf16 and fp32 operands of one dtype, as the JAX
    kernels' predicate does, and refuse fp16, mixed dtypes and head dims
    other than 64 before any launch."""
    for dtype in fu.DTYPES:
        q = torch.zeros((1, 2, 64, 64), dtype=dtype)
        assert fu._check_inputs(q, ("k", q), ("v", q)) == (1, 2, 64, 64)
    h = torch.zeros((1, 2, 64, 64), dtype=torch.float16)
    with pytest.raises(TypeError):
        fu._check_inputs(h, ("k", h), ("v", h))
    f = torch.zeros((1, 2, 64, 64))
    with pytest.raises(TypeError):
        fu._check_inputs(f, ("k", f.bfloat16()), ("v", f))
    with pytest.raises(ValueError):
        fu._check_inputs(f[..., :32], ("k", f[..., :32]), ("v", f[..., :32]))
