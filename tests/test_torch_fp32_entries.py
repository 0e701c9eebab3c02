"""The inputs JAX's Pallas kernels take besides bf16 at head dim 64, on the
CPU: K2 at head dims 16 and 32 in fp32 and bf16 against the JAX kernel in
interpret mode, and what the port's launch routes pick for each input
(which needs no card: the routes read shapes, dtypes and strides only).

K2's op on CPU tensors runs its plain version, all arithmetic in fp32 as in
the JAX kernel, so fp32 agrees to fp32 rounding (rtol 1e-5) and bf16, where
both sides round only the output, to one bf16 step at the output's
magnitude. K1's, K3's and K4's fp32 entries compute the plain versions'
function, which tests/test_torch_ops.py and tests/test_torch_flash.py hold
against the JAX kernels in fp32 already; here their routes, the numerics
the fp32 kernels rest on (three TF32 products, 3xTF32, keep fp32's digits
where one does not), the fp32 forward's whole arithmetic emulated in plain
PyTorch against JAX's K1 in interpret mode, and the views the fp32
kernels' wrappers copy for their tensor maps.
"""

import contextlib
import types

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


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 to TF32 as `cvt.rna.tf32.f32` rounds: to nearest, ties away from
    zero, keeping 10 of the 23 mantissa bits (adding half a TF32 step to
    the magnitude's bits, then clearing the low 13)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """fp32 to TF32 by clearing the low 13 mantissa bits: the kernels' x_hi,
    and what the tensor cores read of an operand that is not TF32 (x_lo)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("rounding", ["rna", "cut"])
def test_three_tf32_products_keep_fp32_digits(rounding):
    """What the fp32 K1-dKV and K1-dQ (csrc/flash_attention_bwd_fp32.cu)
    rest on: with x_hi = tf32(x) and x_lo = tf32(x - x_hi), the 3-term
    product a_hi b_hi + a_hi b_lo + a_lo b_hi of (64, 64) operands is within
    1e-5 relative L2 of the fp64 product, and the 1-term TF32 product
    a_hi b_hi is not (it keeps about three digits). "rna" rounds to nearest
    as cvt.rna.tf32.f32 does; "cut" clears the low bits, the kernels' split
    (x_hi cut by the kernel, x_lo cut by the tensor cores as they read it).
    Products of TF32 values are exact in fp64, as in the tensor cores' fp32
    accumulators."""
    tf32 = _tf32_rna if rounding == "rna" else _tf32_cut
    rng = np.random.default_rng(19)
    a, b = (torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)) for _ in range(2))

    def split(x):
        hi = tf32(x)
        return hi, tf32(x - hi)

    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    for part in (a_hi, a_lo, b_hi, b_lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((a - a_hi).abs() <= a.abs() * 2.0 ** (-11 if rounding == "rna" else -10)).all()
    exact = a.double() @ b.double()

    def rel(x: torch.Tensor) -> float:
        return ((x.double() - exact).norm() / exact.norm()).item()

    def mm(x, y):
        return x.double() @ y.double()

    three = (mm(a_lo, b_hi) + mm(a_hi, b_lo) + mm(a_hi, b_hi)).float()
    one = mm(a_hi, b_hi).float()
    assert rel(three) <= 1e-5 < rel(one)


def test_tf32_rounding_emulations():
    """`_tf32_rna` rounds to nearest with ties away from zero in both signs;
    `_tf32_cut` truncates toward zero."""
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12])
    assert _tf32_rna(x).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 1.0 + 2.0**-10]
    assert _tf32_cut(x).tolist() == [1.0, -1.0, 1.0, 1.0]


def test_fp32_backward_copies_only_the_views_tma_cannot_take():
    """The fp32 K1-dKV and K1-dQ read q, k, v and do through tensor maps:
    `_check_bwd` still takes any fp32 view, and `_bwd_views` copies into the
    `_in_bhld` layout exactly those a map cannot take (a non-contiguous head
    dim, a row stride off 16 bytes, a base off a 16-byte boundary, a zero
    stride). The UNet's packed-qkv views and `_empty_like_bhld` buffers
    pass as they are, and bf16 operands are never copied."""
    B, H, L = 1, 2, 6
    lse = delta = torch.zeros((B, H, L))
    q, k, v = torch.randn((B, L, 3, H, 64)).permute(2, 0, 3, 1, 4).unbind(0)
    do = fu._empty_like_bhld(q).normal_()
    odd = [
        torch.randn((B, H, L, 128))[..., ::2],                     # head dim stride 2
        torch.randn((B, H, L, 65))[..., :64],                      # rows 65 floats apart
        torch.randn((B * H * L * 64 + 1,))[1:].view(B, H, L, 64),  # base 4 bytes off
        torch.randn((B, 1, L, 64)).expand(B, H, L, 64),            # stride 0 over heads
    ]
    for t in (q, k, v, do):
        assert fu._tma_view_ok(t)
    ops = (q, k, v, do)
    _, _, _, maps = fu._check_bwd(*ops, lse, delta)
    got = fu._bwd_views(*ops, maps)
    assert all(a is b for a, b in zip(got[:4], ops)) and got[4] == maps
    for bad in odd:
        ops = (q, bad, v, do)
        _, _, _, maps = fu._check_bwd(*ops, lse, delta)  # any fp32 view is accepted
        got = fu._bwd_views(*ops, maps)
        copied = got[1]
        assert copied is not bad and torch.equal(copied, bad) and fu._tma_view_ok(copied)
        assert copied.stride() == fu._empty_like_bhld(q).stride()
        assert got[0] is q and got[4] == fu._all_strides(*got[:4])
    h = [t.bfloat16() for t in (q, k, v, do)]
    assert fu._bwd_views(*h, [0])[:4] == tuple(h)


def _emulate_fp32_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, products: int = 3):
    """What the fp32 forward of K1, K3 and K4 (csrc/flash_attention_fp32.cu)
    computes, in plain PyTorch on (B, H, L, 64) fp32: q scaled by log2(e) / 8
    in fp32; keys in 64-row tiles, keys past L scoring -inf; every product
    of S = q K^T and of P V as `products` TF32 products (3: the kernel's
    a_lo b_hi + a_hi b_lo + a_hi b_hi with the cut split; 1: a_hi b_hi),
    exact in fp64 as in the tensor cores' accumulators and summed to fp32;
    the base-2 online softmax; each tile's P V summed from zero, then added
    to the rescaled running O. Returns o and the natural-log LSE."""
    B, H, L, D = q.shape
    tile = 64
    pad = -L % tile
    k, v = (torch.cat([t, t.new_zeros((B, H, pad, D))], 2) for t in (k, v))

    def split(x):
        hi = _tf32_cut(x)
        return hi, _tf32_cut(x - hi)

    def mm(a, b):
        (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
        out = a_hi.double() @ b_hi.double()
        if products == 3:
            out = a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double() + out
        return out.float()

    qs = q * torch.tensor(fu._SCALE_LOG2, dtype=torch.float32)
    m = torch.full((B, H, L), -torch.inf)
    l = torch.zeros((B, H, L))
    acc = torch.zeros((B, H, L, D))
    for t0 in range(0, L, tile):
        s = mm(qs, k[:, :, t0 : t0 + tile].transpose(-1, -2))
        s[..., max(L - t0, 0) :] = -torch.inf
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm(p, v[:, :, t0 : t0 + tile])
        m = m_new
    return acc / l[..., None], m * np.float32(np.log(2.0)) + torch.log(l)


@pytest.mark.parametrize("L", [200, 1100])
def test_fp32_forward_arithmetic_matches_jax(L):
    """The fp32 forward's arithmetic (`_emulate_fp32_forward`: 64-key tiles,
    3xTF32 products, base-2 online softmax, per-tile sums) against the JAX
    package's `flash_attention_upstream_bhld` at (1, 2, L, 64) in Pallas
    interpret mode: relative L2 1e-5 and max abs 1e-4, the bars the kernel
    is held to on the card; its LSE within 1e-5 of the port's plain one. The
    same loop with one TF32 product misses the relative L2 bar, so the bar
    tells 3xTF32 from TF32."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.ops.flash_upstream import flash_attention_upstream_bhld as jax_fa

    rng = np.random.default_rng(L)
    q, k, v = (rng.normal(size=(1, 2, L, 64)).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse_plain = fu.flash_attention_plain(tq, tk, tv, return_lse=True)

    def rel(out: torch.Tensor) -> float:
        return float(np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref))

    out, lse = _emulate_fp32_forward(tq, tk, tv)
    assert rel(out) <= 1e-5 and np.abs(out.numpy() - ref).max() <= 1e-4
    assert (lse - lse_plain).abs().max().item() <= 1e-5
    one, _ = _emulate_fp32_forward(tq, tk, tv, products=1)
    assert rel(one) > 1e-5


def test_fp32_forward_copies_only_the_views_tma_cannot_take(monkeypatch):
    """The fp32 forward reads q, k and v through tensor maps: `launch_fwd`
    passes the kernel the views a map takes as they are (K1's packed-qkv
    views, K3's and K4's chunks of a packed projection, as their wrappers
    hand them over) and copies into the `_in_bhld` layout exactly those it
    cannot take (`_map_views`, shared with the backward); o is written
    through its strides, whatever they are. The launch is recorded, not
    run, so no card is needed."""
    B, H, L = 2, 3, 6
    seen = []
    monkeypatch.setattr(_kernels.FLASH_ATTENTION_FP32, "launch", lambda *args: seen.append(args))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=0))

    def launched(q, k, v, o):
        seen.clear()
        fu.launch_fwd(_kernels.FLASH_ATTENTION, q, k, v, o)
        (args,) = seen
        strides = args[8:24]
        return args[:3], [list(strides[4 * i : 4 * i + 4]) for i in range(4)]

    packed = torch.randn((B, L, 3 * H * 64)).chunk(3, dim=-1)
    unet = torch.randn((B, L, 3, H, 64)).permute(2, 0, 3, 1, 4).unbind(0)
    k3 = [t.view(B, L, H, 64).transpose(1, 2) for t in packed]
    k4 = [t.unflatten(-1, (H, 64)).transpose(1, 2) for t in packed]
    for q, k, v in (unet, k3, k4):
        o = fu._empty_like_bhld(q)
        ptrs, strides = launched(q, k, v, o)
        assert list(ptrs) == [t.data_ptr() for t in (q, k, v)]
        assert strides == [list(t.stride()) for t in (q, k, v, o)]
    odd = [
        torch.randn((B, H, L, 128))[..., ::2],                     # head dim stride 2
        torch.randn((B, H, L, 65))[..., :64],                      # rows 65 floats apart
        torch.randn((B * H * L * 64 + 1,))[1:].view(B, H, L, 64),  # base 4 bytes off
        torch.randn((B, 1, L, 64)).expand(B, H, L, 64),            # stride 0 over heads
    ]
    q, k, v = unet
    o = torch.empty((B, H, L, 128))[..., ::2]
    for bad in odd:
        (copied,) = fu._map_views(bad)
        assert copied is not bad and torch.equal(copied, bad) and fu._tma_view_ok(copied)
        assert copied.stride() == fu._empty_like_bhld(q).stride()
        ptrs, strides = launched(q, bad, v, o)
        assert ptrs[0] == q.data_ptr() and ptrs[2] == v.data_ptr() and ptrs[1] != bad.data_ptr()
        assert strides[1] == list(copied.stride()) and strides[3] == list(o.stride())
