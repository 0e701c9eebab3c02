"""The hand-written CUDA kernels (K1 flash attention with its log-sum-exp,
K1-dKV and K1-dQ, K2 temporal attention, K3 flash attention on (B, L, H, 64),
K4 flash attention on packed (B, L, W), K5 LayerNorm, and the fp32 entries
of K1/K3/K4 and of K1-dKV/K1-dQ and K2's entry for any head dim and dtype)
against their plain versions on the card, the routes that reach them from
an fp32 UNet, the wrappers' refusals, a backward through SevaUNet on
the card that reaches the attention weights, K3's recompute backward against
K1's kernel backward, a UNet exported through torch.export against its eager
forward, a DUSt3R forward on the card against the CPU, and the view-sharded
ring attention (parallel/ring_attention.py) over ranks on repeated cuda:0,
its blocks through K1 against the ring through the plain twin, its backward
blocks through K1-dKV and K1-dQ against the plain blocks, and rank
threads started on a card whose allocator cache fills it.

The `cuda` tests need an NVIDIA GPU and skip elsewhere. This file imports
neither jax nor the test conftest, so on a machine with the card and no JAX
it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Inputs are unit-normal bf16 from numpy with a fixed seed. Tolerances: K1 is
bf16 out with P rounded to bf16 before P.V (max 2e-2, mean 2e-3); K2 keeps
all arithmetic in fp32 and rounds only its output (one bf16 ulp at 1, 8e-3,
or one bf16 step at the output's magnitude where outputs exceed 2);
K3 and K4 are K1's tile on other layouts (K1's bars);
K1's LSE is fp32 (1e-2); K1-dKV/K1-dQ round P and dS to bf16 for their
products and their outputs to bf16 (relative L2 2e-2); K5 rounds only its
output (one bf16 step; fp32 within 1e-5 of a unit output). The fp32 forward
and backward entries compute every product as three TF32 products on the
tensor cores (3xTF32, ~2^-20 relative), and differ from
the plain fp32 versions only in the order and rounding of their sums: the
forward within relative L2 1e-5 and max abs 1e-4 (one TF32 product would
give about 1e-3), the backward pair within relative L2 1e-4, two launches of
each bit-equal, K2's other entry within relative L2 1e-5 in fp32 and one step
of the output dtype in bf16 and fp16.
"""

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.io import attention_backend, init_flax_defaults
from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
from stable_virtual_camera_tpu_torch.ops import flash_attention as fa
from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as fap
from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_plain,
    flash_attention_upstream_bhld,
)
from stable_virtual_camera_tpu_torch.ops.layer_norm import ln_fused, ln_reduce
from stable_virtual_camera_tpu_torch.ops.time_attention import (
    _any_plan,
    time_attention_any_cuda,
    time_attention_bhds,
    time_attention_plain,
)


@pytest.fixture()
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _bf16(rng, shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, torch.bfloat16)


# the Hopper tile's 128-row query and key tiles: below one tile, ragged, one
# whole tile, and the longest joint attention of a 576x576 render
TILE_SHAPES = [(1, 1, 64), (2, 3, 100), (1, 2, 1100), (3, 1, 1296), (1, 1, 128), (1, 1, 27216)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", TILE_SHAPES)
@pytest.mark.parametrize("packed", [False, True])
def test_flash_kernel_matches_plain(cuda, B, H, L, packed):
    """Ragged L (keys masked, rows not stored past L) and the UNet's strided
    (B, H, L, 64) views of a packed (B, L, 3, H, 64) projection."""
    rng = np.random.default_rng(L + H)
    if packed:
        q, k, v = _bf16(rng, (B, L, 3, H, 64), cuda).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (_bf16(rng, (B, H, L, 64), cuda) for _ in range(3))
    before = _kernels.FLASH_ATTENTION.launches
    out = flash_attention_upstream_bhld(q, k, v)
    assert _kernels.FLASH_ATTENTION.launches == before + 1
    diff = (out.float() - flash_attention_plain(q, k, v).float()).abs()
    torch.cuda.synchronize()
    assert out.shape == (B, H, L, 64) and out.dtype == torch.bfloat16
    assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", [(2, 3, 100), (1, 2, 1100), (1, 1, 27216)])
def test_flash_kernel_lse_matches_plain(cuda, B, H, L):
    """K1's log-sum-exp (written in the tile's epilogue, read by K1-dKV and
    K1-dQ) at ragged L, on the UNet's packed-qkv views: fp32, within 1e-2."""
    rng = np.random.default_rng(L + 11 * H)
    q, k, v = _bf16(rng, (B, L, 3, H, 64), cuda).permute(2, 0, 3, 1, 4).unbind(0)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    o_ref, lse_ref = flash_attention_plain(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, L) and lse.dtype == torch.float32
    assert (lse - lse_ref).abs().max().item() <= 1e-2
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _fp32(rng, shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)


def _fp32_views(rng, layout, B, H, L, device, odd=None):
    """q, k, v as each fp32 route passes them: K1's (B, H, L, 64) views of a
    packed (B, L, 3, H, 64) projection, K3's (B, L, H, 64) chunks of a
    (B, L, 3 H 64) one, K4's packed (B, L, H 64) chunks of it. With `odd`,
    K1's operands are instead (B, H, L, 64) views no tensor map takes, which
    the wrapper copies first: a head dim of stride 2 ("head_stride"), rows
    65 floats apart ("row_pad"), a base 4 bytes past a 16-byte boundary
    ("base_off") or a zero stride over heads ("broadcast")."""
    if odd is not None:
        n = B * H * L * 64
        make = {"head_stride": lambda: _fp32(rng, (B, H, L, 128), device)[..., ::2],
                "row_pad": lambda: _fp32(rng, (B, H, L, 65), device)[..., :64],
                "base_off": lambda: _fp32(rng, (n + 1,), device)[1:].view(B, H, L, 64),
                "broadcast": lambda: _fp32(rng, (B, 1, L, 64), device).expand(B, H, L, 64)}[odd]
        return make(), make(), make()
    if layout == "k1":
        return _fp32(rng, (B, L, 3, H, 64), device).permute(2, 0, 3, 1, 4).unbind(0)
    qkv = _fp32(rng, (B, L, 3 * H * 64), device).chunk(3, dim=-1)
    if layout == "k3":
        return tuple(t.view(B, L, H, 64) for t in qkv)
    return qkv


# each route's layout at one tile, ragged L and a per-frame length; the
# joint site's length with one head (426 streamed 64-key tiles a block);
# K1 on each kind of view a tensor map cannot take
_FP32_FWD_CASES = [(layout, B, H, L, None) for layout in ("k1", "k3", "k4")
                   for B, H, L in [(1, 1, 64), (2, 3, 100), (1, 2, 1100), (2, 2, 1296)]]
_FP32_FWD_CASES += [("k1", 1, 1, 27216, None)]
_FP32_FWD_CASES += [("k1", 2, 2, 300, odd) for odd in ("head_stride", "row_pad", "base_off", "broadcast")]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,B,H,L,odd", _FP32_FWD_CASES)
def test_flash_fp32_kernel_matches_plain(cuda, layout, B, H, L, odd):
    """The fp32 entry of K1, K3 and K4 (csrc/flash_attention_fp32.cu, 3xTF32
    on the tensor cores) on each route's views, ragged L, a long streaming
    row and views the wrapper copies included, with K1's log-sum-exp:
    relative L2 1e-5 and max abs 1e-4 against the plain fp32 version, the
    LSE within 1e-5, one launch of the fp32 kernel and no other; a second
    launch on the same inputs gives the same bits."""
    rng = np.random.default_rng(L + 3 * H)
    q, k, v = _fp32_views(rng, layout, B, H, L, cuda, odd)
    if layout == "k1":
        def run():
            return flash_attention_cuda(q, k, v, return_lse=True)
        ref, lse_ref = flash_attention_plain(q, k, v, return_lse=True)
    elif layout == "k3":
        def run():
            return fa.flash_attention(q, k, v), None
        ref = fa.flash_attention_plain(q, k, v)
    else:
        def run():
            return fap.flash_attention_packed(q, k, v, H), None
        ref = fap.flash_attention_packed_plain(q, k, v, H)
    before = _kernels.counts()
    out, lse = run()
    after = _kernels.counts()
    out2, lse2 = run()
    torch.cuda.synchronize()
    assert _moved(before, after) == {"flash_attention_fp32": 1}
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert _rel(out, ref) <= 1e-5 and (out - ref).abs().max().item() <= 1e-4
    assert torch.equal(out, out2)
    if lse is not None:
        assert (lse - lse_ref).abs().max().item() <= 1e-5 and torch.equal(lse, lse2)


def _moved(before: dict, after: dict) -> dict:
    return {n: after[n] - before[n] for n in after if after[n] != before[n]}


_FP32_BWD = {"flash_attention_bwd_dkv_fp32": 1, "flash_attention_bwd_dq_fp32": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,head_stride", [(1, 1, 64, 1), (2, 3, 100, 1), (1, 2, 1100, 1), (1, 2, 1701, 1),
                                               (2, 2, 300, 2)])
def test_flash_fp32_backward_kernels_match_plain(cuda, B, H, L, head_stride):
    """The fp32 entries of K1-dKV and K1-dQ (csrc/flash_attention_bwd_fp32.cu)
    through K1's autograd on the UNet's packed-qkv views, a gradient on the
    log-sum-exp included: relative L2 1e-4 against autograd of the plain
    fp32 math; the counts of the fp32 forward and of each fp32 backward
    kernel move by one and no other. With head_stride 2 the head dim is not
    contiguous, a view no tensor map takes: the wrapper copies it first."""
    rng = np.random.default_rng(L + 5 * H)
    base = _fp32(rng, (B, L, 3, H, 64 * head_stride), cuda)
    do = _fp32(rng, (B, H, L, 64), cuda)
    dl = _fp32(rng, (B, H, L), cuda)

    def grads(attend):
        leaf = base.clone().requires_grad_()
        q, k, v = leaf[..., ::head_stride].permute(2, 0, 3, 1, 4).unbind(0)
        assert q.stride(-1) == head_stride
        o, lse = attend(q, k, v)
        (g,) = torch.autograd.grad((o * do).sum() + (lse * dl).sum(), leaf)
        return g[..., ::head_stride]

    from stable_virtual_camera_tpu_torch.ops.flash_upstream import flash_attention_op

    before = _kernels.counts()
    got = grads(lambda q, k, v: flash_attention_op(q, k, v, True))
    after = _kernels.counts()
    ref = grads(lambda q, k, v: flash_attention_plain(q, k, v, return_lse=True))
    torch.cuda.synchronize()
    assert _moved(before, after) == {"flash_attention_fp32": 1, **_FP32_BWD}
    for part in range(3):
        assert _rel(got[:, :, part], ref[:, :, part]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", [(1, 1, 27216), (1, 3, 1296)])
def test_flash_fp32_backward_kernels_stream_and_repeat(cuda, B, H, L):
    """The fp32 K1-dKV and K1-dQ on K1's fp32 output and log-sum-exp, at the
    joint site's length with one head (426 streamed 64-row tiles a block)
    and at a per-frame length: relative L2 1e-4 against the plain fp32
    backward, finite, only the fp32 pair's counts moving; a second launch
    on the same inputs gives the same bits."""
    from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
        attention_delta,
        flash_attention_bwd_dkv_cuda,
        flash_attention_bwd_dq_cuda,
    )

    rng = np.random.default_rng(L + 11 * H)
    q, k, v = _fp32(rng, (B, L, 3, H, 64), cuda).permute(2, 0, 3, 1, 4).unbind(0)
    do = _fp32(rng, (B, L, H, 64), cuda).transpose(1, 2)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    delta = attention_delta(o, do)
    before = _kernels.counts()
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
    after = _kernels.counts()
    dk2, dv2 = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    dq2 = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert _moved(before, after) == _FP32_BWD
    for g, g2, r in zip((dq, dk, dv), (dq2, dk2, dv2), refs):
        assert g.dtype == torch.float32 and g.shape == (B, H, L, 64)
        assert torch.isfinite(g).all() and _rel(g, r) <= 1e-4
        assert torch.equal(g, g2)


_ANY_CASES = [
    # (dtype, D, T, b, H, S, strided, the copy mode `_any_plan` picks): every
    # copy mode in fp32 (TMA where S * 4 is a multiple of 16, cp.async of 8
    # or 4 bytes, loads for a strided S), the tiny spec's head dim, ragged
    # channel chunks (7, 20, 24, 80) and several (128), T on both sides of
    # the key-frame ceilings (1, 4, 5, 8, 21, 22, 32), and every dtype
    (torch.float32, 16, 21, 2, 3, 81, False, "cp.async.4"), (torch.float32, 20, 3, 1, 2, 100, False, "tma"),
    (torch.float32, 64, 21, 2, 5, 1296, False, "tma"), (torch.float32, 64, 32, 1, 2, 64, True, "loads"),
    (torch.bfloat16, 16, 21, 2, 3, 81, False, "loads"), (torch.bfloat16, 64, 5, 2, 2, 70, True, "loads"),
    (torch.float16, 32, 8, 1, 2, 40, False, "tma"), (torch.float32, 8, 1, 3, 1, 5, False, "cp.async.4"),
    (torch.float32, 24, 21, 2, 2, 82, False, "cp.async.8"), (torch.float32, 7, 4, 2, 3, 324, False, "tma"),
    (torch.float32, 80, 5, 1, 2, 97, False, "cp.async.4"), (torch.float32, 128, 22, 1, 2, 64, False, "tma"),
    (torch.float32, 8, 32, 1, 1, 130, False, "cp.async.8"), (torch.float32, 64, 1, 4, 2, 33, True, "loads"),
    (torch.float32, 7, 5, 2, 2, 48, False, "tma"), (torch.bfloat16, 24, 4, 2, 2, 324, False, "cp.async.8"),
    (torch.float16, 80, 22, 1, 2, 50, False, "cp.async.4"), (torch.bfloat16, 128, 32, 1, 1, 64, False, "tma"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,T,b,H,S,strided,copy", _ANY_CASES)
def test_time_any_kernel_matches_plain(cuda, dtype, D, T, b, H, S, strided, copy):
    """K2's entry for any head dim and dtype (csrc/time_attention_any.cu),
    through the op, on views of a (b*T, 3, H, D, S) projection: relative L2
    1e-5 in fp32, one step of the output dtype otherwise; S strided
    (positions every other element) where asked."""
    rng = np.random.default_rng(D * T + S)
    full = _fp32(rng, (b * T, 3, H, D, 2 * S if strided else S), cuda).to(dtype)
    q, k, v = (full[..., ::2] if strided else full).unbind(1)
    assert _any_plan(q, k, v, T).copy == copy
    before = _kernels.counts()
    out = time_attention_bhds(q, k, v, T)
    after = _kernels.counts()
    ref = time_attention_plain(q, k, v, T).float()
    torch.cuda.synchronize()
    assert after["time_attention_any"] == before["time_attention_any"] + 1
    assert after["time_attention"] == before["time_attention"]
    assert out.dtype == dtype and out.shape == (b * T, H, D, S)
    if dtype == torch.float32:
        assert _rel(out, ref) <= 1e-5
    else:
        mant = 7 if dtype == torch.bfloat16 else 10
        step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0**-10))) - mant)
        assert ((out.float() - ref).abs() / step).max().item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("H,D,S", [(20, 16, 81), (5, 64, 5184)])  # the tiny spec's head dim; the fp32 render's ds1
def test_time_any_kernel_is_deterministic(cuda, H, D, S):
    """Two launches on the same (42 frames, T = 21) views give the same bits."""
    rng = np.random.default_rng(4)
    q, k, v = _fp32(rng, (42, 3, H, D, S), cuda).unbind(1)
    first = time_attention_any_cuda(q, k, v, 21)
    second = time_attention_any_cuda(q, k, v, 21)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", [(1, 1, 64), (2, 3, 100), (1, 2, 1100), (3, 1, 1296),
                                   (1, 2, 1701), (1, 1, 1001)])
def test_flash_backward_kernels_match_plain(cuda, B, H, L):
    """K1's LSE, then K1-dKV and K1-dQ, against the plain versions on the
    UNet's packed-qkv views, with the incoming gradient in K1's output
    layout; ragged L included, and L = 1701 and 1001, where the fp32 lse
    and delta rows (4 L bytes) are not a multiple of 16 bytes."""
    rng = np.random.default_rng(L + 7 * H)
    q, k, v = _bf16(rng, (B, L, 3, H, 64), cuda).permute(2, 0, 3, 1, 4).unbind(0)
    do = _bf16(rng, (B, L, H, 64), cuda).transpose(1, 2)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    _, lse_ref = flash_attention_plain(q, k, v, return_lse=True)
    before = _kernels.counts()
    grads = flash_attention_bwd_cuda(q, k, v, o, lse, do)
    after = _kernels.counts()
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (lse - lse_ref).abs().max().item() <= 1e-2
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert after[name] == before[name] + 1
    for g, r in zip(grads, refs):
        assert g.shape == (B, H, L, 64) and g.dtype == torch.bfloat16
        assert torch.isfinite(g).all() and _rel(g, r) <= 2e-2


@pytest.mark.cuda
def test_flash_backward_kernels_are_deterministic(cuda):
    """Two launches of K1-dKV and of K1-dQ on the same inputs give the same
    bits (no atomics; each output row is summed in one fixed order)."""
    rng = np.random.default_rng(5)
    B, H, L = 1, 2, 1701
    q, k, v = _bf16(rng, (B, L, 3, H, 64), cuda).permute(2, 0, 3, 1, 4).unbind(0)
    do = _bf16(rng, (B, L, H, 64), cuda).transpose(1, 2)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, do)
    second = flash_attention_bwd_cuda(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_lse_gradient_through_the_kernels(cuda):
    """A loss on o and on K1's log-sum-exp through the op on the card (K1,
    then K1-dKV and K1-dQ with delta D - dlse) against the plain backward
    given the same dlse, and the LSE alone giving a nonzero dq."""
    from stable_virtual_camera_tpu_torch.ops.flash_upstream import flash_attention_op

    rng = np.random.default_rng(13)
    B, H, L = 1, 2, 1100
    q, k, v = (t.detach().requires_grad_() for t in
               _bf16(rng, (B, L, 3, H, 64), cuda).permute(2, 0, 3, 1, 4).unbind(0))
    wo = _bf16(rng, (B, H, L, 64), cuda)
    wl = torch.from_numpy(rng.normal(size=(B, H, L)).astype(np.float32)).to(cuda)
    before = _kernels.counts()
    o, lse = flash_attention_op(q, k, v, True)
    ((o.float() * wo.float()).sum() + (lse * wl).sum()).backward()
    after = _kernels.counts()
    assert after["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    refs = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(),
                                     wo, dlse=wl)
    for t, r in zip((q, k, v), refs):
        assert torch.isfinite(t.grad).all() and _rel(t.grad, r) <= 2e-2
    q.grad = None
    _, lse = flash_attention_op(q, k, v, True)
    (lse * wl).sum().backward()
    torch.cuda.synchronize()
    assert q.grad.float().norm().item() > 0


@pytest.mark.cuda
def test_flash_function_takes_the_kernels_both_ways(cuda):
    """Under grad, FlashAttentionFn's forward writes the LSE and its
    backward launches K1-dKV and K1-dQ once each; under inference_mode it
    launches K1 alone."""
    rng = np.random.default_rng(3)
    q, k, v = (_bf16(rng, (1, 2, 1030, 64), cuda).requires_grad_() for _ in range(3))
    before = _kernels.counts()
    out = flash_attention_upstream_bhld(q, k, v)
    out.float().square().sum().backward()
    after = _kernels.counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_attention": 1, "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1,
        "time_attention": 0, "flash_attention_blhd": 0, "flash_attention_packed": 0, "layer_norm": 0,
        "flash_attention_fp32": 0, "flash_attention_bwd_dkv_fp32": 0, "flash_attention_bwd_dq_fp32": 0,
        "time_attention_any": 0}
    assert all(torch.isfinite(t.grad).all() and t.grad.abs().max() > 0 for t in (q, k, v))
    with torch.inference_mode():
        flash_attention_upstream_bhld(q, k, v)
    assert _kernels.counts()["flash_attention_bwd_dkv"] == after["flash_attention_bwd_dkv"]


@pytest.mark.cuda
def test_unet_backward_reaches_attention_weights(cuda):
    """A loss through SevaUNet on the card (bf16, per-frame self-attention
    at L = 32 x 32 = 1024 takes K1, time-mix takes K2) backpropagates into
    the qkv weights of both attentions: the kernels are autograd Functions,
    not calls that cut the graph."""
    spec = SevaSpec(model_channels=64, num_frames=2, num_head_channels=64, context_dim=64,
                    channel_mult=(1, 1), transformer_depth=(1, 1), attention_resolutions=(1,))
    unet = init_flax_defaults(SevaUNet(spec), torch.Generator().manual_seed(0))
    unet = unet.to(cuda, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    n = 2
    x = torch.randn((n, 32, 32, 11), generator=g, device=cuda)
    ctx = torch.randn((n, 1, 64), generator=g, device=cuda)
    dense = torch.randn((n, 32, 32, 6), generator=g, device=cuda)
    before = _kernels.counts()
    out = unet(x, torch.full((n,), 500, device=cuda), ctx, dense, n)
    out.square().mean().backward()
    after = _kernels.counts()
    upstream = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "time_attention")
    assert all(after[name] > before[name] for name in upstream)
    assert all(after[name] == before[name] for name in after if name not in upstream)
    blk = unet.input_blocks_1_1
    for w in (blk.spatial_0.attn1.qkv.weight, blk.temporal_0.attn1.qkv.weight):
        assert w.grad is not None and torch.isfinite(w.grad).all() and w.grad.abs().max() > 0


# the first four cases are held to 8e-3 (one bf16 step below |o| = 2, where
# their outputs lie); the others to one bf16 step at the output's magnitude,
# chip_smoke.py's bar for K2, since a T = 3 chunk's outputs reach |o| ~ 4,
# where one step is 1.6e-2
FIXED_BAR_CASES = [(1, 1, 1, 7), (2, 5, 3, 33), (2, 21, 2, 81), (1, 32, 1, 100)]


def _bf16_steps(out, ref):
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0**-10))) - 7)
    return ((out - ref).abs() / step).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,H,S", FIXED_BAR_CASES + [
    # TMA boxes (S % 8 == 0), 8-byte rows (cp.async), the Advanced ds8 level,
    # the Basic first pass
    (2, 21, 5, 1296), (2, 21, 20, 324), (2, 6, 20, 108), (2, 3, 5, 5184),
    # each side of the 8- and 24-frame ceilings, and the 32-frame one
    (1, 8, 1, 200), (1, 9, 1, 200), (1, 24, 1, 72), (1, 25, 1, 72), (1, 32, 2, 64),
])
def test_time_kernel_matches_plain(cuda, b, T, H, S):
    rng = np.random.default_rng(T * S)
    q, k, v = _bf16(rng, (b * T, 3, H, 64, S), cuda).unbind(1)
    before = _kernels.TIME_ATTENTION.launches
    out = time_attention_bhds(q, k, v, T)
    assert _kernels.TIME_ATTENTION.launches == before + 1
    ref = time_attention_plain(q, k, v, T).float()
    torch.cuda.synchronize()
    assert out.shape == (b * T, H, 64, S)
    if (b, T, H, S) in FIXED_BAR_CASES:
        assert (out.float() - ref).abs().max().item() <= 8e-3
    else:
        assert _bf16_steps(out.float(), ref) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("width,S,copy", [(68, 66, "cp.async.4"), (84, 81, "loads"), (80, 80, "tma")])
def test_time_kernel_matches_plain_on_strided_rows(cuda, width, S, copy):
    """Views whose rows are not the UNet's packed ones take the producer's
    other copy modes: rows of S positions at a stride of `width`."""
    from stable_virtual_camera_tpu_torch.ops.time_attention import _k2_plan

    rng = np.random.default_rng(S)
    q, k, v = _bf16(rng, (2 * 5, 3, 2, 64, width), cuda)[..., :S].unbind(1)
    assert _k2_plan(q, k, v, 5).copy == copy
    out = time_attention_bhds(q, k, v, 5)
    ref = time_attention_plain(q, k, v, 5).float()
    torch.cuda.synchronize()
    assert _bf16_steps(out.float(), ref) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1296, 324, 81])  # TMA boxes, cp.async, packed spans
def test_time_kernel_is_deterministic(cuda, S):
    """Two launches on the same inputs give the same bits."""
    rng = np.random.default_rng(S)
    q, k, v = _bf16(rng, (42, 3, 5, 64, S), cuda).unbind(1)
    first = time_attention_bhds(q, k, v, 21)
    second = time_attention_bhds(q, k, v, 21)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 1, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_upstream_bhld(q.half(), q.half(), q.half())  # fp16
    with pytest.raises(TypeError):
        flash_attention_upstream_bhld(q, q.bfloat16(), q)  # mixed dtypes
    h = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_upstream_bhld(h[..., :32], h[..., :32], h[..., :32])  # D != 64
    t = torch.zeros((33, 1, 64, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        time_attention_bhds(t, t, t, 33)  # T > 32
    lse = torch.zeros((1, 1, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(q.half(), q.half(), q.half(), q.half(), lse, q.half())  # fp16
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(h, h, h, h, lse.double(), h)  # lse not fp32


@pytest.mark.parametrize("fn,shape,args", [
    (flash_attention_upstream_bhld, (1, 1, 64, 64), ()),
    (time_attention_bhds, (2, 1, 64, 8), (2,)),
    (fa.flash_attention, (1, 64, 1, 64), ()),
    (fap.flash_attention_packed, (1, 64, 128), (2,)),
    (ln_fused, (4, 320), ()),
])
def test_wrappers_have_no_kernel_off_cpu_and_cuda(fn, shape, args):
    """The plain version serves CPU tensors only: a tensor on another device
    raises instead of falling back."""
    x = torch.zeros(shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fn(x, x, x, *args)


def _split_qkv(rng, B, L, H, device):
    """q, k, v as the UNet's generic path passes them: (B, L, H*64) chunks of
    one (B, L, 3*H*64) projection (row stride 3*H*64)."""
    return _bf16(rng, (B, L, 3 * H * 64), device).chunk(3, dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", TILE_SHAPES)
def test_blhd_kernel_matches_plain(cuda, B, H, L):
    """K3 on (B, L, H, 64) views of split-qkv chunks, ragged L included; the
    output is a contiguous (B, L, H, 64)."""
    rng = np.random.default_rng(3 * L + H)
    q, k, v = (t.reshape(B, L, H, 64) for t in _split_qkv(rng, B, L, H, cuda))
    before = _kernels.counts()
    out = fa.flash_attention(q, k, v)
    after = _kernels.counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {"flash_attention_blhd": 1}
    diff = (out.float() - fa.flash_attention_plain(q, k, v).float()).abs()
    torch.cuda.synchronize()
    assert out.shape == (B, L, H, 64) and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", [(1, 2, 64), (2, 4, 100), (1, 2, 1100), (2, 6, 1296), (1, 1, 128),
                                   (1, 1, 27216)])
def test_packed_kernel_matches_plain(cuda, B, H, L):
    """K4 on split-qkv (B, L, W) chunks, ragged L included; each head
    writes its 64-column slice of rows of stride W."""
    rng = np.random.default_rng(5 * L + H)
    q, k, v = _split_qkv(rng, B, L, H, cuda)
    before = _kernels.counts()
    out = fap.flash_attention_packed(q, k, v, H)
    after = _kernels.counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {"flash_attention_packed": 1}
    diff = (out.float() - fap.flash_attention_packed_plain(q, k, v, H).float()).abs()
    torch.cuda.synchronize()
    assert out.shape == (B, L, H * 64) and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3


@pytest.mark.cuda
def test_blhd_recompute_gradient_matches_k1_kernel_gradient(cuda):
    """K3's wrapper saves q, k, v and differentiates the plain chunked
    recompute; its gradient matches K1's backward kernels (rel L2 2e-2)."""
    rng = np.random.default_rng(11)
    q0, k0, v0 = (_bf16(rng, (1, 1100, 2, 64), cuda) for _ in range(3))
    g = _bf16(rng, (1, 1100, 2, 64), cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q0, k0, v0)]
        out = fn(*leaves)
        out.backward(g)
        return [t.grad for t in leaves]

    before = _kernels.counts()
    ours = grads(fa.flash_attention_trainable)
    assert _kernels.counts()["flash_attention_blhd"] == before["flash_attention_blhd"] + 1
    assert _kernels.counts()["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"]
    ref = grads(lambda q, k, v: flash_attention_upstream_bhld(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2))
    for a, b in zip(ours, ref):
        assert torch.isfinite(a).all() and _rel(a, b) <= 2e-2


@pytest.mark.cuda
def test_packed_gradient_raises(cuda):
    rng = np.random.default_rng(12)
    q, k, v = (t.detach().requires_grad_() for t in _split_qkv(rng, 1, 1100, 2, cuda))
    out = fap.flash_attention_packed(q, k, v, 2)
    with pytest.raises(RuntimeError, match="no gradient"):
        out.float().sum().backward()


@pytest.mark.cuda
def test_k3_k4_refuse_what_they_do_not_take(cuda):
    """fp16 and a head dim other than 64 raise; neither runs the plain
    version on the card."""
    before = _kernels.counts()
    q = torch.zeros((1, 64, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)  # fp16
    h = torch.zeros((1, 64, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(h, h, h)  # D != 64
    p = torch.zeros((1, 64, 128), device=cuda)
    with pytest.raises(TypeError):
        fap.flash_attention_packed(p.half(), p.half(), p.half(), 2)  # fp16
    with pytest.raises(ValueError):
        fap.flash_attention_packed(p.bfloat16(), p.bfloat16(), p.bfloat16(), 4)  # D = 32
    assert _kernels.counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("attention,kernel", [("flash", "flash_attention_blhd"),
                                              ("packed", "flash_attention_packed")])
def test_unet_backends_launch_their_kernels(cuda, attention, kernel):
    """A small bf16 SevaUNet (2 heads of 64 at 32 x 32 = 1024 tokens per
    frame) with attention="flash" launches K3 and with "packed" K4, never
    K1, and agrees with the "upstream" (K1) network on the same weights."""
    spec = SevaSpec(model_channels=128, num_frames=2, num_head_channels=64, context_dim=64,
                    channel_mult=(1, 1), transformer_depth=(1, 1), attention_resolutions=(1,))
    nets = {}
    for name in ("upstream", attention):
        unet = init_flax_defaults(SevaUNet(spec, attention=name), torch.Generator().manual_seed(0))
        nets[name] = unet.to(cuda, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(1)
    n = 2
    args = (torch.randn((n, 32, 32, 11), generator=g, device=cuda), torch.full((n,), 500, device=cuda),
            torch.randn((n, 1, 64), generator=g, device=cuda),
            torch.randn((n, 32, 32, 6), generator=g, device=cuda), n)
    with torch.inference_mode():
        ref = nets["upstream"](*args)
        before = _kernels.counts()
        out = nets[attention](*args)
        after = _kernels.counts()
    assert after[kernel] > before[kernel] and after["flash_attention"] == before["flash_attention"]
    assert torch.isfinite(out).all() and _rel(out, ref) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("attention,kernels", [("upstream", ("flash_attention", "time_attention")),
                                               ("flash", ("flash_attention_blhd", "time_attention")),
                                               ("packed", ("flash_attention_packed", "time_attention"))])
def test_exported_unet_launches_the_kernels(cuda, attention, kernels):
    """The small UNet of tests/test_torch_ops_export.py in bf16 on the card,
    exported through torch.export (the kernels are custom ops with fake
    implementations): the program launches each kernel as often as the
    eager forward does and gives the eager forward's bits."""
    spec = SevaSpec(model_channels=128, num_frames=2, num_head_channels=64, context_dim=64,
                    channel_mult=(1,), transformer_depth=(1,), attention_resolutions=(1,),
                    num_res_blocks=1, unflatten_names=("middle_ds1",))
    unet = init_flax_defaults(SevaUNet(spec, attention=attention), torch.Generator().manual_seed(0))
    unet = unet.to(cuda, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(1)
    n = 4
    args = (torch.randn((n, 32, 32, 11), generator=g, device=cuda), torch.full((n,), 500, device=cuda),
            torch.randn((n, 1, 64), generator=g, device=cuda),
            torch.randn((n, 32, 32, 6), generator=g, device=cuda), 2)
    with torch.no_grad():
        program = torch.export.export(unet, args).module()
    with torch.inference_mode():
        c0 = _kernels.counts()
        eager = unet(*args)
        c1 = _kernels.counts()
        out = program(*args)
        c2 = _kernels.counts()
    eager_launches = {k: c1[k] - c0[k] for k in c0}
    assert all(eager_launches[k] > 0 for k in kernels)
    assert {k: c2[k] - c1[k] for k in c0} == eager_launches
    assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C", [(42 * 5184, 320), (1001, 640), (77, 1280), (3, 2), (42 * 324 + 5, 1280),
                                    (5, 640), (1001, 322), (1, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel_matches_plain(cuda, rows, C, dtype):
    """K5 against ln_reduce: the probe's shape, ragged row counts, the
    UNet's other widths, fewer rows than one tile, a width whose rows are
    not a multiple of 16 bytes, the widest row, and (3, 2), whose 12 bytes
    the bulk copy cannot take."""
    rng = np.random.default_rng(rows + C)
    x = torch.from_numpy((rng.normal(size=(rows, C)) * 3 + 1.5).astype(np.float32)).to(cuda, dtype)
    g, b = (torch.from_numpy(rng.normal(size=(C,)).astype(np.float32)).to(cuda, dtype) for _ in range(2))
    before = _kernels.LAYER_NORM.launches
    out = ln_fused(x, g, b)
    assert _kernels.LAYER_NORM.launches == before + 1
    ref = ln_reduce(x, g, b).float()
    torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == dtype
    step = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    assert ((out.float() - ref).abs() <= step * ref.abs().clamp(min=1.0)).all()


@pytest.mark.cuda
def test_layer_norm_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 320), device=cuda, dtype=torch.bfloat16)
    g = torch.ones(320, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ln_fused(x.half(), g.half(), g.half())
    with pytest.raises(ValueError):
        ln_fused(x[:, :319], g[:319], g[:319])  # odd width
    with pytest.raises(ValueError):
        ln_fused(torch.zeros((2, 4096), device=cuda, dtype=torch.bfloat16), *[torch.ones(4096, device=cuda,
                 dtype=torch.bfloat16)] * 2)  # wider than MAX_WIDTH
    with pytest.raises(ValueError):
        ln_fused(x.t().contiguous().t(), g, g)  # not contiguous
    with pytest.raises(ValueError):
        ln_fused(x, g.float(), g)  # gamma of another dtype
    buf = torch.zeros(4 * 320 + 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ln_fused(buf[2:2 + 4 * 320].view(4, 320), g, g)  # 4 bytes past a 16-byte boundary


@pytest.mark.cuda
def test_dust3r_forward_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The tiny DUSt3R network with one set of flax-default weights, fp32,
    on the card and on the CPU, at mixed aspects (TF32 off for matmuls and
    convolutions). The bar is the one the JAX network is held to against a
    torch mirror (rtol 2e-3, atol 2e-4): the two devices sum convolutions
    and products in other orders, and expm1 of the point norm turns the
    raw output's absolute error into a relative error of the points."""
    from stable_virtual_camera_tpu_torch.models.dust3r import AsymmetricCroCoStereo, Dust3rSpec
    from stable_virtual_camera_tpu_torch.models.io import init_flax_defaults

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cpu = init_flax_defaults(AsymmetricCroCoStereo(Dust3rSpec.tiny()), torch.Generator().manual_seed(0))
    gpu = AsymmetricCroCoStereo(Dust3rSpec.tiny()).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    i1 = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32))
    i2 = torch.from_numpy(rng.uniform(-1, 1, (2, 48, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        ref = cpu(i1, i2)
        out = gpu(i1.to(cuda), i2.to(cuda))
    for pred, k in (("pred1", "pts3d"), ("pred1", "conf"), ("pred2", "pts3d_in_other_view"), ("pred2", "conf")):
        torch.testing.assert_close(out[pred][k].cpu(), ref[pred][k], rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
def test_tiny_cli_render_on_the_card(cuda, tmp_path):
    """`apps/cli.py --random_model True` builds the tiny fp32 bundle on the
    card with the "upstream" backend: its temporal attention (head dim 16)
    launches K2's other entry and no bf16 kernel, and the render writes
    64 x 64 frames."""
    import cv2

    from stable_virtual_camera_tpu_torch.apps import cli

    golden = str(__import__("pathlib").Path(__file__).resolve().parent.parent / "assets" / "golden_scene")
    before = _kernels.counts()
    (out_dir,) = cli.main(golden, task="img2trajvid", use_traj_prior=True, random_model=True, device="cuda",
                          work_dir=str(tmp_path), num_steps=2, guider_types=[1, 2], cfg=[2.0, 2.0],
                          sampler_verbose=False)
    after = _kernels.counts()
    assert after["time_attention_any"] > before["time_attention_any"]
    assert all(after[n] == before[n] for n in ("flash_attention", "time_attention", "flash_attention_blhd",
                                               "flash_attention_packed"))
    frames_dir = __import__("pathlib").Path(out_dir) / "samples-rgb"
    frames = [cv2.imread(str(p)) for p in sorted(frames_dir.glob("*.png"))]
    assert frames and all(f is not None and f.shape == (64, 64, 3) for f in frames)


@pytest.mark.cuda
def test_fp32_unet_forward_takes_the_plain_routes(cuda, monkeypatch):
    """An fp32 SevaUNet on the card at 32 x 32 = 1024 tokens a frame (head
    dim 64, T = 2) with the backend `attention_backend` gives it there
    ("upstream"): the blocks routed to K1 and K2 launch their fp32 entries
    (csrc/flash_attention_fp32.cu, csrc/time_attention_any.cu) and no bf16
    kernel, and the output matches the same network on the CPU (fp32, TF32
    off)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    spec = SevaSpec(model_channels=64, num_frames=2, num_head_channels=64, context_dim=64,
                    channel_mult=(1, 1), transformer_depth=(1, 1), attention_resolutions=(1,))
    cpu = init_flax_defaults(SevaUNet(spec), torch.Generator().manual_seed(0))
    gpu = SevaUNet(spec, attention_backend(None, torch.float32, cuda)).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    n = 2
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((n, 32, 32, 11), (n, 1, 64),
                                                                              (n, 32, 32, 6))]
    with torch.inference_mode():
        ref = cpu(args[0], torch.full((n,), 500), args[1], args[2], n)
        before = _kernels.counts()
        out = gpu(args[0].to(cuda), torch.full((n,), 500, device=cuda), args[1].to(cuda), args[2].to(cuda), n)
        torch.cuda.synchronize()
    after = _kernels.counts()
    assert after["flash_attention_fp32"] > before["flash_attention_fp32"]
    assert after["time_attention_any"] > before["time_attention_any"]
    assert all(after[n] == before[n] for n in ("flash_attention", "time_attention"))
    assert torch.isfinite(out).all() and _rel(out.cpu(), ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", [(2, 20, 567), (2, 10, 2268)])
def test_ring_attention_with_k1_matches_the_ring_with_its_plain_twin(cuda, B, H, L):
    """The view-sharded joint attention on one card: 3 ranks on repeated
    cuda:0, each on its own stream, each block through K1 (n launches a
    rank) against the same ring through the plain twin, and against K1 over
    the whole sequence; L is a rank's share of the 576x576 render's ds8 and
    ds4 joint tokens (1701 / 3, 6804 / 3). K1's bars (max 2e-2, mean 2e-3)."""
    from stable_virtual_camera_tpu_torch.parallel.comm import run_ranks
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh
    from stable_virtual_camera_tpu_torch.parallel.ring_attention import ring_attention

    n = 3
    rng = np.random.default_rng(L)
    q, k, v = _bf16(rng, (B, n * L, 3, H, 64), cuda).permute(2, 0, 3, 1, 4).unbind(0)
    mesh = make_mesh(1, n, devices=[cuda] * n)

    def ring(kernel):
        def shard(ctx):
            rows = slice(ctx.view * L, (ctx.view + 1) * L)
            return ring_attention(q[:, :, rows], k[:, :, rows], v[:, :, rows], ctx.comm, kernel)
        return torch.cat(run_ranks(mesh, shard), dim=2)

    before = _kernels.FLASH_ATTENTION.launches
    out = ring(True)
    assert _kernels.FLASH_ATTENTION.launches == before + n * n
    twin = ring(False)
    whole = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    for ref in (twin, whole):
        diff = (out.float() - ref.float()).abs()
        assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", [(1, 20, 567), (1, 10, 100)])
def test_ring_backward_blocks_through_the_kernels_match_the_plain_blocks(cuda, B, H, L):
    """The ring's backward (ring_backward) over 3 ranks' saved tensors: each
    (query shard, key shard) block through K1-dKV and K1-dQ with the global
    lse and D (one launch of each a block) against the same blocks through
    the plain backward, and against the plain backward of the whole
    sequence; L is a rank's share (the ds8 joint site of a 576x576 train
    step, and a ragged one). The K1 backward's bar (relative L2 2e-2)."""
    from stable_virtual_camera_tpu_torch.parallel.ring_attention import ring_backward

    n = 3
    rng = np.random.default_rng(L)
    q, k, v = _bf16(rng, (B, n * L, 3, H, 64), cuda).permute(2, 0, 3, 1, 4).unbind(0)
    do = _bf16(rng, (B, n * L, H, 64), cuda).transpose(1, 2)
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    cut = [slice(r * L, (r + 1) * L) for r in range(n)]
    # o and lse as the ring's forward keeps them: contiguous, by rank
    saved = [(q[:, :, c], k[:, :, c], v[:, :, c], o[:, :, c].contiguous(), lse[:, :, c].contiguous())
             for c in cut]
    grads = [(do[:, :, c],) for c in cut]
    before = _kernels.counts()
    kern = ring_backward(saved, grads, kernel=True)
    torch.cuda.synchronize()
    after = _kernels.counts()
    for key in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert after[key] == before[key] + n * n
    plain = ring_backward(saved, grads, kernel=False)
    whole = flash_attention_bwd_plain(q, k, v, o, lse, do)
    for i in range(3):
        got = torch.cat([kern[r][i] for r in range(n)], dim=2)
        assert torch.isfinite(got).all()
        assert _rel(got, whole[i]) <= 2e-2
        for r in range(n):
            assert _rel(kern[r][i], plain[r][i]) <= 2e-2


@pytest.mark.cuda
def test_one_rank_ring_is_k1_bit_for_bit(cuda):
    """A 1-rank ring on its own stream returns K1's output (written with the
    LSE) bit for bit, and K1 writes the same o with and without its LSE."""
    from stable_virtual_camera_tpu_torch.parallel.comm import run_ranks
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh
    from stable_virtual_camera_tpu_torch.parallel.ring_attention import ring_attention

    rng = np.random.default_rng(3)
    q, k, v = _bf16(rng, (2, 1701, 3, 20, 64), cuda).permute(2, 0, 3, 1, 4).unbind(0)
    (out,) = run_ranks(make_mesh(1, 1, devices=[cuda]), lambda ctx: ring_attention(q, k, v, ctx.comm))
    o_lse, _ = flash_attention_cuda(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, o_lse) and torch.equal(o_lse, flash_attention_cuda(q, k, v))


@pytest.mark.cuda
def test_rank_threads_start_on_a_card_the_cache_fills(cuda):
    """A rank's stream and a new rank thread's cuBLAS and cuDNN handles are
    created outside the caching allocator. With its cache holding the card,
    a mesh of more ranks than any earlier call still starts, each rank's
    bf16 matmul and conv within 1e-2 of the caller's (the libraries may pick
    other algorithms on other streams); meshes built one after another share
    their ranks' streams, and a mesh's ranks on one card each have their own."""
    import torch.nn.functional as F

    from stable_virtual_camera_tpu_torch.parallel.comm import HANDLE_HEADROOM, run_ranks
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh

    n = 16
    rng = np.random.default_rng(5)
    a, x, w = (_bf16(rng, s, cuda) for s in ((256, 256), (1, 8, 32, 32), (8, 8, 3, 3)))

    def work():
        return a @ a, F.conv2d(x, w, padding=1)

    ref = work()
    held, size = [], 1 << 30
    while size >= 2 << 20:
        try:
            held.append(torch.empty(size, dtype=torch.uint8, device=cuda))
        except torch.cuda.OutOfMemoryError:
            size //= 2
    del held  # every block stays in the allocator's cache
    assert torch.cuda.mem_get_info(cuda)[0] < HANDLE_HEADROOM
    mesh = make_mesh(1, n, devices=[cuda] * n)
    outs = run_ranks(mesh, lambda ctx: work())
    torch.cuda.synchronize()
    for out in outs:
        for o, r in zip(out, ref):
            assert (o.float() - r.float()).abs().max().item() <= 1e-2 * r.float().abs().max().item()
    assert make_mesh(2, 8, devices=[cuda] * n).stream(5) is mesh.stream(5)
    assert len({id(mesh.stream(r)) for r in range(n)}) == n
