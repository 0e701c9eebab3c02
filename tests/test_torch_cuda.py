"""The hand-written CUDA kernels (K1 flash attention with its log-sum-exp,
K1-dKV and K1-dQ, K2 temporal attention, K3 flash attention on (B, L, H, 64),
K4 flash attention on packed (B, L, W), K5 LayerNorm) against their plain
versions on the card, the wrappers' refusals, a backward through SevaUNet on
the card that reaches the attention weights, K3's recompute backward against
K1's kernel backward, and a DUSt3R forward on the card against the CPU.

The `cuda` tests need an NVIDIA GPU and skip elsewhere. This file imports
neither jax nor the test conftest, so on a machine with the card and no JAX
it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Inputs are unit-normal bf16 from numpy with a fixed seed. Tolerances: K1 is
bf16 out with P rounded to bf16 before P.V (max 2e-2, mean 2e-3); K2 keeps
all arithmetic in fp32 and rounds only its output (one bf16 ulp at 1, 8e-3);
K3 and K4 are K1's tile on other layouts (K1's bars);
K1's LSE is fp32 (1e-2); K1-dKV/K1-dQ round P and dS to bf16 for their
products and their outputs to bf16 (relative L2 2e-2); K5 rounds only its
output (one bf16 step; fp32 within 1e-5 of a unit output).
"""

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.io import init_flax_defaults
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", [(1, 1, 64), (2, 3, 100), (1, 2, 1100), (3, 1, 1296)])
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


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", [(1, 1, 64), (2, 3, 100), (1, 2, 1100), (3, 1, 1296)])
def test_flash_backward_kernels_match_plain(cuda, B, H, L):
    """K1's LSE, then K1-dKV and K1-dQ, against the plain versions on the
    UNet's packed-qkv views, with the incoming gradient in K1's output
    layout; ragged L included."""
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
        "time_attention": 0, "flash_attention_blhd": 0, "flash_attention_packed": 0, "layer_norm": 0}
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,H,S", [(1, 1, 1, 7), (2, 5, 3, 33), (2, 21, 2, 81), (1, 32, 1, 100)])
def test_time_kernel_matches_plain(cuda, b, T, H, S):
    rng = np.random.default_rng(T * S)
    q, k, v = _bf16(rng, (b * T, 3, H, 64, S), cuda).unbind(1)
    before = _kernels.TIME_ATTENTION.launches
    out = time_attention_bhds(q, k, v, T)
    assert _kernels.TIME_ATTENTION.launches == before + 1
    diff = (out.float() - time_attention_plain(q, k, v, T).float()).abs()
    torch.cuda.synchronize()
    assert out.shape == (b * T, H, 64, S)
    assert diff.max().item() <= 8e-3


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 1, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_upstream_bhld(q, q, q)  # fp32
    h = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_upstream_bhld(h[..., :32], h[..., :32], h[..., :32])  # D != 64
    t = torch.zeros((33, 1, 64, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        time_attention_bhds(t, t, t, 33)  # T > 32
    lse = torch.zeros((1, 1, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(q, q, q, q, lse, q)  # fp32
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
@pytest.mark.parametrize("B,H,L", [(1, 1, 64), (2, 3, 100), (1, 2, 1100), (3, 1, 1296)])
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
@pytest.mark.parametrize("B,H,L", [(1, 2, 64), (2, 4, 100), (1, 2, 1100), (2, 6, 1296)])
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
    """fp32 and a head dim other than 64 raise; neither runs the plain
    version on the card."""
    before = _kernels.counts()
    q = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)  # fp32
    h = torch.zeros((1, 64, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(h, h, h)  # D != 64
    p = torch.zeros((1, 64, 128), device=cuda)
    with pytest.raises(TypeError):
        fap.flash_attention_packed(p, p, p, 2)  # fp32
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
@pytest.mark.parametrize("rows,C", [(42 * 5184, 320), (1001, 640), (77, 1280), (3, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel_matches_plain(cuda, rows, C, dtype):
    """K5 against ln_reduce: the probe's shape, ragged row counts, the
    UNet's other widths."""
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
