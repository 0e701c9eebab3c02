"""What the CPU can check of the Hopper forward tile and of the attention
dispatch: the tensor maps that K1, K3 and K4 hand the tile, the views TMA
cannot take, and the attention routes (every model on the card takes the
kernel backends, bf16 and fp32 alike; K2 takes every head dim).

`tma_dims_strides` turns a (B, H, L, 64) view into dims (64, L, H, B) and
byte strides (row, head, batch); the backward kernels K1-dKV and K1-dQ
read q, k, v and do through the same maps (`_check_bwd`). Each layout's
view (K1's permuted views of a packed (B, L, 3, H, 64) projection, K3's
split-qkv chunks seen as
(B, L, H, 64), K4's packed (B, L, W) chunks, and the outputs) is rebuilt
from those numbers with `torch.as_strided` over its base storage and must
equal the view element for element. The CUDA tests of the tile itself are
in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models import unet as unet_mod
from stable_virtual_camera_tpu_torch.models.io import attention_backend, init_flax_defaults
from stable_virtual_camera_tpu_torch.ops import flash_attention as fa
from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as fap
from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu


def _base(n: int) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32).to(torch.bfloat16)


def _rebuilt(view: torch.Tensor) -> torch.Tensor:
    """The (B, H, L, 64) tensor that a tensor map with these dims and
    strides reads from the view's storage."""
    (D, L, H, B), (row, head, batch) = fu.tma_dims_strides(view)
    assert all(s % 16 == 0 for s in (row, head, batch))
    storage = torch.empty(0, dtype=view.dtype).set_(view.untyped_storage())
    es = view.element_size()
    offset = (view.data_ptr() - storage.data_ptr()) // es
    return torch.as_strided(storage, (B, H, L, D), (batch // es, head // es, row // es, 1), offset)


def _layouts(B: int, L: int, H: int):
    """(name, (B, H, L, 64) view) for every operand layout of K1, K3 and K4
    as their wrappers hand it to `tma_dims_strides`."""
    W = H * 64
    packed = _base(B * L * 3 * H * 64).view(B, L, 3, H, 64)
    for i, t in enumerate(packed.permute(2, 0, 3, 1, 4).unbind(0)):
        yield f"k1_qkv{i}", t
    yield "k1_contiguous", _base(B * H * L * 64).view(B, H, L, 64)
    yield "k1_out", fu._empty_like_bhld(torch.empty((B, H, L, 64), dtype=torch.bfloat16)).fill_(1.5)
    split = _base(B * L * 3 * W).view(B, L, 3 * W)
    for i, t in enumerate(split.chunk(3, dim=-1)):
        yield f"k3_chunk{i}", t.view(B, L, H, 64).transpose(1, 2)
        yield f"k4_chunk{i}", fap._bhld(t, H)
    yield "k3_k4_out", fap._bhld(_base(B * L * W).view(B, L, W), H)


@pytest.mark.parametrize("B,L,H", [(2, 100, 3), (1, 1296, 5), (3, 64, 2)])
def test_tensor_maps_rebuild_every_layout(B, L, H):
    for name, view in _layouts(B, L, H):
        dims, _ = fu.tma_dims_strides(view)
        assert dims == (64, L, H, B), name
        assert torch.equal(_rebuilt(view), view), name


def _refusals():
    ok = torch.zeros((1, 2, 100, 64), dtype=torch.bfloat16)
    wide = torch.zeros((1, 2, 100, 128), dtype=torch.bfloat16)
    odd_rows = torch.zeros((1, 2, 100, 68), dtype=torch.bfloat16)
    flat = torch.zeros(1 * 2 * 100 * 64 + 8, dtype=torch.bfloat16)
    return ok, {
        "head dim not contiguous": wide[..., ::2],
        "row stride of 136 bytes": odd_rows[..., :64],
        "base 2 bytes off": flat[1:1 + 2 * 100 * 64].view(1, 2, 100, 64),
    }


@pytest.mark.parametrize("case", ["head dim not contiguous", "row stride of 136 bytes", "base 2 bytes off"])
def test_views_tma_cannot_take_raise_before_any_launch(case):
    ok, bad = _refusals()
    t = bad[case]
    with pytest.raises(ValueError):
        fu.tma_dims_strides(t)
    before = _kernels.counts()
    with pytest.raises(ValueError):
        fu.flash_attention_cuda(t, ok, ok)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(*(x.transpose(1, 2) for x in (t, ok, ok)))
    assert _kernels.counts() == before


def test_packed_views_tma_cannot_take_raise_before_any_launch():
    ok = torch.zeros((1, 100, 128), dtype=torch.bfloat16)
    odd = torch.zeros((1, 100, 132), dtype=torch.bfloat16)[..., :128]  # 264-byte rows
    before = _kernels.counts()
    with pytest.raises(ValueError):
        fap.flash_attention_packed_cuda(odd, ok, ok, 2)
    assert _kernels.counts() == before


def _bwd_operands(B: int, L: int, H: int):
    """What autograd hands K1's backward: q, k, v as K1's permuted views of
    a packed (B, L, 3, H, 64) projection, do as the (B, H, L, 64) view of a
    (B, L, H * 64) gradient (to_out's input), and contiguous fp32 lse and
    delta."""
    q, k, v = _base(B * L * 3 * H * 64).view(B, L, 3, H, 64).permute(2, 0, 3, 1, 4).unbind(0)
    do = _base(B * L * H * 64).view(B, L, H * 64).view(B, L, H, 64).transpose(1, 2)
    rows = torch.zeros((B, H, L), dtype=torch.float32)
    return q, k, v, do, rows, rows.clone()


@pytest.mark.parametrize("B,L,H", [(1, 1701, 2), (2, 100, 3), (1, 1001, 1)])
def test_backward_check_takes_autograd_layouts(B, L, H):
    """`_check_bwd` takes the views autograd hands the backward, with the
    tensor-map strides of q, k, v and do in the kernels' order, and takes
    lse and delta whatever 4 L is modulo 16 (they are not read by TMA):
    L = 1701 and 1001 give row strides of 6804 and 4004 bytes."""
    ops = _bwd_operands(B, L, H)
    assert fu._check_bwd(*ops) == (B, H, L, [s for t in ops[:4] for s in fu.tma_dims_strides(t)[1]])
    for t in ops[:4]:
        assert torch.equal(_rebuilt(t), t)


@pytest.mark.parametrize("which", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["head dim not contiguous", "row stride of 136 bytes", "base 2 bytes off"])
def test_backward_refuses_views_tma_cannot_take(which, case):
    """A q, k, v or do view that a tensor map cannot take raises before any
    launch, in both backward kernels' wrappers."""
    ops = list(_bwd_operands(1, 100, 2))
    ops[which] = _refusals()[1][case]
    before = _kernels.counts()
    for fn in (fu._check_bwd, fu.flash_attention_bwd_dkv_cuda, fu.flash_attention_bwd_dq_cuda):
        with pytest.raises(ValueError):
            fn(*ops)
    assert _kernels.counts() == before


def test_attention_delta_is_the_fp32_row_sum():
    """D = rowsum(o dO), computed with dO upcast inside the product, equals
    the reduction of two fp32 copies bit for bit, on K1's output layout."""
    rng = np.random.default_rng(2)
    B, H, L = 2, 3, 100
    o, do = (torch.from_numpy(rng.normal(size=(B, L, H, 64)).astype(np.float32)).to(torch.bfloat16)
             .transpose(1, 2) for _ in range(2))
    delta = fu.attention_delta(o, do)
    assert delta.dtype == torch.float32 and delta.shape == (B, H, L)
    assert torch.equal(delta, (o.float() * do.float()).sum(-1))


def test_flash_predicates_take_bf16_head_dim_64_only():
    """The kernels take bf16 and fp32 (the fp32 entries), as the JAX kernels
    do: `attention_backend` gives every model "upstream" unless a backend
    is asked for, an fp32 model on the card included, and takes every
    backend asked for in either dtype on either device."""
    assert attention_backend(None, torch.bfloat16, "cuda") == "upstream"
    assert attention_backend(None, torch.float32, "cuda") == "upstream"
    assert attention_backend(None, torch.float32, "cpu") == "upstream"
    assert attention_backend("plain", torch.float32, torch.device("cuda", 0)) == "plain"
    for name in ("upstream", "flash", "packed"):
        assert attention_backend(name, torch.bfloat16, "cuda:0") == name
        assert attention_backend(name, torch.float32, "cpu") == name
        assert attention_backend(name, torch.float32, "cuda") == name


@pytest.mark.parametrize("backend,dim_head,T,route", [
    ("upstream", 64, 21, "k2"),
    ("flash", 64, 32, "k2"),
    # K2's other entry takes head dim 16 (the case's id names the route it
    # had before that entry)
    pytest.param("upstream", 16, 21, "k2", id="upstream-16-21-plain"),
    ("plain", 64, 21, "plain"),
    ("upstream", 64, 33, None),      # past the frame cap: the einsum path
])
def test_time_predicate_takes_bf16_head_dim_64_and_up_to_32_frames(monkeypatch, backend, dim_head, T, route):
    """Temporal attention's route follows the backend and T, never the
    tensors: K2 for T <= 32 under a kernel backend, whatever the head dim,
    its plain version under "plain"."""
    calls = []
    for name, attr in (("k2", "time_attention_bhds"), ("plain", "time_attention_plain")):
        fn = getattr(unet_mod, attr)
        monkeypatch.setattr(unet_mod, attr, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    attn = unet_mod.SelfAttention(2 * dim_head, 2, dim_head, attention=backend)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(T, 5, 2 * dim_head)).astype(np.float32))
    with torch.inference_mode():
        assert torch.isfinite(attn(x, time_frames=T)).all()
    assert calls == ([route] if route else [])


def test_unet_routes_on_the_cpu_are_unchanged(monkeypatch):
    """On CPU tensors the UNet calls the kernel wrappers (which run their
    plain versions there) for every block it routed to K1 and K2 before,
    fp32 included: the CPU parity numbers do not move. The "plain" backend
    takes the same routes through the plain versions, to the same bits."""
    spec = SevaSpec(model_channels=64, num_frames=2, num_head_channels=64, context_dim=64,
                    channel_mult=(1, 1), transformer_depth=(1, 1), attention_resolutions=(1,))
    unet = init_flax_defaults(unet_mod.SevaUNet(spec), torch.Generator().manual_seed(0))
    plain = unet_mod.SevaUNet(spec, attention="plain")
    plain.load_state_dict(unet.state_dict())
    calls = {"k1": 0, "k2": 0, "k1_plain": 0, "k2_plain": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name, attr in (("k1", "flash_attention_upstream_bhld"), ("k2", "time_attention_bhds"),
                       ("k1_plain", "flash_attention_plain"), ("k2_plain", "time_attention_plain")):
        monkeypatch.setattr(unet_mod, attr, counted(name, getattr(unet_mod, attr)))
    rng = np.random.default_rng(0)
    n = 2
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((n, 32, 32, 11), (n, 1, 64), (n, 32, 32, 6))]
    with torch.inference_mode():
        out = unet(args[0], torch.full((n,), 500), args[1], args[2], n)
        assert torch.isfinite(out).all()
        assert calls["k1"] > 0 and calls["k2"] > 0 and calls["k1_plain"] == calls["k2_plain"] == 0
        out_plain = plain(args[0], torch.full((n,), 500), args[1], args[2], n)
    assert calls["k1_plain"] == calls["k1"] and calls["k2_plain"] == calls["k2"]
    assert torch.equal(out_plain, out)
