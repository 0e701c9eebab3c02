"""The port's dynamic W8A8 serving path (ops/quant.py, the quantized sites of
models/unet.py) against the JAX package's, on the CPU in fp32.

The same numpy-seeded inputs go through each JAX function (its layouts:
dense kernels (in, out), convs HWIO) and the port's (Linear (out, in), conv
OIHW). The int8 values and scales are held bit-equal, the outputs to fp32
rounding (the int32 products are exact on both sides and the rescales run
the same operations in the same order). The JAX side takes its mode from
SVC_QUANT through monkeypatch, as tests/test_quant.py does.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.models import unet as t_unet
from stable_virtual_camera_tpu_torch.ops import quant as tq
from stable_virtual_camera_tpu_torch.ops.resize import (
    pixel_shuffle_2x,
    rearranged_upsample_weight,
    upsample_2x_conv3x3,
)
from test_torch_unet import _attention_pair, _unet_inputs
from test_torch_weights import port_and_flax_params

T = 3
# the port's outputs against JAX's: fp32 rounding of the same operations
OUT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's tiny tensors on one intra-op thread: when the
    suite's workers oversubscribe the cores, thousands of small parallel
    regions each wait at a barrier for descheduled threads (a tiny render
    took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jq():
    from stable_virtual_camera_tpu.ops import quant as jq

    return jq


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dense_w(w_in_out):
    """A JAX (in, out) kernel as the port's (out, in) weight."""
    return _t(w_in_out.T)


def _conv_w(w_hwio):
    """A JAX HWIO kernel as the port's OIHW weight."""
    return _t(w_hwio.transpose(3, 2, 0, 1))


def _close(got, ref, rtol=OUT_RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["rowwise", "colwise", "persample", "conv_kernel", "static"])
def test_quantizers_match_jax(kind):
    jq = _jq()
    rng = np.random.default_rng(0)
    if kind == "rowwise":
        x = (rng.normal(size=(37, 48)) * 3).astype(np.float32)
        x[5] = 0.0  # an all-zero token
        jout, tout = jq.quantize_rowwise(jnp.asarray(x)), tq.quantize_rowwise(_t(x))
    elif kind == "colwise":
        w = rng.normal(size=(48, 40)).astype(np.float32)
        jout = jq.quantize_colwise(jnp.asarray(w))
        q, s = tq.quantize_colwise(_dense_w(w))
        tout = (q.t(), s.t())
    elif kind == "persample":
        x = rng.normal(size=(3, 6, 5, 16)).astype(np.float32)
        jout, tout = jq.quantize_persample(jnp.asarray(x)), tq.quantize_persample(_t(x))
    elif kind == "conv_kernel":
        w = (rng.normal(size=(3, 3, 16, 24)) * 0.1).astype(np.float32)
        jout = jq.quantize_conv_kernel(jnp.asarray(w))
        q, s = tq.quantize_conv_kernel(_conv_w(w))
        tout = (q.permute(2, 3, 1, 0), s.reshape(1, 1, 1, -1))
    else:
        x = (rng.normal(size=(9, 32)) * 2).astype(np.float32)
        ax = np.float32(2.5)  # below the max: saturates some values
        jout = jq.quantize_static(jnp.asarray(x), jnp.asarray(ax))
        tout = tq.quantize_static(_t(x), torch.tensor(ax))
    (jqv, js), (tqv, ts) = jout, tout
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _dense_case(rng, rows, c_in=64, c_out=80):
    x = rng.normal(size=(rows, c_in)).astype(np.float32)
    w = (rng.normal(size=(c_in, c_out)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(c_out,)) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("rows,c_in,c_out", [
    (7 * 129, 64, 80),  # many tokens
    (6, 64, 80),        # 2T rows of the cross-attention at T=3: padded to 17
    (16, 64, 80),       # the last row count that is padded
    (17, 36, 20),       # K and N not multiples of 8: padded
])
def test_quantized_dense_matches_jax(rows, c_in, c_out):
    jq = _jq()
    x, w, b = _dense_case(np.random.default_rng(rows), rows, c_in, c_out)
    ref = jq.quantized_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tq.quantized_dense(_t(x), _dense_w(w), _t(b))
    _close(got.numpy(), ref)
    # static: a calibrated abs-max below the max (saturating) and the
    # prequantized weight in each side's layout
    ax = np.float32(np.abs(x).max() * 0.8)
    jwq, jws = jq.quantize_colwise(jnp.asarray(w))
    twq, tws = tq.quantize_colwise(_dense_w(w))
    ref = jq.quantized_dense_static(jnp.asarray(x), jwq, jws, jnp.asarray(ax), bias=jnp.asarray(b))
    got = tq.quantized_dense_static(_t(x), twq, tws.reshape(-1), torch.tensor(ax), bias=_t(b))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_quantized_conv_matches_jax(k, stride):
    """ResBlock 3x3, Downsample 3x3 stride 2 and the 1x1 skip, dynamic and
    static, SAME padding as the UNet gives them."""
    jq = _jq()
    rng = np.random.default_rng(10 * k + stride)
    x = rng.normal(size=(3, 11, 9, 16)).astype(np.float32)
    w = (rng.normal(size=(k, k, 16, 24)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(24,)) * 0.1).astype(np.float32)
    pad = k // 2
    jpad = [(pad, pad)] * 2
    ref = jq.quantized_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), strides=(stride,) * 2,
                            padding=jpad)
    got = tq.quantized_conv(_t(x), _conv_w(w), _t(b), stride, pad)
    _close(got.numpy(), ref)
    ax = np.float32(np.abs(x).max() * 0.9)
    jwq, jws = jq.quantize_conv_kernel(jnp.asarray(w))
    twq, tws = tq.quantize_conv_kernel(_conv_w(w))
    ref = jq.quantized_conv_static(jnp.asarray(x), jwq, jws, jnp.asarray(ax), bias=jnp.asarray(b),
                                   strides=(stride,) * 2, padding=jpad)
    got = tq.quantized_conv_static(_t(x), twq, tws.reshape(-1), torch.tensor(ax), bias=_t(b),
                                   stride=stride, padding=pad)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_im2col_product_is_the_integer_conv(k, stride, pad):
    """The im2col product of int8 values equals the convolution of the same
    integers computed in float64 (exact at these magnitudes)."""
    g = torch.Generator().manual_seed(k + stride)
    xq = torch.randint(-127, 128, (2, 9, 7, 24), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (16, 24, k, k), generator=g, dtype=torch.int8)
    got = tq._int8_conv(xq, wq, stride, pad)
    ref = F.conv2d(xq.double().permute(0, 3, 1, 2), wq.double(), stride=stride, padding=pad)
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), ref.permute(0, 2, 3, 1))


@pytest.mark.parametrize("rows,k,n", [(1, 8, 8), (6, 64, 320), (16, 40, 24), (17, 36, 20), (40, 13, 7)])
def test_int8_matmul_pads_and_is_exact(rows, k, n):
    g = torch.Generator().manual_seed(rows)
    a = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = tq.int8_matmul(a, w)
    assert got.shape == (rows, n) and got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ w.long().t())


def test_zero_rows_are_finite_and_static_saturates():
    out = tq.quantized_dense(torch.zeros(4, 16), torch.zeros(8, 16), bias=torch.ones(8))
    assert torch.isfinite(out).all() and torch.equal(out, torch.ones(4, 8))
    wq, ws = tq.quantize_colwise(torch.eye(4))
    x = torch.tensor([[0.5, 1.0, 4.0, -9.0]])
    got = tq.quantized_dense_static(x, wq, ws.reshape(-1), torch.tensor(1.0))[0]
    np.testing.assert_allclose(got[:2].numpy(), [0.5, 1.0], atol=0.02)
    np.testing.assert_allclose(got[2:].numpy(), [1.0, -1.0], atol=0.02)  # saturated
    out = tq.quantized_conv_static(torch.zeros(1, 4, 4, 8), *_conv_site(torch.zeros(8, 8, 3, 3)),
                                   torch.tensor(0.0), bias=torch.ones(8))
    assert torch.isfinite(out).all() and torch.equal(out, torch.ones(1, 4, 4, 8))


def _conv_site(w):
    q, s = tq.quantize_conv_kernel(w)
    return q, s.reshape(-1)


def test_quantized_upsample_matches_jax():
    """The Upsample under w8a8: the rearranged kernel (bit-equal to JAX's),
    then JAX's upsample_2x_conv3x3(quant=True); in mode "0" the port's
    nearest + conv is the rearranged form's exact math."""
    from stable_virtual_camera_tpu.ops.resize import upsample_2x_conv3x3 as j_up

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 16, 16)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    ref_q = j_up(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), quant=True)
    up = t_unet.Upsample(16)
    with torch.no_grad():
        up.conv.weight.copy_(_conv_w(w))
        up.conv.bias.copy_(_t(b))
    up.set_quant("w8a8")
    with torch.inference_mode():
        got_q = up(_t(x))
        w2 = rearranged_upsample_weight(up.conv.weight)
    _close(got_q.numpy(), ref_q)
    # JAX's rearranged HWIO kernel, rebuilt from its docstring's tap map
    taps = ((-1, 0, 0), (0, 0, 1))
    jw2 = np.zeros((3, 3, 16, 4, 16), np.float32)
    for di in (0, 1):
        for dj in (0, 1):
            for ki in range(3):
                for kj in range(3):
                    jw2[taps[di][ki] + 1, taps[dj][kj] + 1, :, di * 2 + dj] += w[ki, kj]
    np.testing.assert_array_equal(w2.permute(2, 3, 1, 0).numpy(), jw2.reshape(3, 3, 16, 64))
    exact = upsample_2x_conv3x3(_t(x), up.conv.weight, up.conv.bias)
    shuffled = pixel_shuffle_2x(F.conv2d(_t(x).permute(0, 3, 1, 2), w2, padding=1)
                                .permute(0, 2, 3, 1) + up.conv.bias.repeat(4))
    np.testing.assert_allclose(exact.detach().numpy(), shuffled.detach().numpy(), atol=1e-5)


def test_w8a8_flash_projection_branch(monkeypatch):
    """The flash route (dim_head 64, L >= 1024) under w8a8 quantizes qkv and
    to_out on the same tensors as the generic route, so the two agree to fp32
    tolerance (as JAX's test_w8a8_flash_projection_branch holds its two
    branches), and the flash route agrees with JAX's flash branch (its
    Pallas kernel replaced by an exact SDPA, as there) within FLIP_REL_L2:
    across the two frameworks fp32 rounding of the attention flips a few
    int8 decisions of to_out's input (0.1% of the outputs here, each by about
    one int8 step)."""
    import stable_virtual_camera_tpu.ops.flash_upstream as fu
    from stable_virtual_camera_tpu.models.unet import Attention

    def fake_flash(q, k, v):
        s = jnp.einsum("bhld,bhsd->bhls", q, k) * (q.shape[-1] ** -0.5)
        return jnp.einsum("bhls,bhsd->bhld", jax.nn.softmax(s, -1), v)

    monkeypatch.setenv("SVC_QUANT", "w8a8")
    monkeypatch.setenv("SVC_UPSTREAM_FLASH", "1")
    monkeypatch.setattr(fu, "flash_attention_upstream_bhld", fake_flash)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 1024, 128)).astype(np.float32)
    params, flash = _attention_pair(2, 64, 128, x)
    generic = t_unet.SelfAttention(128, 2, 64, attention="flash")
    generic.load_state_dict(flash.state_dict())
    for m in (flash, generic):
        for layer in (m.qkv, m.to_out):
            layer.set_quant("w8a8")
    ref = Attention(heads=2, dim_head=64, use_pallas=True).apply(params, jnp.asarray(x))
    with torch.inference_mode():
        out_flash, out_generic = flash(_t(x)), generic(_t(x))
    assert torch.isfinite(out_flash).all()
    np.testing.assert_allclose(out_flash.numpy(), out_generic.numpy(), atol=1e-4, rtol=1e-4)
    ref = np.asarray(ref)
    assert np.linalg.norm(out_flash.numpy() - ref) / np.linalg.norm(ref) < FLIP_REL_L2


@pytest.mark.parametrize("frames,quantized", [(21, False), (33, True)])
def test_w8a8_temporal_branch_matches_jax(monkeypatch, frames, quantized):
    """Temporal self-attention under w8a8: at T <= 32 both sides keep the
    projections exact (JAX's time-kernel branch, the port's K2 branch) and
    agree as the exact path does; above 32 frames both quantize them and
    agree within FLIP_REL_L2 (a few int8 decisions of to_out's input flip
    under the two frameworks' fp32 rounding of the attention)."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.models.unet import Attention

    monkeypatch.setenv("SVC_TIME_PALLAS", "1")
    rng = np.random.default_rng(frames)
    b, S, C = 1, 24, 128
    x = rng.normal(size=(b * frames, S, C)).astype(np.float32)
    params, port = _attention_pair(2, 64, C, x, time_frames=frames)
    exact = port(_t(x), time_frames=frames).detach()
    monkeypatch.setenv("SVC_QUANT", "w8a8")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(Attention(heads=2, dim_head=64, use_pallas=True).apply(
            params, jnp.asarray(x), time_frames=frames
        ))
    for layer in (port.qkv, port.to_out):
        layer.set_quant("w8a8")
    with torch.inference_mode():
        out = port(_t(x), time_frames=frames)
    assert torch.equal(out, exact) != quantized
    if quantized:
        assert np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref) < FLIP_REL_L2
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def bridged():
    return port_and_flax_params(seed=4)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _blocks(unet):
    """(name, port block, JAX block, inputs) for every top-level block of the
    tiny UNet, with numpy-seeded inputs at its width."""
    from stable_virtual_camera_tpu.models import unet as ju

    rng = np.random.default_rng(11)
    sp = unet.spec
    emb = rng.normal(size=(2 * T, 4 * sp.model_channels)).astype(np.float32)
    dense = rng.normal(size=(2 * T, 8, 8, 6)).astype(np.float32)
    ctx = rng.normal(size=(2 * T, 1, sp.context_dim)).astype(np.float32)
    out = []
    for name, mod in unet.named_children():
        if isinstance(mod, t_unet.ResBlock):
            x = rng.normal(size=(2 * T, 8, 8, mod.in_gn.gn.weight.shape[0])).astype(np.float32)
            out.append((name, mod, ju.ResBlock(mod.in_conv.out_channels), [x, emb, dense], {}))
        elif isinstance(mod, (t_unet.Downsample, t_unet.Upsample)):
            c = mod.conv.in_channels
            x = rng.normal(size=(2 * T, 8, 8, c)).astype(np.float32)
            cls = ju.Downsample if isinstance(mod, t_unet.Downsample) else ju.Upsample
            out.append((name, mod, cls(c), [x], {}))
        elif isinstance(mod, t_unet.MultiviewTransformer):
            c = mod.proj_in.in_features
            x = rng.normal(size=(2 * T, 4, 4, c)).astype(np.float32)
            jm = ju.MultiviewTransformer(heads=c // sp.num_head_channels, dim_head=sp.num_head_channels,
                                         depth=mod.depth, unflatten=mod.unflatten, use_pallas=True)
            out.append((name, mod, jm, [x, ctx], {"num_frames": T}))
    return out


# int8 decisions that the two frameworks' fp32 rounding flips: an attention
# path's w8a8 output may differ from JAX's by FLIP_REL_L2 relative L2, a
# block's by half its own w8a8-vs-exact gap; most blocks are the same to
# fp32 rounding (their median is held to BLOCK_MEDIAN)
FLIP_REL_L2 = 5e-3
BLOCK_MEDIAN = 1e-5


def block_rels(monkeypatch, unet, trees, mode, quant=None) -> dict:
    """{block: (rel L2 of the port's output to JAX's in `mode`, JAX's own
    `mode`-vs-exact gap)} over every top-level block of the tiny UNet (JAX on
    its time-kernel branch in interpret mode; `quant`: JAX's "quant"
    collection for the static mode). Each block is also held exact in mode
    "0"."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("SVC_TIME_PALLAS", "1")
    out = {}
    for name, mod, jm, args, kw in _blocks(unet):
        layers = [m for m in mod.modules() if isinstance(m, t_unet._Quantizable)]
        got, ref = {}, {}
        for m_ in ("0", mode):
            monkeypatch.setenv("SVC_QUANT", m_)
            variables = {"params": trees["unet"][name]}
            if m_ == "w8a8-static":
                variables["quant"] = quant.get(name, {})
            with pltpu.force_tpu_interpret_mode():
                ref[m_] = np.asarray(jm.apply(variables, *map(jnp.asarray, args), **kw))
            for m in layers:
                m.set_quant(m_)
            with torch.inference_mode():
                got[m_] = mod(*map(_t, args), **kw).numpy()
        for m in layers:
            m.set_quant("0")
        assert _rel(got["0"], ref["0"]) < 2e-6, name
        out[name] = (_rel(got[mode], ref[mode]), _rel(ref[mode], ref["0"]))
    assert len(out) == 44  # every ResBlock, Downsample, Upsample and transformer
    return out


def check_blocks(rels: dict) -> None:
    for name, (rel, gap) in rels.items():
        assert rel < gap / 2, (name, rel, gap)
    assert np.median([rel for rel, _ in rels.values()]) < BLOCK_MEDIAN, rels


def test_every_unet_block_w8a8_matches_jax(monkeypatch, bridged):
    """Each top-level block of the tiny UNet (ResBlocks with their convs and
    skips, Downsample, Upsample, every MultiviewTransformer with its
    projections and feed-forwards) under w8a8 against the same JAX block:
    exact to fp32 rounding wherever no int8 decision flips, and within half
    the block's own w8a8-vs-exact gap where some do (at most 0.7% here, in
    the deepest transformers)."""
    bundle, trees = bridged
    check_blocks(block_rels(monkeypatch, bundle.unet, trees, "w8a8"))


def _jax_unet(monkeypatch, trees, inputs, modes=("0", "w8a8"), variables=None):
    """JAX's tiny UNet on the time-kernel branch (interpret mode) in each of
    `modes` (SVC_QUANT)."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet

    monkeypatch.setenv("SVC_TIME_PALLAS", "1")
    unet = JaxUNet(JaxSevaSpec.tiny(), use_pallas=True)
    args = [jnp.asarray(a) for a in inputs]
    out = {}
    for mode in modes:
        monkeypatch.setenv("SVC_QUANT", mode)
        with pltpu.force_tpu_interpret_mode():
            out[mode] = np.asarray(unet.apply(variables or {"params": trees["unet"]}, *args,
                                              num_frames=T))
    return out


def test_tiny_unet_w8a8_matches_jax(monkeypatch, bridged):
    """The whole tiny UNet under w8a8 against JAX's. The quantized forward is
    discontinuous: moving JAX's own input by 1e-6 (relative, seeded noise)
    moves its w8a8 output by a few percent at these random weights, about
    its whole w8a8-vs-exact gap, while the exact output moves by ~1e-6. So
    the whole forward is held to that flip floor, and to the gap; the
    per-block and per-op tests above hold the numbers to fp32 rounding."""
    bundle, trees = bridged
    inputs = _unet_inputs(np.random.default_rng(7), 2 * T)
    ref = _jax_unet(monkeypatch, trees, inputs)
    nudged = [inputs[0] * (1 + 1e-6 * np.random.default_rng(70).normal(size=inputs[0].shape))
              .astype(np.float32)] + list(inputs[1:])
    floor = _rel(_jax_unet(monkeypatch, trees, nudged, modes=("w8a8",))["w8a8"], ref["w8a8"])
    unet = bundle.unet
    with torch.inference_mode():
        exact = unet(*map(_t, inputs), T)
        with unet.quant_mode("w8a8"):
            got = unet(*map(_t, inputs), T).numpy()
    gap = _rel(ref["w8a8"], ref["0"])
    rel = _rel(got, ref["w8a8"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(exact.numpy(), ref["0"], atol=2e-4, rtol=2e-4)
    assert rel < min(2 * floor, gap), (rel, floor, gap)


def test_mode_zero_keeps_the_exact_bits(bridged):
    """Mode "0" runs the layers' exact operations: each quantized layer is
    bit-equal to nn.Linear / the NHWC conv, and the UNet gives the same bits
    before and after a round trip through every W8A8 mode."""
    bundle, _ = bridged
    unet = bundle.unet
    inputs = [_t(a) for a in _unet_inputs(np.random.default_rng(8), 2 * T)]
    with torch.inference_mode():
        before = unet(*inputs, T)
        for mode in ("w8a8", "w8a8-calib", "w8a8-static", "0"):
            unet.set_quant(mode)
            unet(*inputs, T)
        after = unet(*inputs, T)
        unet.clear_quant_state()
        lin = unet.input_blocks_1_1.spatial_0.ff.proj_gate
        conv = unet.input_blocks_1_0.in_conv
        x = torch.randn(5, lin.in_features)
        h = torch.randn(2, 8, 8, conv.in_channels)
        assert torch.equal(lin(x), torch.nn.Linear.forward(lin, x))
        assert torch.equal(conv(h), t_unet.Conv.forward(conv, h))
    assert unet.quant == "0"
    assert torch.equal(before, after)


def test_quantized_sites_are_jax_sites(monkeypatch, bridged):
    """The port's quantized layers are exactly JAX's QuantSites: the names of
    JAX's calibrated collection of the tiny UNet (time-kernel branch, T=3)
    are the port's sites but the temporal self-attention's qkv/to_out."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet
    from stable_virtual_camera_tpu_torch.models.weights import _OPTIONAL_SITE, _quant_layers

    bundle, trees = bridged
    monkeypatch.setenv("SVC_TIME_PALLAS", "1")
    monkeypatch.setenv("SVC_QUANT", "w8a8-calib")
    args = [jnp.asarray(a) for a in _unet_inputs(np.random.default_rng(9), 2 * T)]
    with pltpu.force_tpu_interpret_mode():
        shapes = jax.eval_shape(lambda: JaxUNet(JaxSevaSpec.tiny(), use_pallas=True).apply(
            {"params": trees["unet"]}, *args, num_frames=T, mutable=["quant"])[1]["quant"])
    jax_sites = {tuple(str(getattr(k, "key", k)) for k in path[:-1])
                 for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    port = _quant_layers(bundle.unet)
    required = {k for k, (name, _) in port.items() if not _OPTIONAL_SITE.search(name)}
    assert jax_sites == required
    assert len(port) - len(required) == 2 * sum(
        1 for name, _ in bundle.unet.named_modules() if name.endswith("attn1") and "temporal" in name)
