"""The launch plan of K2's other entry (ops/time_attention.py `_any_plan`,
csrc/time_attention_any.cu) on CPU tensors, and its arithmetic.

The kernel runs only on the card (tests/test_torch_cuda.py holds it against
`time_attention_plain` there). Here: which copy mode the plan picks for each
alignment of q, k and v, the key-frame ceiling for each T, that the ring
fits a block's 227 KB of shared memory for every dtype, ceiling and head
dim, and that the work items, the consumer warps' query frames and the
channel chunks cover every output of every (scene, head) exactly once at
the fp32 render's and the tiny CLI's shapes; and the kernel's arithmetic
(zero-filled channels and key frames, 4- or 5-frame warps, 32-position tiles,
exp2 of log2(e)-scaled scores, o scaled by 1 / sum at the store) emulated
in plain PyTorch against JAX's Pallas kernel in interpret mode. The tensors
of the plan tests are allocated and never written, so full-size shapes cost
no memory.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.ops.time_attention import (
    ANY_FRAMES_PER_WARP,
    ANY_POSITIONS,
    CEILINGS,
    CHUNK,
    MAX_SMEM,
    _any_plan,
    k2_route,
)

# (S, H, D, T, b): the fp32 render at 576x576 (T = 21) and the tiny CLI's
# four time-mix shapes (head dim 16, T = 3)
RENDER_SHAPES = [(5184, 5, 64, 21, 2), (1296, 10, 64, 21, 2), (324, 20, 64, 21, 2), (81, 20, 64, 21, 2)]
TINY_SHAPES = [(64, 2, 16, 3, 2), (16, 4, 16, 3, 2), (4, 8, 16, 3, 2), (1, 8, 16, 3, 2)]


def _views(S, H, D, T, b, dtype=torch.float32):
    """q, k, v as the UNet passes them: (b*T, H, D, S) views of one
    (b*T, 3, H, D, S) projection."""
    qkv = torch.empty((b * T, 3, H, D, S), dtype=dtype)
    assert qkv.data_ptr() % 16 == 0
    return qkv.unbind(1)


def _offset(shape, dtype, offset_bytes):
    """A contiguous tensor that starts `offset_bytes` past a 16-byte boundary."""
    e = torch.empty((), dtype=dtype).element_size()
    n = math.prod(shape)
    buf = torch.empty((n + 16,), dtype=dtype)
    skip = (-buf.data_ptr() % 16 + offset_bytes) // e
    return buf[skip:skip + n].view(shape)


@pytest.mark.parametrize("dtype,S,copy", [
    # fp32: rows of S * 4 bytes from 16-byte boundaries
    (torch.float32, 5184, "tma"), (torch.float32, 1296, "tma"), (torch.float32, 324, "tma"),
    (torch.float32, 81, "cp.async.4"), (torch.float32, 82, "cp.async.8"),
    # bf16 and fp16: rows of S * 2 bytes
    (torch.bfloat16, 64, "tma"), (torch.bfloat16, 324, "cp.async.8"), (torch.bfloat16, 162, "cp.async.4"),
    (torch.bfloat16, 81, "loads"), (torch.float16, 16, "tma"), (torch.float16, 4, "cp.async.8"),
    (torch.float16, 2, "cp.async.4"), (torch.float16, 1, "loads"),
])
def test_any_copy_mode_follows_row_alignment(dtype, S, copy):
    """On the UNet's views every row starts at a multiple of S elements from
    a 16-byte boundary: TMA boxes where S times the element size is a
    multiple of 16 (fp32 S % 4 == 0), cp.async of 8 or 4 bytes where it is
    a multiple of that, element loads where 16-bit rows are odd."""
    assert _any_plan(*_views(S, 2, 16, 3, 1, dtype), 3).copy == copy


def test_any_copy_mode_follows_every_row_start():
    """A base address or a stride off a 16-byte boundary leaves TMA for the
    widest granule that divides every row start of q, k and v; a strided S,
    or a zero stride (no tensor map takes one), leaves it too."""
    q, k, v = _views(64, 2, 16, 4, 1)
    assert _any_plan(q, k, v, 4).copy == "tma"
    assert _any_plan(_offset(q.shape, torch.float32, 4), k, v, 4).copy == "cp.async.4"
    assert _any_plan(q, _offset(q.shape, torch.float32, 8), v, 4).copy == "cp.async.8"
    padded = torch.empty((4, 2, 16, 68))[..., :66]  # rows of 66 fp32 values at stride 68
    assert _any_plan(padded, padded, padded, 4).copy == "cp.async.8"
    strided = torch.empty((4, 2, 16, 128))[..., ::2]
    assert _any_plan(strided, strided, strided, 4).copy == "loads"
    assert _any_plan(q, k, strided, 4).copy == "loads"
    expanded = torch.empty((1, 1, 16, 64)).expand(4, 2, 16, 64)  # frame and head strides 0
    assert _any_plan(expanded, expanded, expanded, 4).copy == "cp.async.8"
    for t in (padded, strided, expanded):
        assert k2_route(t, t, t, 4) == "any"


@pytest.mark.parametrize("T,ceiling", [(1, 4), (4, 4), (5, 8), (21, 21), (22, 24), (32, 32)])
def test_any_plan_takes_the_smallest_ceiling_that_holds_t(T, ceiling):
    """Also the block: ceil(T / R) consumer warps of R query frames (R = 4,
    or 5 at the 32-frame ceiling), then one producer warp for TMA and two
    for hand copies (one at 32 frames): at most 8 warps, so that no
    scheduler holds 3 of them."""
    plan = _any_plan(*_views(100, 2, 16, T, 1), T)
    R = plan.frames_per_warp
    assert plan.ceiling == ceiling == min(c for c in CEILINGS if c >= T)
    assert R == ANY_FRAMES_PER_WARP[ceiling] == (5 if ceiling == 32 else 4)
    assert plan.copy == "tma" and plan.threads == 32 * (-(-T // R) + 1)
    hand = _any_plan(*_views(81, 2, 16, T, 1), T)
    assert hand.copy == "cp.async.4" and hand.ceiling == ceiling
    assert hand.threads == 32 * (-(-T // R) + (1 if ceiling == 32 else 2)) <= 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [7, 8, 16, 20, 24, 64, 80, 128])
def test_any_plan_fits_a_block_for_every_ceiling(dtype, D):
    """The ring holds at least one unit beyond a chunk's q and k (so the
    producer runs ahead of the scores) in 227 KB, at every ceiling; D
    changes the chunks and not the units."""
    e = torch.empty((), dtype=dtype).element_size()
    for T in CEILINGS:
        plan = _any_plan(*_views(40, 1, D, T, 1, dtype), T)
        assert plan.unit_bytes == plan.ceiling * CHUNK * ANY_POSITIONS * e
        assert 3 <= plan.stages <= 4
        assert plan.smem_bytes <= MAX_SMEM <= 227 * 1024
        assert plan.threads <= 1024 and plan.threads % 32 == 0
        assert (plan.chunks - 1) * CHUNK < D <= plan.chunks * CHUNK


@pytest.mark.parametrize("shape", RENDER_SHAPES + TINY_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_any_plan_covers_every_output_once(shape, dtype):
    """Blocks walk items blockIdx.x, + gridDim.x, ...; item i is tile i %
    tiles of (scene, head) = divmod(i // tiles, H), lane j of every consumer
    warp its position tile * 32 + j (stored below S), warp w query frames
    R w .. R w + R - 1 (stored below T), chunk c channels 16 c .. 16 c + 15
    (stored below D). Every output element is stored exactly once, for a
    full card's grid and for a grid of 7 blocks."""
    S, H, D, T, b = shape
    plan = _any_plan(*_views(S, H, D, T, b, dtype), T)
    warps = -(-T // plan.frames_per_warp)
    for grid in (min(plan.items, 132), min(plan.items, 7)):
        walked = np.concatenate([np.arange(blk, plan.items, grid) for blk in range(grid)])
        assert np.array_equal(np.sort(walked), np.arange(plan.items))
    items = np.arange(plan.items)
    tile, (scene, head) = items % plan.tiles, np.divmod(items // plan.tiles, H)
    pos = tile[:, None] * ANY_POSITIONS + np.arange(ANY_POSITIONS)[None, :]
    keep = pos < S
    cover = np.zeros((b, H, S), dtype=np.int64)
    np.add.at(cover, (np.broadcast_to(scene[:, None], pos.shape)[keep],
                      np.broadcast_to(head[:, None], pos.shape)[keep], pos[keep]), 1)
    assert (cover == 1).all()
    R = plan.frames_per_warp
    frames = (np.arange(warps)[:, None] * R + np.arange(R)).ravel()
    assert np.array_equal(np.sort(frames[frames < T]), np.arange(T))
    channels = np.arange(plan.chunks * CHUNK)
    assert np.array_equal(channels[channels < D], np.arange(D))


def _emulate_any(q, k, v, T):
    """The kernel's arithmetic in plain fp32 PyTorch: positions in tiles of
    32 (zero past S), channels zero-filled to whole 16-channel chunks, key
    frames zero-filled to the ceiling and masked, query frames in warps of R
    (rows past the ceiling read its last, not stored), unnormalised exp2 of
    log2(e)-scaled scores, o = (P V) * (1 / sum)."""
    BT, H, D, S = q.shape
    b = BT // T
    tc = min(c for c in CEILINGS if c >= T)
    dpad, spad = -(-D // CHUNK) * CHUNK, -(-S // ANY_POSITIONS) * ANY_POSITIONS
    rows = -(-T // ANY_FRAMES_PER_WARP[tc]) * ANY_FRAMES_PER_WARP[tc]

    def slab(t):  # (b, Tc, H, dpad, spad), zero past T, D and S
        out = torch.zeros((b, tc, H, dpad, spad))
        out[:, :T, :, :D, :S] = t.float().reshape(b, T, H, D, S)
        return out

    qs, ks, vs = slab(q), slab(k), slab(v)
    qrows = qs[:, [min(t, tc - 1) for t in range(rows)]]
    sc = torch.einsum("bthds,buhds->bhstu", qrows, ks)
    scale_log2 = D**-0.5 * math.log2(math.e)
    masked = sc.masked_fill(torch.arange(tc) >= T, -math.inf)
    m = masked.amax(-1, keepdim=True)
    p = torch.exp2(sc * scale_log2 - m * scale_log2).masked_fill(torch.arange(tc) >= T, 0.0)
    inv = 1.0 / p.sum(-1, keepdim=True)
    o = torch.einsum("bhstu,buhds->bthds", p, vs) * inv.permute(0, 3, 1, 4, 2)
    return o[:, :T, :, :D, :S].reshape(BT, H, D, S).to(q.dtype)


@pytest.mark.parametrize("D,T,S", [(20, 5, 40), (7, 22, 33), (64, 21, 81), (16, 31, 40)])
def test_any_arithmetic_matches_jax(D, T, S):
    """The emulated kernel against JAX's `time_attention_bhds(...,
    interpret=True)` in fp32 (rtol 1e-5): a ragged chunk and a partial tile,
    T across a ceiling (22 of 24), the model's head dim and chunk length at
    the S that takes cp.async, and 5-frame warps (31 of 32)."""
    from stable_virtual_camera_tpu.ops.time_attention import time_attention_bhds as jax_ta

    rng = np.random.default_rng(D * T + S)
    b, H = 2, 2
    q, k, v = (rng.normal(size=(b * T, H, D, S)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_ta(*(jnp.asarray(a) for a in (q, k, v)), T, s_block=128, interpret=True))
    out = _emulate_any(*(torch.from_numpy(a) for a in (q, k, v)), T)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
