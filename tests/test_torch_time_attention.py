"""K2's launch plan (ops/time_attention.py `_k2_plan`) on CPU tensors.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds it
against `time_attention_plain` there); its plain version is held against
the JAX package's Pallas kernel in tests/test_torch_ops.py. Here: what the
plan refuses, which copy path it picks on the UNet's views of a
(b*T, 3*H*64, S) projection, and that at every shape the render paths give
K2 the plan fits a block (227 KB of shared memory, 1024 threads) and its
items cover every (scene, head, position) exactly once. The tensors are
allocated and never written, so the full-size shapes cost no memory.
"""

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch.ops.time_attention import CEILINGS, MAX_SMEM, _k2_plan

# (S, H, T, b): the 576x576 render at T = 21 and 3, the Advanced render at
# 768x576 at T = 21 and 6
PATH_SHAPES = [(S, H, T, 2) for S, H in ((5184, 5), (1296, 10), (324, 20), (81, 20)) for T in (21, 3)] + [
    (S, H, T, 2) for S, H in ((6912, 5), (1728, 10), (432, 20), (108, 20)) for T in (21, 6)]


def _unet_views(S, H, T, b=1):
    """q, k, v as the UNet's temporal attention passes them: (b*T, H, 64, S)
    views of one (b*T, 3*H*64, S) projection (frame stride 3*H*64*S)."""
    qkv = torch.empty((b * T, 3 * H * 64, S), dtype=torch.bfloat16)
    assert qkv.data_ptr() % 16 == 0
    return qkv.view(b * T, 3, H, 64, S).unbind(1)


@pytest.mark.parametrize("case", ["head_dim_32", "too_many_frames", "frames_not_dividing", "float32",
                                  "s_not_contiguous"])
def test_k2_plan_refuses_what_the_kernel_does_not_take(case):
    q, k, v = _unet_views(64, 2, 4, b=2)
    T, err = 4, ValueError
    if case == "head_dim_32":
        q, k, v = (t[:, :, :32] for t in (q, k, v))
    elif case == "too_many_frames":
        q, k, v = _unet_views(64, 1, 33)
        T = 33
    elif case == "frames_not_dividing":
        T = 3
    elif case == "float32":
        q, err = q.float(), TypeError
    elif case == "s_not_contiguous":
        q = torch.empty((8, 2, 128, 64), dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(err):
        _k2_plan(q, k, v, T)
    _k2_plan(*_unet_views(64, 2, 4, b=2), 4)  # the well-formed call is taken


@pytest.mark.parametrize("S,copy", [(5184, "tma"), (1296, "tma"), (6912, "tma"), (1728, "tma"), (432, "tma"),
                                    (324, "cp.async.8"), (108, "cp.async.8"), (81, "span")])
def test_k2_plan_takes_the_bulk_path_exactly_where_rows_are_16_byte_multiples(S, copy):
    """On the UNet's views every row starts at a multiple of S elements from
    a 16-byte boundary, so rows are 16-byte aligned exactly when S % 8 == 0:
    TMA boxes there, cp.async of 8 bytes at S = 324 and 108, and at S = 81
    (odd) bulk copies of each frame's packed span of 16 rows."""
    plan = _k2_plan(*_unet_views(S, 2, 3), 3)
    assert plan.copy == copy
    assert (plan.copy == "tma") == (S % 8 == 0)


def _offset(shape, offset_bytes):
    """A contiguous bf16 tensor that starts `offset_bytes` past a 16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.empty((n + 16,), dtype=torch.bfloat16)
    skip = (-buf.data_ptr() % 16 + offset_bytes) // 2
    return buf[skip:skip + n].view(shape)


def test_k2_plan_copy_mode_follows_every_row_start():
    """A view whose base or any stride breaks 16-byte alignment leaves the
    bulk path, for the widest copy that divides every row start of q, k, v
    and o; odd rows whose chunks are not packed spans are copied element by
    element."""
    q, k, v = _unet_views(64, 2, 4)
    assert _k2_plan(q, k, v, 4).copy == "tma"
    assert _k2_plan(_offset((4, 2, 64, 64), 4), k, v, 4).copy == "cp.async.4"
    assert _k2_plan(q, k, v, 4, _offset((4, 2, 64, 64), 8)).copy == "cp.async.8"
    assert _k2_plan(q, k, v, 4, _offset((4, 2, 64, 64), 0)).copy == "tma"
    padded = torch.empty((4, 2, 64, 68), dtype=torch.bfloat16)[..., :66]  # rows of 66, stride 68
    assert _k2_plan(padded, padded, padded, 4).copy == "cp.async.4"
    odd = torch.empty((4, 2, 64, 84), dtype=torch.bfloat16)[..., :81]  # rows of 81, stride 84
    assert _k2_plan(odd, odd, odd, 4).copy == "loads"
    q, k, v = _unet_views(81, 2, 4)
    assert _k2_plan(q, k, v, 4).copy == "span"
    assert _k2_plan(q[..., 1:], k[..., 1:], v[..., 1:], 4).copy == "loads"  # rows of 80 at stride 81


def test_k2_plan_falls_back_from_span_where_its_staging_does_not_fit():
    """The staging area of "span" holds T * 16 * S bf16 values beside at
    least two ring stages; where that does not fit a block, "loads"."""
    plan = _k2_plan(*_unet_views(81, 2, 21), 21)
    assert plan.copy == "span" and plan.stages >= 2
    wide = _k2_plan(*_unet_views(2001, 1, 21), 21)
    assert wide.copy == "loads" and wide.smem_bytes <= MAX_SMEM


@pytest.mark.parametrize("S,H,T,b", PATH_SHAPES + [(1296, 10, T, 2) for T in (1, 6, 32)] + [(200, 1, 9, 1)])
def test_k2_plan_fits_a_block_and_covers_every_position_once(S, H, T, b):
    q, k, v = _unet_views(S, H, T, b)
    plan = _k2_plan(q, k, v, T)
    assert plan.ceiling == min(c for c in CEILINGS if c >= T)
    assert plan.smem_bytes <= MAX_SMEM and plan.smem_bytes <= 227 * 1024
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    # the consumer warps hold R query frames for each pair of positions
    assert (plan.threads - 32) * 2 // plan.positions * plan.frames_per_thread >= T
    assert plan.positions * 2 % 16 == 0 and plan.chunk * (64 // plan.chunk) == 64
    cover = np.zeros((b, H, S), dtype=np.int64)
    for i in range(plan.items):
        tile, (scene, head) = i % plan.tiles, divmod(i // plan.tiles, H)
        cover[scene, head, tile * plan.positions:(tile + 1) * plan.positions] += 1
    assert (cover == 1).all()
    assert plan.items == b * H * -(-S // plan.positions)
