"""K5's plain version (ops/layer_norm.py `ln_reduce`) against the JAX
package's LayerNorm probe (benchmark/ln_probe.py), on the CPU.

The probe's Pallas kernel `ln_pallas` runs in interpret mode at (2304, 320),
two of its 1152-row blocks, on the same numpy inputs. bf16 results agree
within one bf16 step of the output (the two sides round the same fp32
values, summed in another order); fp32 results within 1e-5. On a CPU tensor
`ln_fused` is `ln_reduce` and launches nothing; the kernel itself is held
against `ln_reduce` on the card in tests/test_torch_cuda.py. The wrapper's
checks and tile plan (`_check_ln`) are held here, on CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from benchmark import ln_probe
from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops.layer_norm import MAX_WIDTH, STAGE_BYTES, _check_ln, ln_fused, ln_reduce

ROWS, WIDTH = 2 * 1152, 320


def _inputs(dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(ROWS, WIDTH)) * 3 + 1.5).astype(np.float32)
    g = rng.normal(size=(WIDTH,)).astype(np.float32)
    b = rng.normal(size=(WIDTH,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx = [jnp.asarray(a).astype(jdt) for a in (x, g, b)]
    # the bf16 values JAX rounded, bit for bit
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jx]
    return jx, tx


def _tol(dtype, ref):
    if dtype == "bf16":  # one bf16 step of the output: 2^-7 relative
        return np.maximum(np.abs(ref), 1e-30) * 2.0**-7 + 1e-6
    return 1e-5 * np.maximum(np.abs(ref), 1.0)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_ln_reduce_matches_the_pallas_probe(dtype):
    jx, tx = _inputs(dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ln_probe.ln_pallas(*jx).astype(jnp.float32))
    out = ln_reduce(*tx).float().numpy()
    assert out.shape == (ROWS, WIDTH) and ln_reduce(*tx).dtype == tx[0].dtype
    assert (np.abs(out - ref) <= _tol(dtype, ref)).all()


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_ln_reduce_matches_the_probe_reduce(dtype):
    jx, tx = _inputs(dtype, seed=1)
    ref = np.asarray(ln_probe.ln_reduce(*jx).astype(jnp.float32))
    out = ln_reduce(*tx).float().numpy()
    assert (np.abs(out - ref) <= _tol(dtype, ref)).all()


def test_ln_fused_on_cpu_is_the_plain_version_and_launches_nothing():
    _, tx = _inputs("bf16", seed=2)
    before = _kernels.LAYER_NORM.launches
    out = ln_fused(tx[0][:1001], *tx[1:])  # a ragged row count
    assert _kernels.LAYER_NORM.launches == before
    assert torch.equal(out, ln_reduce(tx[0][:1001], *tx[1:]))


def test_ln_reduce_clamps_a_negative_one_pass_variance():
    """A constant row has E[x^2] - mean^2 <= 0 in fp32 rounding: the clamp
    keeps rsqrt finite (the output is beta)."""
    x = torch.full((4, 320), 3.1, dtype=torch.float32)
    g, b = torch.ones(320), torch.linspace(-1, 1, 320)
    out = ln_reduce(x, g, b)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, b.expand(4, 320), atol=2e-3, rtol=0)


# K5's checks and tile plan (`_check_ln`) read shapes, dtypes, strides and
# addresses only, so CPU tensors exercise them here; the kernel that follows
# the plan runs on the card (tests/test_torch_cuda.py).

def _aligned(shape, dtype=torch.bfloat16, offset_bytes=0):
    """A contiguous tensor of `shape` that starts `offset_bytes` past a
    16-byte boundary (a view into a larger buffer)."""
    esize = torch.empty((), dtype=dtype).element_size()
    n = int(np.prod(shape))
    buf = torch.zeros(n + 64 // esize, dtype=dtype)
    skip = (-buf.data_ptr() % 16 + offset_bytes) // esize
    return buf[skip:skip + n].view(shape)


@pytest.mark.parametrize("case", ["x_4_bytes_past_16", "out_4_bytes_past_16", "odd_width", "too_wide",
                                  "not_contiguous", "half", "gamma_dtype", "gamma_shape"])
def test_check_ln_refuses_what_the_kernel_does_not_take(case):
    C = 320
    x, g = _aligned((4, C)), torch.ones(C, dtype=torch.bfloat16)
    args, kwargs, err = (x, g, g), {}, ValueError
    if case == "x_4_bytes_past_16":
        args = (_aligned((4, C), offset_bytes=4), g, g)
    elif case == "out_4_bytes_past_16":
        kwargs = {"out": _aligned((4, C), offset_bytes=4)}
    elif case == "odd_width":
        args = (_aligned((4, 319)), g[:319], g[:319])
    elif case == "too_wide":
        w = MAX_WIDTH + 2
        args = (_aligned((2, w)), torch.ones(w, dtype=torch.bfloat16), torch.ones(w, dtype=torch.bfloat16))
    elif case == "not_contiguous":
        args = (_aligned((C, 4)).t(), g, g)
    elif case == "half":
        args, err = (x.half(), g.half(), g.half()), TypeError
    elif case == "gamma_dtype":
        args = (x, g.float(), g)
    elif case == "gamma_shape":
        args = (x, g[:-2], g)
    with pytest.raises(err, match="16-byte boundary" if "past_16" in case else None):
        _check_ln(*args, **kwargs)
    _check_ln(x, g, g, out=_aligned((4, C)))  # the same call, aligned and whole, is taken


@pytest.mark.parametrize("C", [320, 640, 1280, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_plan_whole_tiles_are_16_byte_multiples(C, dtype):
    """Every whole tile is one bulk copy: R a multiple of 8, R * C * esize a
    multiple of 16, and the ring of stages with gamma and beta within a
    block's 227 KB of shared memory."""
    plan = _check_ln(_aligned((1001, C), dtype), *[torch.ones(C, dtype=dtype)] * 2)
    row_bytes = C * torch.empty((), dtype=dtype).element_size()
    assert plan.rows_per_tile % 8 == 0 and plan.rows_per_tile >= 8
    assert plan.rows_per_tile * row_bytes % 16 == 0
    assert plan.rows_per_tile * row_bytes <= max(STAGE_BYTES, 8 * row_bytes)
    assert plan.stages >= 2
    assert plan.stages * plan.rows_per_tile * row_bytes + 2 * row_bytes <= 227 * 1024


@pytest.mark.parametrize("rows,C,dtype", [(1, 320, torch.bfloat16), (23, 320, torch.bfloat16),
                                          (24, 320, torch.bfloat16), (25, 320, torch.bfloat16),
                                          (42 * 1296 + 7, 640, torch.bfloat16), (42 * 324 + 5, 1280, torch.bfloat16),
                                          (1001, 322, torch.float32), (3, 2, torch.bfloat16), (0, 640, torch.bfloat16)])
def test_ln_plan_reports_the_tail(rows, C, dtype):
    """The last tile holds what is left of the rows (1 to R), and its bytes
    are what the kernel copies: the bulk copy the largest multiple of 16,
    the producer the rest (12 bytes at (3, 2) in bf16, none in bulk)."""
    plan = _check_ln(_aligned((rows, C), dtype), *[torch.ones(C, dtype=dtype)] * 2)
    esize = torch.empty((), dtype=dtype).element_size()
    R = plan.rows_per_tile
    assert plan.tiles == -(-rows // R)
    if rows == 0:
        assert plan.tail_rows == 0 and plan.tail_bytes == 0
        return
    assert 1 <= plan.tail_rows <= R
    assert (plan.tiles - 1) * R + plan.tail_rows == rows
    assert plan.tail_bytes == plan.tail_rows * C * esize
    if (rows, C) == (3, 2):
        assert plan.tail_bytes == 12 and plan.tail_bytes // 16 * 16 == 0
