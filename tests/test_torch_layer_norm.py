"""K5's plain version (ops/layer_norm.py `ln_reduce`) against the JAX
package's LayerNorm probe (benchmark/ln_probe.py), on the CPU.

The probe's Pallas kernel `ln_pallas` runs in interpret mode at (2304, 320),
two of its 1152-row blocks, on the same numpy inputs. bf16 results agree
within one bf16 step of the output (the two sides round the same fp32
values, summed in another order); fp32 results within 1e-5. On a CPU tensor
`ln_fused` is `ln_reduce` and launches nothing; the kernel itself is held
against `ln_reduce` on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from benchmark import ln_probe
from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops.layer_norm import ln_fused, ln_reduce

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
