"""The hand-written CUDA kernels (K1 flash attention, K2 temporal attention)
against their plain versions on the card, and the wrappers' refusals.

The `cuda` tests need an NVIDIA GPU and skip elsewhere. This file imports
neither jax nor the test conftest, so on a machine with the card and no JAX
it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Inputs are unit-normal bf16 from numpy with a fixed seed. Tolerances: K1 is
bf16 out with P rounded to bf16 before P.V (max 2e-2, mean 2e-3); K2 keeps
all arithmetic in fp32 and rounds only its output (one bf16 ulp at 1, 8e-3).
"""

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
    flash_attention_plain,
    flash_attention_upstream_bhld,
)
from stable_virtual_camera_tpu_torch.ops.time_attention import (
    time_attention_bhds,
    time_attention_plain,
)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
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


@pytest.mark.parametrize("fn,shape,args", [
    (flash_attention_upstream_bhld, (1, 1, 64, 64), ()),
    (time_attention_bhds, (2, 1, 64, 8), (2,)),
])
def test_wrappers_have_no_kernel_off_cpu_and_cuda(fn, shape, args):
    """The plain version serves CPU tensors only: a tensor on another device
    raises instead of falling back."""
    x = torch.zeros(shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fn(x, x, x, *args)
