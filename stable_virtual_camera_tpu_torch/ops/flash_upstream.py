"""Self-attention on the (B, H, L, D) layout: kernel K1 and its plain twin.

Counterpart of stable_virtual_camera_tpu/ops/flash_upstream.py::
flash_attention_upstream_bhld. On a CUDA tensor it launches the hand-written
Hopper kernel in csrc/flash_attention.cu; on a CPU tensor it runs
`flash_attention_plain`, the chunked online-softmax form of the same math
(a materialised fp32 score tensor at L=27216, B=2, H=10 would take 59 GB).
"""

from __future__ import annotations

import math

import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops.attention import online_softmax_attention

HEAD_DIM = 64
_SCALE_LOG2 = HEAD_DIM**-0.5 * math.log2(math.e)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, L, D), fp32 online softmax."""
    return online_softmax_attention(q, k, v)


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash attention takes bfloat16, got {name}.dtype={t.dtype}")
    if t.dim() != 4 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash attention: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"flash attention: {name} needs a contiguous head dim and 16-byte aligned "
            f"rows, got strides {t.stride()}"
        )


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch K1. q, k, v: (B, H, L, 64) bf16 views with a contiguous head
    dim (any batch/head/row strides that keep 16-byte rows). Returns a
    (B, H, L, 64) view of a (B, L, H, 64) buffer, so `o.transpose(1, 2)`
    is the packed (B, L, H*64) layout for free."""
    B, H, L, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash attention needs head dim {HEAD_DIM}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, (B, H, L, D))
        if t.device != q.device:
            raise ValueError("flash attention: q, k and v must be on one device")
    o = torch.empty((B, L, H, D), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _kernels.FLASH_ATTENTION.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, H, L, *strides, _SCALE_LOG2, stream,
        )
    return o


def flash_attention_upstream_bhld(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Non-causal attention over (B, H, L, D) with scale 1/sqrt(D): the plain
    version for CPU tensors, kernel K1 for CUDA tensors (or an error)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention has no kernel for device {q.device}")
    return flash_attention_cuda(q, k, v)
