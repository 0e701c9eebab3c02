"""Self-attention on the (B, L, H, 64) layout: kernel K3, its plain twin, and
the differentiable wrapper with a recompute backward.

Counterpart of stable_virtual_camera_tpu/ops/flash_attention.py
(`flash_attention`, the in-repo Pallas kernel) and of `flash_attention_trainable`
in stable_virtual_camera_tpu/ops/attention.py, whose custom VJP runs the
kernel forward and differentiates the backward through the O(L)-memory
chunked attention instead of a backward kernel. The forward is the custom
op `svc::flash_attention_blhd`: on CUDA tensors it launches the hand-written
Hopper kernel in csrc/flash_attention_blhd.cu for bf16 and the fp32 entry
of csrc/flash_attention_fp32.cu for fp32 (the JAX kernel takes both), on
CPU tensors it runs
`flash_attention_plain`, and on both it returns a contiguous (B, L, H, 64)
(the layout of its fake implementation). Its backward, registered with
`register_autograd`, recomputes through `attention_chunked`; there is no
backward kernel, as there is none in JAX.
"""

from __future__ import annotations

import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops.attention import attention_chunked, online_softmax_attention
from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu

MIN_LEN = 1024


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The JAX kernel's predicate: self-attention, head dim 64, L >= 1024,
    bf16 or fp32."""
    B, L, H, D = q.shape
    S = k.shape[1]
    return D == fu.HEAD_DIM and L == S and S >= MIN_LEN and q.dtype in (torch.bfloat16, torch.float32)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / 8) v over (B, L, H, 64), fp32 online softmax over key
    chunks; returns (B, L, H, 64) in q's dtype."""
    return online_softmax_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch K3. q, k, v: (B, L, H, 64) views of one dtype, bf16 with a
    contiguous head dim (any batch/row/head strides that keep 16-byte rows,
    e.g. chunks of one packed projection) or fp32 through any strides (the
    fp32 entry, after `flash_upstream._map_views`). Returns a contiguous
    (B, L, H, 64) of q's dtype."""
    B, L, H, D = q.shape
    if D != fu.HEAD_DIM:
        raise ValueError(f"flash attention (K3) needs head dim {fu.HEAD_DIM}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        fu._check(name, t, (B, L, H, D), q.dtype)
        if t.device != q.device:
            raise ValueError("flash attention (K3): all operands must be on one device")
    o = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    fu.launch_fwd(_kernels.FLASH_ATTENTION_BLHD, *(t.transpose(1, 2) for t in (q, k, v, o)))
    return o


@torch.library.custom_op(f"{_kernels.OPS}::flash_attention_blhd", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors, the plain version on CPU tensors; a contiguous
    (B, L, H, 64)."""
    if _kernels.device_route("flash attention (K3)", q) == "cuda":
        return flash_attention_cuda(q, k, v)
    return flash_attention_plain(q, k, v).contiguous()


@flash_attention_op.register_fake
def _(q, k, v):
    return q.new_empty(q.shape)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    """JAX's `_flash_bwd`: differentiate the plain `attention_chunked`
    recompute."""
    q, k, v = ctx.saved_tensors
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_chunked(*leaves)
    return torch.autograd.grad(out, leaves, g.to(q.dtype))


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over (B, L, H, 64): the plain version for CPU
    tensors, K3 for CUDA tensors, an error elsewhere; differentiable by
    recompute. Under `inference_mode` or `no_grad` nothing is saved."""
    _kernels.device_route("flash attention (K3)", q)
    return flash_attention_op(q, k, v)


# JAX's name for the differentiable form: here the op carries the backward
flash_attention_trainable = flash_attention
