"""Self-attention on the head-packed (B, L, H * 64) layout: kernel K4 and its
plain twin.

Counterpart of stable_virtual_camera_tpu/ops/flash_attention_packed.py: q, k
and v come in as the (B, L, W) views of the fused qkv projection and the
output leaves as the (B, L, W) layout to_out consumes. The custom op
`svc::flash_attention_packed` launches, on CUDA tensors, the hand-written
Hopper kernel in csrc/flash_attention_packed.cu for bf16 and the fp32 entry
of csrc/flash_attention_fp32.cu for fp32 (the JAX kernel takes both), and
runs
`flash_attention_packed_plain` on CPU tensors, a contiguous (B, L, W) on
both (the layout of its fake implementation). Forward only: the JAX kernel
has no VJP, so a gradient through it raises.
"""

from __future__ import annotations

import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops.attention import online_softmax_attention
from stable_virtual_camera_tpu_torch.ops.flash_attention import MIN_LEN
from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu
from stable_virtual_camera_tpu_torch.ops.flash_upstream import HEAD_DIM


def _bhld(t: torch.Tensor, heads: int) -> torch.Tensor:
    """The (B, H, L, 64) view of a (B, L, heads * 64) tensor."""
    return t.unflatten(-1, (heads, HEAD_DIM)).transpose(1, 2)


def supported(q: torch.Tensor, k: torch.Tensor, heads: int) -> bool:
    """The JAX kernel's predicate on (B, L, W) self-attention shapes: W =
    heads * 64 with W % 128 == 0, L >= 1024, bf16 or fp32."""
    B, L, W = q.shape
    return (
        W == heads * HEAD_DIM
        and W % 128 == 0
        and L == k.shape[1]
        and L >= MIN_LEN
        and q.dtype in (torch.bfloat16, torch.float32)
    )


def flash_attention_packed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
) -> torch.Tensor:
    """softmax(q k^T / 8) v per 64-column head of (B, L, W), fp32 online
    softmax over key chunks; returns (B, L, W) in q's dtype."""
    B, L, W = q.shape

    def bhld(t):
        return t.reshape(B, t.shape[1], heads, HEAD_DIM).transpose(1, 2)

    out = online_softmax_attention(bhld(q), bhld(k), bhld(v))
    return out.transpose(1, 2).reshape(B, L, W)


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.dtype not in fu.DTYPES or t.dtype != dtype:
        raise TypeError(f"packed flash attention (K4) takes bfloat16 or float32 operands of one dtype, "
                        f"got {name}.dtype={t.dtype}")
    if t.dim() != 3 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"packed flash attention (K4): {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )


def flash_attention_packed_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
) -> torch.Tensor:
    """Launch K4. q, k, v: (B, L, heads * 64) views of one dtype, bf16 with
    contiguous columns (any batch/row strides that keep 16-byte rows, e.g.
    chunks of one packed projection) or fp32 through any strides (the fp32
    entry, after `flash_upstream._map_views`). Returns a contiguous
    (B, L, heads * 64) of q's dtype."""
    B, L, W = q.shape
    if W != heads * HEAD_DIM:
        raise ValueError(f"packed flash attention (K4) needs W = heads * {HEAD_DIM}, got W={W}, heads={heads}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, (B, L, W), q.dtype)
        if t.device != q.device:
            raise ValueError("packed flash attention (K4): all operands must be on one device")
    o = torch.empty((B, L, W), dtype=q.dtype, device=q.device)
    fu.launch_fwd(_kernels.FLASH_ATTENTION_PACKED, *(_bhld(t, heads) for t in (q, k, v, o)))
    return o


@torch.library.custom_op(f"{_kernels.OPS}::flash_attention_packed", mutates_args=())
def flash_attention_packed_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """K4 on CUDA tensors, the plain version on CPU tensors; a contiguous
    (B, L, heads * 64)."""
    if _kernels.device_route("packed flash attention (K4)", q) == "cuda":
        return flash_attention_packed_cuda(q, k, v, heads)
    return flash_attention_packed_plain(q, k, v, heads).contiguous()


@flash_attention_packed_op.register_fake
def _(q, k, v, heads):
    return q.new_empty(q.shape)


def _backward(ctx, g):
    raise RuntimeError(
        "packed flash attention (K4) has no gradient: the JAX kernel it ports has no VJP; "
        'train with attention="upstream" or "flash"'
    )


flash_attention_packed_op.register_autograd(_backward, setup_context=lambda ctx, inputs, output: None)


def flash_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
) -> torch.Tensor:
    """Non-causal attention over the packed (B, L, heads * 64) layout,
    forward only (a backward through it raises)."""
    _kernels.device_route("packed flash attention (K4)", q)
    return flash_attention_packed_op(q, k, v, heads)
