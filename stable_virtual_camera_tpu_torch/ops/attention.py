"""Attention ops for the multiview transformer and CLIP.

Counterpart of stable_virtual_camera_tpu/ops/attention.py: `attention_xla`
(scores materialised) for short sequences, `attention_chunked` (online
softmax over key chunks, O(L) memory) for long ones, and the dispatch of
`scaled_dot_product_attention` / `sdpa_packed`. All take (B, L, H, D)
queries and (B, S, H, D) keys/values and return (B, L, H, D); the softmax is
always fp32.

The attention backend is an explicit argument where JAX reads the
`SVC_UPSTREAM_FLASH` and `SVC_PACKED_ATTENTION` knobs:
  * "upstream" (default): the plain routes here; the shapes that go to
    kernel K1 are routed in models/unet.py before they reach this module
    (JAX's SVC_UPSTREAM_FLASH=1);
  * "flash": supported shapes to kernel K3 (ops/flash_attention.py), whose
    op carries the recompute backward (SVC_UPSTREAM_FLASH=0);
  * "packed": supported (B, L, W) shapes with W % 128 == 0 to kernel K4
    (ops/flash_attention_packed.py), the rest as "flash"
    (SVC_UPSTREAM_FLASH=0, SVC_PACKED_ATTENTION=1).
"""

from __future__ import annotations

import torch


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain einsum attention; scores materialised (B, H, L, S) in fp32."""
    d = q.shape[-1]
    scores = torch.einsum("blhd,bshd->bhls", q.float(), k.float())
    probs = torch.softmax(scores * d**-0.5, dim=-1)
    return torch.einsum("bhls,bshd->blhd", probs.to(v.dtype), v)


def attention_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_chunk: int = 1024
) -> torch.Tensor:
    """Online-softmax attention over key chunks; equal to full attention up
    to fp associativity, with O(L * kv_chunk) memory."""
    S = k.shape[1]
    if S <= kv_chunk:
        return attention_xla(q, k, v)
    out = online_softmax_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_chunk
    )
    return out.transpose(1, 2)


def online_softmax_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_chunk: int = 1024,
    return_lse: bool = False,
):
    """(B, H, L, D) x (B, H, S, D) online-softmax attention in fp32, one key
    chunk at a time; returns (B, H, L, D) in q's dtype. Slicing the last
    chunk short is the same as masking padded keys to -inf. With
    `return_lse`, also the fp32 (B, H, L) log-sum-exp of the scaled scores,
    ln sum_j exp(q.k_j / sqrt(D)), which the attention backward reads."""
    B, H, L, D = q.shape
    S = k.shape[2]
    qf = q.float() * D**-0.5
    acc = torch.zeros((B, H, L, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, L, 1), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, L, 1), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, kv_chunk):
        k_i = k[:, :, s0 : s0 + kv_chunk].float()
        v_i = v[:, :, s0 : s0 + kv_chunk].float()
        s = torch.matmul(qf, k_i.transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, v_i)
        m = m_new
    out = (acc / l).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


BACKENDS = ("upstream", "flash", "packed", "plain")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"attention backend must be one of {BACKENDS}, got {backend!r}")


def scaled_dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, xla_max_seq: int = 4096,
    backend: str = "upstream",
) -> torch.Tensor:
    """K3 for the shapes it supports under the "flash" and "packed"
    backends; otherwise einsum or chunked attention, picked by key length."""
    _check_backend(backend)
    if backend in ("flash", "packed"):
        from stable_virtual_camera_tpu_torch.ops import flash_attention as fa

        if fa.supported(q, k, v):
            return fa.flash_attention(q, k, v)
    if k.shape[1] > xla_max_seq:
        return attention_chunked(q, k, v)
    return attention_xla(q, k, v)


def sdpa_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, backend: str = "upstream"
) -> torch.Tensor:
    """SDPA on the packed (B, L, heads * d) projection layout: K4 for the
    shapes it supports under the "packed" backend, else
    `scaled_dot_product_attention` on (B, L, heads, d) views."""
    _check_backend(backend)
    if backend == "packed":
        from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as fap

        if fap.supported(q, k, heads):
            return fap.flash_attention_packed(q, k, v, heads)
    B, L, W = q.shape
    S = k.shape[1]
    d = W // heads
    out = scaled_dot_product_attention(
        q.reshape(B, L, heads, d), k.reshape(B, S, heads, d), v.reshape(B, S, heads, d),
        backend=backend,
    )
    return out.reshape(B, L, W)
