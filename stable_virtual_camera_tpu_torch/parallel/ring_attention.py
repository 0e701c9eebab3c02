"""Ring attention over the view (sequence) axis.

Counterpart of stable_virtual_camera_tpu/parallel/ring_attention.py
(`ring_attention`, `ring_sdpa_packed`, `make_ring_self_attention`). Each
rank keeps its query shard and passes its K/V shard around the ring: at
each of n steps the local queries attend to the resident K/V block, and
the block moves on to the next rank (`Comm.ring_shift`, JAX's ppermute).

A step's block is one attention call that also returns its log-sum-exp:
kernel K1 (`svc::flash_attention` with `return_lse=True`) on the card, or
its plain twin (`flash_attention_plain(..., return_lse=True)`) where the
tensors lie on the CPU or the model's head dim or backend has no K1 entry.
K1 takes equal query and key lengths only, which equal view shards give:
that is why the joint attention under view sharding is this ring and not a
gathered K/V. The partials merge in fp32 by their LSEs, the online-softmax
algebra of JAX's `step` (:176-187) with the running output kept
normalised: lse' = logaddexp(lse, lse_i),
acc' = acc * exp(lse - lse') + o_i * exp(lse_i - lse'). One partial merges
exactly (acc = o_i in fp32, cast back), so a 1-rank ring returns K1's
output bit for bit.

The ring has its own exact backward rather than a differentiated merge: it
is one join node over every rank's q, k, v (`Comm.exchange_with_grad`),
which keeps each rank's output o and its global fp32 lse, forms
D_i = rowsum(o_i dO_i), and runs every (query shard i, key shard j) block
through K1-dQ (dQ_i) and K1-dKV (dK_j, dV_j) with the global lse_i and D_i,
so each block's P is the exact global softmax restricted to that block; the
blocks' shares add in fp32. On CPU tensors, or without the kernel route,
`flash_attention_bwd_delta_plain` takes the kernels' place. A 1-rank ring
is K1 alone, with K1's own backward.
"""

from __future__ import annotations

import torch

from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
    attention_delta,
    flash_attention_bwd_blocks,
    flash_attention_op,
    flash_attention_plain,
)
from stable_virtual_camera_tpu_torch.parallel.comm import Comm, _on, run_ranks


def _attend(q, k, v, kernel: bool):
    """One ring block: (o, lse), o in q's dtype, lse fp32 (B, H, L)."""
    if kernel:
        return flash_attention_op(q, k, v, True)
    return flash_attention_plain(q, k, v, return_lse=True)


def merge_partials(acc: torch.Tensor, lse: torch.Tensor, o_i: torch.Tensor, lse_i: torch.Tensor):
    """Fold one block's (o_i, lse_i) into the running fp32 (acc, lse)."""
    lse_new = torch.logaddexp(lse, lse_i)
    acc = acc * torch.exp(lse - lse_new)[..., None] + o_i.float() * torch.exp(lse_i - lse_new)[..., None]
    return acc, lse_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm: Comm,
                   kernel: bool = True) -> torch.Tensor:
    """Exact non-causal attention (scale 1/sqrt(D)) over the sequence
    concatenated from every rank's shard, in rank order. q, k, v: this
    rank's (B, H, L_local, D) shards, equal L_local on every rank. `kernel`
    sends each block to K1's op (which runs the plain twin on CPU tensors;
    on the card it needs bf16 and D = 64), else to the plain twin. Returns
    (B, H, L_local, D) in q's dtype. Differentiable (see the module
    docstring)."""
    if comm.size == 1:
        return _attend(q, k, v, kernel)[0]

    def forward(q, k, v):
        o, lse = _attend(q, k, v, kernel)
        acc = o.float()
        kv = (k, v)
        for _ in range(comm.size - 1):
            kv = comm.ring_shift(kv)
            acc, lse = merge_partials(acc, lse, *_attend(q, *kv, kernel))
        o = acc.to(q.dtype)
        return (o,), (q, k, v, o, lse)

    def backward(saved, grads):
        return ring_backward(saved, grads, kernel)

    return comm.exchange_with_grad((q, k, v), forward, backward)[0]


def ring_backward(saved, grads, kernel: bool = True):
    """Every rank's (dq, dk, dv) of the ring at once, from every rank's
    (q, k, v, o, lse) and dO (lists by rank, as `Comm.exchange_with_grad`
    hands them): block (i, j) adds K1-dQ's dq to dq_i and K1-dKV's dk, dv
    to dk_j, dv_j, in fp32."""
    n = len(saved)
    dq, dk, dv = ([torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in ts]
                  for ts in zip(*(s[:3] for s in saved)))
    for i in range(n):
        q, _, _, o, lse = saved[i]
        (do,) = grads[i]
        dev = q.device
        q, o, lse, do = (_on(t, dev) for t in (q, o, lse, do))
        delta = attention_delta(o, do)
        for j in range(n):
            _, k, v, _, _ = saved[j]
            a, b, c = flash_attention_bwd_blocks(q, _on(k, dev), _on(v, dev), do, lse, delta, kernel)
            dq[i] += a
            dk[j] += _on(b, dk[j].device)
            dv[j] += _on(c, dv[j].device)
    return [tuple(g.to(t.dtype) for g, t in zip((dq[r], dk[r], dv[r]), saved[r][:3])) for r in range(n)]


def ring_sdpa_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, comm: Comm,
                     kernel: bool = True) -> torch.Tensor:
    """`ring_attention` on the packed (B, L_local, heads * D) layout of the
    UNet's projections (views with a contiguous last dim, as `qkv.chunk(3,
    -1)` gives them); returns (B, L_local, heads * D)."""
    B, L, W = q.shape
    D = W // heads

    def bhld(t):
        return t.view(B, L, heads, D).transpose(1, 2)

    o = ring_attention(bhld(q), bhld(k), bhld(v), comm, kernel)
    return o.transpose(1, 2).reshape(B, L, W)


def make_ring_self_attention(mesh, kernel: bool = True):
    """Ring self-attention over the mesh's first data row: `attn(q, k, v)`
    takes global (B, L, H, D) tensors, gives view rank r the rows
    r*L/n:(r+1)*L/n of each on its device, and returns the global
    (B, L, H, D) output on q's device. L must divide over the view axis."""
    n = mesh.shape["view"]

    def attn(q, k, v):
        B, L, H, D = q.shape
        if L % n:
            raise ValueError(f"ring attention: L={L} must divide over the view axis ({n})")
        Ll = L // n

        def shard(ctx):
            rows = slice(ctx.view * Ll, (ctx.view + 1) * Ll)
            q_l, k_l, v_l = (t[:, rows].to(ctx.device, copy=True).transpose(1, 2) for t in (q, k, v))
            return ring_attention(q_l, k_l, v_l, ctx.comm, kernel).transpose(1, 2)

        outs = run_ranks(mesh, shard, rows=[0])
        return torch.cat([o.to(q.device) for o in outs], dim=1)

    return attn
