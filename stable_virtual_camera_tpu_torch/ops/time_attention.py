"""Temporal attention on the (b*T, H, D, S) layout: kernel K2 and its plain twin.

Counterpart of stable_virtual_camera_tpu/ops/time_attention.py::
time_attention_bhds. Every spatial position attends over its scene's T
frames, all in fp32. `TimeAttentionFn` is the autograd Function: its forward
launches the hand-written kernel in csrc/time_attention.cu on a CUDA tensor
and runs `time_attention_plain` on a CPU tensor. Its backward is
`time_attention_bwd_plain` on both devices, an fp32 recompute of the tiny
T x T attentions, exactly as the JAX package's custom VJP has it
(time_attention.py:156-178): the JAX package has no backward kernel here, so
there is none to port.
"""

from __future__ import annotations

import torch

from stable_virtual_camera_tpu_torch import _kernels

HEAD_DIM = 64
MAX_FRAMES = 32


def time_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int
) -> torch.Tensor:
    """(b*T, H, D, S) -> (b*T, H, D, S): fp32 softmax over the frame axis."""
    BT, H, D, S = q.shape
    T = num_frames
    b = BT // T

    def view(t):
        return t.float().reshape(b, T, H, D, S)

    s = torch.einsum("bthds,buhds->bhstu", view(q), view(k)) * D**-0.5
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhstu,buhds->bthds", p, view(v))
    return o.reshape(BT, H, D, S).to(q.dtype)


def time_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int
) -> torch.Tensor:
    """Launch K2. q, k, v: (b*T, H, 64, S) bf16 with S contiguous (any
    frame/head/channel strides). Returns a contiguous (b*T, H, 64, S)."""
    BT, H, D, S = q.shape
    T = num_frames
    if D != HEAD_DIM:
        raise ValueError(f"time attention needs head dim {HEAD_DIM}, got {D}")
    if not 1 <= T <= MAX_FRAMES or BT % T:
        raise ValueError(f"time attention takes 1..{MAX_FRAMES} frames dividing {BT}, got {T}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"time attention takes bfloat16, got {name}.dtype={t.dtype}")
        if tuple(t.shape) != (BT, H, D, S) or t.stride(-1) != 1:
            raise ValueError(
                f"time attention: {name} must be (b*T, H, 64, S) with S contiguous, "
                f"got shape {tuple(t.shape)} strides {t.stride()}"
            )
        if t.device != q.device:
            raise ValueError("time attention: q, k and v must be on one device")
    o = torch.empty((BT, H, D, S), dtype=torch.bfloat16, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _kernels.TIME_ATTENTION.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            BT // T, T, H, S, *strides, D**-0.5, stream,
        )
    return o


def time_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, num_frames: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of `time_attention_plain` by fp32 recompute of the
    attentions: P = softmax(q k^T / sqrt(D)) over the key frames u,
    dV = P^T dO, dS = P (dP - sum_u P dP) / sqrt(D), dQ = dS K, dK = dS^T Q.
    Returns (dq, dk, dv) in q's dtype."""
    BT, H, D, S = q.shape
    T = num_frames
    b = BT // T
    scale = D**-0.5

    def view(t):  # (b, T, H, D, S) fp32
        return t.float().reshape(b, T, H, D, S)

    qf, kf, vf, dof = view(q), view(k), view(v), view(do)
    s = torch.einsum("bthds,buhds->bhtus", qf, kf) * scale
    p = torch.softmax(s, dim=3)  # over the key-frame axis u
    dv = torch.einsum("bhtus,bthds->buhds", p, dof)
    dp = torch.einsum("bthds,buhds->bhtus", dof, vf)
    ds = p * (dp - (dp * p).sum(dim=3, keepdim=True)) * scale
    dq = torch.einsum("bhtus,buhds->bthds", ds, kf)
    dk = torch.einsum("bhtus,bthds->buhds", ds, qf)
    return tuple(t.reshape(BT, H, D, S).to(q.dtype) for t in (dq, dk, dv))


class TimeAttentionFn(torch.autograd.Function):
    """Temporal attention and its gradient: K2 (CUDA) or the plain version
    (CPU) forward, the plain fp32 recompute backward on both. q, k and v are
    saved only when a gradient is needed."""

    @staticmethod
    def forward(ctx, q, k, v, num_frames: int):
        if q.device.type == "cpu":
            out = time_attention_plain(q, k, v, num_frames)
        elif q.device.type == "cuda":
            out = time_attention_cuda(q, k, v, num_frames)
        else:
            raise RuntimeError(f"time attention has no kernel for device {q.device}")
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v)
            ctx.num_frames = num_frames
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*time_attention_bwd_plain(q, k, v, do, ctx.num_frames), None)


def time_attention_bhds(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int
) -> torch.Tensor:
    """Temporal attention over (b*T, H, D, S), differentiable: the plain
    version for CPU tensors, kernel K2 for CUDA tensors (or an error)."""
    return TimeAttentionFn.apply(q, k, v, num_frames)
