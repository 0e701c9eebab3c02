"""Temporal attention on the (b*T, H, D, S) layout: kernel K2 and its plain twin.

Counterpart of stable_virtual_camera_tpu/ops/time_attention.py::
time_attention_bhds. Every spatial position attends over its scene's T
frames, all in fp32. On a CUDA tensor it launches the hand-written kernel in
csrc/time_attention.cu; on a CPU tensor it runs `time_attention_plain`.
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


def time_attention_bhds(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int
) -> torch.Tensor:
    """Temporal attention over (b*T, H, D, S): the plain version for CPU
    tensors, kernel K2 for CUDA tensors (or an error)."""
    if q.device.type == "cpu":
        return time_attention_plain(q, k, v, num_frames)
    if q.device.type != "cuda":
        raise RuntimeError(f"time attention has no kernel for device {q.device}")
    return time_attention_cuda(q, k, v, num_frames)
