"""Self-attention on the (B, H, L, D) layout: kernel K1, its backward
kernels K1-dKV and K1-dQ, and their plain twins.

Counterpart of stable_virtual_camera_tpu/ops/flash_upstream.py::
flash_attention_upstream_bhld, whose upstream Pallas kernel is a custom VJP
with a forward kernel and two backward kernels (dK/dV and dQ). Here the
forward is the custom op `svc::flash_attention` (o and, when asked, the
log-sum-exp) and the backward the custom op `svc::flash_attention_bwd`,
linked by `register_autograd`: on CUDA tensors they launch, for bf16, the
hand-written Hopper kernel in csrc/flash_attention.cu and the two kernels of
csrc/flash_attention_bwd.cu, and for fp32 (which the JAX kernels take too)
their fp32 entries in csrc/flash_attention_fp32.cu and
csrc/flash_attention_bwd_fp32.cu, picked by dtype inside the op; on CPU
tensors they run `flash_attention_plain` and `flash_attention_bwd_plain`,
chunked fp32 forms of the same math (a materialised fp32 score tensor at
L=27216, B=2, H=10 would take 59 GB). On both devices o and the gradients
are (B, H, L, 64) views of (B, L, H, 64) buffers in q's dtype, the layout
the fake implementations give `torch.export`.

The log-sum-exp `lse` is stored in natural-log units, ln sum_j exp(s_j)
with s = q.k / sqrt(D), in both paths; the kernels convert it to their base-2
state by multiplying with log2(e). A gradient `dlse` on it reaches the scores
as dS = P (dP - (D - dlse)), since d lse / dS = P: it folds into the delta
D = rowsum(o dO) that K1-dKV and K1-dQ read, so the same kernels serve it.
The ring's backward (parallel/ring_attention.py) calls the pair per block of
queries and keys with the global lse and delta through
`flash_attention_bwd_blocks`.
"""

from __future__ import annotations

import math

import torch

from stable_virtual_camera_tpu_torch import _kernels
from stable_virtual_camera_tpu_torch.ops.attention import online_softmax_attention

HEAD_DIM = 64
# what K1, K3 and K4 take, as the JAX kernels do: bf16 (the Hopper tile) and
# fp32 (the fp32 entry)
DTYPES = (torch.bfloat16, torch.float32)
_SCALE = HEAD_DIM**-0.5
_SCALE_LOG2 = _SCALE * math.log2(math.e)
_BWD_CHUNK = 1024


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False
):
    """softmax(q k^T / sqrt(D)) v over (B, H, L, D), fp32 online softmax;
    with `return_lse` also the fp32 (B, H, L) log-sum-exp."""
    return online_softmax_attention(q, k, v, return_lse=return_lse)


def attention_delta(o: torch.Tensor, do: torch.Tensor, dlse: torch.Tensor | None = None) -> torch.Tensor:
    """D = rowsum(o dO) in fp32, (B, H, L): the backward's preprocessing, a
    plain reduction as upstream computes it outside its kernels. `do` is
    upcast inside the product (the same fp32 values as a separate copy,
    without writing one). With a gradient `dlse` on the log-sum-exp, D - dlse."""
    delta = (o.float() * do).sum(-1)
    return delta if dlse is None else delta - dlse


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, chunk: int = _BWD_CHUNK, dlse: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FlashAttention-2 backward in fp32, chunked over keys and queries
    so no (L, L) score tensor is held: P = exp(S - lse), dV = P^T dO,
    dP = dO V^T, dS = P (dP - D) with D = rowsum(o dO) (less `dlse`, the
    gradient on the log-sum-exp, where given), dK = dS^T Q / sqrt(D),
    dQ = dS K / sqrt(D). Returns (dq, dk, dv) in the dtypes of q, k, v."""
    return flash_attention_bwd_delta_plain(q, k, v, do, lse, attention_delta(o, do, dlse), chunk)


def flash_attention_bwd_delta_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, chunk: int = _BWD_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_attention_bwd_plain` from a given lse and delta (the rows of
    q), as K1-dKV and K1-dQ take them: the block of the queries q against
    the keys k, v. q and k may differ in length."""
    D = q.shape[-1]
    scale = D**-0.5
    Lq, Lk = q.shape[-2], k.shape[-2]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, Lk, chunk):
        kc = k[:, :, k0 : k0 + chunk].float()
        vc = v[:, :, k0 : k0 + chunk].float()
        for q0 in range(0, Lq, chunk):
            rows = slice(q0, q0 + chunk)
            qc = q[:, :, rows].float()
            doc = do[:, :, rows].float()
            p = torch.exp(torch.matmul(qc, kc.transpose(-1, -2)) * scale - lse[:, :, rows, None])
            dv[:, :, k0 : k0 + chunk] += torch.matmul(p.transpose(-1, -2), doc)
            ds = p * (torch.matmul(doc, vc.transpose(-1, -2)) - delta[:, :, rows, None])
            dk[:, :, k0 : k0 + chunk] += torch.matmul(ds.transpose(-1, -2), qc) * scale
            dq[:, :, rows] += torch.matmul(ds, kc) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tma_view_ok(t: torch.Tensor) -> bool:
    """A contiguous head dim, (batch, head, row) strides of whole 16-byte
    units and a 16-byte aligned base: what a TMA tensor map can take."""
    es = t.element_size()
    return t.stride(-1) == 1 and not any(s * es % 16 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def tma_dims_strides(t: torch.Tensor) -> tuple[tuple[int, int, int, int], tuple[int, int, int]]:
    """The tensor map through which the forward tile (csrc/flash_fwd_sm90.cuh)
    reads a (B, H, L, 64) view: dims (64, L, H, B), innermost first, and
    byte strides (row, head, batch). K1 passes its (B, H, L, 64) views, K3
    and K4 theirs in that order, so the three layouts differ only here.
    Raises ValueError for a view TMA cannot take."""
    if t.dim() != 4 or not _tma_view_ok(t):
        raise ValueError(
            "flash attention: a tensor map needs a (B, H, L, D) view with a contiguous head dim, "
            f"16-byte strides and a 16-byte aligned base, got shape {tuple(t.shape)} strides "
            f"{t.stride()} at address {t.data_ptr():#x}"
        )
    B, H, L, D = t.shape
    es = t.element_size()
    return (D, L, H, B), (t.stride(2) * es, t.stride(1) * es, t.stride(0) * es)


def _check(name: str, t: torch.Tensor, shape, dtype=None) -> None:
    """dtype (bf16 or fp32, and `dtype` where given) and shape; the layout of
    what the bf16 kernels read through tensor maps is checked by
    `tma_dims_strides` (the fp32 entries take any strides: `_map_views` copies
    what their tensor maps cannot take)."""
    if t.dtype not in DTYPES or (dtype is not None and t.dtype != dtype):
        raise TypeError(f"flash attention takes bfloat16 or float32 operands of one dtype, "
                        f"got {name}.dtype={t.dtype}")
    if t.dim() != len(shape) or tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash attention: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_inputs(q: torch.Tensor, *named) -> tuple[int, int, int, int]:
    B, H, L, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash attention needs head dim {HEAD_DIM}, got {D}")
    for name, t in (("q", q), *named):
        _check(name, t, (B, H, L, D), q.dtype)
        if t.device != q.device:
            raise ValueError("flash attention: all operands must be on one device")
    return B, H, L, D


def _check_rows(name: str, t: torch.Tensor, B: int, H: int, L: int, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (B, H, L) or not t.is_contiguous():
        raise ValueError(
            f"flash attention: {name} must be a contiguous fp32 (B, H, L) = {(B, H, L)}, "
            f"got {t.dtype} {tuple(t.shape)} strides {t.stride()}"
        )
    if t.device != device:
        raise ValueError("flash attention: all operands must be on one device")


def _empty_like_bhld(q: torch.Tensor) -> torch.Tensor:
    """A (B, H, L, 64) view of a fresh (B, L, H, 64) buffer of q's dtype, the
    layout the packed projections read without a copy."""
    B, H, L, D = q.shape
    return q.new_empty((B, L, H, D)).transpose(1, 2)


def _in_bhld(t: torch.Tensor) -> torch.Tensor:
    """t's values in the layout of `_empty_like_bhld`."""
    return _empty_like_bhld(t).copy_(t)


def _strides(*ts: torch.Tensor) -> list[int]:
    return [s for t in ts for s in t.stride()[:3]]


def _all_strides(*ts: torch.Tensor) -> list[int]:
    """The (batch, head, row, dim) element strides of each (B, H, L, 64)
    view, as the fp32 entries read them."""
    return [s for t in ts for s in t.stride()]


def fwd_kernel(q: torch.Tensor, kernel: _kernels.Kernel) -> _kernels.Kernel:
    """The kernel a forward launch on q's dtype takes: `kernel` (K1's, K3's
    or K4's Hopper tile) for bf16, the fp32 entry for fp32. Needs no card."""
    return _kernels.FLASH_ATTENTION_FP32 if q.dtype == torch.float32 else kernel


def bwd_kernels(q: torch.Tensor) -> tuple[_kernels.Kernel, _kernels.Kernel]:
    """(K1-dKV, K1-dQ) for q's dtype: the Hopper pair for bf16, the fp32
    entries for fp32. Needs no card."""
    if q.dtype == torch.float32:
        return _kernels.FLASH_ATTENTION_BWD_DKV_FP32, _kernels.FLASH_ATTENTION_BWD_DQ_FP32
    return _kernels.FLASH_ATTENTION_BWD_DKV, _kernels.FLASH_ATTENTION_BWD_DQ


def _map_views(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """fp32 (B, H, L, 64) views as the fp32 entries read them through tensor
    maps: one with a non-contiguous head dim, strides that are not whole
    16-byte units, a base off a 16-byte boundary or a zero (broadcast)
    stride is copied into the `_in_bhld` layout; the others, the UNet's
    packed-qkv views, K3's and K4's chunks of a packed projection and the
    `_empty_like_bhld` buffers among them, pass as they are."""
    return tuple(t if _tma_view_ok(t) and 0 not in t.stride()[:3] else _in_bhld(t) for t in ts)


def launch_fwd(kernel: _kernels.Kernel, q, k, v, o, lse=None) -> None:
    """Launch one of K1, K3, K4 on (B, H, L, 64) views: for bf16 `kernel`
    (the Hopper tile, csrc/flash_fwd_sm90.cuh) with q, k, v through their
    tensor maps, for fp32 the fp32 entry (csrc/flash_attention_fp32.cu) with
    q, k, v through tensor maps as well, after `_map_views` has copied the
    views a map cannot take; o through its element strides, and the fp32
    (B, H, L) log-sum-exp when `lse` is given."""
    B, H, L, _ = q.shape
    if q.dtype == torch.float32:
        q, k, v = _map_views(q, k, v)
        strides = _all_strides(q, k, v, o)
    else:
        strides = [s for t in (q, k, v) for s in tma_dims_strides(t)[1]] + _strides(o)
    with torch.cuda.device(q.device):
        fwd_kernel(q, kernel).launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B, H, L, *strides, _SCALE_LOG2,
            torch.cuda.current_stream(q.device).cuda_stream,
        )


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False
):
    """Launch K1. q, k, v: (B, H, L, 64) views of one dtype: bf16 with a
    contiguous head dim (any batch/head/row strides that keep 16-byte rows),
    or fp32 through any strides (the fp32 entry, after `_map_views`).
    Returns a (B, H, L, 64) view of a (B, L, H, 64) buffer of q's dtype, so
    `o.transpose(1, 2)` is the packed (B, L, H*64) layout for free; with
    `return_lse` also the fp32 (B, H, L) log-sum-exp, which the kernel
    writes in its epilogue."""
    B, H, L, D = _check_inputs(q, ("k", k), ("v", v))
    o = _empty_like_bhld(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device) if return_lse else None
    launch_fwd(_kernels.FLASH_ATTENTION, q, k, v, o, lse)
    return (o, lse) if return_lse else o


def _check_bwd(q, k, v, do, lse, delta) -> tuple[int, int, int, list[int]]:
    """dtype, shape and device of the backward's operands; returns B, H, L
    and how the kernels read q, k, v and do, in that order: for bf16 their
    tensor-map byte strides from `tma_dims_strides` (which raises ValueError
    for a view TMA cannot take), for fp32 their element strides (any view:
    `_bwd_views` copies first what the fp32 entries' tensor maps cannot
    take). lse and delta are read with ordinary loads, so they only need to
    be contiguous fp32 (B, H, L)."""
    B, H, L, _ = _check_inputs(q, ("k", k), ("v", v), ("do", do))
    if q.dtype == torch.float32:
        maps = _all_strides(q, k, v, do)
    else:
        maps = [s for t in (q, k, v, do) for s in tma_dims_strides(t)[1]]
    _check_rows("lse", lse, B, H, L, q.device)
    _check_rows("delta", delta, B, H, L, q.device)
    return B, H, L, maps


def _bwd_views(q, k, v, do, maps: list[int]):
    """q, k, v, do as the backward kernels read them, and their strides for
    the launch. The bf16 pair takes them as they are (`_check_bwd` has
    refused what its tensor maps cannot take). The fp32 entries read them
    through tensor maps as well but accept any fp32 view: one with a
    non-contiguous head dim, strides that are not whole 16-byte units, a
    base off a 16-byte boundary or a zero (broadcast) stride is copied into
    the `_in_bhld` layout here first. The UNet's packed-qkv views and the
    `_empty_like_bhld` buffers need no copy (`_map_views`)."""
    if q.dtype != torch.float32:
        return q, k, v, do, maps
    ts = _map_views(q, k, v, do)
    return (*ts, _all_strides(*ts))


def flash_attention_bwd_dkv_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1-dKV (its fp32 entry for fp32 operands): (dk, dv) as
    (B, H, L, 64) views of (B, L, H, 64) buffers of q's dtype. q, k, v, do:
    (B, H, L, 64) views of one dtype, bf16 ones that a tensor map can take
    (`tma_dims_strides`) or fp32 ones through any strides (the fp32 entries
    read through tensor maps too: an fp32 view a map cannot take is first
    copied into the `_in_bhld` layout, see `_bwd_views`); lse: K1's fp32
    (B, H, L) log-sum-exp; delta: fp32 (B, H, L) rowsum(o do)."""
    B, H, L, maps = _check_bwd(q, k, v, do, lse, delta)
    q, k, v, do, maps = _bwd_views(q, k, v, do, maps)
    dk, dv = _empty_like_bhld(q), _empty_like_bhld(q)
    with torch.cuda.device(q.device):
        bwd_kernels(q)[0].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, L, *maps, *_strides(dk, dv), _SCALE,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return dk, dv


def flash_attention_bwd_dq_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> torch.Tensor:
    """Launch K1-dQ (its fp32 entry for fp32 operands): dq as a
    (B, H, L, 64) view of a (B, L, H, 64) buffer of q's dtype; operands as
    for `flash_attention_bwd_dkv_cuda` (fp32 views a tensor map cannot take
    are copied first)."""
    B, H, L, maps = _check_bwd(q, k, v, do, lse, delta)
    q, k, v, do, maps = _bwd_views(q, k, v, do, maps)
    dq = _empty_like_bhld(q)
    with torch.cuda.device(q.device):
        bwd_kernels(q)[1].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, H, L, *maps, *_strides(dq), _SCALE,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return dq


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, dlse: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's backward: D = rowsum(o dO) (less `dlse` where given) as a plain
    fp32 reduction (the upstream TPU kernel computes it outside its kernels
    too, from the same bf16 o the forward wrote), then K1-dKV and K1-dQ.
    Returns (dq, dk, dv)."""
    _check("o", o, q.shape, q.dtype)
    delta = attention_delta(o, do, dlse)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    return flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta), dk, dv


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """The incoming gradient in a layout the kernels can take: bf16 in one a
    tensor map can take (a copy only when autograd hands over another
    layout), fp32 as it is."""
    if t.dtype == torch.float32 or _tma_view_ok(t):
        return t
    return t.contiguous()


@torch.library.custom_op(f"{_kernels.OPS}::flash_attention", mutates_args=())
def flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention with scale 1/sqrt(D): K1 on CUDA tensors (its
    fp32 entry for fp32 ones), the plain version on CPU tensors. Returns o,
    a (B, H, L, 64) view of a
    (B, L, H, 64) buffer, and the fp32 (B, H, L) log-sum-exp, or an empty
    one without `return_lse`."""
    if _kernels.device_route("flash attention", q) == "cuda":
        out = flash_attention_cuda(q, k, v, return_lse=return_lse)
    else:
        out = flash_attention_plain(q, k, v, return_lse=return_lse)
    o, lse = out if return_lse else (out, q.new_empty((0,), dtype=torch.float32))
    return (o, lse) if q.device.type == "cuda" else (_in_bhld(o), lse)


@flash_attention_op.register_fake
def _(q, k, v, return_lse):
    B, H, L, _ = q.shape
    return _empty_like_bhld(q), q.new_empty((B, H, L) if return_lse else (0,), dtype=torch.float32)


@torch.library.custom_op(f"{_kernels.OPS}::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, dlse: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention_op` from its o and log-sum-exp, with
    `dlse` the gradient on the log-sum-exp where it has one: K1-dKV and
    K1-dQ on CUDA tensors (their fp32 entries for fp32 ones), the plain
    backward on CPU tensors; each a
    (B, H, L, 64) view of a (B, L, H, 64) buffer."""
    if dlse is not None:
        _check_rows("dlse", dlse, *lse.shape, q.device)
    if _kernels.device_route("flash attention", q) == "cuda":
        return flash_attention_bwd_cuda(q, k, v, o, lse, _kernel_layout(do), dlse)
    return tuple(_in_bhld(g) for g in flash_attention_bwd_plain(q, k, v, o, lse, do, dlse=dlse))


@flash_attention_bwd_op.register_fake
def _(q, k, v, o, lse, do, dlse=None):
    return _empty_like_bhld(q), _empty_like_bhld(k), _empty_like_bhld(v)


def flash_attention_bwd_blocks(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block of a backward split over query and key blocks of equal
    length: the queries q (with their dO, their global lse and delta) against
    the keys k, v. K1-dKV and K1-dQ on CUDA tensors with `kernel`, else
    `flash_attention_bwd_delta_plain`. Returns (dq, dk, dv): the block's
    share of each, summed over the blocks by the caller."""
    if kernel and _kernels.device_route("flash attention", q) == "cuda":
        do = _kernel_layout(do)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
        return flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta), dk, dv
    return flash_attention_bwd_delta_plain(q, k, v, do, lse, delta)


def _setup_context(ctx, inputs, output):
    q, k, v, _ = inputs
    ctx.save_for_backward(q, k, v, *output)
    # a gradient that reaches only o, or only the log-sum-exp, leaves the
    # other None rather than a tensor of zeros
    ctx.set_materialize_grads(False)


def _backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    if lse.numel() == 0:
        raise RuntimeError("flash attention: a gradient needs the forward run with return_lse=True")
    if do is None:
        do = torch.zeros_like(o)
    if dlse is not None:
        dlse = dlse.float().contiguous()
    return (*flash_attention_bwd_op(q, k, v, o, lse, do, dlse), None)


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention_upstream_bhld(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Non-causal attention over (B, H, L, D) with scale 1/sqrt(D),
    differentiable: the plain versions for CPU tensors, kernels K1 / K1-dKV /
    K1-dQ for CUDA tensors (or an error). The forward writes the LSE only
    when a gradient is needed, so a call under `inference_mode` or
    `no_grad` runs exactly the forward."""
    _kernels.device_route("flash attention", q)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return flash_attention_op(q, k, v, needs_grad)[0]
