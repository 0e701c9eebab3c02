"""Temporal attention on the (b*T, H, D, S) layout: kernel K2 and its plain twin.

Counterpart of stable_virtual_camera_tpu/ops/time_attention.py::
time_attention_bhds. Every spatial position attends over its scene's T
frames, all in fp32. The forward is the custom op `svc::time_attention`: on
a CUDA tensor it launches one of K2's two hand-written kernels, picked by
`k2_route` inside the op (the Hopper kernel in csrc/time_attention.cu for
bf16 at head dim 64 with S contiguous, the model's case; the entry in
csrc/time_attention_any.cu for every other head dim, for fp32 and fp16, and
for any strides, as the JAX kernel takes them); on a CPU tensor it runs
`time_attention_plain`. It returns a contiguous tensor in q's dtype on both
(the layout its fake implementation gives `torch.export`).
Its backward, registered with `register_autograd`, is
`time_attention_bwd_plain` on both devices, an fp32 recompute of the tiny
T x T attentions, exactly as the JAX package's custom VJP has it
(time_attention.py:156-178): the JAX package has no backward kernel here, so
there is none to port.

The Hopper kernel streams channel chunks of q, k and v through a ring of
shared-memory stages, filled by TMA boxes where every row is 16-byte aligned
and by cp.async or plain copies where it is not; `_k2_plan` checks what it
takes and plans the launch (key-frame ceiling, tile, ring, copy granule).
The other entry has the same shape for any head dim, dtype and strides:
persistent blocks, a ring of 16-channel units in the input dtype filled by
TMA boxes, cp.async granules or element loads (`_any_plan` picks the mode
from the views' row starts), and consumer warps of 32 positions and 4 or 5
query frames with their fp32 scores in registers.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from stable_virtual_camera_tpu_torch import _kernels

HEAD_DIM = 64
MAX_FRAMES = 32
# the dtypes K2 takes (fp32, bf16 and fp16 in time_attention_any.cu's
# order); the Hopper kernel takes bf16 at head dim 64
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the kernel's key-frame ceilings (one instantiation each; 21 is the model's
# chunk length); a launch takes the smallest that holds T
CEILINGS = (4, 8, 16, 21, 24, 32)
CHUNK = 16  # channels of q, k or v in a ring unit
STAGES = 4  # ring units, or as many as fit in a block's shared memory
MAX_SMEM = 232448  # 227 KB, a block's most dynamic shared memory
_SMEM_HEAD = 256  # base alignment slack and the ring's mbarriers
# how the producer warp fills the ring (csrc/time_attention.cu `Copy`)
COPIES = {"tma": 0, "cp.async.8": 1, "cp.async.4": 2, "span": 3, "loads": 4}


class TimePlan(NamedTuple):
    """K2's launch: the key-frame `ceiling` (Tc), `positions` (P) a tile and
    `frames_per_thread` (R), `chunk` channels a ring unit and `stages`
    units, the `copy` mode (a key of COPIES: "tma" where every row of q, k
    and v starts on a 16-byte boundary and S * 2 is a multiple of 16, so a
    unit is one TMA box; "cp.async.8" / "cp.async.4" where the rows start on
    8- / 4-byte boundaries; "span" where they start on 2-byte boundaries, a
    chunk's rows are packed and frames and heads start on 16-byte ones, so
    each frame's chunk is one bulk copy into a staging area; "loads"
    otherwise), `tiles` of P positions a (scene, head), `items` = b * H *
    tiles (item i is tile i % tiles of (scene, head) = divmod(i // tiles,
    H)), `threads` a block (the consumer warps, then one producer warp) and
    `smem_bytes`."""

    ceiling: int
    positions: int
    frames_per_thread: int
    chunk: int
    stages: int
    copy: str
    tiles: int
    items: int
    threads: int
    smem_bytes: int


def _copy_mode(q, k, v, o, S: int) -> str:
    """How the producer copies q, k and v (a key of COPIES): from the
    largest of 16, 8, 4 and 2 bytes that divides every row start (base
    address and frame, head and channel strides) of q, k, v and o and the
    row length S * 2; where that is 2, "span" if every chunk of q, k and v
    is packed (channel stride S) from a 16-byte boundary, else "loads"."""
    g, packed = 16, True
    for t in (q, k, v, o):
        st, sh, sd, _ = t.stride()
        ptr = t.data_ptr()
        g = math.gcd(g, ptr, 2 * st, 2 * sh, 2 * sd, 2 * S)
        packed = packed and (t is o or (sd == S and math.gcd(16, ptr, 2 * st, 2 * sh) == 16))
    if g > 2:
        return {16: "tma", 8: "cp.async.8", 4: "cp.async.4"}[g]
    return "span" if packed else "loads"


@functools.lru_cache(maxsize=256)
def _launch_plan(T: int, S: int, scene_heads: int, copy: str) -> TimePlan:
    """The launch geometry of T frames of S positions for `scene_heads`
    (scene, head) pairs, given the copy mode; "span" falls back to "loads"
    where its staging areas do not fit beside two ring stages."""
    ceiling = next(c for c in CEILINGS if c >= T)
    R, P = (2, 32) if ceiling > 21 else (3, 64)
    consumers = -(-math.ceil(T / R) * (P // 2) // 32) * 32
    tiles = -(-S // P)
    stage = ceiling * CHUNK * P * 2
    # "span": two staging areas, each a unit's T packed spans of CHUNK rows
    # and one word past them
    staging = 2 * (-(-(T * CHUNK * S * 2 + 16) // 128) * 128) if copy == "span" else 0
    if copy == "span" and _SMEM_HEAD + 2 * stage + staging > MAX_SMEM:
        copy, staging = "loads", 0
    stages = min(STAGES, (MAX_SMEM - _SMEM_HEAD - staging) // stage)
    return TimePlan(ceiling, P, R, CHUNK, stages, copy, tiles, scene_heads * tiles, consumers + 32,
                    _SMEM_HEAD + stages * stage + staging)


def _k2_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int,
             out: torch.Tensor | None = None) -> TimePlan:
    """Raise on what K2 does not take; else its launch plan, for writing
    into `out` (a new contiguous tensor where None). Needs no card: it
    reads shapes, dtypes, strides and addresses only."""
    shape = q.shape
    BT, H, D, S = shape
    T = num_frames
    if D != HEAD_DIM:
        raise ValueError(f"time attention needs head dim {HEAD_DIM}, got {D}")
    if not 1 <= T <= MAX_FRAMES or BT % T:
        raise ValueError(f"time attention takes 1..{MAX_FRAMES} frames dividing {BT}, got {T}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"time attention takes bfloat16, got {name}.dtype={t.dtype}")
        if t.shape != shape or t.stride(3) != 1:
            raise ValueError(
                f"time attention: {name} must be (b*T, H, 64, S) with S contiguous, "
                f"got shape {tuple(t.shape)} strides {t.stride()}"
            )
        if t.device != q.device:
            raise ValueError("time attention: q, k and v must be on one device")
    if out is None:
        out = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    elif (out.shape != shape or out.dtype != torch.bfloat16 or out.device != q.device
          or not out.is_contiguous()):
        raise ValueError("time attention: out must be a contiguous (b*T, H, 64, S) bf16 tensor on q's device")
    return _launch_plan(T, S, BT // T * H, _copy_mode(q, k, v, out, S))


# how the other entry's producer fills its ring (csrc/time_attention_any.cu
# `Copy`), its positions a tile (a warp's lanes), and its query frames a
# warp by key-frame ceiling (5 at 32, which keeps a block at 8 warps)
ANY_COPIES = {"tma": 0, "cp.async.8": 1, "cp.async.4": 2, "loads": 3}
ANY_POSITIONS = 32
ANY_FRAMES_PER_WARP = {c: 5 if c > 24 else 4 for c in CEILINGS}


class AnyPlan(NamedTuple):
    """The launch of K2's other entry: the key-frame `ceiling` (Tc), `chunks`
    of CHUNK channels (the last zero-filled past D), `stages` ring units of
    `unit_bytes` (Tc frames x CHUNK channels x ANY_POSITIONS positions in
    the input dtype), the `copy` mode (a key of ANY_COPIES), `tiles` of
    ANY_POSITIONS positions a (scene, head), `items` = b * H * tiles (item i
    is tile i % tiles of (scene, head) = divmod(i // tiles, H)),
    `frames_per_warp` (R), `threads` a block (ceil(T / R) consumer warps,
    then the producer warps: one for "tma", else two where the block stays
    at 8 warps) and `smem_bytes`."""

    ceiling: int
    frames_per_warp: int
    chunks: int
    stages: int
    unit_bytes: int
    copy: str
    tiles: int
    items: int
    threads: int
    smem_bytes: int


def _any_copy_mode(q, k, v, S: int) -> str:
    """How the other entry's producer copies q, k and v: "loads" unless
    positions are contiguous in all three; else by the largest of 16, 8, 4
    bytes that divides every row start (base address and frame, head and
    channel strides, in bytes) and the row length S times the element size:
    "tma" at 16 (where no stride is 0), "cp.async.8" or "cp.async.4" at 8 or
    4, "loads" below."""
    if any(t.stride(3) != 1 for t in (q, k, v)):
        return "loads"
    e = q.element_size()
    g = 16
    for t in (q, k, v):
        st, sh, sd, _ = t.stride()
        g = math.gcd(g, t.data_ptr(), e * st, e * sh, e * sd, e * S)
        if 0 in (st, sh, sd):  # a tensor map takes no zero stride
            g = math.gcd(g, 8)
    return {16: "tma", 8: "cp.async.8", 4: "cp.async.4"}.get(g, "loads")


@functools.lru_cache(maxsize=256)
def _any_launch_plan(T: int, D: int, S: int, scene_heads: int, element_size: int, copy: str) -> AnyPlan:
    """The other entry's launch geometry for T frames of D channels and S
    positions, `scene_heads` (scene, head) pairs, the element size and the
    copy mode."""
    ceiling = next(c for c in CEILINGS if c >= T)
    unit = ceiling * CHUNK * ANY_POSITIONS * element_size
    stages = min(STAGES, (MAX_SMEM - _SMEM_HEAD) // unit)
    tiles = -(-S // ANY_POSITIONS)
    R = ANY_FRAMES_PER_WARP[ceiling]
    producers = 1 if copy == "tma" or -(-ceiling // R) + 2 > 8 else 2
    return AnyPlan(ceiling, R, -(-D // CHUNK), stages, unit, copy, tiles, scene_heads * tiles,
                   32 * (-(-T // R) + producers), _SMEM_HEAD + stages * unit)


def _any_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int) -> AnyPlan:
    """The launch plan of K2's other entry for (b*T, H, D, S) operands that
    `k2_route` took. Needs no card: it reads shapes, strides and addresses
    only."""
    BT, H, D, S = q.shape
    return _any_launch_plan(num_frames, D, S, BT // num_frames * H, q.element_size(),
                            _any_copy_mode(q, k, v, S))


def k2_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int,
             out: torch.Tensor | None = None) -> str:
    """Which of K2's kernels a launch takes: "hopper" (csrc/time_attention.cu)
    for bf16 at head dim 64 with S contiguous in q, k and v (and a
    contiguous bf16 `out` where given), else "any"
    (csrc/time_attention_any.cu). Raises only on what the JAX kernel
    refuses too: T outside 1..32 or not dividing b*T, operands of other
    shapes, dtypes or devices, or a dtype that is not a float. Needs no
    card: it reads shapes, dtypes and strides only."""
    BT, H, D, S = q.shape
    T = num_frames
    if not 1 <= T <= MAX_FRAMES or BT % T:
        raise ValueError(f"time attention takes 1..{MAX_FRAMES} frames dividing {BT}, got {T}")
    if q.dtype not in DTYPES:
        raise TypeError(f"time attention takes float32, bfloat16 or float16, got q.dtype={q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"time attention: {name} must match q (shape {tuple(q.shape)}, {q.dtype}, {q.device}), "
                f"got {tuple(t.shape)}, {t.dtype}, {t.device}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype or out.device != q.device
                            or not out.is_contiguous()):
        raise ValueError("time attention: out must be a contiguous tensor of q's shape, dtype and device")
    hopper = (q.dtype == torch.bfloat16 and D == HEAD_DIM
              and all(t.stride(3) == 1 for t in (q, k, v)))
    return "hopper" if hopper else "any"


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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K2: the kernel `k2_route` picks. q, k, v: (b*T, H, D, S) of one
    dtype. Writes into `out` (a contiguous tensor of q's shape and dtype)
    when given, else into a new one, and returns it."""
    BT, H, D, S = q.shape
    if k2_route(q, k, v, num_frames, out) == "any":
        return time_attention_any_cuda(q, k, v, num_frames, out)
    o = torch.empty((BT, H, D, S), dtype=torch.bfloat16, device=q.device) if out is None else out
    plan = _k2_plan(q, k, v, num_frames, o)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _kernels.TIME_ATTENTION.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            BT // num_frames, num_frames, H, S, *strides, D**-0.5 * math.log2(math.e),
            plan.ceiling, plan.stages, COPIES[plan.copy], stream,
        )
    return o


def time_attention_any_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K2's entry for any head dim, dtype and strides
    (csrc/time_attention_any.cu). q, k, v: (b*T, H, D, S) of one dtype of
    DTYPES; writes into `out` (contiguous, q's shape and dtype) when given,
    else into a new contiguous tensor, and returns it."""
    BT, H, D, S = q.shape
    k2_route(q, k, v, num_frames, out)
    o = torch.empty((BT, H, D, S), dtype=q.dtype, device=q.device) if out is None else out
    plan = _any_plan(q, k, v, num_frames)
    with torch.cuda.device(q.device):
        _kernels.TIME_ATTENTION_ANY.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            BT // num_frames, num_frames, H, D, S, *(s for t in (q, k, v, o) for s in t.stride()),
            D**-0.5 * math.log2(math.e), DTYPES.index(q.dtype), plan.ceiling, plan.stages,
            ANY_COPIES[plan.copy], torch.cuda.current_stream(q.device).cuda_stream,
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


@torch.library.custom_op(f"{_kernels.OPS}::time_attention", mutates_args=())
def time_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Temporal attention over (b*T, H, D, S): K2 on CUDA tensors (one of its
    two kernels by `k2_route`; the Hopper one plans its copy mode from the
    views' strides and addresses at run time), the plain version on CPU
    tensors; a contiguous result."""
    if _kernels.device_route("time attention", q) == "cuda":
        return time_attention_cuda(q, k, v, num_frames)
    return time_attention_plain(q, k, v, num_frames).contiguous()


@time_attention_op.register_fake
def _(q, k, v, num_frames):
    return q.new_empty(q.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, num_frames = inputs
    ctx.save_for_backward(q, k, v)
    ctx.num_frames = num_frames


def _backward(ctx, do):
    q, k, v = ctx.saved_tensors
    return (*time_attention_bwd_plain(q, k, v, do, ctx.num_frames), None)


time_attention_op.register_autograd(_backward, setup_context=_setup_context)


def time_attention_bhds(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int
) -> torch.Tensor:
    """Temporal attention over (b*T, H, D, S), differentiable: the plain
    version for CPU tensors, kernel K2 for CUDA tensors (or an error)."""
    _kernels.device_route("time attention", q)
    return time_attention_op(q, k, v, num_frames)
