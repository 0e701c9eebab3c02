"""The collectives of a view or model group, and the threads that run a
mesh's ranks.

The JAX package never calls a collective itself: XLA inserts them where a
sharded program needs them, and the ring's `lax.ppermute`
(parallel/ring_attention.py:185-186) is its one explicit exchange. The port
runs the ranks of a mesh (parallel/mesh.py) as threads of one process, so
it writes those exchanges out here: `all_gather`, `all_reduce`,
`all_to_all`, `ring_shift` (JAX's ppermute to the next rank), `broadcast`,
`broadcast_object` and `barrier`, each a method of a rank's `Comm`.
`all_reduce` sums every rank's copy in rank order, in fp32 (an integer
tensor in its own dtype, exactly), on every rank, so that all ranks hold
the same bits (the model group's ranks must stay bit-equal over a whole
sampling loop).

An exchange posts the rank's value in its group's slot, waits for the
whole group, takes what it needs from the other slots, and waits once more
so that no slot is overwritten before every rank has read it. A CUDA value
is posted with an event recorded on the producer's stream; the consumer's
stream waits on that event, copies the value into a tensor of its own, and
records the copy's stream on the producer's tensor for the caching
allocator. The copy is explicit because `.to()` onto the same device
returns the same tensor, and ranks that share a card must not share
buffers across streams. On a node with several cards the same copy is a
peer copy over NVLink.

Gradients cross ranks without any exchange inside the autograd engine.
The engine runs the CUDA nodes of every concurrent `backward()` on one
worker thread a device, so a backward node that waited for another rank
would wait for nodes queued behind it. So `Comm.exchange_with_grad` runs an
exchange's forward in the rank threads with no graph, then joins every
rank's inputs and outputs in ONE autograd node (`_JoinFn`, built by rank 0
once all have posted) whose backward sees every rank's output gradients at
once and computes every rank's input gradients with no host
synchronisation; the caller runs one `backward()` over the union of the
ranks' graphs from its own thread (training/train_step.py). `all_to_all`
is differentiable this way (its backward is the inverse all-to-all), and so
is the ring attention (parallel/ring_attention.py). Every exchange raises
when called inside a backward (`torch._C._current_graph_task_id() != -1`).
Rematerialisation recomputes a block inside the backward, so a block run
under `RematRecord` records its exchanges' outputs in the forward and,
recomputed, replays them instead of exchanging.

`run_ranks(mesh, fn)` starts one thread a rank. Each thread runs `fn` on its
own device, inside `torch.cuda.device` (kernels launch on the current
device) and on its own stream, even where devices repeat, so a missing
synchronisation shows on one card too. A rank's stream and a new thread's
cuBLAS and cuDNN handles are created with device memory from outside the
caching allocator, which fails once the allocator's cache fills the card.
So where the cache has left less than `HANDLE_HEADROOM` of a rank's card
free, `run_ranks` first releases the cache's unused blocks, as the
allocator itself does before it reports running out of memory, and every
rank takes its stream and handles before any rank starts `fn`. Every wait
of a collective has a timeout (the mesh's, `make_mesh(..., timeout=)`) and
raises TimeoutError when it runs out; a rank that raises aborts
its groups, which wakes every waiting rank with a CollectiveError, and
`run_ranks` joins every thread and raises the first failure (the root
cause, not the ranks it woke).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from stable_virtual_camera_tpu_torch.parallel.mesh import Mesh

HANDLE_HEADROOM = 1 << 30  # bytes left free on a card for the rank threads' library handles


class CollectiveError(RuntimeError):
    """A collective broken off because another rank failed."""


class _Group:
    """The shared state of one group of ranks for one `run_ranks` call."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.timeout = timeout
        self.slots: list[Any] = [None] * size
        self.joined: Any = None  # the outputs of the last join, by rank
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.aborted = False

    def abort(self) -> None:
        self.aborted = True
        self.barrier.abort()


def _map_tensors(fn: Callable, value):
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, (tuple, list)):
        return type(value)(_map_tensors(fn, v) for v in value)
    if isinstance(value, dict):
        return {k: _map_tensors(fn, v) for k, v in value.items()}
    return value


class RematRecord:
    """The exchanges of one rematerialised block on one rank: entered around
    the block's forward, it records each `exchange_with_grad`'s outputs
    (detached: a record that held their graph would keep it alive in a
    cycle); entered again around the recompute inside the backward, it
    replays them in order, as fresh leaves with the forward's
    requires_grad, so the recompute saves the tensors the forward saved
    and no rank waits in the engine."""

    _local = threading.local()

    def __init__(self):
        self.outputs: list[tuple] = []
        self.entries = 0
        self.played = 0

    def __enter__(self):
        self.entries += 1
        self.played = 0
        stack = self._local.__dict__.setdefault("stack", [])
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._local.stack.pop()

    @classmethod
    def current(cls) -> "RematRecord | None":
        stack = cls._local.__dict__.get("stack")
        return stack[-1] if stack else None

    def replay(self) -> tuple | None:
        """The next recorded outputs while recomputing, else None."""
        if self.entries == 1:
            return None
        outs = self.outputs[self.played]
        self.played += 1
        return tuple(o.detach().requires_grad_(g) for o, g in outs)

    def record(self, outputs: tuple) -> None:
        if self.entries == 1:
            self.outputs.append(tuple((o.detach(), o.requires_grad) for o in outputs))


class _Join:
    """What one join node keeps for its backward: every rank's output count
    and saved values (tensors detached), and the backward function."""

    def __init__(self, posts: list, backward: Callable):
        self.n_outs = [len(p[1]) for p in posts]
        self.outs = [p[1] for p in posts]
        self.saved = [_map_tensors(torch.Tensor.detach, p[2]) for p in posts]
        self.fn = backward

    def backward(self, flat_grads) -> list:
        grads, i = [], 0
        for n in self.n_outs:
            grads.append(flat_grads[i : i + n])
            i += n
        by_rank = self.fn(self.saved, grads)
        self.saved = None  # free them before the rest of the backward
        return [g for rank in by_rank for g in rank]


class _JoinFn(torch.autograd.Function):
    """One autograd node over every rank's share of an exchange: its inputs
    are every rank's inputs, its outputs every rank's outputs (computed
    before, in the rank threads)."""

    @staticmethod
    def forward(ctx, join: _Join, *flat_inputs):
        ctx.join = join
        outs, join.outs = join.outs, None
        return tuple(o for rank in outs for o in rank)

    @staticmethod
    def backward(ctx, *grads):
        join, ctx.join = ctx.join, None
        return (None, *join.backward(grads))


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class Comm:
    """One rank's handle on its group: `rank` in 0..size-1 and the
    collectives. With size 1 each collective returns its input."""

    def __init__(self, group: _Group, rank: int, device: torch.device):
        self._group = group
        self.rank = rank
        self.size = group.size
        self.device = torch.device(device)

    def _wait(self, what: str) -> None:
        if _in_backward():
            raise RuntimeError(
                f"{what}: rank {self.rank} of {self.size} called a collective inside an autograd "
                "backward, where it would wait in the engine's device thread behind the other "
                "ranks' nodes (exchanges with gradients join in one node: exchange_with_grad)"
            )
        try:
            self._group.barrier.wait()
        except threading.BrokenBarrierError:
            if self._group.aborted:
                raise CollectiveError(f"{what}: another rank of the group failed") from None
            raise TimeoutError(
                f"{what}: rank {self.rank} of {self.size} waited more than "
                f"{self._group.timeout} s for its group"
            ) from None

    def _ready(self):
        """An event on this rank's current stream after its last op (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _take(self, src: torch.Tensor, ev) -> torch.Tensor:
        """A copy of another rank's tensor on this rank's device, ordered
        after the producer's event on this rank's stream."""
        if self.device.type == "cuda":
            if ev is not None:
                torch.cuda.current_stream(self.device).wait_event(ev)
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            out.copy_(src)
            if src.device.type == "cuda":
                src.record_stream(torch.cuda.current_stream(src.device))
            return out
        if ev is not None:
            ev.synchronize()
        return src.to(self.device, copy=True, memory_format=torch.contiguous_format)

    def _exchange(self, value, what: str, take: Callable[[list], Any]):
        g = self._group
        g.slots[self.rank] = (value, self._ready())
        self._wait(what)
        out = take(g.slots)
        self._wait(what)
        return out

    def _copy(self, slot) -> Any:
        value, ev = slot
        return _map_tensors(lambda t: self._take(t, ev), value)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's `t`, in rank order (this rank's own is `t` itself)."""
        if self.size == 1:
            return [t]
        return self._exchange(t, "all_gather", lambda slots: [
            t if j == self.rank else self._copy(s) for j, s in enumerate(slots)])

    def all_to_all(self, pieces: list[torch.Tensor]) -> list[torch.Tensor]:
        """`pieces[j]` goes to rank j; returns what each rank sent here, in
        rank order (this rank's own piece is `pieces[rank]` itself without
        a graph). With grad enabled it is differentiable: the backward sends
        each received piece's gradient back to its sender."""
        if len(pieces) != self.size:
            raise ValueError(f"all_to_all: {len(pieces)} pieces for {self.size} ranks")
        if self.size == 1:
            return list(pieces)
        return list(self.exchange_with_grad(tuple(pieces), self._all_to_all, _all_to_all_backward))

    def _all_to_all(self, *pieces: torch.Tensor) -> tuple[tuple[torch.Tensor, ...], tuple]:
        """The exchange, and what its backward needs: each piece's device."""
        return tuple(self._exchange(pieces, "all_to_all", lambda slots: [
            pieces[self.rank] if j == self.rank else self._copy((s[0][self.rank], s[1]))
            for j, s in enumerate(slots)])), tuple(p.device for p in pieces)

    def exchange_with_grad(self, inputs: tuple, forward: Callable, backward: Callable) -> tuple:
        """Run an exchange whose gradient crosses ranks. `forward(*inputs)
        -> (outputs, saved)` runs on every rank with no graph (it may use
        this Comm's collectives; `saved` holds what the backward needs);
        with grad enabled, every rank's inputs and outputs are then joined
        in one autograd node, whose backward calls `backward(saved, grads)`
        once for all ranks: each argument a list by rank of that rank's
        tuple (grads: of its outputs, zeros where an output has none),
        returning a list by rank of tuples of input gradients (None for
        none). Inside a `RematRecord`'s recompute it returns the forward's
        outputs without exchanging."""
        record = RematRecord.current()
        replayed = None if record is None else record.replay()
        if replayed is not None:
            return replayed
        with torch.no_grad():
            outputs, saved = forward(*inputs)
        outputs = tuple(o.detach() for o in outputs)
        if torch.is_grad_enabled():
            outputs = self._join(inputs, outputs, saved, backward)
        if record is not None:
            record.record(outputs)
        return outputs

    def _join(self, inputs: tuple, outputs: tuple, saved: tuple, backward: Callable) -> tuple:
        g = self._group
        g.slots[self.rank] = (inputs, outputs, saved)
        self._wait("join")
        if self.rank == 0:
            posts = list(g.slots)
            if any(t.requires_grad for p in posts for t in p[0]):
                flat = _JoinFn.apply(_Join(posts, backward), *(t for p in posts for t in p[0]))
                g.joined, i = [], 0
                for p in posts:
                    g.joined.append(tuple(flat[i : i + len(p[1])]))
                    i += len(p[1])
            else:
                g.joined = [p[1] for p in posts]
        self._wait("join")
        mine = g.joined[self.rank]
        self._wait("join")
        return mine

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t`, the same bits on every rank: the
        ranks' copies added in rank order in fp32, cast back once; an
        integer `t` (W8A8's int32 partial products) summed in its own dtype,
        which is exact in any order."""
        if self.size == 1:
            return t
        parts = self._exchange(t, "all_reduce", lambda slots: [
            t if j == self.rank else self._copy(s) for j, s in enumerate(slots)])
        acc = parts[0].to(torch.float32 if t.is_floating_point() else t.dtype, copy=True)
        for p in parts[1:]:
            acc += p
        return acc.to(t.dtype)

    def ring_shift(self, value):
        """Send `value` (a tensor or a tuple of them) to the next rank and
        return the previous rank's: JAX's ppermute i -> i + 1 mod n."""
        if self.size == 1:
            return value
        return self._exchange(value, "ring_shift",
                              lambda slots: self._copy(slots[(self.rank - 1) % self.size]))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank."""
        if self.size == 1:
            return t
        return self._exchange(t if self.rank == src else None, "broadcast",
                              lambda slots: t if self.rank == src else self._copy(slots[src]))

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s Python object (no tensors) on every rank."""
        if self.size == 1:
            return obj
        return self._exchange(obj, "broadcast_object", lambda slots: slots[src][0])

    def barrier(self) -> None:
        if self.size > 1:
            self._wait("barrier")


def _on(t: torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    """t on `device`, for use on the current stream there: a copy across
    devices; on the same device t itself, recorded on the current stream
    so the caching allocator keeps it until the work queued here is done."""
    if t is None:
        return None
    if t.device != device:
        return t.to(device, copy=True)
    if t.device.type == "cuda":
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


def _all_to_all_backward(devices, grads):
    """Rank r's output piece j came from rank j's input piece r, so its
    gradient goes back there."""
    n = len(devices)
    return [tuple(_on(grads[j][r], devices[r][j]) for j in range(n)) for r in range(n)]


@dataclass
class RankContext:
    """What `fn` gets in `run_ranks`: the rank's flat index, its (data,
    view, model) coordinates, its device, the Comm of its view group (the
    ranks of its data row at its model coordinate) and that of its model
    group (the ranks at its data and view coordinates; size 1 on a mesh
    without a "model" axis) and that of its data group (the ranks of the
    rows run at its view and model coordinates, ranked by row)."""

    rank: int
    data: int
    view: int
    device: torch.device
    comm: Comm
    model: int = 0
    model_comm: Comm | None = None
    data_comm: Comm | None = None


def _take_handles(device: torch.device) -> None:
    """This thread's cuBLAS and cuDNN handles on `device`, taken from
    PyTorch's pools or created now (a 1x1 conv takes the cuDNN one)."""
    torch.cuda.current_blas_handle()
    if torch.backends.cudnn.is_available() and torch.backends.cudnn.enabled:
        x = torch.zeros(1, 1, 1, 1, device=device)
        torch.nn.functional.conv2d(x, x)


def _root_cause(errors: list[BaseException]) -> BaseException:
    for e in errors:
        if not isinstance(e, CollectiveError):
            return e
    return errors[0]


def run_ranks(mesh: Mesh, fn: Callable[[RankContext], Any], rows=None,
              timeout: float | None = None) -> list:
    """Run `fn(ctx)` once for every rank of the mesh's data rows `rows`
    (default all), each in its own thread on its own device and stream;
    returns the results in rank order. The ranks' streams start after the
    caller's current streams, and the caller's current streams wait for
    the ranks' work before this returns, so the results can be used on them
    directly. Grad and inference mode carry over from the caller. Raises
    the first failure of any rank once every thread has ended, or once the
    ranks still running have had `timeout` seconds to end after it
    (default: the mesh's `timeout`)."""
    if timeout is None:
        timeout = mesh.timeout
    n_data, n_view, n_model = mesh.shape["data"], mesh.shape["view"], mesh.n_model
    rows = list(range(n_data)) if rows is None else list(rows)
    ranks = [mesh.rank(d, v, m) for d in rows for v in range(n_view) for m in range(n_model)]
    groups = {(d, m): _Group(n_view, timeout) for d in rows for m in range(n_model)}
    model_groups = {(d, v): _Group(n_model, timeout) for d in rows for v in range(n_view)}
    data_groups = {(v, m): _Group(len(rows), timeout) for v in range(n_view) for m in range(n_model)}
    inference, grad = torch.is_inference_mode_enabled(), torch.is_grad_enabled()
    cuda_devices = {mesh.device(r) for r in ranks if mesh.device(r).type == "cuda"}
    if any(torch.cuda.mem_get_info(dev)[0] < HANDLE_HEADROOM for dev in cuda_devices):
        torch.cuda.empty_cache()
    cuda_ranks = [r for r in ranks if mesh.device(r).type == "cuda"]
    # the CUDA ranks meet here once each holds its stream and handles
    start = _Group(max(len(cuda_ranks), 1), timeout)
    started = {}
    for dev in cuda_devices:
        started[dev] = torch.cuda.Event()
        started[dev].record(torch.cuda.current_stream(dev))
    results: dict[int, Any] = {}
    finished: dict[int, torch.cuda.Event] = {}
    errors: list[BaseException] = []
    lock = threading.Lock()

    def body(rank: int) -> None:
        data, view, model = (*mesh.coords(rank), 0)[:3]
        dev = mesh.device(rank)
        ctx = RankContext(rank, data, view, dev, Comm(groups[data, model], view, dev), model,
                          Comm(model_groups[data, view], model, dev),
                          Comm(data_groups[view, model], rows.index(data), dev))
        try:
            with torch.inference_mode() if inference else torch.set_grad_enabled(grad):
                if dev.type != "cuda":
                    results[rank] = fn(ctx)
                    return
                stream = mesh.stream(rank)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    stream.wait_event(started[dev])
                    _take_handles(dev)
                    Comm(start, cuda_ranks.index(rank), dev).barrier()
                    results[rank] = fn(ctx)
                    finished[rank] = torch.cuda.Event()
                    finished[rank].record(stream)
        except BaseException as e:  # noqa: BLE001 - handed to the caller below
            with lock:
                errors.append(e)
            for g in (start, *groups.values(), *model_groups.values(), *data_groups.values()):
                g.abort()

    threads = [threading.Thread(target=body, args=(r,), name=f"mesh-rank-{r}", daemon=True)
               for r in ranks]
    for t in threads:
        t.start()
    deadline = None
    for t in threads:
        while t.is_alive():
            t.join(0.05)
            if errors and deadline is None:
                deadline = time.monotonic() + timeout
            if deadline is not None and t.is_alive() and time.monotonic() > deadline:
                err = _root_cause(errors)
                err.add_note(f"run_ranks: {t.name} did not end within {timeout} s of this failure")
                raise err
    if errors:
        raise _root_cause(errors)
    for ev in finished.values():
        for dev in cuda_devices:
            torch.cuda.current_stream(dev).wait_event(ev)
    for r in finished:
        _map_tensors(lambda t: t.record_stream(torch.cuda.current_stream(t.device))
                     if t.device.type == "cuda" else None, results[r])
    return [results.get(r) for r in ranks]
