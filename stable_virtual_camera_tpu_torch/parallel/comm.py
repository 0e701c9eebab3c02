"""The collectives of a view or model group, and the threads that run a
mesh's ranks.

The JAX package never calls a collective itself: XLA inserts them where a
sharded program needs them, and the ring's `lax.ppermute`
(parallel/ring_attention.py:185-186) is its one explicit exchange. The port
runs the ranks of a mesh (parallel/mesh.py) as threads of one process, so
it writes those exchanges out here: `all_gather`, `all_reduce`,
`all_to_all`, `ring_shift` (JAX's ppermute to the next rank), `broadcast`,
`broadcast_object` and `barrier`, each a method of a rank's `Comm`.
`all_reduce` sums every rank's copy in rank order, in fp32, on every rank,
so that all ranks hold the same bits (the model group's ranks must stay
bit-equal over a whole sampling loop).

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

`run_ranks(mesh, fn)` starts one thread a rank. Each thread runs `fn` on its
own device, inside `torch.cuda.device` (kernels launch on the current
device) and on its own stream, even where devices repeat, so a missing
synchronisation shows on one card too. A rank's stream and a new thread's
cuBLAS and cuDNN handles are created with device memory from outside the
caching allocator, which fails once the allocator's cache fills the card.
So where the cache has left less than `HANDLE_HEADROOM` of a rank's card
free, `run_ranks` first releases the cache's unused blocks, as the
allocator itself does before it reports running out of memory, and every
rank takes its stream and handles before any rank starts `fn`. Every wait of a collective has a
timeout and raises TimeoutError when it runs out; a rank that raises aborts
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

DEFAULT_TIMEOUT = 600.0  # seconds a rank waits for its group at a collective
HANDLE_HEADROOM = 1 << 30  # bytes left free on a card for the rank threads' library handles


class CollectiveError(RuntimeError):
    """A collective broken off because another rank failed."""


class _Group:
    """The shared state of one group of ranks for one `run_ranks` call."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.timeout = timeout
        self.slots: list[Any] = [None] * size
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


class Comm:
    """One rank's handle on its group: `rank` in 0..size-1 and the
    collectives. With size 1 each collective returns its input."""

    def __init__(self, group: _Group, rank: int, device: torch.device):
        self._group = group
        self.rank = rank
        self.size = group.size
        self.device = torch.device(device)

    def _wait(self, what: str) -> None:
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
        rank order (this rank's own piece is `pieces[rank]` itself)."""
        if len(pieces) != self.size:
            raise ValueError(f"all_to_all: {len(pieces)} pieces for {self.size} ranks")
        if self.size == 1:
            return list(pieces)
        return self._exchange(pieces, "all_to_all", lambda slots: [
            pieces[self.rank] if j == self.rank else self._copy((s[0][self.rank], s[1]))
            for j, s in enumerate(slots)])

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t`, the same bits on every rank: the
        ranks' copies added in rank order in fp32, cast back once."""
        if self.size == 1:
            return t
        parts = self._exchange(t, "all_reduce", lambda slots: [
            t if j == self.rank else self._copy(s) for j, s in enumerate(slots)])
        acc = parts[0].to(torch.float32, copy=True)
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


@dataclass
class RankContext:
    """What `fn` gets in `run_ranks`: the rank's flat index, its (data,
    view, model) coordinates, its device, the Comm of its view group (the
    ranks of its data row at its model coordinate) and that of its model
    group (the ranks at its data and view coordinates; size 1 on a mesh
    without a "model" axis)."""

    rank: int
    data: int
    view: int
    device: torch.device
    comm: Comm
    model: int = 0
    model_comm: Comm | None = None


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
              timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run `fn(ctx)` once for every rank of the mesh's data rows `rows`
    (default all), each in its own thread on its own device and stream;
    returns the results in rank order. The ranks' streams start after the
    caller's current streams, and the caller's current streams wait for
    the ranks' work before this returns, so the results can be used on them
    directly. Grad and inference mode carry over from the caller. Raises
    the first failure of any rank once every thread has ended, or once the
    ranks still running have had `timeout` seconds to end after it."""
    n_data, n_view, n_model = mesh.shape["data"], mesh.shape["view"], mesh.n_model
    rows = list(range(n_data)) if rows is None else list(rows)
    ranks = [mesh.rank(d, v, m) for d in rows for v in range(n_view) for m in range(n_model)]
    groups = {(d, m): _Group(n_view, timeout) for d in rows for m in range(n_model)}
    model_groups = {(d, v): _Group(n_model, timeout) for d in rows for v in range(n_view)}
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
                          Comm(model_groups[data, view], model, dev))
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
            for g in (start, *groups.values(), *model_groups.values()):
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
