"""The ("data", "view") device mesh, and the ("data", "view", "model") one.

Counterpart of stable_virtual_camera_tpu/parallel/mesh.py (`make_mesh`,
`make_mesh_tp`):
  * "view" shards a chunk's frames over ranks: per-frame convs, norms,
    cross-attention and per-frame self-attention stay local; the joint
    (T*h*w)-token self-attention runs as a ring over the ranks
    (parallel/ring_attention.py) and the temporal attention behind an
    all-to-all from frames to positions (models/unet.py);
  * "data" fans independent chunks out over rows of the mesh
    (parallel/sharding.make_data_parallel_sampler);
  * "model", on a mesh from `make_mesh_tp`, shards the UNet's weights
    (parallel/param_sharding.py, parallel/tensor_parallel.py): the ranks of
    a model group hold the same frames and different weight shards.

Where JAX has one controller driving every local device, the port runs one
thread a rank in one process (parallel/comm.run_ranks): each rank has its
own device and its own CUDA stream, and tensors pass between ranks by
device copies ordered by events. A device may repeat in the grid: ranks on
one card share it, each on its own stream, which is how a mesh runs on one
H100 (and on the CPU in the tests).
"""

from __future__ import annotations

import threading

import torch


# a device's rank streams, shared by every mesh: (device, slot) -> stream
_STREAMS: dict[tuple[torch.device, int], torch.cuda.Stream] = {}
_STREAMS_LOCK = threading.Lock()

DEFAULT_TIMEOUT = 600.0  # seconds a rank waits for its group at a collective


class Mesh:
    """An (n_data, n_view) grid of devices, or with a "model" axis an
    (n_data, n_view, n_model) one (`make_mesh_tp`). Rank r sits at
    (data, view) = divmod(r, n_view), or at (data, view, model) in the same
    row-major order, as JAX's `np.array(devices).reshape(...)` lays the
    grid. Each rank runs on a CUDA stream of its own (`stream`).
    `timeout` is how many seconds a rank waits for its group at a
    collective (parallel/comm.run_ranks)."""

    def __init__(self, grid: list, timeout: float = DEFAULT_TIMEOUT):
        if grid and grid[0] and isinstance(grid[0][0], (list, tuple)):
            self.axes = ("data", "view", "model")
            dims = (len(grid), len(grid[0]), len(grid[0][0]))
            flat = [d for row in grid for col in row for d in col]
        else:
            self.axes = ("data", "view")
            dims = (len(grid), len(grid[0]))
            flat = [d for row in grid for d in row]
        self.dims = dims
        self.timeout = timeout
        self._devices = [_indexed(d) for d in flat]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.dims))

    @property
    def n_model(self) -> int:
        return self.shape.get("model", 1)

    @property
    def size(self) -> int:
        return len(self._devices)

    @property
    def devices(self) -> list[torch.device]:
        """Every rank's device, in rank order."""
        return list(self._devices)

    def coords(self, rank: int) -> tuple[int, ...]:
        """(data, view), or (data, view, model) on a mesh with that axis."""
        out = []
        for n in reversed(self.dims):
            rank, c = divmod(rank, n)
            out.append(c)
        return tuple(reversed(out))

    def rank(self, data: int, view: int, model: int = 0) -> int:
        return (data * self.dims[1] + view) * self.n_model + model

    def device(self, rank: int) -> torch.device:
        return self._devices[rank]

    def stream(self, rank: int) -> torch.cuda.Stream:
        """Rank `rank`'s own stream on its (CUDA) device. The k-th rank of a
        mesh on a device takes that device's k-th rank stream, which every
        mesh shares: the caching allocator keeps a stream's freed blocks for
        that stream alone, so meshes built one after another (a CLI run, a
        server's jobs, a test) reuse the same streams' blocks instead of
        each caching its own."""
        dev = self.device(rank)
        key = (dev, self.devices[:rank].count(dev))
        with _STREAMS_LOCK:
            if key not in _STREAMS:
                _STREAMS[key] = torch.cuda.Stream(device=dev)
            return _STREAMS[key]

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}, devices={self.devices})"


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" is the current CUDA device, so that
    ranks compare equal to the tensors on them."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return local_cuda_devices()[torch.cuda.current_device()]
    return device


def local_cuda_devices() -> list[torch.device]:
    """Every CUDA device of this process; raises where there is none (a
    mesh has no CPU fallback: the CPU takes an explicit device list)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices= explicitly (e.g. [cpu] * n)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int = 1, n_view: int | None = None, devices=None,
              timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """A (n_data, n_view) mesh over `devices` (default: every local CUDA
    device, one rank each). `n_view=None` takes every device left over.
    An explicit list may repeat a device. Asking for more ranks than
    devices raises, as JAX's assert does. `timeout`: the mesh's collective
    timeout in seconds."""
    devices = list(local_cuda_devices() if devices is None else devices)
    if n_data < 1:
        raise ValueError(f"make_mesh: n_data must be >= 1, got {n_data}")
    if n_view is None:
        n_view = len(devices) // n_data
    if n_view < 1 or n_data * n_view > len(devices):
        raise ValueError(f"mesh {n_data}x{n_view} needs more than {len(devices)} devices")
    flat = devices[: n_data * n_view]
    return Mesh([flat[d * n_view : (d + 1) * n_view] for d in range(n_data)], timeout)


def make_mesh_tp(n_data: int = 1, n_view: int = 1, n_model: int | None = None, devices=None) -> Mesh:
    """A ("data", "view", "model") mesh (JAX's `make_mesh_tp`): chunks x
    frames x weight shards. "model" carries the tensor parallelism of
    parallel/tensor_parallel.py; `n_model=None` takes every device left
    over. Devices as in `make_mesh`."""
    devices = list(local_cuda_devices() if devices is None else devices)
    if n_data < 1 or n_view < 1:
        raise ValueError(f"make_mesh_tp: n_data and n_view must be >= 1, got {n_data}, {n_view}")
    if n_model is None:
        n_model = len(devices) // (n_data * n_view)
    if n_model < 1 or n_data * n_view * n_model > len(devices):
        raise ValueError(f"mesh {n_data}x{n_view}x{n_model} needs more than {len(devices)} devices")
    flat = devices[: n_data * n_view * n_model]
    return Mesh([[flat[(d * n_view + v) * n_model : (d * n_view + v + 1) * n_model]
                  for v in range(n_view)] for d in range(n_data)])
