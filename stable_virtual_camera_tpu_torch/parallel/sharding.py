"""View-sharded, tensor-parallel, batched and data-parallel sampling.

Counterpart of stable_virtual_camera_tpu/parallel/sharding.py
(`make_sharded_step`, `make_sharded_sampler`, `make_batched_sampler`,
`make_data_parallel_sampler`, `make_tensor_parallel_sampler`). Where JAX
annotates shardings and lets XLA partition one program, each rank here runs
the port's own Euler loop (sampling/sampler.py) on its share,
`sample_shard`:
  * a view rank holds frames r*T/n..(r+1)*T/n - 1 of each CFG half of its
    chunks, so `torch.cat([x, x])` and the CFG combine of the step stay
    within the rank, and the UNet's joint and temporal attention reach the
    other ranks' frames through its view group (models/unet.py);
  * the initial and per-step noise is drawn whole, exactly as the serial
    path draws it, then sliced to the rank's frames, so the sharded and
    serial paths see the same noise;
  * several chunks sample together as one batch of scenes (JAX's vmap over
    chunks): the step's CFG halves are [uncond of every chunk | cond of
    every chunk], and the UNet, whose every operation is per scene or per
    frame, takes them as 2N scenes of T frames;
  * on a mesh with a "model" axis the ranks of a model group hold the
    same frames and run the network on their weight shards
    (parallel/tensor_parallel.py), so they compute the same latents, bit
    for bit; the result is taken from model rank 0;
  * progress is reported from the rank at view 0 and model 0, and all
    ranks agree on an abort at each step boundary (that rank reads the
    event; the model group, then the view group, broadcast it).
The network is `network_fn(x, concat, t_vec, crossattn, dense, num_frames,
group=comm, model_group=model_comm, film=film)`
(engine/runner.ModelBundle.network), called with this rank's frames a
scene; a keyword goes only where it applies. `film_fn(dense, num_frames,
group, model_group)` (ModelBundle.chunk_film), where given, computes the
rank's FiLM cache of its chunks once before the loop, or returns None.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from stable_virtual_camera_tpu_torch.parallel.comm import Comm, run_ranks
from stable_virtual_camera_tpu_torch.parallel.mesh import Mesh
from stable_virtual_camera_tpu_torch.sampling.sampler import (
    ChunkConditioning,
    SamplingPlan,
    euler_edm_sample,
    euler_edm_step,
)

_FIELDS = ("crossattn", "concat", "dense", "replace", "scale")


def frames_of(t: torch.Tensor, rank: int, n: int, scenes: int) -> torch.Tensor:
    """Rank `rank` of `n`'s frames of each of `scenes` scenes of t
    ((scenes * T, ...), T frames a scene)."""
    if n == 1:
        return t
    T = t.shape[0] // scenes
    Tl = T // n
    return t.unflatten(0, (scenes, T))[:, rank * Tl : (rank + 1) * Tl].flatten(0, 1)


def stack_conditioning(conds: Sequence[ChunkConditioning]) -> ChunkConditioning:
    """N chunks' conditioning as one batch of 2N scenes: every CFG-doubled
    leaf as [uncond of each chunk | cond of each chunk], the scales one
    after another."""
    if len(conds) == 1:
        return conds[0]
    T = conds[0].scale.shape[0]
    doubled = {
        f: torch.cat([getattr(c, f)[:T] for c in conds] + [getattr(c, f)[T:] for c in conds])
        for f in _FIELDS[:-1]
    }
    return ChunkConditioning(**doubled, scale=torch.cat([c.scale for c in conds]))


class _AgreedAbort:
    """An abort event that every rank reads alike: the rank at view 0 and
    model 0 polls the caller's event; its model group, then its view group
    broadcast what it saw (the second broadcast's source, view rank 0,
    holds that value at every model coordinate)."""

    def __init__(self, comms: list[Comm], event):
        self.comms = comms
        self.event = event

    def is_set(self) -> bool:
        root = all(c.rank == 0 for c in self.comms)
        seen = self.event.is_set() if root else None
        for comm in self.comms:
            seen = comm.broadcast_object(seen)
        return seen


def sample_shard(
    network_fn: Callable,
    noises: Sequence[torch.Tensor],
    plan: SamplingPlan,
    conds: Sequence[ChunkConditioning],
    num_frames: int,
    step_noises: Sequence[Callable[[int], torch.Tensor]],
    comm: Comm | None = None,
    progress_cb=None,
    abort_event=None,
    device=None,
    model_comm: Comm | None = None,
    film_fn: Callable | None = None,
) -> torch.Tensor | None:
    """One rank's share of N chunks sampled together: `noises[c]` (T, h, w,
    C), `conds[c]` and `step_noises[c](i)` are chunk c's whole initial noise,
    conditioning and step-i churn noise. With a view `comm` of n ranks this
    rank denoises frames comm.rank*T/n.. of each chunk; without one, all T.
    With a `model_comm` of more than one rank the network runs on this
    rank's weight shards. Returns (N, T/n, h, w, C) on `device` (default:
    the noise's), or None when aborted."""
    n, r = (1, 0) if comm is None else (comm.size, comm.rank)
    if model_comm is not None and model_comm.size == 1:
        model_comm = None
    if num_frames % n:
        raise ValueError(f"num_frames={num_frames} must divide over the view axis ({n})")
    N, Tl = len(conds), num_frames // n
    dev = torch.device(device) if device is not None else noises[0].device
    cond = stack_conditioning(conds)
    local = ChunkConditioning(**{
        f: frames_of(getattr(cond, f), r, n, N if f == "scale" else 2 * N).to(dev) for f in _FIELDS
    })
    noise = torch.cat([frames_of(x, r, n, 1) for x in noises]).to(dev)

    def step_noise(i):
        return torch.cat([frames_of(draw(i), r, n, 1) for draw in step_noises]).to(dev)

    kw = {} if comm is None else {"group": comm}
    if model_comm is not None:
        kw["model_group"] = model_comm
    film = None if film_fn is None else film_fn(local.dense, Tl, comm, model_comm)
    if film is not None:
        kw["film"] = film

    def network(x, concat, t_vec, crossattn, dense, _batch_frames):
        return network_fn(x, concat, t_vec, crossattn, dense, Tl, **kw)

    comms = [c for c in (model_comm, comm) if c is not None]
    if comms and abort_event is not None:
        abort_event = _AgreedAbort(comms, abort_event)
    lead = r == 0 and (model_comm is None or model_comm.rank == 0)
    x = euler_edm_sample(network, noise, plan, local, N * Tl, step_noise,
                         progress_cb=progress_cb if lead else None, abort_event=abort_event)
    return None if x is None else x.unflatten(0, (N, Tl))


def _check_view(mesh: Mesh, num_frames: int) -> int:
    n_view = mesh.shape["view"]
    if num_frames % n_view:
        raise ValueError(f"num_frames={num_frames} must divide over view axis {n_view}")
    return n_view


def make_sharded_step(network_fn: Callable, mesh: Mesh, num_frames: int):
    """One Euler step (sampling/sampler.euler_edm_step) view-sharded over the
    mesh's first data row: `step(x, eps, scalars, cond, t_index)` takes the
    whole chunk's (T, h, w, C) state and churn noise and returns the next
    state on x's device."""
    n = _check_view(mesh, num_frames)
    Tl = num_frames // n

    def step(x, eps, scalars, cond, t_index):
        def shard(ctx):
            r = ctx.comm.rank
            local = ChunkConditioning(**{
                f: frames_of(getattr(cond, f), r, n, 1 if f == "scale" else 2).to(ctx.device)
                for f in _FIELDS
            })

            def network(*args):
                return network_fn(*args, group=ctx.comm)

            with torch.inference_mode():
                return euler_edm_step(network, frames_of(x, r, n, 1).to(ctx.device),
                                      frames_of(eps, r, n, 1).to(ctx.device), scalars, local,
                                      t_index.to(ctx.device), Tl)

        return torch.cat([o.to(x.device) for o in run_ranks(mesh, shard, rows=[0])])

    return step


def _row_sampler(network_fn: Callable, mesh: Mesh, num_frames: int, shard_frames: bool,
                 film_fn: Callable | None):
    """One chunk on the mesh's first data row: frames over the view ranks
    when `shard_frames` (else on view rank 0 alone), weights over the model
    ranks."""

    def run(noise, plan, cond, step_noise, progress_cb=None, abort_event=None):
        def shard(ctx):
            if not shard_frames and ctx.view:
                return None
            return sample_shard(network_fn, [noise], plan, [cond], num_frames, [step_noise],
                                ctx.comm if shard_frames else None, progress_cb, abort_event,
                                ctx.device, ctx.model_comm, film_fn)

        outs = run_ranks(mesh, shard, rows=[0])
        if outs[0] is None:  # the rank at view 0 and model 0 always samples
            return None
        n_model = mesh.n_model
        firsts = [o for o in outs[::n_model] if o is not None]  # model rank 0 of each view rank
        return torch.cat([o[0].to(noise.device) for o in firsts])

    return run


def make_sharded_sampler(network_fn: Callable, mesh: Mesh, num_frames: int,
                         film_fn: Callable | None = None):
    """The whole sampling loop view-sharded over the mesh's first data row:
    `run(noise, plan, cond, step_noise, progress_cb=None, abort_event=None)`
    with the chunk's whole (T, h, w, C) noise, conditioning and churn-noise
    function; returns the (T, h, w, C) latents on the noise's device, or
    None when aborted. On a mesh with a "model" axis the weights shard over
    it too (as `make_tensor_parallel_sampler`)."""
    _check_view(mesh, num_frames)
    return _row_sampler(network_fn, mesh, num_frames, True, film_fn)


def make_tensor_parallel_sampler(network_fn: Callable, mesh: Mesh, num_frames: int,
                                 film_fn: Callable | None = None):
    """The whole sampling loop with the network's weights sharded over the
    mesh's "model" axis (parallel/param_sharding.py,
    parallel/tensor_parallel.py), on its first data row; the frames shard
    over "view" too when the mesh has a view axis that divides num_frames,
    else view rank 0's model group samples them all (JAX replicates them).
    `run(...)` as `make_sharded_sampler`'s."""
    return _row_sampler(network_fn, mesh, num_frames, num_frames % mesh.shape["view"] == 0, film_fn)


def make_batched_sampler(network_fn: Callable, num_frames: int, film_fn: Callable | None = None):
    """N independent chunks denoised together on one device, as one batch
    of 2N scenes (JAX vmaps the loop over chunks): `run(noises, plan,
    conds, step_noises)` -> (N, T, h, w, C)."""

    def run(noises, plan, conds, step_noises):
        return sample_shard(network_fn, noises, plan, conds, num_frames, step_noises,
                            film_fn=film_fn)

    return run


def make_data_parallel_sampler(network_fn: Callable, mesh: Mesh, num_frames: int,
                               film_fn: Callable | None = None):
    """N chunks over the mesh's data rows: row d denoises chunks
    d*N/n_data..(d+1)*N/n_data - 1 as one batch, its frames sharded over the
    row's view ranks when T divides over them (JAX's data-parallel sampler
    replicates the view axis; here it carries the frames), else on the
    row's first rank alone. The weights are whole, as JAX's data-parallel
    program replicates them: on a mesh with a "model" axis only model rank
    0 of each (data, view) samples. `run(noises, plan, conds,
    step_noises)` -> (N, T, h, w, C) on the first noise's device; N must be
    a multiple of the data axis."""
    n_data, n_view, n_model = mesh.shape["data"], mesh.shape["view"], mesh.n_model
    sharded = num_frames % n_view == 0

    def run(noises, plan, conds, step_noises):
        N = len(conds)
        if N % n_data:
            raise ValueError(f"chunk count {N} must divide data axis {n_data}")
        per = N // n_data
        out_dev = noises[0].device

        def shard(ctx):
            if (not sharded and ctx.view) or ctx.model:
                return None
            mine = slice(ctx.data * per, (ctx.data + 1) * per)
            return sample_shard(network_fn, noises[mine], plan, conds[mine], num_frames,
                                step_noises[mine], ctx.comm if sharded else None, device=ctx.device,
                                film_fn=film_fn)

        outs = run_ranks(mesh, shard)[::n_model]
        rows = [[o.to(out_dev) for o in outs[d * n_view : (d + 1) * n_view] if o is not None]
                for d in range(n_data)]
        return torch.cat([torch.cat(row, dim=1) for row in rows])

    return run
