"""The port's multi-device sampling (stable_virtual_camera_tpu_torch/parallel/)
against the JAX package's parallel/ on the CPU, in fp32.

The port's meshes repeat the CPU device (one thread a rank, one intra-op
thread each); the JAX side runs on the 8 virtual CPU devices of
tests/conftest.py. Held here: the collectives against their definitions on
1-4 ranks (hypothesis over shapes), the mesh's refusals, a rank's failure
and a collective's timeout; ring attention against JAX's
`make_ring_self_attention` at n in {2, 4, 8} and bit-equal to its one
block at 1 rank; the view-sharded sampler (n_view=3, T=3) against JAX's
`make_sharded_sampler` and the port's unsharded loop, and one sharded step
against the unsharded step; the data-parallel
sampler (3 chunks padded to 4 over data=2, view=3) against JAX's
`make_data_parallel_sampler`; W8A8 on a view mesh within quantization
noise of the exact sampler.

Tolerance: 2e-4 of the largest latent (random tiny weights give latents
up to ~700 after 3 steps, so every bar is relative to that scale), the bar
the JAX package held against the torch oracle; the fp32 paths differ only
in summation order.
"""

import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.parallel import comm as pcomm
from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh
from stable_virtual_camera_tpu_torch.parallel.ring_attention import make_ring_self_attention, ring_attention
from stable_virtual_camera_tpu_torch.parallel.sharding import (
    make_data_parallel_sampler,
    make_sharded_sampler,
)
from stable_virtual_camera_tpu_torch.sampling import sampler as t_sampler
from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_sampler import _conditioning, _step_keys

CPU = torch.device("cpu")
T, HW, STEPS = 3, 8, 3


def cpu_mesh(n_data, n_view):
    return make_mesh(n_data, n_view, devices=[CPU] * (n_data * n_view))


def assert_close_to_scale(out, ref, rel=2e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


# --------------------------------------------------------------------------
# mesh and collectives
# --------------------------------------------------------------------------


def test_make_mesh_grid_and_refusals():
    mesh = cpu_mesh(2, 3)
    assert mesh.shape == {"data": 2, "view": 3} and mesh.size == 6
    assert [mesh.coords(r) for r in range(6)] == [(d, v) for d in range(2) for v in range(3)]
    assert all(mesh.rank(*mesh.coords(r)) == r for r in range(6))
    assert make_mesh(2, devices=[CPU] * 5).shape == {"data": 2, "view": 2}  # n_view fills the rest
    with pytest.raises(ValueError, match="needs more than 4 devices"):
        make_mesh(2, 3, devices=[CPU] * 4)
    if not torch.cuda.is_available():  # no CPU fallback for the default device list
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 1, devices=["cuda"])


@settings(max_examples=12, deadline=None)
@given(n=st.integers(1, 4), shape=st.lists(st.integers(1, 5), min_size=1, max_size=3),
       seed=st.integers(0, 2**16))
def test_collectives_match_their_definitions(n, shape, seed):
    """Every rank's tensors from one seed: all_gather gives every rank's in
    rank order, all_to_all transposes the pieces, ring_shift gives the
    previous rank's, broadcast and broadcast_object rank `src`'s."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, n, *shape)).astype(np.float32)  # [sender][receiver]
    src = int(rng.integers(n))

    def body(ctx):
        c, r = ctx.comm, ctx.comm.rank
        mine = torch.from_numpy(data[r, 0].copy())
        pieces = [torch.from_numpy(data[r, j].copy()) for j in range(n)]
        gathered = c.all_gather(mine)
        moved = c.all_to_all(pieces)
        shifted = c.ring_shift((mine, mine * 2))
        bcast = c.broadcast(mine, src=src)
        obj = c.broadcast_object({"rank": r}, src=src)
        c.barrier()
        return gathered, moved, shifted, bcast, obj

    outs = pcomm.run_ranks(cpu_mesh(1, n), body)
    for r, (gathered, moved, shifted, bcast, obj) in enumerate(outs):
        for j in range(n):
            np.testing.assert_array_equal(gathered[j].numpy(), data[j, 0])
            np.testing.assert_array_equal(moved[j].numpy(), data[j, r])
        prev = (r - 1) % n
        np.testing.assert_array_equal(shifted[0].numpy(), data[prev, 0])
        np.testing.assert_array_equal(shifted[1].numpy(), 2 * data[prev, 0])
        np.testing.assert_array_equal(bcast.numpy(), data[src, 0])
        assert obj == {"rank": src}


def test_run_ranks_data_rows_have_their_own_view_groups():
    mesh = cpu_mesh(2, 2)
    outs = pcomm.run_ranks(mesh, lambda ctx: (ctx.rank, ctx.data, ctx.view,
                                              ctx.comm.all_gather(torch.tensor([ctx.rank]))))
    for rank, data, view, gathered in outs:
        assert (data, view) == mesh.coords(rank)
        assert [int(t) for t in gathered] == [mesh.rank(data, v) for v in range(2)]
    assert pcomm.run_ranks(mesh, lambda ctx: ctx.rank, rows=[1]) == [2, 3]


def test_a_failing_rank_fails_the_call_and_wakes_the_others():
    """Rank 1 raises before the collective the others wait at: the call
    raises rank 1's error (not the ranks it woke), promptly."""
    def body(ctx):
        if ctx.comm.rank == 1:
            raise ValueError("rank 1 failed")
        ctx.comm.all_gather(torch.zeros(2))
        return ctx.rank

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 failed"):
        pcomm.run_ranks(cpu_mesh(1, 3), body, timeout=60.0)
    assert time.monotonic() - t0 < 30.0
    assert not [t for t in threading.enumerate() if t.name.startswith("mesh-rank-")]


def test_a_collective_times_out_rather_than_hangs():
    """Rank 0 never reaches the barrier: the others' wait raises
    TimeoutError after the timeout."""
    release = threading.Event()

    def body(ctx):
        if ctx.comm.rank == 0:
            release.wait(5.0)
            return None
        ctx.comm.barrier()

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="waited more than 0.3 s"):
        pcomm.run_ranks(cpu_mesh(1, 2), body, timeout=0.3)
    release.set()
    assert time.monotonic() - t0 < 10.0


# --------------------------------------------------------------------------
# ring attention
# --------------------------------------------------------------------------


def _qkv(seed, B=2, L=48, H=2, D=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_attention_matches_jax(n):
    """The port's ring over n CPU ranks against JAX's shard_map ring over n
    of the virtual devices, on (B, L, H, D) = (2, 48, 2, 16) fp32."""
    from stable_virtual_camera_tpu.ops.attention import attention_xla
    from stable_virtual_camera_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from stable_virtual_camera_tpu.parallel.ring_attention import make_ring_self_attention as jax_ring

    q, k, v = _qkv(n)
    jmesh = jax_make_mesh(n_data=1, n_view=n, devices=jax.devices()[:n])
    with jmesh:
        ref = np.asarray(jax_ring(jmesh)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = make_ring_self_attention(cpu_mesh(1, n))(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4)
    full = np.asarray(attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(out, full, atol=2e-4, rtol=2e-4)


def test_one_rank_ring_is_its_block_bit_for_bit():
    """The merge of one partial is exact: a 1-rank ring returns what K1's
    op (here its CPU route, the plain twin) gives for the block."""
    from stable_virtual_camera_tpu_torch.ops.flash_upstream import flash_attention_op

    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in _qkv(1))
    (out,) = pcomm.run_ranks(cpu_mesh(1, 1), lambda ctx: ring_attention(q, k, v, ctx.comm))
    assert torch.equal(out, flash_attention_op(q, k, v, True)[0])


# --------------------------------------------------------------------------
# the samplers
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """A bundle holding the port's tiny UNet (no VAE or CLIP: only its
    network is sampled here), the same weights as a JAX network_fn, and
    three chunks' conditioning and noise."""
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet, assemble_network_input
    from stable_virtual_camera_tpu_torch.engine.runner import ModelBundle
    from stable_virtual_camera_tpu_torch.models import io as mio
    from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
    from stable_virtual_camera_tpu_torch.models.weights import to_flax_tree

    port_unet = mio.init_flax_defaults(SevaUNet(SevaSpec.tiny()), torch.Generator().manual_seed(5))
    bundle = ModelBundle(spec=SevaSpec.tiny(), unet=mio._finish(port_unet, torch.float32, CPU),
                         vae=None, clip=None)
    unet = JaxUNet(JaxSpec.tiny())
    z = jnp.zeros
    tree = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(0), z((T, HW, HW, 11)), z((T,), jnp.int32),
                                            z((T, 1, 64)), z((T, HW, HW, 6)), num_frames=T))["params"]
    params = to_flax_tree(bundle.unet, tree)

    def network_fn(x, concat, t_vec, crossattn, dense, num_frames):
        return unet.apply({"params": params}, assemble_network_input(x, concat), t_vec,
                          crossattn, dense, num_frames=num_frames)

    rng = np.random.default_rng(11)
    conds = [_conditioning(rng, T, HW, SevaSpec.tiny().context_dim) for _ in range(3)]
    noises = [rng.normal(size=(T, HW, HW, 4)).astype(np.float32) for _ in range(3)]
    return bundle, network_fn, conds, noises


def _plans():
    from stable_virtual_camera_tpu.sampling import sampler as j_sampler
    from stable_virtual_camera_tpu.sampling.discretization import DDPMDiscretization as JaxDisc

    return (j_sampler.plan_to_device(j_sampler.make_sampling_plan(JaxDisc(), STEPS)),
            t_sampler.make_sampling_plan(DDPMDiscretization(), STEPS))


def _eps(key):
    """JAX's churn draws of a sampling loop keyed by `key`, for the port."""
    return [torch.from_numpy(np.array(jax.random.normal(k, (T, HW, HW, 4), jnp.float32)))
            for k in _step_keys(key, STEPS)]


def _port_cond(c):
    return t_sampler.ChunkConditioning(**{k: torch.from_numpy(v) for k, v in c.items()})


def test_view_sharded_sampler_matches_jax_and_unsharded(tiny):
    """n_view=3 over T=3 (one frame a rank): the port's sharded loop
    against JAX's make_sharded_sampler on 3 virtual devices, and against the
    port's own unsharded loop, with JAX's churn noise replayed."""
    from stable_virtual_camera_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from stable_virtual_camera_tpu.parallel.sharding import make_sharded_sampler as jax_sharded
    from stable_virtual_camera_tpu.sampling.sampler import ChunkConditioning as JaxCond

    bundle, network_fn, conds, noises = tiny
    plan_j, plan = _plans()
    key = jax.random.PRNGKey(3)
    jmesh = jax_make_mesh(n_data=1, n_view=3, devices=jax.devices()[:3])
    with jmesh:
        ref = np.asarray(jax_sharded(network_fn, jmesh, T)(
            jnp.asarray(noises[0]), plan_j, JaxCond(**{k: jnp.asarray(v) for k, v in conds[0].items()}), key))
    eps = _eps(key)
    noise, cond = torch.from_numpy(noises[0]), _port_cond(conds[0])
    ticks = []
    out = make_sharded_sampler(bundle.network, cpu_mesh(1, 3), T)(
        noise, plan, cond, lambda i: eps[i], progress_cb=lambda i, n: ticks.append((i, n)))
    unsharded = t_sampler.euler_edm_sample(bundle.network, noise, plan, cond, T, step_noise=lambda i: eps[i])
    assert ticks == [(i + 1, STEPS) for i in range(STEPS)]  # from rank 0 only
    assert_close_to_scale(out.numpy(), ref)
    assert_close_to_scale(out.numpy(), unsharded.numpy())


def test_sharded_step_matches_the_unsharded_step(tiny):
    """One Euler step (make_sharded_step) over 3 ranks against
    euler_edm_step on one device, at the first step of the schedule."""
    from stable_virtual_camera_tpu_torch.parallel.sharding import make_sharded_step

    bundle, _, conds, noises = tiny
    _, plan = _plans()
    scalars = t_sampler.step_scalars(plan)[0]
    t_index = torch.tensor(int(plan.t_indices[0]))
    x = torch.from_numpy(noises[2]) * float(plan.init_scale)
    eps = torch.from_numpy(noises[0])
    cond = _port_cond(conds[2])
    with torch.inference_mode():
        ref = t_sampler.euler_edm_step(bundle.network, x, eps, scalars, cond, t_index, T)
    out = make_sharded_step(bundle.network, cpu_mesh(1, 3), T)(x, eps, scalars, cond, t_index)
    assert_close_to_scale(out.numpy(), ref.numpy())
    with pytest.raises(ValueError, match="must divide over view axis"):
        make_sharded_step(bundle.network, cpu_mesh(1, 2), T)


def test_view_sharded_sampler_stops_on_abort_on_every_rank(tiny):
    bundle, _, conds, noises = tiny
    _, plan = _plans()
    stop = threading.Event()

    def tick(i, n):
        stop.set()

    out = make_sharded_sampler(bundle.network, cpu_mesh(1, 3), T)(
        torch.from_numpy(noises[0]), plan, _port_cond(conds[0]), lambda i: torch.zeros(T, HW, HW, 4),
        progress_cb=tick, abort_event=stop)
    assert out is None


def test_data_parallel_sampler_matches_jax(tiny):
    """3 chunks, padded to 4 by repeating the last (as the engine pads its
    last group), over data=2 x view=3 ranks: against JAX's
    make_data_parallel_sampler over data=2 on the virtual devices."""
    from stable_virtual_camera_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from stable_virtual_camera_tpu.parallel.sharding import make_data_parallel_sampler as jax_dp
    from stable_virtual_camera_tpu.sampling.sampler import ChunkConditioning as JaxCond

    bundle, network_fn, conds, noises = tiny
    plan_j, plan = _plans()
    idx = [0, 1, 2, 2]
    keys = jax.random.split(jax.random.PRNGKey(7), 3)[jnp.asarray(idx)]
    jmesh = jax_make_mesh(n_data=2, n_view=1, devices=jax.devices()[:2])
    with jmesh:
        ref = np.asarray(jax_dp(network_fn, jmesh, T)(
            jnp.asarray(np.stack([noises[i] for i in idx])), plan_j,
            JaxCond(**{k: jnp.asarray(np.stack([conds[i][k] for i in idx])) for k in conds[0]}), keys))
    eps = [_eps(keys[j]) for j in range(4)]
    out = make_data_parallel_sampler(bundle.network, cpu_mesh(2, 3), T)(
        [torch.from_numpy(noises[i]) for i in idx], plan, [_port_cond(conds[i]) for i in idx],
        [lambda s, e=e: e[s] for e in eps])
    assert out.shape == (4, T, HW, HW, 4)
    assert_close_to_scale(out.numpy(), ref)
    with pytest.raises(ValueError, match="must divide data axis"):
        make_data_parallel_sampler(bundle.network, cpu_mesh(2, 3), T)(
            [torch.from_numpy(n) for n in noises], plan, [_port_cond(c) for c in conds], [None] * 3)


def test_w8a8_on_a_view_mesh_is_within_quant_noise_of_exact(tiny):
    """Dynamic W8A8 takes each site's abs-max over the rank's own rows, so
    the sharded quantized loop is another valid quantization than the
    unsharded one: it is held within quantization noise of the exact loop,
    JAX's bar (tests/test_parallel.py, relative L2 < 0.10, correlation >
    0.995)."""
    bundle, _, conds, noises = tiny
    _, plan = _plans()
    noise, cond = torch.from_numpy(noises[1]), _port_cond(conds[1])
    eps = [torch.from_numpy(np.random.default_rng(i).normal(size=(T, HW, HW, 4)).astype(np.float32))
           for i in range(STEPS)]
    exact = t_sampler.euler_edm_sample(bundle.network, noise, plan, cond, T, step_noise=lambda i: eps[i])
    with bundle.unet.quant_mode("w8a8"):
        out = make_sharded_sampler(bundle.network, cpu_mesh(1, 3), T)(noise, plan, cond, lambda i: eps[i])
    out, exact = out.numpy(), exact.numpy()
    assert np.isfinite(out).all()
    rel = np.linalg.norm(out - exact) / np.linalg.norm(exact)
    assert 0 < rel < 0.10, rel
    assert np.corrcoef(out.ravel(), exact.ravel())[0, 1] > 0.995
