"""The port's sigma schedule and Euler-EDM loop against the JAX package's, on
the CPU in fp32.

`jax_noise` replays the JAX engine's draws for the port's `noise_fn`: a
chunk's key is fold_in(fold_in(PRNGKey(seed), pass), chunk), split into the
initial-noise key and the loop key, and every step splits the loop key once
more for its churn noise (stable_virtual_camera_tpu/sampling/sampler.py
`sample_from_key` and `euler_edm_sample`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.sampling import sampler as t_sampler
from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
from test_torch_weights import port_and_flax_params


def _step_keys(key, n):
    keys = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return keys


def jax_noise(seed, pass_id, chunk_id, step, shape, device):
    """The JAX engine's initial (step None) or churn (step i) noise."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), pass_id), chunk_id)
    key_init, key_loop = jax.random.split(key)
    key = key_init if step is None else _step_keys(key_loop, step + 1)[-1]
    return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), jnp.float32))).to(device)


@pytest.mark.parametrize("num_steps", [2, 4, 50])
def test_sampling_plan_matches_jax(num_steps):
    """The same schedule on both sides. Its churn term is not zero: the
    1e-6 added to every sigma_hat gives noise_coeff = sqrt(2e-6 sigma + 1e-12),
    so the churn noise has to be replayed too."""
    from stable_virtual_camera_tpu.sampling.discretization import DDPMDiscretization as JaxDisc
    from stable_virtual_camera_tpu.sampling.sampler import make_sampling_plan

    ref = make_sampling_plan(JaxDisc(), num_steps)
    out = t_sampler.make_sampling_plan(DDPMDiscretization(), num_steps)
    for field in ("sigma_hat_raw", "sigma_hat_quant", "t_indices", "sigma_next", "noise_coeff"):
        np.testing.assert_array_equal(getattr(out, field), getattr(ref, field), err_msg=field)
    assert out.init_scale == ref.init_scale
    sigma = ref.sigma_hat_raw.astype(np.float64) - 1e-6
    np.testing.assert_allclose(out.noise_coeff, np.sqrt(2e-6 * sigma + 1e-12), rtol=1e-3)
    assert 0 < out.noise_coeff.max() < 0.05


def _conditioning(rng, T, hw, ctx):
    """A random CFG-doubled chunk conditioning with frame 0 as the input."""
    mask = np.zeros((T,), bool)
    mask[0] = True
    lat = rng.normal(size=(T, hw, hw, 4)).astype(np.float32)
    replace_c = np.concatenate([lat, np.ones((T, hw, hw, 1), np.float32)], -1) * mask[:, None, None, None]
    plucker = rng.normal(size=(T, hw, hw, 6)).astype(np.float32)
    mask_map = np.broadcast_to(mask[:, None, None, None], (T, hw, hw, 1)).astype(np.float32)
    emb = rng.normal(size=(T, 1, ctx)).astype(np.float32)
    return dict(
        crossattn=np.concatenate([np.zeros_like(emb), emb]),
        concat=np.concatenate([np.concatenate([0 * mask_map, plucker], -1),
                               np.concatenate([mask_map, plucker], -1)]),
        dense=np.concatenate([plucker, plucker]),
        replace=np.concatenate([np.zeros_like(replace_c), replace_c]),
        scale=np.array([1.2, 2.0, 2.5], np.float32),
    )


def test_euler_edm_sample_matches_jax():
    """Three steps of the tiny UNet with the same weights, conditioning,
    initial noise and churn noise: the JAX engine's scan program against the
    port's Python loop."""
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet
    from stable_virtual_camera_tpu.sampling.discretization import DDPMDiscretization as JaxDisc
    from stable_virtual_camera_tpu.sampling import sampler as j_sampler

    T, hw, steps = 3, 8, 3
    bundle, trees = port_and_flax_params(seed=5)
    rng = np.random.default_rng(11)
    c = _conditioning(rng, T, hw, SevaSpec.tiny().context_dim)
    noise = rng.normal(size=(T, hw, hw, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    denoiser = j_sampler.UNetDenoiser(JaxUNet(JaxSevaSpec.tiny()), trees["unet"])
    plan_j = j_sampler.make_sampling_plan(JaxDisc(), steps)
    ref = denoiser.make_scan_fn(T)(
        trees["unet"], jnp.asarray(noise), j_sampler.plan_as_host(plan_j),
        j_sampler.ChunkConditioning(**{k: jnp.asarray(v) for k, v in c.items()}), key,
    )

    eps = [torch.from_numpy(np.array(jax.random.normal(k, noise.shape, jnp.float32)))
           for k in _step_keys(key, steps)]
    ticks = []
    out = t_sampler.euler_edm_sample(
        bundle.network, torch.from_numpy(noise), t_sampler.make_sampling_plan(DDPMDiscretization(), steps),
        t_sampler.ChunkConditioning(**{k: torch.from_numpy(v) for k, v in c.items()}), T,
        step_noise=lambda i: eps[i], progress_cb=lambda i, n: ticks.append((i, n)),
    )
    assert ticks == [(1, 3), (2, 3), (3, 3)]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_euler_edm_sample_stops_on_abort():
    import threading

    plan = t_sampler.make_sampling_plan(DDPMDiscretization(), 4)
    stop = threading.Event()
    calls = []

    def net(x, *a):
        calls.append(1)
        stop.set()
        return torch.zeros_like(x)

    cond = t_sampler.ChunkConditioning(
        crossattn=None, concat=None, dense=None,
        replace=torch.zeros((2, 2, 2, 5)), scale=torch.ones((1,)),
    )
    out = t_sampler.euler_edm_sample(net, torch.zeros((1, 2, 2, 4)), plan, cond, 1,
                                     step_noise=lambda i: torch.zeros((1, 2, 2, 4)), abort_event=stop)
    assert out is None and len(calls) == 1


def _euler_edm_step_before(network_fn, x, plan, i, cond, eps, num_frames):
    """The step as it was before it took its scalars as tensors: Python
    floats from float32 numpy arithmetic, and the timestep as `torch.full`."""
    f32 = np.float32
    s_raw, s_quant = f32(plan.sigma_hat_raw[i]), f32(plan.sigma_hat_quant[i])
    C = x.shape[-1]
    rep_lat, rep_mask = cond.replace[..., :C], cond.replace[..., C:]
    x = x + eps * float(plan.noise_coeff[i])
    xin = torch.cat([x, x], dim=0)
    xin = xin * (1 - rep_mask) + rep_lat * rep_mask
    c_in = float(f32(1.0) / np.sqrt(s_quant * s_quant + f32(1.0)))
    t_vec = torch.full((2 * num_frames,), int(plan.t_indices[i]), dtype=torch.int64, device=x.device)
    out = network_fn(xin * c_in, cond.concat, t_vec, cond.crossattn, cond.dense, num_frames)
    denoised = out * float(-s_quant) + xin
    uncond, condit = denoised.chunk(2, dim=0)
    denoised = uncond + cond.scale[:, None, None, None] * (condit - uncond)
    d = (x - denoised) / float(s_raw)
    return x + float(f32(plan.sigma_next[i]) - s_raw) * d


def test_tensor_scalar_step_is_bit_equal_to_the_float_step():
    """The loop over `euler_edm_step` (scalars as fp32 host tensors, the
    timestep as a 0-d tensor) gives the bits of the loop over the step with
    Python floats, on the tiny UNet at 4 steps."""
    from stable_virtual_camera_tpu_torch.models.io import random_bundle

    T, hw, steps = 3, 8, 4
    bundle = random_bundle(device="cpu", generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(12)
    c = t_sampler.ChunkConditioning(**{k: torch.from_numpy(v) for k, v in _conditioning(
        rng, T, hw, SevaSpec.tiny().context_dim).items()})
    noise = torch.from_numpy(rng.normal(size=(T, hw, hw, 4)).astype(np.float32))
    eps = [torch.from_numpy(rng.normal(size=(T, hw, hw, 4)).astype(np.float32)) for _ in range(steps)]
    plan = t_sampler.make_sampling_plan(DDPMDiscretization(), steps)
    with torch.inference_mode():
        x = noise * float(np.float32(plan.init_scale))
        for i in range(steps):
            x = _euler_edm_step_before(bundle.network, x, plan, i, c, eps[i], T)
    out = t_sampler.euler_edm_sample(bundle.network, noise, plan, c, T, step_noise=lambda i: eps[i])
    assert torch.equal(out, x)
