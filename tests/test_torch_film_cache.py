"""The per-chunk FiLM cache of the port's UNet and engine (models/unet.py
`SevaUNet.film`, `forward(..., film=)`; engine/runner.py
`ModelBundle.chunk_film`), against the JAX package's
`film_only` walk, on the CPU in fp32.

Mirrors the JAX package's tests/test_film_cache.py: the walk covers every
ResBlock, keyed as JAX's dict is, and its maps match JAX's to 2e-4; the
cached forward equals the inline one (JAX's bar, 1e-6), with the half-batch
cache broadcast over the CFG halves and with a whole-batch cache; sampling
with the cache (the engine's loop) equals sampling without it (1e-5); the
cache composes with W8A8 (1e-5); above FILM_CACHE_MAX_T frames a chunk
recomputes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.engine import runner
from stable_virtual_camera_tpu_torch.engine.runner import FILM_CACHE_MAX_T, ModelBundle
from stable_virtual_camera_tpu_torch.models.io import random_bundle
from stable_virtual_camera_tpu_torch.sampling import sampler as t_sampler
from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

T, HW = 3, 16


@pytest.fixture(scope="module")
def tiny():
    bundle = random_bundle(device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    plucker = torch.from_numpy(rng.normal(size=(T, HW, HW, 6)).astype(np.float32))
    inputs = (torch.from_numpy(rng.normal(size=(2 * T, HW, HW, 11)).astype(np.float32)),
              torch.full((2 * T,), 7), torch.from_numpy(rng.normal(size=(2 * T, 1, 64)).astype(np.float32)),
              torch.cat([plucker, plucker]))
    return bundle, inputs


def _unet(bundle, x, t, c, d, **kw):
    with torch.inference_mode():
        return bundle.unet(x, t, c, d, T, **kw).numpy()


def test_film_walk_covers_every_resblock_and_matches_jax(tiny):
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet
    from stable_virtual_camera_tpu_torch.models.unet import ResBlock
    from stable_virtual_camera_tpu_torch.models.weights import to_flax_tree

    bundle, (x, t, c, d) = tiny
    unet, z = JaxUNet(JaxSpec.tiny()), jnp.zeros
    tree = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(0), z((T, 8, 8, 11)), z((T,), jnp.int32),
                                            z((T, 1, 64)), z((T, 8, 8, 6)), num_frames=T))["params"]
    params = to_flax_tree(bundle.unet, tree)
    ref = jax.jit(lambda p, dense: unet.apply({"params": p}, None, None, None, dense, num_frames=T,
                                              film_only=True))(params, jnp.asarray(d[:T].numpy()))
    with torch.inference_mode():
        films = bundle.unet.film(d[:T])
    res_names = {n for n, m in bundle.unet.named_children() if isinstance(m, ResBlock)}
    assert set(films) == set(ref) == res_names and res_names
    for name, f in films.items():
        assert f.shape[0] == T and f.shape[-1] % 2 == 0, name
        r = np.asarray(ref[name])
        assert f.shape == r.shape, name
        assert np.abs(f.numpy() - r).max() <= 2e-4 * max(1.0, np.abs(r).max()), name


@pytest.mark.parametrize("batch", ["half", "full"])
def test_film_cached_forward_matches_inline(tiny, batch):
    """The (T, ...) cache broadcast over the CFG-doubled batch, and a
    (2T, ...) cache with no sharing, both give the inline forward."""
    bundle, (x, t, c, d) = tiny
    ref = _unet(bundle, x, t, c, d)
    with torch.inference_mode():
        films = bundle.unet.film(d[:T] if batch == "half" else d)
    np.testing.assert_allclose(_unet(bundle, x, t, c, d, film=films), ref, atol=1e-6, rtol=1e-6)


def test_film_composes_with_w8a8(tiny):
    bundle, (x, t, c, d) = tiny
    with bundle.unet.quant_mode("w8a8"):
        ref = _unet(bundle, x, t, c, d)
        with torch.inference_mode():
            films = bundle.unet.film(d[:T])
        out = _unet(bundle, x, t, c, d, film=films)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def _cond(rng):
    plucker = rng.normal(size=(T, HW, HW, 6)).astype(np.float32)
    emb = rng.normal(size=(T, 1, 64)).astype(np.float32)
    mask = np.zeros((T, HW, HW, 1), np.float32)
    mask[:1] = 1.0
    replace = rng.normal(size=(T, HW, HW, 5)).astype(np.float32) * mask

    def cat(a, b):
        return torch.from_numpy(np.concatenate([a, b]))

    return t_sampler.ChunkConditioning(
        crossattn=cat(0 * emb, emb),
        concat=cat(np.concatenate([0 * mask, plucker], -1), np.concatenate([mask, plucker], -1)),
        dense=cat(plucker, plucker),  # the ChunkConditioning contract: the same halves
        replace=cat(0 * replace, replace),
        scale=torch.full((T,), 2.0),
    )


def test_sampling_with_the_cache_equals_without(tiny, monkeypatch):
    """`sample_latents` (the engine's loop, which samples every chunk of at
    most FILM_CACHE_MAX_T frames on its cache) against the same loop on the
    bundle's network with no cache: the same latents; the cache is computed
    once a chunk (not once a step) and every step's forward is given it;
    with the chunk above FILM_CACHE_MAX_T frames (the limit lowered here)
    none is computed."""
    unet = tiny[0].unet
    rng = np.random.default_rng(1)
    cond = _cond(rng)
    plan = t_sampler.make_sampling_plan(DDPMDiscretization(), 3)
    noise = torch.from_numpy(rng.normal(size=(T, HW, HW, 4)).astype(np.float32))
    eps = [torch.from_numpy(rng.normal(size=(T, HW, HW, 4)).astype(np.float32)) for _ in range(3)]
    walks, films_seen = [], []
    film, forward = unet.film, unet.forward

    def count_walk(*a, **kw):
        walks.append(1)
        return film(*a, **kw)

    def record(*a, **kw):
        films_seen.append(kw.get("film"))
        return forward(*a, **kw)

    monkeypatch.setattr(unet, "film", count_walk)
    monkeypatch.setattr(unet, "forward", record)
    bundle = ModelBundle(spec=tiny[0].spec, unet=unet, vae=None, clip=None)

    def sample(cached):
        walks.clear(), films_seen.clear()
        with torch.inference_mode():
            if cached:
                return runner.sample_latents(bundle, noise, plan, cond, lambda i: eps[i]).numpy()
            return t_sampler.euler_edm_sample(bundle.network, noise, plan, cond, T,
                                              step_noise=lambda i: eps[i]).numpy()

    off = sample(False)
    assert not walks and films_seen == [None] * 3
    on = sample(True)
    assert len(walks) == 1 and len(films_seen) == 3 and all(f is films_seen[0] for f in films_seen)
    assert films_seen[0] is not None and next(iter(films_seen[0].values())).shape[0] == T
    assert np.isfinite(on).all()
    np.testing.assert_allclose(on, off, atol=1e-5, rtol=1e-5)
    monkeypatch.setattr(runner, "FILM_CACHE_MAX_T", T - 1)
    sample(True)
    assert not walks and films_seen == [None] * 3
    assert FILM_CACHE_MAX_T == 48
