"""The port's calibrated static W8A8 (models/common.QuantSite, the quant
collection bridge of models/weights.py, sampling/sampler.euler_edm_capture,
engine/runner.ensure_quant_calibrated, `--quant` in apps/cli.py) against the
JAX package's, on the CPU in fp32.

The JAX side takes its mode from SVC_QUANT through monkeypatch and, for the
temporal projections' branch, SVC_TIME_PALLAS=1 in Pallas interpret mode, so
that both sides quantize the same sites (tests/test_torch_quant.py).
"""

import os.path as osp
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.apps import cli
from stable_virtual_camera_tpu_torch.engine import runner as t_runner
from stable_virtual_camera_tpu_torch.engine.value_dict import build_chunk_values
from stable_virtual_camera_tpu_torch.models.common import QuantSite
from stable_virtual_camera_tpu_torch.models.io import random_bundle
from stable_virtual_camera_tpu_torch.models.weights import load_flax_quant, quant_to_flax_tree
from stable_virtual_camera_tpu_torch.sampling import sampler as t_sampler
from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
from test_torch_quant import _jax_unet, _rel, block_rels, check_blocks, one_torch_thread  # noqa: F401
from test_torch_sampler import _conditioning, _step_keys
from test_torch_unet import _unet_inputs
from test_torch_weights import port_and_flax_params

T, HW = 3, 8
GOLDEN = osp.join(osp.dirname(__file__), "..", "assets", "golden_scene")


def test_quant_site_semantics():
    """Serving before calibration raises; a calibration step quantizes the
    weight per output channel and keeps the running abs-max of its inputs;
    the buffers stay int8/fp32 through a cast and stay out of the state dict."""
    w = torch.tensor([[0.5, -1.0, 0.25], [0.0, 0.0, 0.0]])
    site = QuantSite(w.shape)
    with pytest.raises(RuntimeError, match="before calibration"):
        site.frozen()
    site.record(w, torch.tensor([[1.0, -3.0]]))
    site.record(w, torch.tensor([[2.0, 0.5]]))
    wq, ws, ax = site.frozen()
    assert wq.tolist() == [[64, -127, 32], [0, 0, 0]]
    assert torch.equal(ws, torch.tensor([1.0 / 127, 1e-8 / 127]))
    assert ax.item() == 3.0
    site.to(torch.bfloat16)
    assert (site.wq.dtype, site.ws.dtype, site.ax.dtype) == (torch.int8, torch.float32, torch.float32)
    assert site.state_dict() == {}
    conv = QuantSite((4, 3, 3, 3))
    assert conv.wq.is_contiguous(memory_format=torch.channels_last) and conv.ws.shape == (4,)


def _capture_inputs(bundle, steps=4):
    """Network inputs of an exact tiny trajectory (the port's capture)."""
    c = _conditioning(np.random.default_rng(21), T, HW, bundle.spec.context_dim)
    cond = t_sampler.ChunkConditioning(**{k: torch.from_numpy(v) for k, v in c.items()})
    g = torch.Generator().manual_seed(1)
    noise = torch.randn((T, HW, HW, 4), generator=g)
    plan = t_sampler.make_sampling_plan(DDPMDiscretization(), steps)
    net_xs, t_vecs = t_sampler.euler_edm_capture(
        bundle.network, noise, plan, cond, T, step_noise=lambda i: torch.randn(noise.shape, generator=g))
    return c, cond, net_xs, t_vecs


@pytest.fixture(scope="module")
def calibrated():
    """The tiny port UNet calibrated on captured inputs by the port, and
    JAX's calibration of the same weights on the same inputs (its
    calibration step: one mutable-"quant" apply per point, merged by max)."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet

    bundle, trees = port_and_flax_params(seed=12)
    c, cond, net_xs, t_vecs = _capture_inputs(bundle)
    points = t_runner.calibration_points(net_xs.shape[0])
    unet = JaxUNet(JaxSevaSpec.tiny(), use_pallas=True)
    mp = pytest.MonkeyPatch()
    mp.setenv("SVC_TIME_PALLAS", "1")
    mp.setenv("SVC_QUANT", "w8a8-calib")
    acc = None
    try:
        for k in points:
            ni = jnp.concatenate([jnp.asarray(net_xs[k].numpy()), jnp.asarray(c["concat"])], -1)
            with pltpu.force_tpu_interpret_mode():
                q = unet.apply({"params": trees["unet"]}, ni, jnp.asarray(t_vecs[k].numpy()),
                               jnp.asarray(c["crossattn"]), jnp.asarray(c["dense"]), num_frames=T,
                               mutable=["quant"])[1]["quant"]
            acc = q if acc is None else jax.tree_util.tree_map(
                lambda a, b: a if a.dtype == jnp.int8 else jnp.maximum(a, b), acc, q)
    finally:
        mp.undo()
    t_runner.calibrate_unet(bundle.unet, net_xs, t_vecs, cond, T, points)
    return bundle, trees, jax.tree_util.tree_map(np.asarray, acc), points


def test_calibration_matches_jax(calibrated):
    """The same captured inputs calibrate the same sites: int8 weights and
    their scales bit-equal, activation abs-maxes within rtol 1e-5."""
    bundle, _, ref, points = calibrated
    assert list(points) == [0, 1, 2, 3]
    assert bundle.unet.quant == "w8a8-static" and bundle.unet.quant_calibrated
    got = quant_to_flax_tree(bundle.unet)
    flat_ref = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_got.keys() == flat_ref.keys()
    for key, r in flat_ref.items():
        g = flat_got[key]
        assert g.shape == r.shape and g.dtype == r.dtype, key
        if key.endswith("['ax']"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(g, r, err_msg=key)


def test_jax_collection_serves_like_jax(monkeypatch, calibrated):
    """JAX's calibrated collection, carried into a fresh port UNet through
    models/weights.load_flax_quant, serves like JAX: every top-level block's
    static output agrees with JAX's as in the dynamic test (exact where no
    int8 decision flips, within half the block's static-vs-exact gap where
    some do); the whole forward, where those flips cascade through the
    decoder, is closer to JAX's static output than JAX's is to the exact
    one. The bridge round-trips and is strict."""
    bundle, trees, ref_quant, _ = calibrated
    port = random_bundle(device="cpu", generator=torch.Generator().manual_seed(99)).unet
    port.load_state_dict(bundle.unet.state_dict())
    load_flax_quant(port, ref_quant)
    check_blocks(block_rels(monkeypatch, port, trees, "w8a8-static", ref_quant))
    port.set_quant("w8a8-static")
    variables = {"params": trees["unet"], "quant": ref_quant}
    inputs = _unet_inputs(np.random.default_rng(13), 2 * T)
    ref = _jax_unet(monkeypatch, trees, inputs, modes=("0", "w8a8-static"), variables=variables)
    with torch.inference_mode():
        got = port(*map(torch.from_numpy, inputs), T).numpy()
    gap = _rel(ref["w8a8-static"], ref["0"])
    assert np.isfinite(got).all()
    assert _rel(got, ref["w8a8-static"]) < gap, (_rel(got, ref["w8a8-static"]), gap)
    back = quant_to_flax_tree(port)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref_quant)
    bad = dict(ref_quant)
    bad["nowhere_qsite"] = bad.pop("input_blocks_1_0")["in_conv_qsite"]
    with pytest.raises(KeyError):
        load_flax_quant(port, bad)


def test_euler_edm_capture_matches_jax():
    """The capture's stacked network inputs against JAX's euler_edm_capture,
    replaying its churn draws."""
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet
    from stable_virtual_camera_tpu.sampling import sampler as j_sampler
    from stable_virtual_camera_tpu.sampling.discretization import DDPMDiscretization as JaxDisc

    steps = 3
    bundle, trees = port_and_flax_params(seed=5)
    rng = np.random.default_rng(14)
    c = _conditioning(rng, T, HW, bundle.spec.context_dim)
    noise = rng.normal(size=(T, HW, HW, 4)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    den = j_sampler.UNetDenoiser(JaxUNet(JaxSevaSpec.tiny()), trees["unet"])
    ref_x, ref_t = j_sampler.euler_edm_capture(
        partial(den.network_with_params, trees["unet"]), jnp.asarray(noise),
        j_sampler.plan_as_host(j_sampler.make_sampling_plan(JaxDisc(), steps)),
        j_sampler.ChunkConditioning(**{k: jnp.asarray(v) for k, v in c.items()}), key, num_frames=T)
    eps = [torch.from_numpy(np.array(jax.random.normal(k, noise.shape, jnp.float32)))
           for k in _step_keys(key, steps)]
    got_x, got_t = t_sampler.euler_edm_capture(
        bundle.network, torch.from_numpy(noise), t_sampler.make_sampling_plan(DDPMDiscretization(), steps),
        t_sampler.ChunkConditioning(**{k: torch.from_numpy(v) for k, v in c.items()}), T,
        step_noise=lambda i: eps[i])
    assert got_x.shape == (steps, 2 * T, HW, HW, 4) and got_t.shape == (steps, 2 * T)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), atol=2e-4, rtol=2e-4)


def _chunk_values(rng, T_, H=64):
    imgs = rng.uniform(-1, 1, size=(T_, H, H, 3)).astype(np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32)[None, :3], (T_, 1, 1))
    c2ws[:, :, 3] = rng.normal(size=(T_, 3)).astype(np.float32) * 0.3
    Ks = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)[None], (T_, 1, 1))
    return build_chunk_values(imgs, imgs.copy(), [0], c2ws, Ks, [0], all_c2ws=c2ws,
                              latent_hw=(H // 8, H // 8))


def test_calibrate_then_serve_through_sample_chunk():
    """Under w8a8-static the bundle's first sample_chunk calibrates on its own
    conditioning, once; the served chunk repeats bit for bit and tracks the
    exact result within JAX's own bars for this flow (tests/
    test_quant_static.py: rel < 0.4, corr > 0.95 over a 5-step trajectory)."""
    bundle = random_bundle(device="cpu", generator=torch.Generator().manual_seed(3))
    values = _chunk_values(np.random.default_rng(15), T)
    latents = []
    decode = bundle.vae.decode

    def recording(z, *a, **k):
        latents.append(z.clone())
        return decode(z, *a, **k)

    bundle.vae.decode = recording
    kw = dict(num_steps=5, cfg=2.0, guider_type=1, cfg_min=1.2, noise_fn=partial(t_sampler.torch_noise, 7))
    ref = t_runner.sample_chunk(bundle, values, **kw)
    bundle.unet.set_quant("w8a8-static")
    assert not bundle.unet.quant_calibrated
    got = t_runner.sample_chunk(bundle, values, **kw)
    assert bundle.unet.quant_calibrated and bundle.unet.quant == "w8a8-static"
    calibrated = {k: v.clone() for k, v in bundle.unet.named_buffers()}
    again = t_runner.sample_chunk(bundle, values, **kw)
    cond, shape = t_runner.build_chunk_conditioning(bundle, values, cfg=2.0, guider_type=1, cfg_min=1.2)
    assert not t_runner.ensure_quant_calibrated(bundle, shape, bundle.plan(5), cond)
    assert all(torch.equal(v, calibrated[k]) for k, v in bundle.unet.named_buffers())
    np.testing.assert_array_equal(again, got)
    assert ref.shape == got.shape and np.isfinite(got).all()
    lat_ref, lat_q = latents[0].numpy(), latents[1].numpy()
    rel = _rel(lat_q, lat_ref)
    corr = np.corrcoef(lat_q.ravel(), lat_ref.ravel())[0, 1]
    assert 0 < rel < 0.4 and corr > 0.95, (rel, corr)


@pytest.mark.parametrize("quant", ["w8a8-static", "w8a8", 0])
def test_cli_quant_renders_a_tiny_scene(tmp_path, monkeypatch, quant):
    """`cli.main(..., quant=...)` on the golden scene with the tiny bundle:
    the frames are written, and under w8a8-static the render calibrated."""
    built = []
    build = cli._build_bundle

    def keep(*a, **k):
        out = build(*a, **k)
        built.append(out[0])
        return out

    monkeypatch.setattr(cli, "_build_bundle", keep)
    (out_dir,) = cli.main(GOLDEN, task="img2img", random_model=True, device="cpu", quant=quant,
                          num_steps=2, work_dir=str(tmp_path), use_traj_prior=False)
    assert osp.exists(osp.join(out_dir, "transforms.json"))
    assert osp.exists(osp.join(out_dir, "samples-rgb.mp4"))
    unet = built[0].unet
    assert unet.quant == str(quant)
    assert unet.quant_calibrated == (quant == "w8a8-static")


@pytest.mark.parametrize("quant", ["int4", "w8a8-calib", "1"])
def test_cli_refuses_other_quant_modes(quant):
    with pytest.raises(SystemExit, match="--quant must be 'w8a8', 'w8a8-static' or '0'"):
        cli.main("nowhere", device="cpu", random_model=True, quant=quant)
    with pytest.raises(ValueError, match="--quant must be"):
        random_bundle(device="cpu", quant=quant)
