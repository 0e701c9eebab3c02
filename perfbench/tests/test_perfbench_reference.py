"""The frozen reference against the port's plain path at tiny size (the bar
of tests/test_midtier_parity.py), its parameter table against the port's
at full width, the sampler's arithmetic, and the control's precision."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import sampling
from perfbench.reference.precision import Precision, attention

ATOL, RTOL = 2e-4, 1e-3


def tiny_config():
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec

    unet = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(SevaSpec.tiny()).items()}
    return {"unet": unet, "clip": dataclasses.asdict(ClipVisionSpec.tiny())}, SevaSpec.tiny(), ClipVisionSpec.tiny()


@pytest.fixture(scope="module")
def tiny():
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionTower
    from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
    from stable_virtual_camera_tpu_torch.models.vae import AutoEncoderKL

    cfg, spec, clip_spec = tiny_config()
    state = weights.make_all(cfg, 1234, torch.float32, "cpu")
    ref = weights.reference_models(cfg, "cpu")
    port = (SevaUNet(spec, "plain"), AutoEncoderKL(), ClipVisionTower(clip_spec))
    for r, p, key in zip(ref, port, ("unet", "vae", "clip")):
        r.load_state_dict(state[key], strict=True)
        p.load_state_dict(state[key], strict=True)
    return ref, port


def close(a, b):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=ATOL, rtol=RTOL)


def test_unet_matches_the_port(tiny):
    (ref, _, _), (port, _, _) = tiny
    g = torch.Generator().manual_seed(0)
    B, T, h, w = 6, 3, 8, 8
    x, ctx, dense = (torch.randn(s, generator=g) for s in ((B, h, w, 11), (B, 1, 64), (B, h, w, 6)))
    t = torch.full((B,), 700)
    with torch.no_grad():
        close(port(x, t, ctx, dense, T), ref.run(Precision(), x, t, ctx, dense, T))


def test_vae_and_clip_match_the_port(tiny):
    from stable_virtual_camera_tpu_torch.models.clip import preprocess

    (_, rvae, rclip), (_, pvae, pclip) = tiny
    g = torch.Generator().manual_seed(1)
    img = torch.rand((2, 32, 32, 3), generator=g) * 2 - 1
    z = torch.randn((2, 4, 4, 4), generator=g)
    P = Precision()
    with torch.no_grad():
        close(pvae.decode(z), rvae.decode(P, z))
        close(pvae.encode(img), rvae.encode(P, img))
        px = preprocess(img, 28)
        close(pclip(px), rclip.run(P, px))


def test_parameter_table_is_the_ports_at_full_width():
    from stable_virtual_camera_tpu_torch.config import SevaSpec
    from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec, ClipVisionTower
    from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
    from stable_virtual_camera_tpu_torch.models.vae import AutoEncoderKL

    cfg = harness.load_json(harness.HERE / "configs" / "seva-bf16.json")
    ref = weights.reference_models(cfg)
    with torch.device("meta"):
        port = (SevaUNet(SevaSpec(), "upstream"), AutoEncoderKL(), ClipVisionTower(ClipVisionSpec()))
    for r, p in zip(ref, port):
        assert [(n, tuple(t.shape)) for n, t in r.named_parameters()] == \
            [(n, tuple(t.shape)) for n, t in p.named_parameters()]
    assert 1.2e9 < sum(t.numel() for t in ref[0].parameters()) < 1.3e9


def test_weights_follow_the_seed_and_the_rule():
    cfg, _, _ = tiny_config()
    a = weights.make_all(cfg, 7, torch.bfloat16, "cpu")
    b = weights.make_all(cfg, 7, torch.bfloat16, "cpu")
    c = weights.make_all(cfg, 8, torch.bfloat16, "cpu")
    assert all(torch.equal(a["unet"][k], b["unet"][k]) for k in a["unet"])
    assert not torch.equal(a["unet"]["out_conv.weight"], c["unet"]["out_conv.weight"])
    w = a["unet"]["output_blocks_0_0.in_conv.weight"].float()
    std = (1.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.05 and w.abs().max().item() <= 2 * std / weights.TRUNC_STD + 1e-3
    assert torch.equal(a["unet"]["out_gn.gn.weight"], torch.ones_like(a["unet"]["out_gn.gn.weight"]))
    assert not a["unet"]["out_conv.bias"].any()


def test_sampler_arithmetic_matches_the_port():
    from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
    from stable_virtual_camera_tpu_torch.sampling.guidance import compute_scale_vector
    from stable_virtual_camera_tpu_torch.sampling.sampler import make_sampling_plan, step_scalars

    plan = make_sampling_plan(DDPMDiscretization(), 50)
    port = step_scalars(plan).numpy()
    rows, init = sampling.step_scalars(50, 5e-6, 0.012, 2.4)
    ours = np.array([[r[1], -r[2], r[3], r[4], r[5]] for r in rows], np.float32)
    np.testing.assert_array_equal(ours, port)
    np.testing.assert_array_equal([r[0] for r in rows], plan.t_indices)
    assert init == pytest.approx(plan.init_scale, rel=1e-12)
    mask = np.array([True, False, False, True, False, False, False])
    c2w = np.tile(np.eye(4), (7, 1, 1))
    c2w[:, 0, 3] = [0, 1, 2, 0, 4, 5, 6]  # frame 3 repeats frame 0's camera
    K = np.tile(np.eye(3), (7, 1, 1))
    close_frames = np.array([True, False, False, True, False, False, False])
    for guider, cfg in ((1, 4.0), (2, 2.0)):
        np.testing.assert_array_equal(sampling.cfg_scale(guider, cfg, 1.2, mask, close_frames),
                                      compute_scale_vector(guider, cfg, 7, c2w, K, mask, 1.2))


def test_blocked_attention_is_exact():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((2, 3, 50, 8), generator=g) for _ in range(3))
    full = torch.softmax(q @ k.transpose(-1, -2) * 8**-0.5, -1) @ v
    torch.testing.assert_close(attention(Precision(), q, k, v, budget_bytes=3 * 50 * 4 * 7), full)


def test_the_control_rounds_to_fp8():
    x = torch.linspace(-3, 3, 101)
    y = Precision("fp8").q(x)
    assert (y - x).abs().max() > 1e-3 and torch.equal(Precision().q(x), x)
    assert len(torch.unique(y)) < len(x)
