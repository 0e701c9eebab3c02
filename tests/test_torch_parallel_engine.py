"""The port's engine, CLI and HTTP service on a ("data", "view") mesh, on the
CPU in fp32 with the tiny bundle; each held against the same port run on
one device (the mesh's samplers are held against the JAX package's in
tests/test_torch_parallel.py).

Counterparts of the JAX package's tests/test_parallel.py engine tests: a
render with every chunk view-sharded over 3 ranks (T=3); a second pass
whose 3 chunks fan out over data=2 (a full group and a padded one), the
same with the frames sharded over view=3, and batched two at a time with
`chunk_batch=2` on one device; the CLI's --mesh_view / --mesh_data /
--platform flags, --mesh_model (tensor parallelism over a "model" axis)
and the refusal of --platform tpu; a served job on a mesh. The mesh paths sum in other orders than the serial
one (the ring's merge, batched products), so frames agree within one uint8
step, JAX's bar for its data-parallel engine.

Every bundle here carries `LightVae` in place of the SD VAE: these tests
hold the sampling's sharding and grouping, and the full VAE's convolutions
on one CPU thread are most of a tiny render's time.
"""

import glob
import os.path as osp

import cv2
import numpy as np
import pytest
import torch
from torch import nn

from stable_virtual_camera_tpu_torch.apps import cli
from stable_virtual_camera_tpu_torch.config import EngineOptions, VersionConfig
from stable_virtual_camera_tpu_torch.engine import runner
from stable_virtual_camera_tpu_torch.models import io as mio
from stable_virtual_camera_tpu_torch.models.io import random_bundle
from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh
from test_torch_engine import _assert_frames_close
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

CPU = torch.device("cpu")
GOLDEN = osp.join(osp.dirname(__file__), "..", "assets", "golden_scene")


class LightVae(nn.Module):
    """The VAE's interface at a fraction of its cost: 8x8 average pooling
    and a linear map to 4 latent channels; decoding a linear map back to 3
    channels, tanh (scaled to the random tiny UNet's latents, which reach
    hundreds) and 8x nearest upsampling; uint8 as AutoEncoderKL quantizes."""

    def __init__(self):
        super().__init__()
        self.enc = nn.Linear(3, 4)
        self.dec = nn.Linear(4, 3)

    def encode(self, x):
        N, H, W, C = x.shape
        return self.enc(x.reshape(N, H // 8, 8, W // 8, 8, C).mean((2, 4))).float()

    def decode(self, z):
        y = torch.tanh(self.dec(z.float()) / 64.0)
        return y.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)

    def decode_uint8(self, z):
        v = ((self.decode(z) + 1.0) / 2.0) * 255.0
        return torch.floor(torch.clamp(v, 0.0, 255.0)).to(torch.uint8)


@pytest.fixture(scope="module", autouse=True)
def light_vae():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mio, "AutoEncoderKL", LightVae)
        yield


def cpu_mesh(n_data, n_view):
    return make_mesh(n_data, n_view, devices=[CPU] * (n_data * n_view))


def _bundle(mesh=None):
    return random_bundle(device="cpu", generator=torch.Generator().manual_seed(0), mesh=mesh)


def _cameras(rng, n):
    from conftest import random_c2ws

    c2ws = random_c2ws(rng, n).astype(np.float32)[:, :3]
    K = np.array([[1.2, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32)
    return c2ws, [K] * n


@pytest.fixture()
def calls(monkeypatch):
    """Counts of the engine's sharded and grouped sampling calls."""
    counts = {"sharded": 0, "many": 0}
    sharded, many = runner.make_sharded_sampler, runner.sample_many

    def count_sharded(*a, **kw):
        counts["sharded"] += 1
        return sharded(*a, **kw)

    def count_many(*a, **kw):
        counts["many"] += 1
        return many(*a, **kw)

    monkeypatch.setattr(runner, "make_sharded_sampler", count_sharded)
    monkeypatch.setattr(runner, "sample_many", count_many)
    return counts


def test_engine_view_mesh_matches_unsharded(calls):
    """img2img on 4 frames (2 inputs) at T=3: every chunk view-sharded over
    3 ranks, frames within one step of the unsharded engine's."""
    rng = np.random.default_rng(0)
    imgs = list(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    c2ws, Ks = _cameras(rng, 4)
    options = EngineOptions().update(dict(
        num_steps=2, cfg=2.0, guider_types=1, chunk_strategy="nearest-gt", sampler_verbose=False,
        encoding_t=0, decoding_t=0,
    ))

    def run(mesh):
        bundle = _bundle(mesh)
        engine = runner.SceneEngine(bundle, VersionConfig(H=64, W=64, T=3), options)
        (frames,) = engine.run_one_scene("img2img", {"img": imgs, "input_indices": [0, 1]},
                                         {"c2w": c2ws, "K": Ks, "input_indices": list(range(4))},
                                         seed=3)
        return frames, bundle

    base, _ = run(None)
    assert calls["sharded"] == 0
    sharded, bundle = run(cpu_mesh(1, 3))
    assert calls["sharded"] > 0 and bundle._warned_unsharded == set()
    _assert_frames_close(sharded, base)


def test_a_rank_on_another_device_gets_a_replica_kept_in_step():
    """Ranks on the bundle's device share its UNet; another device gets a
    copy, made again once the bundle's W8A8 mode changes (the meta device
    stands in for a second card)."""
    bundle = _bundle()
    assert bundle.unet_on(CPU) is bundle.unet
    meta = torch.device("meta")
    replica = bundle.unet_on(meta)
    assert replica is not bundle.unet and next(replica.parameters()).device == meta
    assert bundle.unet_on(meta) is replica
    with bundle.unet.quant_mode("w8a8"):
        refreshed = bundle.unet_on(meta)
        assert refreshed is not replica and refreshed.quant == "w8a8"
    assert bundle.unet_on(meta).quant == "0"


def _two_pass(bundle, chunk_batch=0):
    """img2trajvid with 1 input, 3 targets and 2 anchors between them at
    T=3 (JAX's test_engine_data_parallel_second_pass scene, cut to size): a
    second pass of 3 chunks, one target each."""
    rng = np.random.default_rng(11)
    imgs = list(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    c2ws, Ks = _cameras(rng, 4)
    options = EngineOptions().update(dict(
        num_steps=2, cfg=[2.0, 2.0], cfg_min=1.2, guider_types=[1, 2], chunk_strategy="interp",
        chunk_strategy_first_pass="gt", sampler_verbose=False, encoding_t=0, decoding_t=0,
        save_first_pass=False, chunk_batch=chunk_batch,
    ))
    engine = runner.SceneEngine(bundle, VersionConfig(H=64, W=64, T=3), options)
    (frames,) = engine.run_one_scene(
        "img2trajvid",
        {"img": imgs, "input_indices": [0], "prior_indices": [1.5, 2.5]},
        {"c2w": c2ws, "K": Ks, "input_indices": list(range(4))},
        use_traj_prior=True, traj_prior_c2ws=c2ws[[2, 3]], seed=2,
    )
    assert frames.shape == (3, 64, 64, 3)
    return frames


@pytest.fixture(scope="module")
def serial_two_pass():
    return _two_pass(_bundle())


@pytest.mark.parametrize("mesh_shape,chunk_batch,groups", [
    ((2, 1), 0, 2),  # 3 chunks over data=2: 2, then 1 padded to 2
    ((2, 3), 0, 2),  # the same, each chunk view-sharded over 3 ranks
    (None, 2, 2),  # one device, two chunks a batch, the last padded
])
def test_second_pass_groups_match_serial(serial_two_pass, calls, mesh_shape, chunk_batch, groups):
    grouped = _two_pass(_bundle(cpu_mesh(*mesh_shape) if mesh_shape else None), chunk_batch)
    assert calls["many"] == groups
    _assert_frames_close(grouped, serial_two_pass)


def _pngs(out_dir):
    paths = sorted(glob.glob(osp.join(out_dir, "samples-rgb", "*.png")))
    assert paths
    return np.stack([cv2.imread(p) for p in paths])


def test_cli_mesh_flags_render_the_single_device_frames(tmp_path, calls):
    """`cli.main` with --platform cpu --mesh_view 3 --mesh_data 2 on a
    two-pass orbit from one image (a second pass of 3 chunks, so the last
    group is padded): the frames of the single-device CLI."""
    scene = tmp_path / "scenes" / "scene.png"
    scene.parent.mkdir()
    cv2.imwrite(str(scene), np.random.default_rng(4).integers(0, 256, (64, 64, 3), dtype=np.uint8))
    opts = dict(task="img2trajvid_s-prob", use_traj_prior=True, random_model=True, num_steps=2,
                traj_prior="orbit", num_targets=3, guider_types=[1, 2], cfg=[2.0, 2.0],
                sampler_verbose=False)
    (single,) = cli.main(str(scene.parent), device="cpu", work_dir=str(tmp_path / "one"), **opts)
    assert calls["many"] == 0
    (meshed,) = cli.main(str(scene.parent), platform="cpu", mesh_view=3, mesh_data=2,
                         work_dir=str(tmp_path / "mesh"), **opts)
    assert calls["sharded"] > 0 and calls["many"] == 2
    _assert_frames_close(_pngs(meshed), _pngs(single))
    # --mesh_model: every chunk on weight shards over 2 model ranks
    (tp,) = cli.main(str(scene.parent), device="cpu", mesh_model=2, work_dir=str(tmp_path / "tp"),
                     **opts)
    _assert_frames_close(_pngs(tp), _pngs(single))
    with pytest.raises(ValueError, match="JAX package"):
        cli.main(str(scene.parent), platform="tpu", **opts)


def test_server_job_on_a_mesh_gives_the_cli_frames(tmp_path):
    """A job of the render service whose bundle is on a (data=2, view=3)
    mesh (apps/server.main's --mesh_view / --mesh_data) writes the PNGs of
    the CLI run with the same flags, byte for byte."""
    import threading

    from test_torch_server import OPTS, _Job, _tiny_runner

    mesh_flags = dict(mesh_view=3, mesh_data=2)
    (cli_dir,) = cli.main(data_path=GOLDEN, random_model=True, platform="cpu",
                          work_dir=str(tmp_path / "w_cli"), **mesh_flags, **OPTS)
    bundle, _ = cli._build_bundle(None, random_model=True, device="cpu",
                                  mesh=cli.build_mesh(**mesh_flags, device="cpu"))
    assert bundle.mesh.shape == {"data": 2, "view": 3}
    (srv_dir,) = _tiny_runner(bundle, tmp_path / "w_srv")({"data_path": GOLDEN, **OPTS}, _Job(),
                                                          threading.Event())
    cli_pngs = sorted(glob.glob(osp.join(cli_dir, "samples-rgb", "*.png")))
    srv_pngs = sorted(glob.glob(osp.join(srv_dir, "samples-rgb", "*.png")))
    assert len(cli_pngs) == len(srv_pngs) > 0
    for a, b in zip(cli_pngs, srv_pngs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), (a, b)
