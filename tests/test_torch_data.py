"""The port's scene data path (data/, core/normalize.py, training/data.py)
and its train CLI, on the CPU.

The parsers and the Dataset are held against the JAX package's on the
COLMAP (text and binary) and reconfusion scenes that tests/test_colmap.py and
tests/test_training_data.py build; the port's OpenCV image reader against
imageio; SceneChunkSampler's chunks against the JAX sampler's for one seed,
including non-integer resizes (the port's exact area resize against
cv2.INTER_AREA). The train CLI runs end to end on the tiny model with resume,
as the JAX package's CLI test does.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch.core import normalize
from stable_virtual_camera_tpu_torch.data import Dataset, DirectParser, get_parser
from stable_virtual_camera_tpu_torch.data.dataset import read_image
from stable_virtual_camera_tpu_torch.training.data import (
    SceneChunkSampler,
    device_prefetch,
    train_batch_from_values,
)

from conftest import random_c2ws
from test_colmap import _make_scene


def _assert_parsers_equal(ours, ref):
    assert ours.image_names == ref.image_names
    assert ours.image_paths == ref.image_paths
    assert list(ours.camera_ids) == list(ref.camera_ids)
    np.testing.assert_array_equal(ours.camtoworlds, ref.camtoworlds)
    for attr in ("Ks_dict", "params_dict", "mapx_dict", "mapy_dict"):
        a, b = getattr(ours, attr), getattr(ref, attr)
        assert a.keys() == b.keys(), attr
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{attr}[{key}]")
    assert ours.imsize_dict == ref.imsize_dict
    assert ours.roi_undist_dict == ref.roi_undist_dict
    for attr in ("points", "points_rgb", "points_err", "transform"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr), err_msg=attr)
    assert ours.point_indices.keys() == ref.point_indices.keys()
    for key in ours.point_indices:
        np.testing.assert_array_equal(ours.point_indices[key], ref.point_indices[key])
    assert ours.scene_scale == ref.scene_scale


def _assert_items_equal(ours: Dataset, ref):
    assert len(ours) == len(ref)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"item {i} {key}")


@pytest.mark.parametrize("encoding", ["text", "binary"])
@pytest.mark.parametrize("normalize_world", [False, True])
def test_colmap_parser_and_dataset_match_jax(tmp_path, encoding, normalize_world):
    """Cameras, intrinsics, distortion and undistortion maps, points and
    tracks, and the undistorted, cropped images of the Dataset."""
    from stable_virtual_camera_tpu.data import Dataset as JaxDataset
    from stable_virtual_camera_tpu.data import get_parser as jax_get_parser

    if encoding == "text":
        from stable_virtual_camera_tpu.data.colmap_text import write_text_model as write
    else:
        from stable_virtual_camera_tpu.data.colmap_binary import write_binary_model as write
    root, _, _ = _make_scene(tmp_path / "scene", write)
    kw = dict(data_dir=root, test_every=3, normalize=normalize_world)
    ours, ref = get_parser("colmap", **kw), jax_get_parser("colmap", **kw)
    _assert_parsers_equal(ours, ref)
    for split in ("train", "test"):
        _assert_items_equal(Dataset(ours, split=split, load_depths=True),
                            JaxDataset(ref, split=split, load_depths=True))


def _reconfusion_scene(root, n=6, hw=(64, 64)):
    """A reconfusion-format scene on disk: PNG frames, OpenGL transforms
    and one train/test split (the JAX CLI test's layout)."""
    import cv2

    rng = np.random.default_rng(11)
    (root / "images").mkdir(parents=True)
    c2ws = random_c2ws(rng, n)
    c2ws[:, :, [1, 2]] *= -1  # OpenCV -> OpenGL
    frames = []
    for i in range(n):
        name = f"images/frame_{i:03d}.png"
        cv2.imwrite(str(root / name), rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
        frames.append({"file_path": f"./{name}", "transform_matrix": c2ws[i].tolist(),
                       "fl_x": 80.0, "fl_y": 80.0, "cx": hw[1] / 2, "cy": hw[0] / 2,
                       "w": hw[1], "h": hw[0]})
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    (root / "train_test_split_4.json").write_text(
        json.dumps({"train_ids": [0, 1, 2, 3], "test_ids": [4, 5]}))
    return str(root)


@pytest.mark.parametrize("normalize_world", [False, True])
def test_reconfusion_parser_and_dataset_match_jax(tmp_path, normalize_world):
    from stable_virtual_camera_tpu.data import Dataset as JaxDataset
    from stable_virtual_camera_tpu.data import get_parser as jax_get_parser

    root = _reconfusion_scene(tmp_path / "scene")
    kw = dict(data_dir=root, normalize=normalize_world)
    ours, ref = get_parser("reconfusion", **kw), jax_get_parser("reconfusion", **kw)
    _assert_parsers_equal(ours, ref)
    assert ours.splits_per_num_input_frames == ref.splits_per_num_input_frames
    for split in ("train", "test"):
        _assert_items_equal(Dataset(ours, split=split, num_input_frames=4),
                            JaxDataset(ref, split=split, num_input_frames=4))


def test_normalize_scene_matches_jax():
    from stable_virtual_camera_tpu.core import normalize as jax_normalize

    rng = np.random.default_rng(2)
    c2ws = random_c2ws(rng, 9)
    points = rng.normal(size=(40, 3))
    for method in ("focus", "poses"):
        ours = normalize.normalize_scene(c2ws.copy(), points.copy(), camera_center_method=method)
        ref = jax_normalize.normalize_scene(c2ws.copy(), points.copy(), camera_center_method=method)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [3, 4])
def test_image_reader_matches_imageio(tmp_path, channels):
    """The port reads images through OpenCV (BGR(A) -> RGB, alpha dropped);
    the JAX package through imageio."""
    import cv2
    import imageio.v3 as iio

    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (20, 30, channels), dtype=np.uint8)
    path = str(tmp_path / "im.png")
    assert cv2.imwrite(path, img[..., [2, 1, 0, 3][:channels]])  # RGB(A) -> BGR(A)
    ours = read_image(path)
    assert ours.dtype == np.uint8 and ours.shape == (20, 30, 3)
    np.testing.assert_array_equal(ours, iio.imread(path)[..., :3])
    np.testing.assert_array_equal(ours, img[..., :3])
    with pytest.raises(FileNotFoundError):
        read_image(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("src_hw,size,k", [((72, 96), 64, 1), ((750, 1000), 576, 2)])
def test_scene_sampler_matches_jax(src_hw, size, k):
    """Chunks of both samplers for one seed: view choice and order, the
    resized images (non-integer factors 0.889 and 0.768), normalized
    intrinsics, centered cameras and Plücker maps."""
    from stable_virtual_camera_tpu.data import Dataset as JaxDataset
    from stable_virtual_camera_tpu.data import DirectParser as JaxDirectParser
    from stable_virtual_camera_tpu.training.data import SceneChunkSampler as JaxSampler

    rng = np.random.default_rng(3)
    n = 5
    imgs = [im for im in rng.integers(0, 256, size=(n, *src_hw, 3), dtype=np.uint8)]
    c2ws = random_c2ws(rng, n).astype(np.float32)[:, :3]
    Ks = np.repeat(np.array([[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]], np.float32)[None],
                   n, axis=0)
    ours = SceneChunkSampler(Dataset(DirectParser(imgs, c2ws, Ks)), 3, k, (size, size))
    ref = JaxSampler(JaxDataset(JaxDirectParser(imgs, c2ws, Ks)), 3, k, (size, size))
    a, b = ours.sample(np.random.default_rng(0)), ref.sample(np.random.default_rng(0))
    np.testing.assert_array_equal(a.input_frame_mask, b.input_frame_mask)
    np.testing.assert_array_equal(a.camera_mask, b.camera_mask)
    assert a.imgs.shape == (3, size, size, 3)
    np.testing.assert_allclose(a.imgs, b.imgs, atol=1e-5)
    np.testing.assert_allclose(a.K, b.K, atol=1e-6)
    np.testing.assert_allclose(a.c2w, b.c2w, atol=1e-6)
    np.testing.assert_allclose(a.plucker, b.plucker, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    """A tiny fp32 CPU bundle and a 6-view in-memory scene of 72x96 images."""
    from stable_virtual_camera_tpu_torch.models.io import random_bundle

    rng = np.random.default_rng(3)
    imgs = [im for im in rng.integers(0, 256, size=(6, 72, 96, 3), dtype=np.uint8)]
    c2ws = random_c2ws(rng, 6).astype(np.float32)[:, :3]
    Ks = np.repeat(np.array([[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]], np.float32)[None],
                   6, axis=0)
    bundle = random_bundle(device="cpu", generator=torch.Generator().manual_seed(0))
    sampler = SceneChunkSampler(Dataset(DirectParser(imgs, c2ws, Ks)), 3, 1, (64, 64))
    return bundle, sampler


def test_train_batch_semantics(tiny):
    """The conditioning tensors as the sampler sees them: mask map ++
    Plücker, one shared CLIP row, input views out of the loss, latents the
    VAE encode of the frames."""
    bundle, sampler = tiny
    v = sampler.sample(np.random.default_rng(1))
    b = train_batch_from_values(bundle.vae, bundle.clip, v)
    assert b.latents.shape == (3, 8, 8, 4) and b.crossattn.shape == (3, 1, 64)
    np.testing.assert_array_equal(b.concat[..., 0], np.broadcast_to([[[1.0]], [[0.0]], [[0.0]]], (3, 8, 8)))
    np.testing.assert_array_equal(b.concat[..., 1:], b.dense)
    np.testing.assert_array_equal(b.dense, v.plucker.astype(np.float32))
    np.testing.assert_array_equal(b.crossattn[0], b.crossattn[1])
    np.testing.assert_array_equal(b.loss_mask, [0.0, 1.0, 1.0])
    np.testing.assert_array_equal(
        train_batch_from_values(bundle.vae, bundle.clip, v, mask_inputs=False).loss_mask, [1.0] * 3)
    np.testing.assert_allclose(b.latents, bundle.vae.encode(v.imgs, 0), rtol=1e-5)


def test_device_prefetch_matches_direct_and_reraises(tiny):
    bundle, sampler = tiny
    direct = list(itertools.islice(sampler.batches(bundle.vae, bundle.clip, seed=5), 2))
    fetched = list(itertools.islice(
        device_prefetch(sampler.batches(bundle.vae, bundle.clip, seed=5), "cpu", size=2), 2))
    for a, b in zip(direct, fetched):
        for name in ("latents", "concat", "crossattn", "dense", "loss_mask"):
            got = getattr(b, name)
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), getattr(a, name))

    def failing():
        raise RuntimeError("producer failed")
        yield  # pragma: no cover

    with pytest.raises(RuntimeError, match="producer failed"):
        list(device_prefetch(failing(), "cpu"))


def test_train_cli_smoke_and_resume(tmp_path):
    """The fine-tuning CLI runs end to end on a reconfusion scene on disk
    with the tiny random model on the CPU, checkpoints (params, optimizer,
    step, EMA), and resumes from its own state; a LoRA run saves merged
    weights as the converted cache, which load_bundle reads back exactly and
    --checkpoint_dir trains from."""
    from stable_virtual_camera_tpu_torch.apps import train_cli
    from stable_virtual_camera_tpu_torch.models.io import load_bundle
    from stable_virtual_camera_tpu_torch.training.checkpoint import restore_train_state
    from stable_virtual_camera_tpu_torch.training.lora import merge_lora

    scene = _reconfusion_scene(tmp_path / "scene0")
    work = str(tmp_path / "work")
    kw = dict(data_path=scene, work_dir=work, random_model=True, num_input_frames=1, lr=1e-4,
              warmup_steps=1, ckpt_every=2, log_every=1, seed=3, device="cpu")
    out = train_cli.main(num_steps=3, ema_decay=0.99, **kw)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    _, opt_state, step, ema = restore_train_state(out["ckpt_path"])
    assert step == 3 and ema is not None and opt_state["schedule"]["last_epoch"] == 3
    out = train_cli.main(num_steps=5, ema_decay=0.99, **kw)  # resumes at 3, runs 2 more
    assert len(out["losses"]) == 2 and restore_train_state(out["ckpt_path"])[2] == 5

    out = train_cli.main(num_steps=1, lora_rank=4, save_merged=True,
                         **{**kw, "work_dir": str(tmp_path / "lora")})
    assert len(out["lora"]) > 0
    base, _ = train_cli.random_model_bundle("cpu")
    expected = dict(base.unet.state_dict())
    expected.update(merge_lora(base.unet, out["lora"], None))
    merged_dir = str(tmp_path / "lora" / "merged")
    merged = load_bundle(merged_dir, dtype=torch.float32, device="cpu")
    assert merged.spec == base.spec
    got = merged.unet.state_dict()
    assert got.keys() == expected.keys()
    assert all(torch.equal(got[k], expected[k]) for k in expected)
    vae = merged.vae.module.state_dict()
    assert all(torch.equal(vae[k], v) for k, v in base.vae.module.state_dict().items())
    out = train_cli.main(**{**kw, "random_model": False, "checkpoint_dir": merged_dir, "W": 64,
                            "H": 64, "num_steps": 1, "work_dir": str(tmp_path / "from_ckpt")})
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    with pytest.raises(SystemExit, match="checkpoint_dir"):
        train_cli.main(**{**kw, "random_model": False})
    assert train_cli._parse_argv(["--num_steps", "3", "--lr=1e-4", "--remat"]) == {
        "num_steps": 3, "lr": 1e-4, "remat": True}
