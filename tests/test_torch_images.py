"""The port's two image readers against the JAX package's, on files of every
bit depth the readers meet, on the CPU.

`core/transforms.py::load_image` (the CLI's and the renderer's reader) is
held equal to JAX's `load_image`, which reads with PIL's `convert("RGBA")`;
`data/dataset.py::read_image` (the training data's reader) is held equal to
`imageio.v3.imread(path)[..., :3]`, which JAX's Dataset reads with. 16-bit
PNGs are written with OpenCV from a numpy seed: PIL and imageio keep the
high byte of a 16-bit colour file, PIL clips 16-bit gray to 255 and imageio
returns it as uint16, so each port reader follows its own JAX reader. 8-bit
RGB, RGBA, gray, gray+alpha, palette PNGs and a JPEG stay bit-identical.
"""

import numpy as np
import pytest

from stable_virtual_camera_tpu.core.transforms import load_image as jax_load_image
from stable_virtual_camera_tpu_torch.core.transforms import load_image
from stable_virtual_camera_tpu_torch.data.dataset import read_image

SIXTEEN_BIT = {"rgb16": (12, 10, 3), "rgba16": (12, 10, 4), "gray16": (12, 10)}


def _write(tmp_path, kind: str) -> str:
    """One seeded image file of `kind`; 16-bit ones through OpenCV (which
    writes (B, G, R(, A)) channel order), 8-bit ones through PIL."""
    import cv2
    from PIL import Image

    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind in SIXTEEN_BIT:
        path = str(tmp_path / f"{kind}.png")
        # the whole 16-bit range, with values below 256 too (gray clips there)
        img = rng.integers(0, 65536, SIXTEEN_BIT[kind], dtype=np.uint16)
        img.flat[::7] = rng.integers(0, 256, img.flat[::7].shape)
        assert cv2.imwrite(path, img)
        return path
    mode, ext = {"rgb8": ("RGB", "png"), "rgba8": ("RGBA", "png"), "gray8": ("L", "png"),
                 "la8": ("LA", "png"), "p8": ("P", "png"), "jpeg": ("RGB", "jpg")}[kind]
    channels = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2, "P": 1}[mode]
    arr = rng.integers(0, 256, (12, 10, channels), dtype=np.uint8)
    if mode == "P":
        image = Image.fromarray(arr[..., 0], "L").convert("P")
        image.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
    else:
        image = Image.fromarray(arr[..., 0] if channels == 1 else arr, mode)
    path = str(tmp_path / f"{kind}.{ext}")
    image.save(path)
    return path


@pytest.mark.parametrize("kind", [*SIXTEEN_BIT, "rgb8", "rgba8", "gray8", "la8", "p8", "jpeg"])
def test_load_image_matches_jax(tmp_path, kind):
    path = _write(tmp_path, kind)
    ours = load_image(path)
    ref = jax_load_image(path)
    assert ours.dtype == np.float32 and ours.shape == (1, 12, 10, 3)
    np.testing.assert_array_equal(ours, ref)
    assert 0.0 <= ours.min() and ours.max() <= 1.0


@pytest.mark.parametrize("kind", list(SIXTEEN_BIT))
def test_read_image_matches_imageio_on_16_bit_files(tmp_path, kind):
    import imageio.v3 as iio

    path = _write(tmp_path, kind)
    ours = read_image(path)
    ref = iio.imread(path)[..., :3]
    assert ours.dtype == ref.dtype == (np.uint16 if kind == "gray16" else np.uint8)
    np.testing.assert_array_equal(ours, ref)
