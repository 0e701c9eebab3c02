"""Streamed frame writes and the ordered second-pass flush of the port's
engine (engine/saving.py `StreamingFrameWriter`, `save_output(...,
skip_png_keys=)`; engine/runner.py `stream_save` and the flush worker), on
the CPU.

Counterparts of the JAX engine's `StreamingFrameWriter` and `stream_save`
(stable_virtual_camera_tpu/engine/saving.py:32-80, engine/runner.py:904-925,
:1036-1090, :1290-1313). Held here: the writer's files are the bytes of
`save_output`'s synchronous PNGs, and decode to the pixels JAX's writer
writes for the same frames (the port writes through OpenCV, JAX through
imageio: lossless both); `drain` re-raises a worker's error; a tiny
two-pass render with `stream_save` on and off writes byte-identical files,
its second pass's flushes run on one worker thread; an
abort mid-pass, or a failing flush, leaves no worker thread behind and the
failure is raised.

The bundles carry tests/test_torch_parallel_engine.py's light stand-in for
the SD VAE: these tests hold the writes, not the decode.
"""

import glob
import os.path as osp
import threading

import cv2
import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch.config import EngineOptions, VersionConfig
from stable_virtual_camera_tpu_torch.engine import runner, saving
from stable_virtual_camera_tpu_torch.models import io as mio
from stable_virtual_camera_tpu_torch.models.io import random_bundle
from test_torch_parallel_engine import LightVae, _cameras
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

WORKERS = ("svc-flush", "svc-frame-writer")


@pytest.fixture(scope="module", autouse=True)
def light_vae():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mio, "AutoEncoderKL", LightVae)
        yield


@pytest.fixture(scope="module")
def bundle():
    return random_bundle(device="cpu", generator=torch.Generator().manual_seed(0))


def _frames(n=5, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 24, 32, 3), dtype=np.uint8)


def _files(root):
    """{relative path: bytes} of every PNG under `root`."""
    out = {}
    for p in sorted(glob.glob(osp.join(root, "**", "*.png"), recursive=True)):
        with open(p, "rb") as f:
            out[osp.relpath(p, root)] = f.read()
    return out


def _live_workers():
    return [t.name for t in threading.enumerate() if t.name.startswith(WORKERS)]


def test_writer_bytes_equal_save_output_and_pixels_equal_jax(tmp_path):
    """Frames submitted out of order in two batches (a second pass's chunks
    give their final indices) against `save_output`'s synchronous PNGs,
    byte for byte, and against JAX's StreamingFrameWriter's files, pixel
    for pixel; `skip_png_keys` leaves out the streamed PNGs and still
    writes the mp4."""
    from stable_virtual_camera_tpu.engine.saving import StreamingFrameWriter as JaxWriter

    frames = _frames()
    floats = frames.astype(np.float32) / 127.5 - 1.0  # to_uint8 is floor: not the uint8 frames
    writer = saving.StreamingFrameWriter(str(tmp_path / "stream" / "samples-rgb"))
    writer.submit([3, 1, 4], floats[[3, 1, 4]])
    writer.submit([0, 2], floats[[0, 2]])
    writer.drain()
    writer.drain()  # a second drain is a no-op
    saving.save_output({"samples-rgb/image": floats}, str(tmp_path / "sync"))
    streamed, sync = _files(tmp_path / "stream"), _files(tmp_path / "sync")
    assert list(streamed) == [f"samples-rgb/{i:03d}.png" for i in range(5)]
    assert streamed == sync

    jax_writer = JaxWriter(str(tmp_path / "jax"))
    jax_writer.submit(range(5), floats)
    jax_writer.drain()
    for i in range(5):
        ours = cv2.imread(str(tmp_path / "stream" / "samples-rgb" / f"{i:03d}.png"))
        theirs = cv2.imread(str(tmp_path / "jax" / f"{i:03d}.png"))
        np.testing.assert_array_equal(ours, theirs)

    saving.save_output({"samples-rgb/image": floats}, str(tmp_path / "skip"), skip_png_keys=("samples-rgb",))
    assert osp.exists(tmp_path / "skip" / "samples-rgb.mp4") and not _files(tmp_path / "skip")


def test_writer_drain_reraises_a_worker_error(tmp_path, monkeypatch):
    calls = []

    def failing(path, frame):
        calls.append(path)
        raise OSError("disk full")

    monkeypatch.setattr(saving, "write_png", failing)
    writer = saving.StreamingFrameWriter(str(tmp_path))
    writer.submit([0, 1], _frames(2))
    with pytest.raises(OSError, match="disk full"):
        writer.drain()
    assert len(calls) == 2 and not writer._t.is_alive()  # the worker went on after the first error
    with pytest.raises(OSError, match="disk full"):
        writer.drain()


def _render(bundle, save_path, stream_save=True, abort_at=None, **kw):
    """img2trajvid at T=3 with 1 input, 3 targets and 2 anchors (a second
    pass of 3 chunks, one target each), 2 steps, written to `save_path`.
    `abort_at=k` sets the abort event at the first step of second-pass
    chunk k (the per-step progress callback keeps the serial loop)."""
    rng = np.random.default_rng(11)
    imgs = list(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    c2ws, Ks = _cameras(rng, 4)
    options = EngineOptions().update(dict(
        num_steps=2, cfg=[2.0, 2.0], cfg_min=1.2, guider_types=[1, 2], chunk_strategy="interp",
        chunk_strategy_first_pass="gt", sampler_verbose=False, encoding_t=0, decoding_t=0,
        stream_save=stream_save, **kw,
    ))
    abort, ticks = threading.Event(), []

    def pbar(i, n):
        ticks.append(i)
        if abort_at is not None and len(ticks) == abort_at * n + 1:
            abort.set()

    engine = runner.SceneEngine(bundle, VersionConfig(H=64, W=64, T=3), options)
    return list(engine.run_one_scene(
        "img2trajvid",
        {"img": imgs, "input_indices": [0], "prior_indices": [1.5, 2.5]},
        {"c2w": c2ws, "K": Ks, "input_indices": list(range(4))},
        save_path=str(save_path), use_traj_prior=True, traj_prior_c2ws=c2ws[[2, 3]], seed=2,
        abort_event=abort, second_pass_pbar=pbar,
    ))


def test_streamed_render_writes_the_synchronous_bytes_in_order(bundle, tmp_path, monkeypatch):
    """A two-pass render with `stream_save` on and off: the same PNGs, byte
    for byte (first pass and final frames), both mp4s; with it on, the
    second pass's three flushes run on one worker thread (a FIFO of one
    keeps the chunk order), and no worker thread is left when the render
    ends."""
    seen = []
    decode_output = runner.decode_output

    def record(samples, T, indices=None):
        seen.append((threading.current_thread().name, list(indices)))
        return decode_output(samples, T, indices)

    monkeypatch.setattr(runner, "decode_output", record)
    out_on = _render(bundle, tmp_path / "on")
    flushes = [s for s in seen if s[0] != threading.current_thread().name]
    seen.clear()
    _render(bundle, tmp_path / "off", stream_save=False)
    assert out_on[-1].endswith("samples-rgb.mp4") and osp.exists(out_on[-1])
    on, off = _files(tmp_path / "on"), _files(tmp_path / "off")
    assert len([k for k in on if k.startswith("samples-rgb/")]) == 3
    assert len([k for k in on if k.startswith("first-pass/samples-rgb/")]) == 2
    assert on == off
    assert [name for name, _ in flushes] == ["svc-flush_0"] * 3
    assert not _live_workers()


@pytest.mark.parametrize("failure", ["abort", "flush_error"])
def test_abort_or_failing_flush_leaves_no_thread(bundle, tmp_path, monkeypatch, failure):
    """An abort at the second chunk of the second pass ends the render with
    no final save; a flush that raises fails the render with its error.
    Either way no flush or writer thread outlives it."""
    if failure == "abort":
        outs = _render(bundle, tmp_path, abort_at=1)
        assert len(outs) == 1 and outs[0].endswith(osp.join("first-pass", "samples-rgb.mp4"))
        assert not osp.exists(tmp_path / "samples-rgb.mp4")
    else:
        decode_output = runner.decode_output

        def broken(samples, T, indices=None):
            if threading.current_thread().name.startswith("svc-flush"):
                raise RuntimeError("flush failed")
            return decode_output(samples, T, indices)

        monkeypatch.setattr(runner, "decode_output", broken)
        with pytest.raises(RuntimeError, match="flush failed"):
            _render(bundle, tmp_path)
    assert not _live_workers()
