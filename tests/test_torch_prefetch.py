"""The second pass's conditioning prefetch window (engine/runner.py, the
`prefetch_chunks` option; JAX's engine/runner.py:1211-1275 with
SVC_PREFETCH_CHUNKS), on the CPU with the tiny bundle.

Held here: windows of 1 and 3 write the same PNGs byte for byte, and
every chunk's frames equal those of the chunk built inline by
`sample_chunk` (the build the window replaces); the serial loop builds the
first `prefetch_chunks` chunks before it dispatches any and chunk
k + prefetch_chunks right after dispatching chunk k, with every chunk's
encodes first; an abort mid-pass leaves no worker thread and no staged
conditioning behind.

The bundles carry tests/test_torch_parallel_engine.py's light stand-in for
the SD VAE: these tests hold the loop, not the decode.
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch.config import EngineOptions, VersionConfig
from stable_virtual_camera_tpu_torch.engine import runner
from stable_virtual_camera_tpu_torch.models import io as mio
from stable_virtual_camera_tpu_torch.models.io import random_bundle
from test_torch_parallel_engine import LightVae, _cameras
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_streaming import _files, _live_workers

TARGETS = 5  # a second pass of 5 chunks, one target each


@pytest.fixture(scope="module", autouse=True)
def light_vae():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mio, "AutoEncoderKL", LightVae)
        yield


@pytest.fixture(scope="module")
def bundle():
    return random_bundle(device="cpu", generator=torch.Generator().manual_seed(0))


def _render(bundle, save_path, prefetch_chunks, abort_at=None):
    """img2trajvid at T=3 with 1 input, TARGETS targets and an anchor
    between each two (a second pass of TARGETS chunks), 2 steps;
    `abort_at=k` sets the abort event at the first step of second-pass
    chunk k."""
    rng = np.random.default_rng(11)
    n = TARGETS + 1
    imgs = list(rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8))
    c2ws, Ks = _cameras(rng, n)
    options = EngineOptions().update(dict(
        num_steps=2, cfg=[2.0, 2.0], cfg_min=1.2, guider_types=[1, 2], chunk_strategy="interp",
        chunk_strategy_first_pass="gt", sampler_verbose=False, encoding_t=0, decoding_t=0,
        prefetch_chunks=prefetch_chunks,
    ))
    abort, ticks = threading.Event(), []

    def pbar(i, steps):
        ticks.append(i)
        if abort_at is not None and len(ticks) == abort_at * steps + 1:
            abort.set()

    engine = runner.SceneEngine(bundle, VersionConfig(H=64, W=64, T=3), options)
    return list(engine.run_one_scene(
        "img2trajvid",
        {"img": imgs, "input_indices": [0], "prior_indices": [i + 0.5 for i in range(1, TARGETS)]},
        {"c2w": c2ws, "K": Ks, "input_indices": list(range(n))},
        save_path=str(save_path), use_traj_prior=True, traj_prior_c2ws=c2ws[2:], seed=2,
        abort_event=abort, second_pass_pbar=pbar,
    ))


def test_windows_write_the_inline_frames(bundle, tmp_path, monkeypatch):
    """Windows of 1 and 3 chunks: the same PNGs, byte for byte; and each
    second-pass chunk's frames from its prebuilt conditioning (window 3)
    equal the frames `sample_chunk` gives when it builds the conditioning
    itself."""
    _render(bundle, tmp_path / "w1", 1)
    sample_chunk = runner.sample_chunk
    checked = []

    def also_inline(bundle_, values, **kw):
        out = sample_chunk(bundle_, values, **kw)
        if kw.get("prebuilt") is not None:
            inline = sample_chunk(bundle_, values, **{**kw, "prebuilt": None})
            checked.append(torch.equal(out, inline))
        return out

    monkeypatch.setattr(runner, "sample_chunk", also_inline)
    _render(bundle, tmp_path / "w3", 3)
    one, three = _files(tmp_path / "w1"), _files(tmp_path / "w3")
    assert len([k for k in three if k.startswith("samples-rgb/")]) == TARGETS
    assert one == three
    assert checked == [True] * TARGETS


def test_window_builds_ahead_of_dispatch(bundle, tmp_path, monkeypatch):
    """With a window of 3: every chunk's encodes first, chunks 0..2 built
    before chunk 0 is dispatched, then chunk k + 3 built right after chunk k's
    dispatch. The first pass builds inline (inside sample_chunk)."""
    build, sample_chunk = runner.build_chunk_conditioning, runner.sample_chunk
    prime = runner.prime_chunk_conditioning
    log, inside = [], []

    def spy_build(*a, **kw):
        if not inside:
            log.append("build")
        return build(*a, **kw)

    def spy_sample(*a, **kw):
        inside.append(True)
        try:
            return sample_chunk(*a, **kw)
        finally:
            inside.pop()
            if kw["pass_id"] == 2:
                log.append(f"sample {kw['chunk_id']}")

    def spy_prime(*a, **kw):
        log.append("prime")
        return prime(*a, **kw)

    monkeypatch.setattr(runner, "build_chunk_conditioning", spy_build)
    monkeypatch.setattr(runner, "sample_chunk", spy_sample)
    monkeypatch.setattr(runner, "prime_chunk_conditioning", spy_prime)
    _render(bundle, tmp_path, 3)
    builds = iter(range(TARGETS))
    named = [f"build {next(builds)}" if e == "build" else e for e in log]
    assert named == (["prime"] * TARGETS + ["build 0", "build 1", "build 2",
                                            "sample 0", "build 3", "sample 1", "build 4",
                                            "sample 2", "sample 3", "sample 4"])


def test_abort_leaves_no_worker_and_no_staged_conditioning(bundle, tmp_path, monkeypatch):
    """An abort at the second chunk of the second pass ends the render with
    no final save; no flush or writer thread outlives it, and no chunk's
    conditioning (the window's slots) is still referenced."""
    build = runner.build_chunk_conditioning
    refs = []

    def spy_build(*a, **kw):
        cond, shape = build(*a, **kw)
        refs.append(weakref.ref(cond.crossattn))
        return cond, shape

    monkeypatch.setattr(runner, "build_chunk_conditioning", spy_build)
    outs = _render(bundle, tmp_path, 3, abort_at=1)
    assert len(outs) == 1 and not (tmp_path / "samples-rgb.mp4").exists()
    assert not _live_workers()
    gc.collect()
    assert refs and all(r() is None for r in refs)
