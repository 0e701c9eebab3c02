"""Per-scene state in the port's CLI: every scene of `cli.main` plans its
anchors on its own copies of the CLI's EngineOptions and VersionConfig.

Anchor planning rewrites both in place (engine/prior.py: `resolve_anchors`
sets `deliver_anchors`, it and `infer_prior_stats` rewrite `version.T`).
The JAX CLI hands one pair to every scene, so a dense scene after a
semi-dense one loses its anchor delivery and inherits the other's
first-pass window; the port copies them a scene (apps/cli.render_one_scene).

Held here on the CPU with the tiny bundle at T=21, 1 step, the
`interp` chunking and dense anchor placement (`min_anchor_fill=False`):
scene "a" has 3 inputs and 80 targets, scene "b" 12 inputs and 20 targets
(semi-dense: its plan turns delivery off and rewrites the window).
Run in either order, each scene gets the anchors, delivery and PNGs it
gets as the first scene of a run (a one-scene run); scene "a"'s anchors
are [0, 20, 40, 59, 79] with delivery, as JAX's `resolve_anchors` plans
them for it on fresh options. The bundle carries
tests/test_torch_parallel_engine.py's light stand-in for the SD VAE.
"""

import json

import cv2
import numpy as np
import pytest

from stable_virtual_camera_tpu_torch.apps import cli
from stable_virtual_camera_tpu_torch.models import io as mio
from test_torch_parallel_engine import LightVae
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_streaming import _files

N_TARGETS = {"a": 80, "b": 20}
OPTS = dict(task="img2trajvid", use_traj_prior=True, random_model=True, device="cpu", T=21, num_steps=1,
            chunk_strategy="interp", guider_types=[1, 2], cfg=[2.0, 2.0], sampler_verbose=False,
            save_first_pass=False)


@pytest.fixture(autouse=True)
def light_vae(monkeypatch):
    monkeypatch.setattr(mio, "AutoEncoderKL", LightVae)


def _orbit_scene(root, n_inputs, n_targets, seed):
    """A reconfusion-format scene of 16x16 frames on a circle around the
    origin, `n_inputs` inputs spread over it, the rest targets."""
    n = n_inputs + n_targets
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    frames = []
    for i, a in enumerate(np.linspace(0, 2 * np.pi, n, endpoint=False)):
        eye = np.array([4 * np.sin(a), 0.3, 4 * np.cos(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], 1)  # OpenGL axes
        c2w[:3, 3] = eye
        name = f"images/frame_{i:03d}.png"
        cv2.imwrite(str(root / name), rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
        frames.append({"file_path": f"./{name}", "transform_matrix": c2w.tolist(), "fl_x": 14.0,
                       "fl_y": 14.0, "cx": 8.0, "cy": 8.0, "w": 16, "h": 16})
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    train = np.linspace(0, n - 1, n_inputs).round().astype(int).tolist()
    (root / f"train_test_split_{n_inputs}.json").write_text(
        json.dumps({"train_ids": train, "test_ids": [i for i in range(n) if i not in train]}))


def test_each_scene_keeps_its_own_anchors_and_frames_in_either_order(tmp_path, monkeypatch):
    from stable_virtual_camera_tpu.config import EngineOptions as JaxOptions, VersionConfig as JaxVersion
    from stable_virtual_camera_tpu.engine.prior import resolve_anchors as jax_resolve_anchors

    data = tmp_path / "scenes"
    _orbit_scene(data / "a", 3, N_TARGETS["a"], seed=1)
    _orbit_scene(data / "b", 12, N_TARGETS["b"], seed=2)
    planned = []
    resolve = cli.resolve_anchors

    def record(T, num_inputs, num_targets, version, options):
        rel, dense = resolve(T, num_inputs, num_targets, version, options)
        planned.append((num_inputs, [round(r) for r in rel], options.get("deliver_anchors"),
                        str(version.T)))
        return rel, dense

    monkeypatch.setattr(cli, "resolve_anchors", record)
    runs = {}
    for order in ("ab", "ba"):
        planned.clear()
        dirs = cli.main(str(data), data_items=list(order), work_dir=str(tmp_path / order), **OPTS)
        runs[order] = {name: (plan, _files(d)) for name, plan, d in zip(order, list(planned), dirs)}

    alone_a, alone_b = runs["ab"]["a"], runs["ba"]["b"]  # each the first scene of its run
    assert runs["ba"]["a"][0] == alone_a[0] and runs["ab"]["b"][0] == alone_b[0]
    assert runs["ba"]["a"][1] == alone_a[1] and runs["ab"]["b"][1] == alone_b[1]
    assert len(alone_a[1]) == N_TARGETS["a"] + 3 and alone_a[1] != alone_b[1]
    n, rel, deliver, _ = alone_a[0]
    assert (n, rel, deliver) == (3, [0, 20, 40, 59, 79], True)
    assert alone_b[0][2] is False

    options = JaxOptions(chunk_strategy="interp", min_anchor_fill=False)
    jax_rel, _ = jax_resolve_anchors(21, 3, N_TARGETS["a"], JaxVersion(T=21), options)
    assert [round(r) for r in jax_rel] == rel and options.get("deliver_anchors") is True
