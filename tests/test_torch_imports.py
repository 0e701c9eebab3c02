"""The port's main path, its CLI, its fine-tuning path, its Advanced-mode
path, its weight loading, its W8A8 serving, its HTTP service, its GUI demo,
its utilities, LPIPS, its ahead-of-time export and its multi-device
sampling (parallel/, tensor parallelism included), with its streamed frame
writes and FiLM cache, and its sharded training (the view-sharded and FSDP
train steps, the train CLI's mesh) and edge-sharded alignment, import no JAX, nothing of the JAX package, no
`safetensors`, no image library and neither gradio nor viser.

The machine with the card has PyTorch but no JAX, no `safetensors` (so the
port reads and writes the format itself) and no `imageio` (so the port
keeps its own image transforms, and imports its readers' and writers'
libraries only when they read or write), and neither gradio nor viser (the
GUI imports them when it is built). A fresh interpreter blocks those
packages, then imports the port's entry points, its training and data
modules and `chip_smoke`; any import of a blocked package fails the import.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib.abc, sys

BLOCKED = {blocked!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())

import chip_smoke
import stable_virtual_camera_tpu_torch.apps.renderer
import stable_virtual_camera_tpu_torch.apps.cli
import stable_virtual_camera_tpu_torch.ops.flash_attention
import stable_virtual_camera_tpu_torch.ops.flash_attention_packed
import stable_virtual_camera_tpu_torch.models.io
import stable_virtual_camera_tpu_torch.engine.runner
import stable_virtual_camera_tpu_torch.apps.train_cli
import stable_virtual_camera_tpu_torch.core.normalize
import stable_virtual_camera_tpu_torch.data
import stable_virtual_camera_tpu_torch.data.colmap_binary
import stable_virtual_camera_tpu_torch.data.colmap_text
import stable_virtual_camera_tpu_torch.training.checkpoint
import stable_virtual_camera_tpu_torch.training.data
import stable_virtual_camera_tpu_torch.training.lora
import stable_virtual_camera_tpu_torch.training.optim
import stable_virtual_camera_tpu_torch.training.train_step
import stable_virtual_camera_tpu_torch.utils.seeding
import stable_virtual_camera_tpu_torch.apps.preprocessor
import stable_virtual_camera_tpu_torch.apps.trajectory
import stable_virtual_camera_tpu_torch.core.global_alignment
import stable_virtual_camera_tpu_torch.core.kb_splines
import stable_virtual_camera_tpu_torch.models.convert_dust3r
import stable_virtual_camera_tpu_torch.models.dust3r
import stable_virtual_camera_tpu_torch.ops.layer_norm
import stable_virtual_camera_tpu_torch.models.convert
import stable_virtual_camera_tpu_torch.apps.convert_weights
import stable_virtual_camera_tpu_torch.ops.quant
import stable_virtual_camera_tpu_torch.models.common
import stable_virtual_camera_tpu_torch.apps.server
import stable_virtual_camera_tpu_torch.apps.ui_manifest
import stable_virtual_camera_tpu_torch.apps.scene_viz
import stable_virtual_camera_tpu_torch.apps.viser_gui
import stable_virtual_camera_tpu_torch.apps.gradio_app
import stable_virtual_camera_tpu_torch.utils
import stable_virtual_camera_tpu_torch.utils.video
import stable_virtual_camera_tpu_torch.utils.profiling
import stable_virtual_camera_tpu_torch.utils.trace_analysis
import stable_virtual_camera_tpu_torch.models.lpips
import stable_virtual_camera_tpu_torch.models.export
import stable_virtual_camera_tpu_torch.apps.export_artifacts
import stable_virtual_camera_tpu_torch.parallel.mesh
import stable_virtual_camera_tpu_torch.parallel.comm
import stable_virtual_camera_tpu_torch.parallel.ring_attention
import stable_virtual_camera_tpu_torch.parallel.sharding
import stable_virtual_camera_tpu_torch.parallel.param_sharding
import stable_virtual_camera_tpu_torch.parallel.tensor_parallel
from stable_virtual_camera_tpu_torch.engine.saving import StreamingFrameWriter
from stable_virtual_camera_tpu_torch.engine.runner import FILM_CACHE_MAX_T
from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh_tp
from stable_virtual_camera_tpu_torch.parallel.sharding import make_tensor_parallel_sampler
from stable_virtual_camera_tpu_torch.models.io import load_bundle, read_safetensors, save_converted
from stable_virtual_camera_tpu_torch.training.train_step import (
    make_fsdp_train_step, make_sharded_train_step, make_train_step_ema)
from stable_virtual_camera_tpu_torch.training.optim import concat_state, slice_state
from stable_virtual_camera_tpu_torch.parallel.comm import RematRecord
from stable_virtual_camera_tpu_torch.parallel.ring_attention import ring_backward
from stable_virtual_camera_tpu_torch.core.global_alignment import refine_sharded
from stable_virtual_camera_tpu_torch.apps.train_cli import train_mesh
print("imported")
"""


@pytest.mark.parametrize("blocked", [
    ("jax", "flax", "optax", "stable_virtual_camera_tpu", "safetensors"),
    ("cv2", "PIL", "imageio"),
    ("jax", "flax", "optax", "stable_virtual_camera_tpu", "safetensors", "cv2", "PIL", "imageio",
     "gradio", "viser"),
])
def test_main_path_imports_without(blocked):
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(blocked=set(blocked))],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0 and "imported" in proc.stdout, proc.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """On a machine without CUDA (and in a directory holding only the script)
    chip_smoke exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, script], capture_output=True, text=True,
                          cwd=cwd, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
