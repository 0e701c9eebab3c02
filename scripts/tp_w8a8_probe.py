#!/usr/bin/env python3
"""How far tensor parallelism moves a W8A8 chunk, and why, on one NVIDIA GPU:
the reading behind chip_smoke.py `tp_path`'s W8A8 bar.

The seeded T=21 chunk of chip_smoke.py (576x576, 4 steps, the full-width
bf16 random bundle) on a (data, view, model) = (1, 1, 2) mesh of thread
ranks on cuda:0 against the unsharded chunk, in each mode ("0", "w8a8",
"w8a8-static"). Every W8A8 layer is bit-equal on the model axis, so the
difference comes from the exact layers, which round otherwise on shards
than whole; the probe runs the mesh twice: as the port runs it, and with
the exact layers whose input the rule cuts (the ResBlocks' emb_proj, the
out conv) computed on their all-gathered whole weights, which takes their
partial sums out of the difference.

Prints one JSON object: for each mode, the unsharded chunk's relative L2 to
the unsharded exact chunk (W8A8's own error; 0 in mode "0") and the
sharded chunk's relative L2 to the unsharded chunk in the same mode, both
ways, with the card's name and power limit.

Run from the repository root: python3 scripts/tp_w8a8_probe.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from stable_virtual_camera_tpu_torch import _kernels  # noqa: E402
from stable_virtual_camera_tpu_torch.config import SevaSpec  # noqa: E402
from stable_virtual_camera_tpu_torch.engine.runner import ensure_quant_calibrated  # noqa: E402
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec  # noqa: E402
from stable_virtual_camera_tpu_torch.models.io import random_bundle  # noqa: E402
from stable_virtual_camera_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402
from stable_virtual_camera_tpu_torch.parallel.comm import run_ranks  # noqa: E402
from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh_tp  # noqa: E402
from stable_virtual_camera_tpu_torch.parallel.sharding import sample_shard  # noqa: E402
from stable_virtual_camera_tpu_torch.sampling.sampler import euler_edm_sample, torch_noise  # noqa: E402


def _whole_weight(layer):
    """The layer's whole weight, gathered from the ranks' input slices."""
    return torch.cat(tp._group(layer).all_gather(layer.weight), dim=1)


def _exact_input_sharded(layer) -> bool:
    """An exact (never quantized) layer whose input the rule cuts."""
    return tp._group(layer) is not None and layer.tp_dim == 1 and not hasattr(layer, "quant")


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    bundle = random_bundle(SevaSpec(), ClipVisionSpec(), dtype=torch.bfloat16, device=cs.DEVICE,
                           generator=torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED))
    h = cs.RES // 8
    cond = cs.seeded_chunk(bundle.spec.context_dim, h)
    plan = bundle.plan(cs.NUM_STEPS)
    shape = (cs.T, h, h, 4)

    def draw(step):
        return torch_noise(cs.SEED, 0, 0, step, shape, cs.DEVICE)

    def rel(a, b):
        return ((a - b).float().norm() / b.float().norm()).item()

    linear, conv = tp.linear, tp.conv

    def gathered_linear(layer, x):
        return F.linear(x, _whole_weight(layer), layer.bias) if _exact_input_sharded(layer) else linear(layer, x)

    def gathered_conv(layer, x, fn):
        if _exact_input_sharded(layer):
            return fn(x, _whole_weight(layer).contiguous(memory_format=torch.channels_last), layer.bias)
        return conv(layer, x, fn)

    exact = euler_edm_sample(bundle.network, draw(None), plan, cond, cs.T, step_noise=draw)
    out = {}
    for mode in ("0", "w8a8", "w8a8-static"):
        bundle.unet.set_quant(mode)
        ensure_quant_calibrated(bundle, shape, plan, cond)
        whole = euler_edm_sample(bundle.network, draw(None), plan, cond, cs.T, step_noise=draw)
        mesh = make_mesh_tp(1, 1, 2, devices=[cs.DEVICE] * 2)
        bundle.mesh = mesh
        bundle.replicate()
        row = {"unsharded_vs_exact_rel_l2": rel(whole, exact)}
        try:
            for name, fns in (("as_run", (linear, conv)), ("exact_inputs_gathered", (gathered_linear, gathered_conv))):
                tp.linear, tp.conv = fns
                outs = run_ranks(mesh, lambda ctx: sample_shard(
                    bundle.network, [draw(None)], plan, [cond], cs.T, [draw], None, device=ctx.device,
                    model_comm=ctx.model_comm), rows=[0])
                row[f"sharded_vs_unsharded_rel_l2_{name}"] = rel(outs[0][0], whole)
                row[f"sharded_vs_exact_rel_l2_{name}"] = rel(outs[0][0], exact)
        finally:
            tp.linear, tp.conv = linear, conv
            bundle.mesh = None
            bundle._shards.clear()
            bundle.unet.set_quant("0")
            bundle.unet.clear_quant_state()
        out[mode] = row
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi, "modes": out}))


if __name__ == "__main__":
    main()
