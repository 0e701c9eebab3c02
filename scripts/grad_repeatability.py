#!/usr/bin/env python3
"""Whether the full-width train step's gradient repeats bit for bit on one
NVIDIA GPU, and where it first does not: what sets the FSDP step's two data
ranks (chip_smoke.py `sharded_train` (b)) apart in their last bits.

Prints one JSON object:
  * `unsharded`: the loss's gradient (chip_smoke's training batch and draw:
    T=21, 576x576, bf16 weights, remat) computed twice on one stream,
    leaf by leaf: the leaves that differ, the first of them in the order
    the backward finishes the leaves, and the worst ones' relative L2;
  * `fsdp_data_ranks`: the same comparison between the two data ranks'
    whole gradients on the FSDP step's (2, 1) mesh, before each keeps its
    cut (the ranks run the same frames and draw; each on its own stream);
  * `fsdp_rank0_vs_unsharded`: data rank 0's whole gradient against the
    unsharded one, with the memory layout of the first differing leaf's
    weight in each;
  * `deterministic`: whether the deterministic settings were on, and the
    ops torch warned have no deterministic implementation on the way.

Run from the repository root:
    python3 scripts/grad_repeatability.py [--deterministic] [--contiguous_gather]
--contiguous_gather gathers every FSDP weight with contiguous strides (the
convs' weights not channels_last, as the module holds them), to show what
the strides change. --deterministic sets CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts,
cuDNN's deterministic algorithms, and
torch.use_deterministic_algorithms(True, warn_only=True).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import warnings

DETERMINISTIC = "--deterministic" in sys.argv[1:]
CONTIGUOUS_GATHER = "--contiguous_gather" in sys.argv[1:]
if DETERMINISTIC:
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from stable_virtual_camera_tpu_torch.config import SevaSpec  # noqa: E402
from stable_virtual_camera_tpu_torch.models.clip import ClipVisionSpec  # noqa: E402
from stable_virtual_camera_tpu_torch.models.io import random_bundle  # noqa: E402
from stable_virtual_camera_tpu_torch.parallel.comm import run_ranks  # noqa: E402
from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from stable_virtual_camera_tpu_torch.training.optim import AdamW  # noqa: E402
from stable_virtual_camera_tpu_torch.training.train_step import (  # noqa: E402
    _whole_draw,
    make_fsdp_train_step,
    make_loss_fn,
)

DEV = "cuda"


def compare(a: dict, b: dict, order: list[str]) -> dict:
    """Leaf-by-leaf comparison of two gradients, in backward order."""
    differ = [n for n in order if not torch.equal(a[n], b[n])]
    rel = {n: ((a[n].float() - b[n].float()).norm() / b[n].float().norm().clamp_min(1e-30)).item()
           for n in differ}
    worst = sorted(rel, key=rel.get, reverse=True)[:5]
    return {"leaves": len(order), "leaves_differing": len(differ),
            "first_differing_in_backward_order": differ[0] if differ else None,
            "first_differing_position": order.index(differ[0]) if differ else None,
            "worst_rel_l2": {n: rel[n] for n in worst},
            "max_abs": max([(a[n].float() - b[n].float()).abs().max().item() for n in differ], default=0.0)}


def main() -> int:
    if not torch.cuda.is_available():
        print("grad_repeatability: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if DETERMINISTIC:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    from stable_virtual_camera_tpu_torch import _kernels

    _kernels.build_all()
    gen = torch.Generator(device=DEV).manual_seed(cs.SEED)
    bundle = random_bundle(SevaSpec(), ClipVisionSpec(), dtype=torch.bfloat16, device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(cs.SEED))
    unet = bundle.unet
    unet.requires_grad_(True)
    batch, draw = cs.train_inputs(bundle, gen)
    order: list[str] = []
    hooks = [p.register_post_accumulate_grad_hook(lambda p, n=n: order.append(n))
             for n, p in unet.named_parameters()]
    loss_fn = make_loss_fn(unet, cs.TRAIN_T, remat=True)
    caught: list[str] = []
    runs = []
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(2):
            unet.zero_grad(set_to_none=True)
            loss_fn(batch, draw).backward()
            torch.cuda.synchronize()
            runs.append({n: p.grad.detach().clone() for n, p in unet.named_parameters() if p.grad is not None})
            for h in hooks:
                h.remove()
            hooks = []
        unet.zero_grad(set_to_none=True)
        out = {"unsharded": compare(runs[1], runs[0], order)}
        unsharded = runs[0]
        del runs

        # the FSDP step's forward and one backward over both data ranks, as
        # FsdpTrainStep.loss_and_grads runs them, stopped before the cut
        opt = AdamW(unet.parameters(), cs.TRAIN_LR)
        mesh = make_mesh(2, 1, devices=[DEV] * 2, timeout=cs.MESH_TIMEOUT)
        fstep, init = make_fsdp_train_step(unet, opt, cs.TRAIN_T, mesh, remat=True)
        state = init()
        if CONTIGUOUS_GATHER:
            fstep.strides = {n: torch.empty(s.shape, device="meta").stride()
                             for n, s in state.ranks[0].skeleton.named_parameters()}
        drawn = _whole_draw(batch, draw)
        gathered: dict[int, dict] = {}

        def forward(ctx):
            st = state.ranks[ctx.rank]
            with torch.no_grad():
                gathered[ctx.rank] = fstep._gather(ctx, st)
            return fstep._loss(ctx, st, gathered[ctx.rank], batch, drawn)

        torch.autograd.backward(run_ranks(mesh, forward))
        torch.cuda.synchronize()
        grads = [{n: t.grad for n, t in gathered[r].items()} for r in range(2)]
        out["fsdp_data_ranks"] = compare(grads[1], grads[0], order)
        out["fsdp_rank0_vs_unsharded"] = compare(grads[0], unsharded, order)
        first = out["fsdp_rank0_vs_unsharded"]["first_differing_in_backward_order"]
        if first is not None:
            own = dict(unet.named_parameters())[first]
            out["fsdp_rank0_vs_unsharded"]["first_differing_strides"] = {
                "module": list(own.stride()), "gathered": list(gathered[0][first].stride())}
        caught = sorted({str(x.message).split(" does not have")[0] for x in w
                         if "deterministic" in str(x.message)})
    out["deterministic"] = {"on": DETERMINISTIC, "ops_without_a_deterministic_implementation": caught}
    out["contiguous_gather"] = CONTIGUOUS_GATHER
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out["card"] = smi
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
