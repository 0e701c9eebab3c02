"""The kernels of the main path as `torch.library` custom ops (ops/): each
op's CPU registration against torch's own op checks (schema, fake
implementation, autograd registration, AOT dispatch), and a small UNet
with head dim 64 and L >= FLASH_MIN_LEN exported through `torch.export` on
each attention backend: its graph holds the kernels' op nodes and runs bit
for bit as the eager UNet on the CPU, handing K2 views of the same strides.
The same export on the card is `test_exported_unet_launches_the_kernels`
in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from torch.library import opcheck

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.io import init_flax_defaults
from stable_virtual_camera_tpu_torch.models.unet import FLASH_MIN_LEN, SevaUNet
from stable_virtual_camera_tpu_torch.ops import flash_attention as fa
from stable_virtual_camera_tpu_torch.ops import flash_attention_packed as fap
from stable_virtual_camera_tpu_torch.ops import flash_upstream as fu
from stable_virtual_camera_tpu_torch.ops import time_attention as ta

# one level at 32x32 latents: per-frame self-attention at L = 1024 and a
# joint middle block at L = 2 * 1024, two heads of 64 (W = 128, K4's rule)
SPEC = SevaSpec(model_channels=128, num_frames=2, num_head_channels=64, context_dim=64,
                channel_mult=(1,), transformer_depth=(1,), attention_resolutions=(1,),
                num_res_blocks=1, unflatten_names=("middle_ds1",))
HW = 32
OPS = {"upstream": {"svc.flash_attention.default", "svc.time_attention.default"},
       "flash": {"svc.flash_attention_blhd.default", "svc.time_attention.default"},
       "packed": {"svc.flash_attention_packed.default", "svc.time_attention.default"},
       "plain": set()}


def _t(rng, *shape, grad=False):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).requires_grad_(grad)


def _op_cases():
    rng = np.random.default_rng(0)
    bhld = [_t(rng, 1, 2, 40, 64, grad=True) for _ in range(3)]
    plain = [t.detach() for t in bhld]
    o, lse = fu.flash_attention_op(*plain, True)
    # K2's (b*T, H, 64, S) views of one projection, as the UNet's GEMM writes them
    time_views = [t.detach().requires_grad_() for t in _t(rng, 4, 3, 2, 64, 16).unbind(1)]
    split = _t(rng, 1, 40, 3 * 128).chunk(3, dim=-1)
    return {
        "k1_lse": (fu.flash_attention_op, (*bhld, True)),
        "k1": (fu.flash_attention_op, (*plain, False)),
        "k1_bwd": (fu.flash_attention_bwd_op, (*plain, o, lse, _t(rng, 1, 2, 40, 64))),
        "k2": (ta.time_attention_op, (*time_views, 2)),
        "k3": (fa.flash_attention_op, tuple(t.reshape(1, 40, 2, 64).detach().requires_grad_() for t in split)),
        "k4": (fap.flash_attention_packed_op, (*split, 2)),  # no gradient: no VJP, as in JAX
    }


@pytest.mark.parametrize("name", ["k1_lse", "k1", "k1_bwd", "k2", "k3", "k4"])
def test_ops_pass_opcheck(name):
    op, args = _op_cases()[name]
    opcheck(op, args)


def _unet_and_inputs(attention):
    unet = init_flax_defaults(SevaUNet(SPEC, attention=attention), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    n = 2 * SPEC.num_frames
    return unet, (_t(rng, n, HW, HW, SPEC.in_channels), torch.full((n,), 500), _t(rng, n, 1, SPEC.context_dim),
                  _t(rng, n, HW, HW, SPEC.dense_in_channels), SPEC.num_frames)


def _time_views(monkeypatch):
    """Record the layout of every view K2's CPU registration is handed."""
    seen = []
    plain = ta.time_attention_plain

    def recording(q, k, v, num_frames):
        seen.append([(tuple(t.shape), t.stride(), t.storage_offset()) for t in (q, k, v)])
        return plain(q, k, v, num_frames)

    monkeypatch.setattr(ta, "time_attention_plain", recording)
    return seen


@pytest.mark.parametrize("attention", sorted(OPS))
def test_exported_unet_holds_the_kernel_ops(attention, monkeypatch):
    assert HW * HW >= FLASH_MIN_LEN
    unet, args = _unet_and_inputs(attention)
    with torch.no_grad():
        ep = torch.export.export(unet, args)
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert {t for t in targets if t.startswith("svc.")} == OPS[attention]
    # serving writes no log-sum-exp
    assert all(n.args[3] is False for n in ep.graph.nodes if str(n.target) == "svc.flash_attention.default")
    seen = _time_views(monkeypatch)
    with torch.inference_mode():
        eager = unet(*args)
        n_eager = len(seen)
        exported = ep.module()(*args)
    assert torch.equal(eager, exported)
    # the "plain" backend calls no op, so K2's registration sees nothing
    assert (n_eager > 0) == bool(OPS[attention]) and seen[:n_eager] == seen[n_eager:]
