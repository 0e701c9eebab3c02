"""The port's view-sharded and FSDP train steps against the JAX package's
`make_sharded_train_step` and `make_fsdp_train_step`, on the CPU in fp32.

The JAX steps run on the virtual CPU devices of tests/conftest.py, the
port's ranks are threads on the repeated CPU device, with the same meshes:
(data, view) = (1, 2) for the sharded step and (2, 1) for FSDP. Both sides
start from the port's seeded init carried into the flax tree, take the same
numpy batch, and the port replays JAX's (t_idx, eps) draw. The two JAX
steps compile once, in a module-scoped fixture, at a two-level spec (every
layer kind of tests/test_torch_training.py's spec: channel-changing
ResBlocks, a downsample and an upsample, per-frame, joint and temporal
attention, at T=8), which cuts the sharded programs' compile time against
that spec's four levels (~90 and ~140 s there). Bars: JAX's own, loss rel
1e-4 and params atol 2e-3 after one AdamW step (tests/test_training.py).
That params bar passes any gradient: AdamW's first step moves a weight by
about the rate (1e-3) whatever the gradient's size. So the update itself
(params after minus before) is also held to JAX's at LR / 5, on the
elements whose gradient (the port's unsharded one) stands well clear of
the noise floor, where the update's sign is the gradient's: above 1e-5 and
above 1e-2 of its leaf's RMS. A gradient of the wrong sign there moves
the weight 2 LR away from JAX's. At least 90% of the elements qualify.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.io import init_flax_defaults
from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
from stable_virtual_camera_tpu_torch.models.weights import flax_to_state_dict, to_flax_tree
from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh
from stable_virtual_camera_tpu_torch.training.optim import AdamW
from stable_virtual_camera_tpu_torch.training.train_step import (
    TrainBatch,
    make_fsdp_train_step,
    make_loss_fn,
    make_sharded_train_step,
)
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

CPU = torch.device("cpu")
T, HW, LR = 8, 16, 1e-3
KW = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
          num_head_channels=16, transformer_depth=(1, 1), context_dim=64, num_frames=T,
          unflatten_names=("middle_ds2", "output_ds2"))
SPEC = SevaSpec(**KW)


def _jax_unet():
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet

    return JaxUNet(JaxSevaSpec(**KW), dtype=jnp.float32, param_dtype=jnp.float32, use_pallas=True)


@pytest.fixture(scope="module")
def steps():
    """The port's initial state dict and numpy batch; JAX's loss and params
    after one sharded and one FSDP step; the draw JAX's key gives."""
    from stable_virtual_camera_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from stable_virtual_camera_tpu.training.train_step import TrainBatch as JaxBatch
    from stable_virtual_camera_tpu.training.train_step import make_fsdp_train_step as jax_fsdp
    from stable_virtual_camera_tpu.training.train_step import make_sharded_train_step as jax_sharded

    unet = init_flax_defaults(SevaUNet(SPEC), torch.Generator().manual_seed(0))
    z = jnp.zeros
    like = jax.eval_shape(lambda: _jax_unet().init(
        jax.random.PRNGKey(0), z((T, HW, HW, 11)), z((T,), jnp.int32), z((T, 1, 64)),
        z((T, HW, HW, 6)), num_frames=T,
    ))["params"]
    params = to_flax_tree(unet, like)
    rng = np.random.default_rng(1)
    concat = (rng.normal(size=(T, HW, HW, 7)) * 0.1).astype(np.float32)
    batch = TrainBatch(
        latents=rng.normal(size=(T, HW, HW, 4)).astype(np.float32),
        concat=concat,
        crossattn=(rng.normal(size=(T, 1, 64)) * 0.1).astype(np.float32),
        dense=concat[..., 1:].copy(),
        loss_mask=np.array([0.0] + [1.0] * (T - 1), np.float32),
    )
    jbatch = JaxBatch(*(jnp.asarray(getattr(batch, f)) for f in
                        ("latents", "concat", "crossattn", "dense", "loss_mask")))
    key = jax.random.PRNGKey(4)
    opt = optax.adamw(LR)
    copy = lambda tree: jax.tree_util.tree_map(jnp.copy, tree)  # noqa: E731 (the steps donate)
    mesh = jax_make_mesh(n_data=1, n_view=2)
    with mesh:
        p, _, loss = jax_sharded(_jax_unet(), opt, T, mesh)(copy(params), opt.init(params), jbatch, key)
        sharded = float(loss), flax_to_state_dict(jax.device_get(p))
    mesh = jax_make_mesh(n_data=2, n_view=1)
    with mesh:
        step, init = jax_fsdp(_jax_unet(), opt, T, mesh, params)
        p, _, loss = step(*init(copy(params)), jbatch, key)
        fsdp = float(loss), flax_to_state_dict(jax.device_get(p))
    t_key, eps_key = jax.random.split(key)
    t_idx = int(jax.random.randint(t_key, (), 0, 1000))
    eps = np.asarray(jax.random.normal(eps_key, batch.latents.shape, jnp.float32))
    state = {k: v.clone() for k, v in unet.state_dict().items()}
    return state, batch, {"sharded": sharded, "fsdp": fsdp}, t_idx, eps


@pytest.mark.parametrize("kind", ["sharded", "fsdp"])
def test_mesh_step_matches_jax(steps, kind):
    state, batch, ref, t_idx, eps = steps
    loss_ref, params_ref = ref[kind]
    unet = SevaUNet(SPEC)
    unet.load_state_dict(state)
    opt = AdamW(unet.parameters(), LR)
    draw = lambda shape: (torch.tensor(t_idx), torch.from_numpy(eps.copy()))  # noqa: E731
    if kind == "sharded":
        loss = make_sharded_train_step(unet, opt, T, make_mesh(1, 2, devices=[CPU] * 2))(
            batch.to(CPU), draw)
        params = {n: p.detach() for n, p in unet.named_parameters()}
    else:
        step, init = make_fsdp_train_step(unet, opt, T, make_mesh(2, 1, devices=[CPU] * 2))
        fsdp_state = init()
        loss = step(fsdp_state, batch.to(CPU), draw)
        params = fsdp_state.params()
    assert loss.item() == pytest.approx(loss_ref, rel=1e-4)
    assert params.keys() == params_ref.keys()
    ref_unet = SevaUNet(SPEC)
    ref_unet.load_state_dict(state)
    make_loss_fn(ref_unet, T)(batch.to(CPU), draw).backward()
    kept = total = 0
    for name, p in ref_unet.named_parameters():
        r = params_ref[name]
        np.testing.assert_allclose(params[name].numpy(), r.numpy(), atol=2e-3, err_msg=name)
        g = torch.zeros_like(p) if p.grad is None else p.grad.abs()
        clear = (g > 1e-5) & (g > 1e-2 * g.square().mean().sqrt())
        update, update_ref = params[name] - state[name], r - state[name]
        np.testing.assert_allclose(update[clear].numpy(), update_ref[clear].numpy(), atol=LR / 5,
                                   err_msg=name)
        kept, total = kept + int(clear.sum()), total + g.numel()
    assert kept >= 0.9 * total
