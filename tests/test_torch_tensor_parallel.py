"""Tensor parallelism over a "model" mesh axis (parallel/param_sharding.py,
parallel/tensor_parallel.py, `make_mesh_tp`, `Comm.all_reduce`,
`make_tensor_parallel_sampler`) against the JAX package on the CPU, fp32.

Held here: `partition_spec` against JAX's over a grid of shapes; the port's
specs, in its own layout, name the logical dimension JAX's
`tree_partition_specs` names on the flax tree, leaf for leaf, at tiny width
and at full width (`meta` tensors: 1018 of 1018 leaves sharded at n = 2,
1017 at n = 4); a rank's shard module holds at most 0.51 of the UNet's
bytes at n = 2; `all_reduce` gives every rank the same bits, the rank-order
sum, whatever order the ranks arrive in; the 3-D mesh; the tensor-parallel
UNet forward on CPU thread ranks at (data, view, model) = (1, 1, 2),
(1, 1, 4) and (1, 2, 2) against the port's unsharded forward (1e-5 of the
output's scale) and JAX's (2e-4), with the model ranks bit-equal; the
tensor-parallel sampler at (1, 2, 2) against JAX's unsharded
`euler_edm_sample` at the bar of JAX's
tests/test_parallel.py::test_tensor_parallel_sampler_matches_unsharded
(atol 5e-4, rtol 1e-3); W8A8 under tensor parallelism (both modes): every
quantized layer kind, input- and output-sharded, bit-equal to the unsharded
layer on thread ranks, the static sites' int8 weights and scales cut as the
weights are, the tiny UNet's (1, 1, 2) forward against the unsharded W8A8
forward at the TP bar with the model ranks bit-equal, and the CLI's
--quant w8a8 with --mesh_model 2 on the tiny model.
"""

import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
from stable_virtual_camera_tpu_torch.parallel import comm as pcomm
from stable_virtual_camera_tpu_torch.parallel import param_sharding as ps
from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh, make_mesh_tp
from stable_virtual_camera_tpu_torch.parallel.sharding import frames_of, make_tensor_parallel_sampler
from stable_virtual_camera_tpu_torch.parallel import tensor_parallel as tp
from stable_virtual_camera_tpu_torch.parallel.tensor_parallel import shard_unet
from stable_virtual_camera_tpu_torch.sampling import sampler as t_sampler
from stable_virtual_camera_tpu_torch.sampling.discretization import DDPMDiscretization
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_sampler import _step_keys

CPU = torch.device("cpu")
T, HW, STEPS = 4, 8, 2
# the forward and sampler tests' UNet: every layer kind of the tiny spec (a
# downsample and an upsample, channel-changing ResBlocks, per-frame and
# joint attention, the temporal mix) at two levels, which halves JAX's
# compile time against SevaSpec.tiny()
SPEC = SevaSpec(model_channels=32, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                num_head_channels=16, transformer_depth=(1, 1), context_dim=64,
                unflatten_names=("middle_ds2", "output_ds2"))


def cpu_mesh_tp(n_data, n_view, n_model):
    return make_mesh_tp(n_data, n_view, n_model, devices=[CPU] * (n_data * n_view * n_model))


def assert_close_to_scale(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale, err = np.abs(ref).max(), np.abs(out - ref).max()
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _jax_tree(spec):
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet

    jspec = JaxSpec(**{f: getattr(spec, f) for f in spec.__dataclass_fields__})
    unet, z = JaxUNet(jspec), jnp.zeros
    tree = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(0), z((T, HW, HW, 11)), z((T,), jnp.int32),
                                            z((T, 1, spec.context_dim)), z((T, HW, HW, 6)), num_frames=T))
    return unet, tree["params"]


# --------------------------------------------------------------------------
# the sharding rule
# --------------------------------------------------------------------------


def test_partition_spec_matches_jax():
    from stable_virtual_camera_tpu.parallel.param_sharding import partition_spec as jax_spec

    shapes = [(), (4,), (6,), (320,), (320, 320), (1280, 320), (320, 1280), (3, 3, 640, 320),
              (3, 3, 11, 320), (3, 3, 320, 4), (1, 1, 6, 640), (2, 6, 6), (7, 9), (8, 8, 8)]
    for shape in shapes:
        for n in (1, 2, 3, 4, 8):
            for min_size in (1, 2, 4):
                ref = tuple(jax_spec(shape, n, "model", min_size))
                assert ps.partition_spec(shape, n, "model", min_size) == ref, (shape, n, min_size)


def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _in_flax_order(spec, rank):
    """A port-layout spec in the flax layout, written out: nn.Linear (out,
    in) is the dense kernel (in, out), Conv2d OIHW the conv kernel HWIO."""
    if not spec or rank not in (2, 4):
        return spec
    return spec[::-1] if rank == 2 else (spec[2], spec[3], spec[1], spec[0])


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_specs_name_the_dims_jax_names_leaf_for_leaf(width):
    """The port's specs (its layout) against JAX's `tree_partition_specs`
    on the flax tree of the same model, at n = 2 and 4; at full width, on
    `meta` tensors, JAX's counts: 1018 / 1017 leaves sharded, of them 650
    one-dimensional, 202 dense kernels on out and 78 on in, 63 conv kernels
    on O and 25 on I. A rank's shard module holds <= 0.51 of the bytes at
    n = 2 (the one-dimensional leaves stay whole on every rank)."""
    from stable_virtual_camera_tpu.parallel.mesh import make_mesh_tp as jax_mesh_tp
    from stable_virtual_camera_tpu.parallel.param_sharding import tree_partition_specs as jax_specs

    spec = SevaSpec.tiny() if width == "tiny" else SevaSpec()
    with torch.device("meta"):
        unet = SevaUNet(spec)
    params = dict(unet.named_parameters())
    _, tree = _jax_tree(spec)
    for n in (2, 4):
        jspecs = dict(_flax_leaves(jax_specs(tree, jax_mesh_tp(1, 1, n, devices=jax.devices()[:n]), "model")))
        ours = ps.tree_partition_specs(unet, n)
        names = {".".join(path[:-1] + ({"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1]),)): path
                 for path in jspecs}
        assert set(names) == set(ours)
        for name, path in names.items():
            assert _in_flax_order(ours[name], params[name].dim()) == tuple(jspecs[path]), name
        if width == "full":
            kinds = {}
            for name, s in ours.items():
                d = ps.sharded_dim(s)
                if d is not None:
                    key = (params[name].dim(), d)
                    kinds[key] = kinds.get(key, 0) + 1
            assert sum(kinds.values()) == {2: 1018, 4: 1017}[n]
            assert kinds == {(1, 0): {2: 650, 4: 649}[n], (2, 0): 202, (2, 1): 78, (4, 0): 63, (4, 1): 25}
    if width == "full":
        total = sum(p.numel() for p in params.values())
        shard = shard_unet(unet, 0, 2, "meta")
        assert sum(p.numel() for p in shard.parameters()) <= 0.51 * total
        cut = ps.shard_tree(unet, 1, 2)
        assert all(cut[k].shape[d] * 2 == params[k].shape[d] for k, (d, _) in
                   ((k, v) for k, v in ps.tree_shardings(unet, 2).items() if v is not None))


# --------------------------------------------------------------------------
# the mesh and the reduction
# --------------------------------------------------------------------------


def test_make_mesh_tp_grid_and_refusals():
    mesh = cpu_mesh_tp(2, 3, 2)
    assert mesh.shape == {"data": 2, "view": 3, "model": 2} and mesh.size == 12 and mesh.n_model == 2
    assert [mesh.coords(r) for r in range(12)] == [(d, v, m) for d in range(2) for v in range(3)
                                                   for m in range(2)]
    assert all(mesh.rank(*mesh.coords(r)) == r for r in range(12))
    assert make_mesh_tp(1, 2, devices=[CPU] * 7).shape == {"data": 1, "view": 2, "model": 3}
    assert make_mesh(2, 3, devices=[CPU] * 6).shape == {"data": 2, "view": 3}  # 2-D meshes as before
    with pytest.raises(ValueError, match="needs more than 4 devices"):
        make_mesh_tp(1, 2, 3, devices=[CPU] * 4)
    outs = pcomm.run_ranks(mesh, lambda ctx: (ctx.data, ctx.view, ctx.model, ctx.comm.size,
                                              ctx.model_comm.size, ctx.model_comm.rank), rows=[1])
    assert outs == [(1, v, m, 3, 2, m) for v in range(3) for m in range(2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_all_reduce_gives_every_rank_the_rank_order_sum(dtype):
    """Three ranks that reach the reduction in reverse order: every rank
    holds the same bits, the fp32 sum in rank order cast once; an int32
    tensor (W8A8's partial products) the exact integer sum, at magnitudes
    an fp32 sum would round."""
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        vals = [torch.randn(64, 33, generator=g).mul(10 ** i).to(dtype) for i in range(3)]
        ref = ((vals[0].float() + vals[1].float()) + vals[2].float()).to(dtype)
    else:
        vals = [torch.randint(-2**28, 2**28, (64, 33), generator=g, dtype=dtype) for _ in range(3)]
        ref = vals[0] + vals[1] + vals[2]

    def body(ctx):
        time.sleep(0.05 * (2 - ctx.view))
        return ctx.comm.all_reduce(vals[ctx.view].clone())

    outs = pcomm.run_ranks(make_mesh(1, 3, devices=[CPU] * 3), body)
    for o in outs:
        assert o.dtype == dtype and torch.equal(o, ref)


# --------------------------------------------------------------------------
# the tensor-parallel UNet and sampler
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """A bundle of SPEC's UNet alone, the same weights in JAX, a chunk's
    inputs at T=4 and JAX's forward on them."""
    from stable_virtual_camera_tpu_torch.engine.runner import ModelBundle
    from stable_virtual_camera_tpu_torch.models import io as mio
    from stable_virtual_camera_tpu_torch.models.weights import to_flax_tree

    unet = mio._finish(mio.init_flax_defaults(SevaUNet(SPEC), torch.Generator().manual_seed(5)),
                       torch.float32, CPU)
    bundle = ModelBundle(spec=SPEC, unet=unet, vae=None, clip=None)
    jax_unet, tree = _jax_tree(SPEC)
    params = to_flax_tree(unet, tree)
    rng = np.random.default_rng(3)
    plucker = rng.normal(size=(T, HW, HW, 6)).astype(np.float32)
    inputs = (rng.normal(size=(2 * T, HW, HW, 11)).astype(np.float32), np.full((2 * T,), 7, np.int32),
              rng.normal(size=(2 * T, 1, 64)).astype(np.float32), np.concatenate([plucker, plucker]))
    jref = np.asarray(jax.jit(lambda p, *a: jax_unet.apply({"params": p}, *a, num_frames=T))(
        params, *map(jnp.asarray, inputs)))
    return bundle, jax_unet, params, inputs, jref


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 1, 4), (1, 2, 2)])
def test_tensor_parallel_forward_matches_unsharded_and_jax(tiny, shape):
    bundle, _, _, inputs, jref = tiny
    x, t, c, d = (torch.from_numpy(a) for a in inputs)
    with torch.inference_mode():
        ref = bundle.unet(x, t, c, d, T)
    _, n_view, n_model = shape
    mesh = cpu_mesh_tp(*shape)
    bundle.mesh = mesh
    try:
        bundle.replicate()  # every rank's shard, once

        def rank(ctx):
            local = [frames_of(a, ctx.view, n_view, 2) for a in (x, t, c, d)]
            return bundle.module_for(ctx.device, ctx.model_comm)(
                *local, T // n_view, group=ctx.comm if n_view > 1 else None, model_group=ctx.model_comm)

        with torch.inference_mode():
            outs = pcomm.run_ranks(mesh, rank)
    finally:
        bundle.mesh = None
    assert len([key for key in bundle._shards if key[2] == n_model]) == n_model
    for v in range(n_view):
        for m in range(1, n_model):
            assert torch.equal(outs[mesh.rank(0, v, m)], outs[mesh.rank(0, v, 0)])
    full = torch.cat([outs[mesh.rank(0, v, 0)].unflatten(0, (2, T // n_view)) for v in range(n_view)], 1)
    full = full.flatten(0, 1).numpy()
    assert_close_to_scale(full, ref.numpy(), 1e-5)
    assert_close_to_scale(full, jref, 2e-4)


def test_tensor_parallel_sampler_matches_jax_unsharded(tiny):
    """Frames over view=2, weights over model=2, 2 steps with JAX's churn
    noise replayed, against JAX's unsharded scan program."""
    from stable_virtual_camera_tpu.sampling import sampler as j_sampler
    from stable_virtual_camera_tpu.sampling.discretization import DDPMDiscretization as JaxDisc

    bundle, jax_unet, params, _, _ = tiny
    rng = np.random.default_rng(11)
    plucker = rng.normal(size=(T, HW, HW, 6)).astype(np.float32)
    mask = np.zeros((T, HW, HW, 1), np.float32)
    mask[0] = 1.0
    lat = np.concatenate([rng.normal(size=(T, HW, HW, 4)), np.ones((T, HW, HW, 1))], -1).astype(np.float32)
    emb = rng.normal(size=(T, 1, 64)).astype(np.float32)
    c = dict(crossattn=np.concatenate([0 * emb, emb]),
             concat=np.concatenate([np.concatenate([0 * mask, plucker], -1), np.concatenate([mask, plucker], -1)]),
             dense=np.concatenate([plucker, plucker]),
             replace=np.concatenate([0 * lat, lat * mask]),
             scale=np.array([1.2, 2.0, 2.5, 1.5], np.float32))
    noise = rng.normal(size=(T, HW, HW, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    denoiser = j_sampler.UNetDenoiser(jax_unet, params)
    ref = np.asarray(denoiser.make_scan_fn(T)(
        params, jnp.asarray(noise), j_sampler.plan_as_host(j_sampler.make_sampling_plan(JaxDisc(), STEPS)),
        j_sampler.ChunkConditioning(**{k: jnp.asarray(v) for k, v in c.items()}), key))
    eps = [torch.from_numpy(np.array(jax.random.normal(k, noise.shape, jnp.float32))) for k in _step_keys(key, STEPS)]
    ticks = []
    out = make_tensor_parallel_sampler(bundle.network, cpu_mesh_tp(1, 2, 2), T)(
        torch.from_numpy(noise), t_sampler.make_sampling_plan(DDPMDiscretization(), STEPS),
        t_sampler.ChunkConditioning(**{k: torch.from_numpy(v) for k, v in c.items()}),
        lambda i: eps[i], progress_cb=lambda i, n: ticks.append(threading.current_thread().name))
    assert len(ticks) == STEPS and len(set(ticks)) == 1  # from one rank
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-3)


class _QuantLayers(torch.nn.Module):
    """One of each W8A8 layer kind, sized so the sharding rule cuts each
    one's input (in > out) or output (out >= in; the Upsample's square
    kernel goes to its output, as ties do)."""

    def __init__(self):
        from stable_virtual_camera_tpu_torch.models.unet import QuantConv, QuantLinear, Upsample

        super().__init__()
        self.linear_in = QuantLinear(64, 24)
        self.linear_out = QuantLinear(24, 64)
        self.conv_in = QuantConv(64, 24, 3)
        self.conv_out = QuantConv(24, 64, 3, stride=2)
        self.upsample = Upsample(32)


_LAYER_INPUTS = {"linear_in": (7, 5, 64), "linear_out": (9, 24), "conv_in": (2, 6, 6, 64),
                 "conv_out": (2, 8, 8, 24), "upsample": (2, 4, 4, 32)}
_LAYER_CUTS = {"linear_in": 1, "linear_out": 0, "conv_in": 1, "conv_out": 0, "upsample": 0}


def _quantized_layers(mode):
    g = torch.Generator().manual_seed(1)
    layers = _QuantLayers().to(memory_format=torch.channels_last)
    with torch.no_grad():
        for p in layers.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    xs = {name: torch.randn(shape, generator=g) for name, shape in _LAYER_INPUTS.items()}
    for name, layer in layers.named_children():
        if mode == "w8a8-static":  # each site calibrated on its own input
            layer.set_quant("w8a8-calib")
            with torch.no_grad():
                layer(xs[name])
        layer.set_quant(mode)
    return layers, xs


@pytest.mark.parametrize("mode", ["w8a8", "w8a8-static"])
def test_w8a8_layers_under_tensor_parallelism_are_bit_equal(mode):
    """Every W8A8 layer kind on its shards over (1, 1, 2) thread ranks:
    output-sharded layers quantize x whole and gather their channels,
    input-sharded ones multiply their slice with the whole weight's scales
    and all-reduce the int32 partial products, so each rank's output is the
    unsharded layer's, bit for bit."""
    layers, xs = _quantized_layers(mode)
    with torch.no_grad():
        ref = {name: layer(xs[name]) for name, layer in layers.named_children()}
    shards = [shard_unet(layers, r, 2, CPU) for r in range(2)]
    assert {name: getattr(shards[0], name).sharded_layer.tp_dim for name in _LAYER_CUTS} == _LAYER_CUTS

    def rank(ctx):
        with tp.model_group(ctx.model_comm), torch.no_grad():
            return {name: getattr(shards[ctx.model], name)(xs[name]) for name in ref}

    for out in pcomm.run_ranks(cpu_mesh_tp(1, 1, 2), rank):
        for name in ref:
            assert torch.equal(out[name], ref[name]), name


def test_static_sites_are_cut_as_their_weights_are():
    """`shard_unet` cuts a static site's int8 weight along its layer's
    sharded dimension and its scales along the output where the output is
    sharded (per phase-major group of the Upsample's rearranged kernel);
    the activation abs-max stays whole; input-sharded layers carry their
    whole weight's abs-max."""
    layers, _ = _quantized_layers("w8a8-static")
    for r in range(2):
        shard = shard_unet(layers, r, 2, CPU)
        for name, cut in _LAYER_CUTS.items():
            whole, part = getattr(layers, name).site(), getattr(shard, name).site()
            assert torch.equal(part.ax, whole.ax)
            if name == "upsample":
                c = whole.wq.shape[0] // 4
                idx = torch.cat([torch.arange(p * c + r * c // 2, p * c + (r + 1) * c // 2) for p in range(4)])
                assert torch.equal(part.wq, whole.wq[idx]) and torch.equal(part.ws, whole.ws[idx])
            elif cut == 0:
                rows = whole.wq.shape[0] // 2
                assert torch.equal(part.wq, whole.wq[r * rows:(r + 1) * rows])
                assert torch.equal(part.ws, whole.ws[r * rows:(r + 1) * rows])
            else:
                cols = whole.wq.shape[1] // 2
                assert torch.equal(part.wq, whole.wq[:, r * cols:(r + 1) * cols])
                assert torch.equal(part.ws, whole.ws)
                assert torch.equal(getattr(shard, name).tp_amax.flatten(),
                                   getattr(layers, name).weight.abs().amax(dim=tuple(range(1, whole.wq.dim()))))
    layers.quant = "w8a8-calib"  # a model in its calibration pass is not sharded
    with pytest.raises(ValueError, match="calib"):
        shard_unet(layers, 0, 2, CPU)


@pytest.mark.parametrize("mode", ["w8a8", "w8a8-static"])
def test_tensor_parallel_w8a8_forward_matches_unsharded(tiny, mode):
    """The tiny UNet under W8A8 on (1, 1, 2) thread ranks against the same
    W8A8 UNet unsharded (itself held to JAX by tests/test_torch_quant.py),
    at this file's TP bar of 1e-5 of the output's scale, with the model
    ranks bit-equal. Only the unquantized input-sharded layers (fp32
    partial sums in rank order) round otherwise; every W8A8 layer computes
    the unsharded layer's bits."""
    bundle, _, _, inputs, _ = tiny
    x, t, c, d = (torch.from_numpy(a) for a in inputs)
    unet = bundle.unet
    try:
        if mode == "w8a8-static":
            unet.set_quant("w8a8-calib")
            with torch.inference_mode():
                unet(x, t, c, d, T)
        unet.set_quant(mode)
        with torch.inference_mode():
            ref = unet(x, t, c, d, T)
        mesh = cpu_mesh_tp(1, 1, 2)
        bundle.mesh = mesh
        bundle.replicate()
        with torch.inference_mode():
            outs = pcomm.run_ranks(mesh, lambda ctx: bundle.module_for(ctx.device, ctx.model_comm)(
                x, t, c, d, T, model_group=ctx.model_comm))
    finally:
        bundle.mesh = None
        unet.set_quant("0")
        unet.clear_quant_state()
        bundle._shards.clear()
    assert torch.equal(outs[0], outs[1])
    assert_close_to_scale(outs[0].numpy(), ref.numpy(), 1e-5)


def test_cli_renders_w8a8_under_tensor_parallelism(tmp_path):
    """`cli.main(..., quant="w8a8", mesh_model=2)` on the tiny model: a
    one-pass orbit render with its chunk on weight shards over 2 model
    ranks under dynamic W8A8 writes its frames."""
    import cv2

    from stable_virtual_camera_tpu_torch.apps import cli

    scene = tmp_path / "scenes" / "scene.png"
    scene.parent.mkdir()
    cv2.imwrite(str(scene), np.random.default_rng(4).integers(0, 256, (64, 64, 3), dtype=np.uint8))
    (out,) = cli.main(str(scene.parent), device="cpu", mesh_model=2, quant="w8a8", work_dir=str(tmp_path / "tp"),
                      task="img2trajvid_s-prob", random_model=True, num_steps=2, traj_prior="orbit",
                      num_targets=3, sampler_verbose=False)
    frames = sorted(glob.glob(os.path.join(out, "samples-rgb", "*.png")))
    assert len(frames) == 3 and all(cv2.imread(f).shape == (64, 64, 3) for f in frames)
