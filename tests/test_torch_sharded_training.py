"""The port's sharded training (training/train_step.py: the view-sharded
and FSDP steps; parallel/comm.py's join nodes and rematerialisation replay;
parallel/ring_attention.py's backward) against the port's unsharded step,
on the CPU in fp32.

The ranks are threads on the repeated CPU device, at tests/test_torch_
training.py's spec (T=8, 16x16 latents), the same weights, batch and draw
on both sides. Bars: loss rel 1e-5, gradients rel L2 1e-4 per leaf (against
1e-3 of the global norm where a leaf's true gradient vanishes, as
test_torch_training.py explains), params atol 2e-3 after one AdamW step
(Adam's first step moves a near-zero gradient by the whole learning rate
whatever its sign). The replicas of the view-sharded step stay bit-equal.
The guard (no collective waits inside the autograd engine) is held by
running the sharded step with remat, whose recomputes replay the exchanges.
JAX's sharded and FSDP steps are held in
tests/test_torch_sharded_training_jax.py, the train CLI's mesh in
tests/test_torch_train_cli_mesh.py.
"""

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu_torch.parallel import comm as pcomm
from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh
from stable_virtual_camera_tpu_torch.parallel.ring_attention import ring_attention
from stable_virtual_camera_tpu_torch.training.checkpoint import restore_train_state, save_train_state
from stable_virtual_camera_tpu_torch.training.optim import AdamW
from stable_virtual_camera_tpu_torch.training.train_step import (
    ema_init,
    ema_update,
    make_fsdp_train_step,
    make_loss_fn,
    make_sharded_train_step,
    make_train_step,
    make_train_step_ema,
)
from stable_virtual_camera_tpu_torch.config import SevaSpec
from stable_virtual_camera_tpu_torch.models.io import init_flax_defaults
from stable_virtual_camera_tpu_torch.models.unet import SevaUNet
from stable_virtual_camera_tpu_torch.training.train_step import TrainBatch
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

SPEC = SevaSpec(model_channels=32, num_frames=8, num_head_channels=16, context_dim=64)
T, HW = SPEC.num_frames, 16
CPU = torch.device("cpu")
LR, DECAY = 1e-3, 0.9
VARIANTS = {"plain": (None, False), "ema_remat": (DECAY, True)}


def cpu_mesh(n_data, n_view):
    return make_mesh(n_data, n_view, devices=[CPU] * (n_data * n_view))


def _draw(seed=3):
    eps = torch.from_numpy(np.random.default_rng(seed).normal(size=(T, HW, HW, 4)).astype(np.float32))
    return lambda shape: (torch.tensor(321 + seed), eps)


@pytest.fixture(scope="module")
def setup():
    """The seeded initial weights (a state dict) and a batch with frame 0 as
    the input view, as tests/test_torch_training.py makes them."""
    unet = init_flax_defaults(SevaUNet(SPEC), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    concat = (rng.normal(size=(T, HW, HW, 7)) * 0.1).astype(np.float32)
    batch = TrainBatch(
        latents=rng.normal(size=(T, HW, HW, 4)).astype(np.float32),
        concat=concat,
        crossattn=(rng.normal(size=(T, 1, 64)) * 0.1).astype(np.float32),
        dense=concat[..., 1:].copy(),
        loss_mask=np.array([0.0] + [1.0] * (T - 1), np.float32),
    )
    return {k: v.clone() for k, v in unet.state_dict().items()}, batch


def _unet(setup) -> SevaUNet:
    unet = SevaUNet(SPEC)
    unet.load_state_dict(setup[0])
    return unet


def _batch(setup):
    return setup[1].to(CPU)


@pytest.fixture(scope="module")
def reference(setup):
    """The port's unsharded loss and gradients on `_draw()`, and the params
    and EMA (decay DECAY) after one AdamW step. Remat changes no number
    (test_torch_training.py::test_remat_step_matches_plain), so every
    variant is held to this one step."""
    unet = _unet(setup)
    ema = ema_init(unet)
    loss = make_loss_fn(unet, T)(_batch(setup), _draw())
    loss.backward()
    grads = {n: p.grad.clone() for n, p in unet.named_parameters() if p.grad is not None}
    AdamW(unet.parameters(), LR).step()
    ema_update(ema, dict(unet.named_parameters()), DECAY)
    return loss.item(), grads, {n: p.detach() for n, p in unet.named_parameters()}, ema


def _assert_grads_close(grads, ref):
    floor = 1e-3 * torch.stack([g.norm() for g in ref.values()]).norm()
    for name, r in ref.items():
        err = (grads[name] - r).norm() / torch.maximum(r.norm(), floor)
        assert err <= 1e-4, f"{name}: grad rel L2 {err.item():.3g}"


def _assert_params_close(params, ref, atol=2e-3):
    for name, r in ref.items():
        np.testing.assert_allclose(params[name].numpy(), r.numpy(), atol=atol, err_msg=name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_step_matches_the_unsharded_step(setup, reference, variant):
    """(1, 2) view mesh: the loss, the summed gradients, the params and EMA
    after one step against the unsharded step's; the two replicas' params
    and EMA bit-equal."""
    ema_decay, remat = VARIANTS[variant]
    draw = _draw()
    loss_ref, grads_ref, params_ref, ema_ref = reference
    unet = _unet(setup)
    ema = ema_init(unet) if ema_decay is not None else None
    step = make_sharded_train_step(unet, AdamW(unet.parameters(), LR), T, cpu_mesh(1, 2),
                                   remat=remat, ema_decay=ema_decay)
    loss = step.loss_and_grads(_batch(setup), draw, ema)
    assert loss.item() == pytest.approx(loss_ref, rel=1e-5)
    _assert_grads_close({n: p.grad for n, p in unet.named_parameters()}, grads_ref)
    step.apply()
    _assert_params_close({n: p.detach() for n, p in unet.named_parameters()}, params_ref)
    if ema is not None:
        _assert_params_close(ema, ema_ref)
    other = step.replicas[1]
    for name, p in unet.named_parameters():
        assert torch.equal(p, other.params[name]), name
        if ema is not None:
            assert torch.equal(ema[name], other.ema[name]), name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fsdp_step_matches_the_unsharded_step(setup, reference, variant):
    """(2, 2) mesh (the frames over "view" too), and (2, 1) with EMA and
    remat: every leaf cut over "data" by JAX's rule; each rank's shard
    gradient is its own cut of the whole gradient it computed (the batch is
    replicated, so the whole gradient once); loss, gradients, params and
    EMA against the unsharded step's; a rank keeps half the state."""
    ema_decay, remat = VARIANTS[variant]
    draw = _draw()
    loss_ref, grads_ref, params_ref, ema_ref = reference
    unet = _unet(setup)
    opt = AdamW(unet.parameters(), LR)
    mesh = cpu_mesh(2, 2) if variant == "plain" else cpu_mesh(2, 1)
    step, init = make_fsdp_train_step(unet, opt, T, mesh, remat=remat, ema_decay=ema_decay)
    state = init(ema_init(unet) if ema_decay is not None else None)
    loss = step.loss_and_grads(state, _batch(setup), draw)
    assert loss.item() == pytest.approx(loss_ref, rel=1e-5)
    grads = state._whole([{n: t.grad for n, t in st.params.items()} for st in state._rows()])
    _assert_grads_close(grads, grads_ref)
    step.apply(state)
    _assert_params_close(state.params(), params_ref)
    if ema_decay is not None:
        _assert_params_close(state.ema(), ema_ref)
    whole = sum(p.numel() * p.element_size() for p in unet.parameters()) * (4 if ema_decay else 3)
    share = state.persistent_bytes(0) / whole
    assert 0.49 < share < 0.51, share


def test_fsdp_gathers_each_weight_with_the_module_strides(setup):
    """cuDNN picks its algorithm by a weight's strides, those of size-1 dims
    too: a 1x1 conv's (O, 6, 1, 1) weight has strides (6, 1, 6, 6)
    channels_last and (6, 1, 1, 1) contiguous. While FSDP gathered every
    weight contiguous, its gradient on an H100 differed from the unsharded
    step's in 17 such leaves (PERF.md). So each gathered weight takes the
    module's strides, here with the convs' weights channels_last as
    models/io lays them out, and the module's values."""
    unet = _unet(setup).to(memory_format=torch.channels_last)
    step, init = make_fsdp_train_step(unet, AdamW(unet.parameters(), LR), T, cpu_mesh(2, 1))
    state = init()
    gathered = pcomm.run_ranks(step.mesh, lambda ctx: step._gather(ctx, state.ranks[ctx.rank]))
    own = dict(unet.named_parameters())
    assert any(p.stride() != torch.empty(p.shape, device="meta").stride() for p in own.values())
    for weights in gathered:
        for name, w in weights.items():
            assert w.stride() == own[name].stride(), name
            assert torch.equal(w, own[name].detach()), name


def test_make_train_step_ema_is_the_ema_step(setup):
    draw = _draw()
    unets = [_unet(setup), _unet(setup)]
    emas = [ema_init(u) for u in unets]
    make_train_step_ema(unets[0], AdamW(unets[0].parameters(), LR), T, ema_decay=DECAY)(
        _batch(setup), draw, emas[0])
    make_train_step(unets[1], AdamW(unets[1].parameters(), LR), T, ema_decay=DECAY)(
        _batch(setup), draw, emas[1])
    for name, e in emas[0].items():
        assert torch.equal(e, emas[1][name])


def test_remat_replays_exchanges_and_no_collective_waits_in_the_engine(setup, monkeypatch):
    """The sharded step with remat: every exchange of a recomputed block is
    replayed (none recomputed), and no collective is ever entered inside a
    backward (the guard in Comm raises there; it never trips)."""
    replayed, waits_in_backward = [], []
    replay, wait = pcomm.RematRecord.replay, pcomm.Comm._wait

    def counting_replay(self):
        out = replay(self)
        if out is not None:
            replayed.append(len(out))
        return out

    def watching_wait(self, what):
        if torch._C._current_graph_task_id() != -1:
            waits_in_backward.append(what)
        return wait(self, what)

    monkeypatch.setattr(pcomm.RematRecord, "replay", counting_replay)
    monkeypatch.setattr(pcomm.Comm, "_wait", watching_wait)
    unet = _unet(setup)
    step = make_sharded_train_step(unet, AdamW(unet.parameters(), LR), T, cpu_mesh(1, 2), remat=True)
    assert torch.isfinite(step(_batch(setup), _draw()))
    assert replayed and not waits_in_backward


def test_a_collective_inside_a_backward_raises():
    """A backward node that waits for the other ranks would wait in the
    engine's device thread behind their nodes: Comm refuses it."""

    class Waits(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, comm):
            ctx.comm = comm
            return x * 2

        @staticmethod
        def backward(ctx, g):
            ctx.comm.barrier()
            return g * 2, None

    def body(ctx):
        x = torch.ones(3, requires_grad=True)
        Waits.apply(x, ctx.comm).sum().backward()

    with pytest.raises(RuntimeError, match="inside an autograd backward"):
        pcomm.run_ranks(cpu_mesh(1, 2), body, timeout=30.0)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kernel", [True, False])
def test_ring_backward_matches_autograd_of_plain_attention(n, kernel):
    """The ring's join node (every (i, j) block through K1-dQ/K1-dKV's plain
    versions on the CPU, with the global lse and delta) against float64
    autograd of softmax(q k^T / 8) v over the whole sequence."""
    rng = np.random.default_rng(n)
    B, H, L = 1, 2, 12 * n
    q, k, v, w = (rng.normal(size=(B, H, L, 64)).astype(np.float32) for _ in range(4))
    Ll = L // n
    leaves = [[torch.from_numpy(x[:, :, r * Ll:(r + 1) * Ll].copy()).requires_grad_() for r in range(n)]
              for x in (q, k, v)]

    def body(ctx):
        r = ctx.view
        o = ring_attention(*(t[r] * 1.0 for t in leaves), ctx.comm, kernel)
        return (o * torch.from_numpy(w[:, :, r * Ll:(r + 1) * Ll])).sum()

    torch.autograd.backward(pcomm.run_ranks(cpu_mesh(1, n), body, timeout=30.0))
    refs = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    o = torch.softmax(refs[0] @ refs[1].transpose(-1, -2) / 8.0, -1) @ refs[2]
    (o * torch.from_numpy(w).double()).sum().backward()
    for name, shards, r in zip("qkv", leaves, refs):
        got = torch.cat([t.grad for t in shards], dim=2).double()
        assert (got - r.grad).abs().max().item() <= 1e-5 * max(r.grad.abs().max().item(), 1.0), name


def test_all_to_all_backward_is_the_inverse_all_to_all():
    """Rank r's output piece j came from rank j's input piece r: its
    gradient goes back there."""
    n = 3
    w = torch.randn(n, n, 4, generator=torch.Generator().manual_seed(0))  # [receiver][sender]
    inputs = [[torch.randn(4, requires_grad=True) for _ in range(n)] for _ in range(n)]  # [sender][receiver]

    def body(ctx):
        r = ctx.comm.rank
        out = ctx.comm.all_to_all([p * 1.0 for p in inputs[r]])
        return sum((o * w[r, j]).sum() for j, o in enumerate(out))

    torch.autograd.backward(pcomm.run_ranks(cpu_mesh(1, n), body, timeout=30.0))
    for s in range(n):
        for r in range(n):
            assert torch.equal(inputs[s][r].grad, w[r, s])


def test_checkpoints_hold_the_whole_state_across_sharding(setup, tmp_path):
    """One FSDP step's state saved whole (today's format) loads into the
    unsharded module and AdamW bit for bit, and an FSDP state cut from that
    unsharded state holds the same whole state again: a sharded run resumes
    unsharded and the other way round (tests/test_torch_train_cli_mesh.py
    trains on after such resumes)."""
    unet = _unet(setup)
    step, init = make_fsdp_train_step(unet, AdamW(unet.parameters(), LR), T, cpu_mesh(2, 1))
    state = init()
    step(state, _batch(setup), _draw(3))
    path = str(tmp_path / "state.pt")
    save_train_state(path, state.params(), state.optimizer_state(), 1)

    params, opt_state, n, _ = restore_train_state(path)
    resumed = _unet(setup)
    with torch.no_grad():
        for name, p in resumed.named_parameters():
            p.copy_(params[name])
    opt = AdamW(resumed.parameters(), LR)
    opt.load_state_dict(opt_state)
    assert n == 1 and opt.state_dict()["schedule"]["last_epoch"] == 1
    moments = opt.state_dict()["adamw"]["state"]
    for i, entry in opt_state["adamw"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments[i][key], entry[key]), (i, key)

    _, init2 = make_fsdp_train_step(resumed, opt, T, cpu_mesh(2, 1))
    state2 = init2()
    whole = state2.optimizer_state()
    for i, entry in opt_state["adamw"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(whole["adamw"]["state"][i][key], entry[key]), (i, key)
    for name, t in state2.params().items():
        assert torch.equal(t, params[name]), name
