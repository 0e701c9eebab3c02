"""The port's training step (training/train_step.py, optim.py, lora.py,
checkpoint.py) against the JAX package's, on the CPU in fp32.

One whole step is held against JAX's `make_train_step` pieces at the JAX
test's spec (tests/test_training.py:23-41): the same weights (the port's
seeded init bridged into the flax tree), the same numpy batch, and JAX's
(t_idx, eps) draw replayed through the port's `draw`. The JAX step compiles
once, in a module-scoped fixture. The optimizer, schedule, gradient
accumulation and EMA are held against optax / the JAX EMA on fixed inputs;
remat, resume and LoRA against the port's own plain step.
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
from stable_virtual_camera_tpu_torch.training import lora as t_lora
from stable_virtual_camera_tpu_torch.training.checkpoint import (
    restore_train_state,
    save_train_state,
)
from stable_virtual_camera_tpu_torch.training.optim import (
    AdamW,
    MultiSteps,
    warmup_cosine_decay_schedule,
)
from stable_virtual_camera_tpu_torch.training.train_step import (
    TrainBatch,
    ema_init,
    ema_update,
    make_loss_fn,
    make_train_step,
    torch_draw,
)
from test_torch_quant import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

SPEC = SevaSpec(model_channels=32, num_frames=8, num_head_channels=16, context_dim=64)
T, HW = SPEC.num_frames, 16


def _jax_unet():
    from stable_virtual_camera_tpu.config import SevaSpec as JaxSevaSpec
    from stable_virtual_camera_tpu.models.unet import SevaUNet as JaxUNet

    spec = JaxSevaSpec(model_channels=32, num_frames=8, num_head_channels=16, context_dim=64)
    return JaxUNet(spec, dtype=jnp.float32, param_dtype=jnp.float32, use_pallas=True)


@pytest.fixture(scope="module")
def setup():
    """The port's initial weights, the same weights as a flax tree, and a
    numpy batch with frame 0 as the input view."""
    unet = init_flax_defaults(SevaUNet(SPEC), torch.Generator().manual_seed(0))
    z = jnp.zeros
    like = jax.eval_shape(lambda: _jax_unet().init(
        jax.random.PRNGKey(0), z((T, HW, HW, 11)), z((T,), jnp.int32), z((T, 1, 64)),
        z((T, HW, HW, 6)), num_frames=T,
    ))["params"]
    rng = np.random.default_rng(1)
    concat = (rng.normal(size=(T, HW, HW, 7)) * 0.1).astype(np.float32)
    batch = TrainBatch(
        latents=rng.normal(size=(T, HW, HW, 4)).astype(np.float32),
        concat=concat,
        crossattn=(rng.normal(size=(T, 1, 64)) * 0.1).astype(np.float32),
        dense=concat[..., 1:].copy(),
        loss_mask=np.array([0.0] + [1.0] * (T - 1), np.float32),
    )
    state = {k: v.clone() for k, v in unet.state_dict().items()}
    return state, to_flax_tree(unet, like), batch


def _unet(setup) -> SevaUNet:
    unet = SevaUNet(SPEC)
    unet.load_state_dict(setup[0])
    return unet


def _draw(seed: int):
    return torch_draw(torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's loss, gradients and params after one optax.adamw(1e-3) update,
    and the (t_idx, eps) its loss drew, from one compile."""
    from stable_virtual_camera_tpu.training.train_step import TrainBatch as JaxBatch
    from stable_virtual_camera_tpu.training.train_step import _make_loss_fn

    _, params, b = setup
    batch = JaxBatch(*(jnp.asarray(getattr(b, f)) for f in
                       ("latents", "concat", "crossattn", "dense", "loss_mask")))
    key = jax.random.PRNGKey(2)
    loss_fn = _make_loss_fn(_jax_unet(), T, None, False)
    opt = optax.adamw(1e-3)

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, key)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    loss, grads, new_params = jax.device_get(step(params))
    t_key, eps_key = jax.random.split(key)
    t_idx = int(jax.random.randint(t_key, (), 0, 1000))
    eps = np.asarray(jax.random.normal(eps_key, b.latents.shape, jnp.float32))
    return float(loss), flax_to_state_dict(grads), flax_to_state_dict(new_params), t_idx, eps


def test_train_step_matches_jax(setup, jax_step):
    """Loss, per-parameter gradients and the params after one AdamW step
    against JAX's value_and_grad + optax.adamw on the same weights, batch
    and draw. Parameters the loss does not reach (the norm2 of every
    transformer block) get zero gradients on both sides. A few leaves have a
    vanishing true gradient, where both sides give fp32 noise of ~1e-8:
    the per-channel time-embedding shift (emb_proj) and conv biases just
    before a GroupNorm with one channel per group (32 channels, 32 groups),
    which removes them; their rel. L2 is taken against 1e-3 of the global
    gradient norm."""
    loss_ref, grads_ref, params_ref, t_idx, eps = jax_step
    _, _, batch = setup
    draw = lambda shape: (torch.tensor(t_idx), torch.from_numpy(eps.copy()))  # noqa: E731

    unet = _unet(setup)
    loss = make_loss_fn(unet, T)(batch.to("cpu"), draw)
    loss.backward()
    assert loss.item() == pytest.approx(loss_ref, rel=1e-5)
    grads = {n: p.grad for n, p in unet.named_parameters()}
    assert grads.keys() == grads_ref.keys()
    dead = [n for n, g in grads.items() if g is None]
    assert dead and all(".norm2." in n for n in dead)
    floor = 1e-3 * torch.stack([g.norm() for g in grads_ref.values()]).norm()
    for name, ref in grads_ref.items():
        if grads[name] is None:
            assert torch.count_nonzero(ref) == 0, name
            continue
        rel = (grads[name] - ref).norm() / torch.maximum(ref.norm(), floor)
        assert rel.item() <= 1e-4, (name, rel.item(), ref.norm().item())

    unet = _unet(setup)
    step = make_train_step(unet, AdamW(unet.parameters(), 1e-3, weight_decay=1e-4), T)
    assert float(step(batch.to("cpu"), draw)) == pytest.approx(loss_ref, rel=1e-5)
    for name, p in unet.named_parameters():
        torch.testing.assert_close(p.detach(), params_ref[name], atol=2e-3, rtol=0, msg=name)


def _fixed_grads(seed: int, n: int):
    rng = np.random.default_rng(seed)
    shapes = [(3, 4), (5,), (2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    # the last parameter never gets a gradient: a dead weight
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes[:2]] + [np.zeros(shapes[2], np.float32)]
             for _ in range(n)]
    return params, grads


def _run_port(opt_factory, params, grads):
    ts = [torch.from_numpy(p.copy()) for p in params]
    opt = opt_factory(ts)
    trail = []
    for gs in grads:
        for t, g in zip(ts[:2], gs[:2]):
            t.grad = torch.from_numpy(g)
        opt.step()
        trail.append([t.clone().numpy() for t in ts])
    return trail


def _run_optax(opt, params, grads):
    ps = [jnp.asarray(p) for p in params]
    state = opt.init(ps)
    trail = []
    for gs in grads:
        updates, state = opt.update([jnp.asarray(g) for g in gs], state, ps)
        ps = optax.apply_updates(ps, updates)
        trail.append([np.asarray(p) for p in ps])
    return trail


@pytest.mark.parametrize("every_k", [1, 2])
def test_adamw_schedule_and_accumulation_match_optax(every_k):
    """AdamW under warmup-cosine (first update at lr = 0) with weight decay,
    alone and under MultiSteps(k=2), against the optax chain the JAX CLI
    builds, over a fixed gradient sequence; the dead weight (zero gradient)
    is only decayed."""
    sched_args = (0.0, 1e-2, 2, 8)
    params, grads = _fixed_grads(0, 6)

    def port(ts):
        opt = AdamW(ts, warmup_cosine_decay_schedule(*sched_args), weight_decay=1e-2)
        return MultiSteps(opt, every_k) if every_k > 1 else opt

    opt = optax.adamw(optax.warmup_cosine_decay_schedule(*sched_args), weight_decay=1e-2)
    if every_k > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=every_k)
    for i, (a, b) in enumerate(zip(_run_port(port, params, grads), _run_optax(opt, params, grads))):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=0, err_msg=f"update {i}")
    first = _run_port(port, params, grads[:1])[0]
    np.testing.assert_array_equal(first[0], params[0])  # lr = 0, or an accumulation call


def test_warmup_cosine_schedule_matches_optax():
    for args in [(0.0, 1e-3, 1, 4), (0.0, 1e-5, 100, 1000), (1e-4, 1e-3, 3, 5)]:
        ours = warmup_cosine_decay_schedule(*args)
        ref = optax.warmup_cosine_decay_schedule(*args)
        for count in range(6):
            assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12), (args, count)
    assert warmup_cosine_decay_schedule(0.0, 1e-3, 1, 4)(0) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ema_update_matches_jax(dtype):
    from stable_virtual_camera_tpu.training.train_step import ema_update as jax_ema

    rng = np.random.default_rng(4)
    e, p = (jnp.asarray(rng.normal(size=(7, 5)), dtype) for _ in range(2))
    ref = jax_ema({"w": e}, {"w": p}, 0.999)["w"]
    to_t = lambda a: torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))  # noqa: E731
    ours = {"w": to_t(e)}
    ema_update(ours, {"w": to_t(p)}, 0.999)
    np.testing.assert_array_equal(ours["w"].float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_ema_step_tracks_params(setup):
    """The EMA step leaves the raw params exactly as the plain step does,
    and the shadows equal the closed-form exponential average."""
    _, _, batch = setup
    decay = 0.5
    plain, tracked = _unet(setup), _unet(setup)
    step_p = make_train_step(plain, AdamW(plain.parameters(), 1e-3), T)
    step_e = make_train_step(tracked, AdamW(tracked.parameters(), 1e-3), T, ema_decay=decay)
    shadow = ema_init(tracked)
    expect = {n: p.detach().clone() for n, p in plain.named_parameters()}
    for seed in (7, 8):
        step_p(batch.to("cpu"), _draw(seed))
        step_e(batch.to("cpu"), _draw(seed), shadow)
        for n, p in plain.named_parameters():
            expect[n] = expect[n] * decay + p.detach() * (1 - decay)
    for (n, a), b in zip(plain.named_parameters(), tracked.parameters()):
        assert torch.equal(a, b), n
    for n, e in shadow.items():
        torch.testing.assert_close(e, expect[n], atol=1e-6, rtol=0, msg=n)
    with pytest.raises(ValueError, match="ema_params"):
        step_e(batch.to("cpu"), _draw(9))


def test_gradient_accumulation_step(setup):
    """MultiSteps(k=2) through the train step: the first micro-step leaves
    the params as they were, the second applies one update equal to the
    plain step's (the same batch and draw twice average to one gradient)."""
    _, _, batch = setup
    ref = _unet(setup)
    make_train_step(ref, AdamW(ref.parameters(), 1e-3), T)(batch.to("cpu"), _draw(4))
    acc = _unet(setup)
    step = make_train_step(acc, MultiSteps(AdamW(acc.parameters(), 1e-3), 2), T)
    step(batch.to("cpu"), _draw(4))
    for (n, p), v in zip(acc.named_parameters(), setup[0].values()):
        assert torch.equal(p.detach(), v), n
    step(batch.to("cpu"), _draw(4))
    for (n, a), b in zip(acc.named_parameters(), ref.parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=n)


def test_remat_step_matches_plain(setup):
    """Per-block rematerialisation changes memory, not numbers."""
    _, _, batch = setup
    plain, remat = _unet(setup), _unet(setup)
    l1 = make_train_step(plain, AdamW(plain.parameters(), 1e-3), T)(batch.to("cpu"), _draw(7))
    l2 = make_train_step(remat, AdamW(remat.parameters(), 1e-3), T, remat=True)(
        batch.to("cpu"), _draw(7))
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    for (n, a), b in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=n)
    assert all(not hasattr(m, "__dict__") or "forward" not in m.__dict__ for m in remat.modules())


def test_checkpoint_resume_bit_identical(setup, tmp_path):
    """Save after one step, restore into a fresh model and optimizer,
    continue: identical to an uninterrupted run (params and EMA bitwise).
    The periodic-save path is overwritten in place."""
    _, _, batch = setup
    seeds = [100, 101, 102]

    def run(unet):
        opt = AdamW(unet.parameters(), warmup_cosine_decay_schedule(0.0, 1e-3, 1, 3),
                    weight_decay=1e-2)
        return opt, make_train_step(unet, opt, T, ema_decay=0.9), ema_init(unet)

    whole = _unet(setup)
    _, step, ema = run(whole)
    for s in seeds:
        step(batch.to("cpu"), _draw(s), ema)

    first = _unet(setup)
    opt, step, ema1 = run(first)
    ckpt = str(tmp_path / "state.pt")
    save_train_state(ckpt, dict(first.named_parameters()), opt.state_dict(), step=0)
    step(batch.to("cpu"), _draw(seeds[0]), ema1)
    save_train_state(ckpt, dict(first.named_parameters()), opt.state_dict(), step=1,
                     ema_params=ema1)

    params, opt_state, n, ema_state = restore_train_state(ckpt)
    assert n == 1 and ema_state is not None
    resumed = _unet(setup)
    opt, step, ema2 = run(resumed)
    with torch.no_grad():
        for name, p in resumed.named_parameters():
            p.copy_(params[name])
            ema2[name].copy_(ema_state[name])
    opt.load_state_dict(opt_state)
    for s in seeds[1:]:
        step(batch.to("cpu"), _draw(s), ema2)
    for (name, a), b in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), name
    for name, e in ema.items():
        assert torch.equal(e, ema2[name]), name
    save_train_state(ckpt, dict(resumed.named_parameters()), opt.state_dict(), step=3)
    assert restore_train_state(ckpt)[2] == 3 and restore_train_state(ckpt)[3] is None


def test_lora_targets_and_merge_match_jax(setup):
    """The adapter target set, the zero-init identity and the merge algebra
    against the JAX package's lora.py on the same flax tree and adapters."""
    from stable_virtual_camera_tpu.training import lora as jax_lora

    _, tree, _ = setup
    unet = _unet(setup)
    paths = t_lora.lora_target_paths(unet)
    assert paths == jax_lora.lora_target_paths(tree)

    lora = t_lora.init_lora(unet, rank=4, generator=torch.Generator().manual_seed(3))
    merged = t_lora.merge_lora(unet, lora)
    params = dict(unet.named_parameters())
    for name, w in merged.items():
        assert torch.equal(w, params[name].detach()), name  # b = 0: the base exactly

    rng = np.random.default_rng(6)
    ab = {p: {"a": rng.normal(size=tuple(lora[p]["a"].shape)).astype(np.float32),
              "b": rng.normal(size=tuple(lora[p]["b"].shape)).astype(np.float32)} for p in paths}
    ref = flax_to_state_dict(jax_lora.merge_lora(tree, ab, alpha=8.0))
    ours = t_lora.merge_lora(
        unet, {p: {k: torch.from_numpy(v) for k, v in d.items()} for p, d in ab.items()}, alpha=8.0)
    assert len(ours) == len(paths)
    for name, w in ours.items():
        torch.testing.assert_close(w, ref[name], atol=1e-5, rtol=1e-5, msg=name)


def test_lora_step_trains_adapters_only(setup):
    """One LoRA step: the frozen base is bit-identical after it, every
    adapter `b` moved from zero, and the loss at step 0 is the base model's."""
    _, _, batch = setup
    unet = _unet(setup)
    base_loss = make_loss_fn(unet, T)(batch.to("cpu"), _draw(2))
    lora = t_lora.init_lora(unet, rank=4, generator=torch.Generator().manual_seed(3))
    opt = AdamW([t for ab in lora.values() for t in ab.values()], 1e-3)
    loss = t_lora.make_lora_train_step(unet, opt, T)(lora, batch.to("cpu"), _draw(2))
    assert loss.item() == pytest.approx(base_loss.item(), rel=1e-6)
    for (name, p), v in zip(unet.named_parameters(), setup[0].values()):
        assert torch.equal(p, v) and not p.requires_grad, name
    assert all(ab["b"].detach().abs().max().item() > 0 for ab in lora.values())
