"""The port's differentiable attention ops against the JAX package's, on the
CPU in fp32: K1's plain forward (with its log-sum-exp) and plain backward
through `FlashAttentionFn`, held against `jax.grad` of
`flash_attention_upstream_bhld` with the upstream Pallas kernels in
interpret mode; `TimeAttentionFn` against `jax.grad` of
`time_attention_bhds(..., interpret=True)`; K1's op differentiated through
its log-sum-exp against autograd of the plain math. Inputs are numpy-seeded.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_virtual_camera_tpu_torch.ops.flash_upstream import (
    flash_attention_bwd_plain,
    flash_attention_op,
    flash_attention_plain,
    flash_attention_upstream_bhld,
)
from stable_virtual_camera_tpu_torch.ops.time_attention import time_attention_bhds


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _port_grads(fn, inputs, do):
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, inputs, do):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("L", [300, 1100])
def test_flash_backward_matches_jax_kernels(L):
    """dq, dk, dv of K1's plain twins against the upstream TPU kernels'
    custom VJP (forward, dK/dV and dQ Pallas kernels, interpret mode), at a
    padded length (300) and past one 1024-key chunk of the plain versions
    (1100)."""
    from jax.experimental.pallas import tpu as pltpu

    from stable_virtual_camera_tpu.ops.flash_upstream import (
        flash_attention_upstream_bhld as jax_flash,
    )

    rng = np.random.default_rng(L)
    q, k, v, do = (_normal(rng, (1, 2, L, 64)) for _ in range(4))
    out, grads = _port_grads(flash_attention_upstream_bhld, (q, k, v), do)
    with pltpu.force_tpu_interpret_mode():
        ref, ref_grads = _jax_grads(jax_flash, (q, k, v), do)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=1e-4, err_msg=f"d{name}")


def test_flash_lse_matches_jax_kernel():
    """The plain forward's log-sum-exp (natural log of the scaled scores)
    against the residuals m + log(l) the upstream forward kernel saves for
    its backward."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as upstream

    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, (1, 2, 256, 64), 2.0) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        o_ref, l, m = upstream._flash_attention(
            *map(jnp.asarray, (q, k, v)), None, None, True, False, 64**-0.5,
            upstream.BlockSizes.get_default(1, 2, 256, 256, 64), False,
        )
    o, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), return_lse=True)
    assert lse.shape == (1, 2, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(m + jnp.log(l)), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)


def test_flash_backward_plain_is_chunk_invariant():
    """Chunking the plain backward over keys and queries (the ragged last
    chunk included) changes only the summation order."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(_normal(rng, (2, 1, 200, 64))) for _ in range(4))
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    whole = flash_attention_bwd_plain(q, k, v, o, lse, do, chunk=1024)
    chunked = flash_attention_bwd_plain(q, k, v, o, lse, do, chunk=48)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_flash_saves_nothing_without_grad():
    """Under inference_mode the Function runs exactly the forward: no LSE,
    no saved tensors, no graph."""
    q = torch.randn(1, 1, 70, 64)
    with torch.inference_mode():
        out = flash_attention_upstream_bhld(q, q, q)
    assert out.grad_fn is None
    torch.testing.assert_close(out, flash_attention_plain(q, q, q), atol=0, rtol=0)
    out = flash_attention_upstream_bhld(q.clone().requires_grad_(), q, q)
    assert out.grad_fn is not None


def test_time_attention_grads_match_jax():
    """TimeAttentionFn (plain forward, plain fp32 recompute backward)
    against the JAX package's custom VJP around its Pallas kernel at the
    training layout: b=2 scenes of T=21 frames, S=81 positions, H=2."""
    from stable_virtual_camera_tpu.ops.time_attention import time_attention_bhds as jax_time

    b, T, H, S = 2, 21, 2, 81
    rng = np.random.default_rng(21)
    q, k, v, do = (_normal(rng, (b * T, H, 64, S)) for _ in range(4))
    out, grads = _port_grads(lambda *t: time_attention_bhds(*t, T), (q, k, v), do)
    ref, ref_grads = _jax_grads(
        lambda *t: jax_time(*t, T, 128, True), (q, k, v), do
    )
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("through", ["lse", "o_and_lse"])
def test_flash_op_gradient_through_the_lse_matches_autograd(through):
    """A loss on K1's log-sum-exp (alone, and with one on o) against autograd
    of softmax(q k^T / 8) v and logsumexp(q k^T / 8) in float64: the
    gradient on the LSE folds into the backward's delta (D - dlse)."""
    rng = np.random.default_rng(11)
    q, k, v, wo = (_normal(rng, (2, 3, 90, 64)) for _ in range(4))
    wl = _normal(rng, (2, 3, 90))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention_op(*ts, True)
    loss = (lse * torch.from_numpy(wl)).sum()
    if through == "o_and_lse":
        loss = loss + (o * torch.from_numpy(wo)).sum()
    loss.backward()
    refs = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    s = refs[0] @ refs[1].transpose(-1, -2) / 8.0
    ref_loss = (torch.logsumexp(s, -1) * torch.from_numpy(wl).double()).sum()
    if through == "o_and_lse":
        ref_loss = ref_loss + ((torch.softmax(s, -1) @ refs[2]) * torch.from_numpy(wo).double()).sum()
    ref_loss.backward()
    for name, t, r in zip("qkv", ts, refs):
        ref = torch.zeros_like(r) if r.grad is None else r.grad  # v does not reach the LSE
        scale = ref.abs().max().item()
        err = (t.grad.double() - ref).abs().max().item()
        assert err <= 1e-5 * max(scale, 1.0), f"d{name}: {err} (scale {scale})"
    assert ts[0].grad.norm() > 0
