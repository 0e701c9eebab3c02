"""The port's global alignment (core/global_alignment.py) against the JAX
package's, on the CPU.

The synthetic scenes are those of tests/test_global_alignment.py: known
cameras on an arc, smooth depth, every edge with its own scale and per-pixel
confidences. The host initialization must equal JAX's to 1e-10 (the same
numpy code); the torch Adam refinement must follow the optax scan (after 60
steps: loss rtol 1e-3, camera centers atol 5e-3, focal rtol 1e-3, the bars
the JAX package holds its sharded aligner to) and recover the scene at the
JAX test's tolerances. The edge-sharded refinement (`mesh=`, thread ranks
on the repeated CPU) is held to JAX's on `make_mesh(4, 2)` at those bars.
"""

import numpy as np
import pytest
import torch

from stable_virtual_camera_tpu.core import global_alignment as jax_ga
from stable_virtual_camera_tpu_torch.core import global_alignment as ga
from test_global_alignment import _align_to_gt, _lookat_c2w, _make_scene
from test_torch_dust3r import _few_threads  # noqa: F401 (autouse)



def _port_edges(edges):
    return ga.EdgePreds(**{f: getattr(edges, f) for f in
                           ("i_idx", "j_idx", "pts1", "conf1", "pts2", "conf2", "img_whs")})


@pytest.mark.parametrize("same_focals", [True, False])
def test_initialization_equals_jax(same_focals):
    edges, _ = _make_scene(N=4, noise=0.01, seed=3)
    ref = jax_ga._initialize(edges, same_focals)
    out = ga._initialize(_port_edges(edges), same_focals)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_sixty_steps_follow_the_optax_scan(schedule):
    """Seed 7 (the JAX sharded test's noise 0.005): both sides end within
    ~1e-6 of each other. Not seed 6: its init has a translation gradient of
    ~1e-5 that fp32 rounding (of the same size on both sides, against a
    float64 recompute) gives either sign, and Adam's first step moves it by
    the full learning rate whatever its size, so the two runs part at step
    one (by ~0.4% in loss after 60 steps)."""
    edges, _ = _make_scene(N=4, noise=0.005, seed=7)
    ref = jax_ga.global_align(edges, niter=60, lr=0.01, schedule=schedule)
    out = ga.global_align(_port_edges(edges), niter=60, lr=0.01, schedule=schedule, device="cpu")
    np.testing.assert_allclose(out.final_loss, ref.final_loss, rtol=1e-3)
    np.testing.assert_allclose(out.c2ws[:, :3, 3], ref.c2ws[:, :3, 3], atol=5e-3)
    np.testing.assert_allclose(out.Ks[0, 0, 0], ref.Ks[0, 0, 0], rtol=1e-3)
    np.testing.assert_array_equal(out.conf, ref.conf)


def test_schedules_equal_optax():
    import optax

    for name, sched in (("cosine", optax.cosine_decay_schedule(0.01, 37)),
                        ("linear", optax.linear_schedule(0.01, 0.0, 37))):
        port = ga.learning_rate(name, 0.01, 37)
        np.testing.assert_allclose([port(c) for c in range(40)], [float(sched(c)) for c in range(40)],
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_recovers_the_scene(noise):
    edges, gt = _make_scene(N=4, noise=noise, seed=1)
    scene = ga.global_align(_port_edges(edges), niter=200, lr=0.01, device="cpu")
    assert np.isfinite(scene.final_loss)
    rec, s, R, t = _align_to_gt(scene.c2ws.astype(np.float64), gt["c2ws"])
    np.testing.assert_allclose(rec[:, :3, 3], gt["c2ws"][:, :3, 3], atol=0.02 if noise == 0 else 0.08)
    for n in range(len(rec)):
        dR = rec[n, :3, :3].T @ gt["c2ws"][n, :3, :3]
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < (1.0 if noise == 0 else 4.0), f"cam {n}: {ang:.2f} deg"
    np.testing.assert_allclose(scene.Ks[:, 0, 0], gt["f"], rtol=0.01 if noise == 0 else 0.05)
    rec_pts = scene.pts3d.astype(np.float64) @ R.T * s + t
    assert np.median(np.linalg.norm(rec_pts - gt["world"], axis=-1)) < (0.02 if noise == 0 else 0.1)


def _ragged_output(seed=12):
    """dust3r-style ragged inference output: each image at its own aspect."""
    rng = np.random.default_rng(seed)
    f = 40.0
    hws = [(24, 32), (32, 24), (24, 32)]
    N = len(hws)
    thetas = np.linspace(-0.4, 0.4, N)
    c2ws = np.stack([_lookat_c2w((4 * np.sin(t), 0.5 * np.sin(2 * t), -4 * np.cos(t))) for t in thetas])
    w2cs = np.linalg.inv(c2ws)
    world = []
    for n, (H, W) in enumerate(hws):
        uu, vv = np.meshgrid(np.arange(W) + 0.5 - W / 2, np.arange(H) + 0.5 - H / 2)
        depth = 3.0 + 0.4 * np.cos(uu / 9 + 0.3 * n) * np.sin(vv / 7)
        pts = depth[..., None] * np.stack([uu / f, vv / f, np.ones_like(uu)], -1)
        world.append(np.einsum("ab,hwb->hwa", c2ws[n, :3, :3], pts) + c2ws[n, :3, 3])
    out = {"view1": {"idx": []}, "view2": {"idx": []}, "pred1": {"pts3d": [], "conf": []},
           "pred2": {"pts3d_in_other_view": [], "conf": []}}
    for i in range(N):
        for j in range(N):
            if i == j:
                continue
            kappa = float(rng.uniform(0.6, 1.7))

            def in_i(pts):
                return np.einsum("ab,hwb->hwa", w2cs[i, :3, :3], pts) + w2cs[i, :3, 3]

            out["view1"]["idx"].append(i)
            out["view2"]["idx"].append(j)
            out["pred1"]["pts3d"].append(torch.tensor((kappa * in_i(world[i])).astype(np.float32)))
            out["pred2"]["pts3d_in_other_view"].append(torch.tensor((kappa * in_i(world[j])).astype(np.float32)))
            out["pred1"]["conf"].append(torch.tensor(rng.uniform(1, 10, hws[i]).astype(np.float32)))
            out["pred2"]["conf"].append(torch.tensor(rng.uniform(1, 10, hws[j]).astype(np.float32)))
    return out, c2ws, f


def test_mixed_resolution_edges_pad_as_jax_and_recover_the_scene():
    output, c2ws, f = _ragged_output()
    edges = ga.edges_from_dust3r_output(output)
    ref = jax_ga.edges_from_dust3r_output(output)
    for name in ("i_idx", "j_idx", "pts1", "conf1", "pts2", "conf2", "img_whs"):
        np.testing.assert_array_equal(getattr(edges, name), getattr(ref, name), err_msg=name)
    np.testing.assert_array_equal(edges.img_whs[1], (24, 32))

    scene = ga.global_align(edges, niter=200, lr=0.01, device="cpu")
    rec, *_ = _align_to_gt(scene.c2ws.astype(np.float64), c2ws)
    np.testing.assert_allclose(rec[:, :3, 3], c2ws[:, :3, 3], atol=0.03)
    np.testing.assert_allclose(scene.Ks[:, 0, 0], f, rtol=0.02)
    np.testing.assert_allclose(scene.Ks[0, 0, 2], 16.0)
    np.testing.assert_allclose(scene.Ks[1, 0, 2], 12.0)
    masks = scene.masks(0.5)
    assert not masks[1][:, 24:].any() and not masks[0][24:, :].any()


def test_refuses_a_mesh_and_zero_steps():
    """An edge count that does not divide over the mesh's "data" axis (6
    edges over 4 rows) raises ValueError, as JAX's device_put does."""
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh

    edges, _ = _make_scene(N=3, seed=2)
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="must divide over the mesh's data axis"):
        ga.global_align(_port_edges(edges), niter=5, mesh=mesh)
    with pytest.raises(ValueError):
        ga.global_align(_port_edges(edges), niter=0, device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        ga.global_align(_port_edges(edges), niter=5, schedule="step", device="cpu")


@pytest.mark.parametrize("shape", [(4, 2), (2, 1)])
def test_sharded_refinement_follows_jax_on_a_mesh(shape):
    """The edges (12 at N=4) over the "data" axis against JAX's edge-sharded
    refinement on its virtual 4x2 mesh, after 60 steps, at the bars of
    tests/test_global_alignment.py:166-181 (seed 7, as the unsharded test
    above); the sharded port also ends where its unsharded refinement does."""
    from stable_virtual_camera_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from stable_virtual_camera_tpu_torch.parallel.mesh import make_mesh

    edges, _ = _make_scene(N=4, noise=0.005, seed=7)
    ref = jax_ga.global_align(edges, niter=60, lr=0.01, mesh=jax_make_mesh(n_data=4, n_view=2))
    mesh = make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    out = ga.global_align(_port_edges(edges), niter=60, lr=0.01, mesh=mesh)
    single = ga.global_align(_port_edges(edges), niter=60, lr=0.01, device="cpu")
    for other in (ref, single):
        np.testing.assert_allclose(out.final_loss, other.final_loss, rtol=1e-3)
        np.testing.assert_allclose(out.c2ws[:, :3, 3], other.c2ws[:, :3, 3], atol=5e-3)
        np.testing.assert_allclose(out.Ks[0, 0, 0], other.Ks[0, 0, 0], rtol=1e-3)
    np.testing.assert_array_equal(out.conf, ref.conf)
