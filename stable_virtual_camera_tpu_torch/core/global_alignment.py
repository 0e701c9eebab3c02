"""Global alignment of pairwise stereo pointmaps, with the refinement on the card.

Counterpart of stable_virtual_camera_tpu/core/global_alignment.py. Given
per-edge pointmap/confidence predictions of a pairwise stereo network, it
recovers per-image intrinsics, c2w poses and globally consistent per-pixel
3D points.

  variables   q_i, t_i   c2w rotation (quaternion) / translation, image 0
                         held fixed (gauge)
              logd_i     per-pixel log-depth
              logf       log-focal (scalar when ``same_focals``)
              logs_e     per-edge log-scale, mean pinned to 0 (gauge)

  loss        sum_e sum_{v in {1,2}}  conf^e_v *
                 || chi_{img(e,v)} - P_{e.i} @ (exp(logs_e) * X^e_v) ||_2

  chi_i(u,v)  = P_i @ ( d_i(u,v) * K_i^{-1} [u + .5 - W/2, v + .5 - H/2, 1] )

The host part (initialization by focal least squares, a maximum-confidence
spanning tree of weighted-Umeyama similarity fits and closed-form per-edge
scales; the `EdgePreds`/`AlignedScene` containers; the ragged-map adapter
`edges_from_dust3r_output`) is a numpy copy of the JAX module's. The
refinement restates its loss in torch and runs `torch.optim.Adam` on the
card in place of the jitted `optax.adam` scan, step for step: b1 0.9, b2
0.999, eps 1e-8 added outside the square root, bias-corrected moments, and
the learning rate of update k read from optax's cosine-decay or linear
schedule at count k (the count before the update). `final_loss` is the loss
computed in the last step, before its update.

With a mesh (parallel/mesh.Mesh), the per-edge work shards over its "data"
axis as JAX shards it: data row d takes its cut of the edge rows (i, j,
pts1, c1, pts2, c2, and the per-edge log-scales once their mean is taken
over every edge), while the parameters, the per-image data and conf_total
stay whole on every rank. Each rank runs the backward of its partial loss
in its own thread, then ONE flat fp32 all-reduce of the five gradients and
the partial loss (parallel/comm.Comm.all_reduce, rank order, outside the
autograd engine), and every rank takes the same Adam step. The ranks off
view 0 (and model 0) would repeat their row's work, as JAX replicates the
edges over those axes, so they sit out. An edge count that does not divide
over "data" raises ValueError, as JAX's device_put does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host-side building blocks (numpy)
# ---------------------------------------------------------------------------


def weighted_umeyama(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray
) -> tuple[float, np.ndarray, np.ndarray]:
    """Weighted similarity fit: (s, R, t) minimizing sum w ||dst - (s R src + t)||^2.

    src, dst: (M, 3); w: (M,) non-negative.
    """
    w = np.asarray(w, np.float64)
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    wsum = w.sum()
    assert wsum > 0, "umeyama needs positive total weight"
    mu_s = (w[:, None] * src).sum(0) / wsum
    mu_d = (w[:, None] * dst).sum(0) / wsum
    cs, cd = src - mu_s, dst - mu_d
    cov = (w[:, None] * cd).T @ cs / wsum  # (3,3)
    U, D, Vt = np.linalg.svd(cov)
    sgn = np.sign(np.linalg.det(U @ Vt))
    S = np.diag([1.0, 1.0, sgn])
    R = U @ S @ Vt
    var_s = (w * (cs**2).sum(-1)).sum() / wsum
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    t = mu_d - s * R @ mu_s
    return s, R, t


def estimate_focal(
    pts: np.ndarray, conf: np.ndarray, wh: tuple[float, float] | None = None
) -> float:
    """Weighted LSQ focal from a self-view pointmap (centered principal point).

    Pinhole identity per pixel: (u + .5 - W/2) = f * x / z (same for v/y);
    one scalar f minimizes the stacked weighted system. `wh` is the image's
    REAL (width, height) when the map is padded (padding must carry conf 0);
    the principal point sits at the real center.
    """
    H, W = pts.shape[:2]
    w_real, h_real = wh if wh is not None else (W, H)
    uu, vv = np.meshgrid(
        np.arange(W, dtype=np.float64) + 0.5 - w_real / 2,
        np.arange(H, dtype=np.float64) + 0.5 - h_real / 2,
    )
    z = pts[..., 2]
    valid = z > 1e-6
    w = np.where(valid, conf, 0.0).ravel()
    xz = np.where(valid, pts[..., 0] / np.maximum(z, 1e-6), 0.0).ravel()
    yz = np.where(valid, pts[..., 1] / np.maximum(z, 1e-6), 0.0).ravel()
    num = (w * (uu.ravel() * xz + vv.ravel() * yz)).sum()
    den = (w * (xz**2 + yz**2)).sum()
    if den <= 1e-9 or num <= 0:
        return float(max(H, W))  # degenerate: default-FOV-ish fallback
    return float(num / den)


def _max_spanning_tree(n: int, edges: list[tuple[int, int]], weight: np.ndarray):
    """Prim's maximum spanning tree; returns list of edge indices, rooted at
    the endpoint of the heaviest edge. Asserts connectivity."""
    best = int(np.argmax(weight))
    root = edges[best][0]
    in_tree = {root}
    tree: list[int] = []
    while len(in_tree) < n:
        cand, cand_w = -1, -np.inf
        for eidx, (i, j) in enumerate(edges):
            if (i in in_tree) != (j in in_tree) and weight[eidx] > cand_w:
                cand, cand_w = eidx, weight[eidx]
        if cand < 0:  # data-dependent: must survive python -O
            raise ValueError("pair graph is disconnected")
        i, j = edges[cand]
        in_tree.add(j if i in in_tree else i)
        tree.append(cand)
    return root, tree


def _quat_from_rot(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) from a rotation matrix (Shepperd's method)."""
    m = R
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# Inputs / outputs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EdgePreds:
    """Stacked pairwise predictions. For edge e = (i, j), BOTH pointmaps live
    in image i's camera frame (the stereo net's view-1 frame):
    pts1[e] are image i's pixels, pts2[e] are image j's pixels.

    Mixed-resolution image sets (dust3r resizes each image to its own
    aspect-dependent shape) are supported by padding every map to a common
    (H, W) at the bottom/right with confidence 0 and recording each image's
    real size in `img_whs` — padded pixels carry zero loss weight and the
    principal point sits at the real center."""

    i_idx: np.ndarray  # (E,) int
    j_idx: np.ndarray  # (E,) int
    pts1: np.ndarray  # (E, H, W, 3) float32
    conf1: np.ndarray  # (E, H, W) float32, >= 0 (0 on padding)
    pts2: np.ndarray  # (E, H, W, 3)
    conf2: np.ndarray  # (E, H, W)
    img_whs: np.ndarray | None = None  # (N, 2) real (w, h) per image

    @property
    def num_images(self) -> int:
        return int(max(self.i_idx.max(), self.j_idx.max())) + 1

    def whs(self) -> np.ndarray:
        """(N, 2) real (w, h) per image; defaults to the map size."""
        if self.img_whs is not None:
            return np.asarray(self.img_whs, np.float64)
        _, H, W = self.conf1.shape
        return np.tile(np.array([W, H], np.float64), (self.num_images, 1))


@dataclasses.dataclass
class AlignedScene:
    """The aligned scene: what the preprocessor reads back."""

    Ks: np.ndarray  # (N, 3, 3) at the working resolution
    c2ws: np.ndarray  # (N, 4, 4)
    pts3d: np.ndarray  # (N, H, W, 3) world-frame points
    conf: np.ndarray  # (N, H, W) aggregated per-pixel confidence
    final_loss: float

    def masks(self, min_conf_thr: float) -> list[np.ndarray]:
        return [c > min_conf_thr for c in self.conf]


# ---------------------------------------------------------------------------
# Initialization (host)
# ---------------------------------------------------------------------------


def _scale_of(pts: np.ndarray, conf: np.ndarray) -> float:
    w = conf.ravel()
    n = np.linalg.norm(pts.reshape(-1, 3), axis=-1)
    return float((w * n).sum() / max(w.sum(), 1e-9))


def _initialize(edges: EdgePreds, same_focals: bool):
    N = edges.num_images
    E, H, W = edges.conf1.shape
    whs = edges.whs()  # (N, 2) real (w, h)

    # each image's own-frame pointmap: its highest-confidence view-1 edge
    mean_c1 = edges.conf1.reshape(E, -1).mean(-1)
    self_edge = np.full(N, -1)
    self_conf = np.full(N, -np.inf)
    for e in range(E):
        i = int(edges.i_idx[e])
        if mean_c1[e] > self_conf[i]:
            self_edge[i], self_conf[i] = e, mean_c1[e]
    if not (self_edge >= 0).all():  # data-dependent: must survive python -O
        raise ValueError(
            "every image must appear as view 1 of some edge (use a "
            "symmetrized pair graph)"
        )
    self_pts = edges.pts1[self_edge]  # (N, H, W, 3), per-image self scale
    self_cw = edges.conf1[self_edge]

    # focal(s) from self predictions
    focals = np.array(
        [estimate_focal(self_pts[i], self_cw[i], wh=tuple(whs[i]))
         for i in range(N)]
    )
    if same_focals:
        wts = np.maximum(self_conf, 1e-3)
        focals[:] = float((focals * wts).sum() / wts.sum())

    # one undirected edge per image pair (best direction by view-1 conf)
    und: dict[tuple[int, int], int] = {}
    for e in range(E):
        i, j = int(edges.i_idx[e]), int(edges.j_idx[e])
        key = (min(i, j), max(i, j))
        if key not in und or mean_c1[e] > mean_c1[und[key]]:
            und[key] = e
    pair_keys = list(und.keys())
    root, tree_pos = _max_spanning_tree(
        N, pair_keys, mean_c1[np.array([und[k] for k in pair_keys])]
    )
    tree_eidx = [und[pair_keys[p]] for p in tree_pos]

    # chain similarities outward from the root over the tree edges.
    # Per-image state: world = R_init (alpha * p_self) + t_init, where p_self
    # are frame-local points at that image's self scale and alpha is the
    # image's depth-scale multiplier relative to the root.
    R_init = np.tile(np.eye(3), (N, 1, 1))
    t_init = np.zeros((N, 3))
    alpha = np.ones(N)
    placed = {root}
    remaining = list(tree_eidx)
    while remaining:
        progress = False
        for e in list(remaining):
            i, j = int(edges.i_idx[e]), int(edges.j_idx[e])
            if (i in placed) == (j in placed):
                continue
            remaining.remove(e)
            progress = True
            # r converts edge-e scale -> image i's self scale (pts1[e] and
            # self_pts[i] are the same pixels in the same frame)
            r = _scale_of(edges.pts1[e], edges.conf1[e]) / max(
                _scale_of(self_pts[i], self_cw[i]), 1e-9
            )
            if i in placed:
                k, m = i, j
                # fit m's self points -> m's pixels in frame k (pts2, edge
                # scale), then rescale the result into k's self scale
                s, R, t = weighted_umeyama(
                    self_pts[m].reshape(-1, 3),
                    edges.pts2[e].reshape(-1, 3),
                    (self_cw[m] * edges.conf2[e]).ravel(),
                )
                s_km, R_km, t_km = s / r, R, t / r
            else:
                k, m = j, i
                # fit k's self points -> k's pixels in frame m (pts2, edge
                # scale). Frame m's self scale differs from edge scale by r
                # (both express image m's frame). Then invert the similarity.
                s, R, t = weighted_umeyama(
                    self_pts[k].reshape(-1, 3),
                    edges.pts2[e].reshape(-1, 3),
                    (self_cw[k] * edges.conf2[e]).ravel(),
                )
                s_mk, t_mk = s / r, t / r  # frame_m@self_m <- frame_k@self_k
                s_km = 1.0 / max(s_mk, 1e-9)
                R_km = R.T
                t_km = -s_km * (R.T @ t_mk)
            R_init[m] = R_init[k] @ R_km
            t_init[m] = R_init[k] @ (alpha[k] * t_km) + t_init[k]
            alpha[m] = alpha[k] * s_km
            placed.add(m)
        assert progress, "tree chaining stalled (disconnected tree?)"
    assert len(placed) == N, "tree chaining failed to place every image"

    depth_init = np.maximum(self_pts[..., 2], 1e-4) * alpha[:, None, None]

    # closed-form per-edge scale against the initialized global points
    chi = _backproject_np(depth_init, focals, R_init, t_init, H, W, whs / 2)
    logs = np.zeros(E)
    for e in range(E):
        i = int(edges.i_idx[e])
        Ri, ti = R_init[i], t_init[i]
        num = den = 0.0
        for pts, cw, tgt in (
            (edges.pts1[e], edges.conf1[e], chi[int(edges.i_idx[e])]),
            (edges.pts2[e], edges.conf2[e], chi[int(edges.j_idx[e])]),
        ):
            rp = pts.reshape(-1, 3) @ Ri.T
            d = tgt.reshape(-1, 3) - ti
            w = cw.ravel()
            num += (w * (d * rp).sum(-1)).sum()
            den += (w * (rp * rp).sum(-1)).sum()
        logs[e] = np.log(max(num / max(den, 1e-9), 1e-3))

    quats = np.stack([_quat_from_rot(R_init[i]) for i in range(N)])
    return quats, t_init, np.log(depth_init), np.log(focals), logs


def _backproject_np(depth, focals, R, t, H, W, pps):
    """pps: (N, 2) per-image principal points (cx, cy) in pixels."""
    uu, vv = np.meshgrid(
        np.arange(W, dtype=np.float64) + 0.5,
        np.arange(H, dtype=np.float64) + 0.5,
    )
    dirs = np.stack(
        [
            (uu[None] - pps[:, 0, None, None]) / focals[:, None, None],
            (vv[None] - pps[:, 1, None, None]) / focals[:, None, None],
            np.ones((1, H, W)).repeat(len(focals), 0),
        ],
        axis=-1,
    )  # (N, H, W, 3)
    cam = depth[..., None] * dirs
    return np.einsum("nab,nhwb->nhwa", R, cam) + t[:, None, None, :]


# ---------------------------------------------------------------------------
# Device-side refinement (torch)
# ---------------------------------------------------------------------------


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2)], -1),
        ],
        -2,
    )


def _unpack(p: dict, data: dict):
    q = torch.cat([data["q0"], p["quat"]], 0)
    t = torch.cat([data["t0"], p["trans"]], 0)
    R = _quat_to_rot(q)
    f = torch.exp(p["logf"]).expand(q.shape[0])
    depth = torch.exp(p["logd"])
    scales = torch.exp(p["logs"] - p["logs"].mean())
    return R, t, f, depth, scales


def _rotate(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R (n, 3, 3) applied to every point of x (n, H, W, 3). Written as a
    broadcast product and sum rather than an einsum: the einsum's gradient
    with respect to R is a batched GEMM with a 3x3 output and an H*W-long
    reduction, which cuBLAS runs at ~5 ms a call at 384x512 on an H100,
    where this form's gradient is one reduction."""
    return (R[:, None, None] * x[..., None, :]).sum(-1)


# the per-edge arrays of the problem's data, cut over "data" on a mesh
EDGE_KEYS = ("i", "j", "pts1", "c1", "pts2", "c2")


def _loss_fn(p: dict, data: dict, edges: slice | None = None) -> torch.Tensor:
    """The loss over `data`'s edges; with `edges`, data holds the rows
    `edges` of every per-edge array (one rank's share) and the per-edge
    scales, normalised over every edge, are cut to them."""
    R, t, f, depth, scales = _unpack(p, data)
    if edges is not None:
        scales = scales[edges]
    xy = (data["uv"][None] - data["pp"][:, None, None, :]) / f[:, None, None, None]
    dirs = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    cam = depth[..., None] * dirs
    chi = _rotate(R, cam) + t[:, None, None, :]
    Ri, ti = R[data["i"]], t[data["i"]]
    sc = scales[:, None, None, None]
    w1 = _rotate(Ri, sc * data["pts1"]) + ti[:, None, None, :]
    w2 = _rotate(Ri, sc * data["pts2"]) + ti[:, None, None, :]
    d1 = torch.sqrt(((chi[data["i"]] - w1) ** 2).sum(-1) + 1e-12)
    d2 = torch.sqrt(((chi[data["j"]] - w2) ** 2).sum(-1) + 1e-12)
    return ((data["c1"] * d1).sum() + (data["c2"] * d2).sum()) / data["conf_total"]


def learning_rate(schedule: str, lr: float, niter: int):
    """optax's `cosine_decay_schedule(lr, niter)` or `linear_schedule(lr, 0,
    niter)` as a function of the update count."""
    steps = max(niter, 1)
    if schedule == "cosine":
        return lambda count: lr * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
    if schedule == "linear":
        return lambda count: lr * (1.0 - min(count, steps) / steps)
    raise ValueError(f"unknown schedule {schedule!r}")


def alignment_problem(edges: EdgePreds, same_focals: bool = True, device="cuda"):
    """The host initialization, expressed in the loss's gauge, as the
    refinement's parameters (leaf tensors that require grad) and constant
    data on `device`: `_loss_fn(params, data)` is the loss before the first
    step."""
    _, H, W = edges.conf1.shape
    quats0, trans0, logd0, logf0, logs0 = _initialize(edges, same_focals)
    if same_focals:
        logf0 = logf0[:1]

    # express the init in the loss's gauge (mean(logs) pinned to 0): shifting
    # every log-scale by -mu is a global rescale of the scene, so depths and
    # translations shift with it
    mu = float(logs0.mean())
    logs0 = logs0 - mu
    logd0 = logd0 - mu
    trans0 = trans0 * np.exp(-mu)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    # image 0's pose is held fixed (gauge); the rest is optimized
    params = {
        "quat": dev(quats0[1:]),
        "trans": dev(trans0[1:]),
        "logd": dev(logd0),
        "logf": dev(logf0),
        "logs": dev(logs0),
    }
    for p in params.values():
        p.requires_grad_(True)
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5, np.arange(H, dtype=np.float32) + 0.5)
    data = {
        "i": dev(edges.i_idx, torch.long),
        "j": dev(edges.j_idx, torch.long),
        "pts1": dev(edges.pts1),
        "c1": dev(edges.conf1),
        "pts2": dev(edges.pts2),
        "c2": dev(edges.conf2),
        "q0": dev(quats0[:1]),
        "t0": dev(trans0[:1]),
        "pp": dev(edges.whs() / 2),  # (N, 2) principal points
        "conf_total": dev(np.float32(edges.conf1.sum() + edges.conf2.sum())),
        "uv": dev(np.stack([uu, vv], -1)),  # (H, W, 2) raw pixels
    }
    return params, data


def refine(params: dict, data: dict, niter: int, lr: float = 0.01, schedule: str = "cosine",
           mesh=None) -> float:
    """`niter` Adam steps on `params` in place, as optax.adam under the
    schedule; returns the loss of the last step (before its update). With a
    `mesh`, the edges shard over its "data" axis (`refine_sharded`)."""
    if niter < 1:
        raise ValueError(f"niter must be at least 1, got {niter}")
    if mesh is not None:
        return refine_sharded(params, data, niter, lr, schedule, mesh)
    sched = learning_rate(schedule, lr, niter)
    opt = torch.optim.Adam(list(params.values()), lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for count in range(niter):
            for group in opt.param_groups:
                group["lr"] = sched(count)
            opt.zero_grad(set_to_none=True)
            loss = _loss_fn(params, data)
            loss.backward()
            opt.step()
    return float(loss.detach())


def refine_sharded(params: dict, data: dict, niter: int, lr: float, schedule: str, mesh) -> float:
    """`refine` with the edges over the mesh's "data" axis (see the module
    docstring); `params` end as data row 0's, the same bits on every row."""
    from stable_virtual_camera_tpu_torch.parallel.comm import run_ranks

    n = mesh.shape["data"]
    E = data["i"].shape[0]
    if E % n:
        raise ValueError(f"global_align: {E} edges must divide over the mesh's data axis ({n})")
    per = E // n
    sched = learning_rate(schedule, lr, niter)
    names = list(params)

    def rank(ctx):
        if ctx.view or ctx.model:
            return None
        dev = ctx.device
        rows = slice(ctx.data * per, (ctx.data + 1) * per)
        mine = {k: (v[rows] if k in EDGE_KEYS else v).to(dev) for k, v in data.items()}
        p = {k: params[k].detach().to(dev, copy=True).requires_grad_(True) for k in names}
        sizes = [p[k].numel() for k in names]
        opt = torch.optim.Adam([p[k] for k in names], lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
        with torch.enable_grad():
            for count in range(niter):
                for group in opt.param_groups:
                    group["lr"] = sched(count)
                loss = _loss_fn(p, mine, rows)
                grads = torch.autograd.grad(loss, [p[k] for k in names])
                flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.detach().reshape(1)])
                flat = ctx.data_comm.all_reduce(flat)
                for k, g in zip(names, flat[:-1].split(sizes)):
                    p[k].grad = g.view_as(p[k])
                opt.step()
        return p, flat[-1]

    outs = run_ranks(mesh, rank)
    p, loss = outs[0]
    with torch.no_grad():
        for k in names:
            params[k].copy_(p[k])
    return float(loss)


def aligned_scene(edges: EdgePreds, params: dict, data: dict, final_loss: float) -> AlignedScene:
    """The refined parameters as intrinsics, c2w poses, world points and
    per-pixel confidences (max over each image's edges), on the host."""
    N = edges.num_images
    _, H, W = edges.conf1.shape
    whs = edges.whs()
    with torch.no_grad():
        R, t, f, depth, _ = (x.double().cpu().numpy() for x in _unpack(params, data))
    chi = _backproject_np(depth, f, R, t, H, W, whs / 2)

    Ks = np.zeros((N, 3, 3))
    Ks[:, 0, 0] = f
    Ks[:, 1, 1] = f
    Ks[:, 0, 2] = whs[:, 0] / 2
    Ks[:, 1, 2] = whs[:, 1] / 2
    Ks[:, 2, 2] = 1.0
    c2ws = np.tile(np.eye(4), (N, 1, 1))
    c2ws[:, :3, :3] = R
    c2ws[:, :3, 3] = t

    conf = np.zeros((N, H, W), np.float32)
    for e in range(len(edges.i_idx)):
        i = int(edges.i_idx[e])
        conf[i] = np.maximum(conf[i], edges.conf1[e])
        j = int(edges.j_idx[e])
        conf[j] = np.maximum(conf[j], edges.conf2[e])

    return AlignedScene(
        Ks=Ks.astype(np.float32),
        c2ws=c2ws.astype(np.float32),
        pts3d=chi.astype(np.float32),
        conf=conf,
        final_loss=final_loss,
    )


def global_align(
    edges: EdgePreds,
    niter: int = 300,
    lr: float = 0.01,
    schedule: str = "cosine",
    same_focals: bool = True,
    mesh=None,
    device="cuda",
) -> AlignedScene:
    """Initialize on the host, refine with `niter` Adam steps on `device`
    (the card unless the caller passes the CPU), or with a `mesh`
    (parallel/mesh.Mesh) with the edges over its "data" axis, the problem
    built on its first device."""
    if mesh is not None:
        device = mesh.device(0)
    params, data = alignment_problem(edges, same_focals, device)
    final_loss = refine(params, data, niter, lr, schedule, mesh)
    return aligned_scene(edges, params, data, final_loss)


def edges_from_dust3r_output(output) -> EdgePreds:
    """Adapt a dust3r ``inference`` result dict (torch tensors) to EdgePreds.

    Expects the standard keys: view1/view2 ``idx``, pred1 ``pts3d``/``conf``,
    pred2 ``pts3d_in_other_view``/``conf``. Predictions may be
    one stacked (E, H, W, ...) tensor (uniform image sizes) or a per-edge
    list with mixed sizes (dust3r resizes each image to its own
    aspect-dependent shape): mixed sizes are padded bottom/right to the max
    extent with confidence 0 and each image's real (w, h) is recorded."""

    def npy(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    i_idx = np.asarray(output["view1"]["idx"], np.int64)
    j_idx = np.asarray(output["view2"]["idx"], np.int64)

    p1_raw = output["pred1"]["pts3d"]
    c1_raw = output["pred1"]["conf"]
    p2_raw = output["pred2"]["pts3d_in_other_view"]
    c2_raw = output["pred2"]["conf"]

    if not isinstance(p1_raw, (list, tuple)):
        return EdgePreds(
            i_idx=i_idx,
            j_idx=j_idx,
            pts1=npy(p1_raw).astype(np.float32),
            conf1=npy(c1_raw).astype(np.float32),
            pts2=npy(p2_raw).astype(np.float32),
            conf2=npy(c2_raw).astype(np.float32),
        )

    # ragged: per-edge maps sized to each image's own resolution
    p1s = [npy(x).astype(np.float32) for x in p1_raw]
    c1s = [npy(x).astype(np.float32) for x in c1_raw]
    p2s = [npy(x).astype(np.float32) for x in p2_raw]
    c2s = [npy(x).astype(np.float32) for x in c2_raw]
    E = len(p1s)
    H = max(max(p.shape[0] for p in p1s), max(p.shape[0] for p in p2s))
    W = max(max(p.shape[1] for p in p1s), max(p.shape[1] for p in p2s))

    N = int(max(i_idx.max(), j_idx.max())) + 1
    img_whs = np.zeros((N, 2))
    for e in range(E):
        img_whs[int(i_idx[e])] = (p1s[e].shape[1], p1s[e].shape[0])
        img_whs[int(j_idx[e])] = (p2s[e].shape[1], p2s[e].shape[0])

    def pad_pts(maps):
        out = np.zeros((E, H, W, 3), np.float32)
        for e, m in enumerate(maps):
            out[e, : m.shape[0], : m.shape[1]] = m
        return out

    def pad_conf(maps):
        out = np.zeros((E, H, W), np.float32)
        for e, m in enumerate(maps):
            out[e, : m.shape[0], : m.shape[1]] = m
        return out

    return EdgePreds(
        i_idx=i_idx,
        j_idx=j_idx,
        pts1=pad_pts(p1s),
        conf1=pad_conf(c1s),
        pts2=pad_pts(p2s),
        conf2=pad_conf(c2s),
        img_whs=img_whs,
    )
