"""Kochanek-Bartels (TCB) splines for camera trajectories: vector and
unit-quaternion variants, plus monotone (PCHIP) time parameterization.

A copy of stable_virtual_camera_tpu/core/kb_splines.py (numpy), so that the
port imports nothing of the JAX package: uniform-knot TCB cubic Hermite for
vectors, and cubic Bezier-on-SO(3) (De Casteljau slerp with TCB tangents)
for quaternions, with "natural" or "closed" end conditions. scipy is
imported where the PCHIP mapping is built.
"""

from __future__ import annotations

import numpy as np


def _tcb_coeffs(tension: float, continuity: float, bias: float):
    a = (1 - tension) * (1 + continuity) * (1 + bias) / 2.0  # outgoing, prev leg
    b = (1 - tension) * (1 - continuity) * (1 - bias) / 2.0  # outgoing, next leg
    c = (1 - tension) * (1 - continuity) * (1 + bias) / 2.0  # incoming, prev leg
    d = (1 - tension) * (1 + continuity) * (1 - bias) / 2.0  # incoming, next leg
    return a, b, c, d


class KochanekBartels:
    """Vector-valued TCB spline on uniform knots t = 0..n-1 (or 0..n for
    closed). evaluate(t) accepts scalars or arrays."""

    def __init__(self, points, tcb=(0.0, 0.0, 0.0), endconditions: str = "natural"):
        pts = np.asarray(points, dtype=np.float64)
        if pts.ndim == 1:
            pts = pts[:, None]
            self._scalar = True
        else:
            self._scalar = False
        assert pts.shape[0] >= 2, "need at least 2 keyframes"
        self.closed = endconditions == "closed"
        self.points = pts
        n = pts.shape[0]
        T, C, B = tcb
        a, b, c, d = _tcb_coeffs(T, C, B)

        if self.closed:
            prev_d = pts - np.roll(pts, 1, axis=0)  # x_i - x_{i-1}
            next_d = np.roll(pts, -1, axis=0) - pts
            self.out_tan = a * prev_d + b * next_d
            self.in_tan = c * prev_d + d * next_d
            self.segments = n  # wraps around
        else:
            out_tan = np.zeros_like(pts)
            in_tan = np.zeros_like(pts)
            for i in range(1, n - 1):
                prev_d = pts[i] - pts[i - 1]
                next_d = pts[i + 1] - pts[i]
                out_tan[i] = a * prev_d + b * next_d
                in_tan[i] = c * prev_d + d * next_d
            # natural end conditions: second derivative zero at both ends
            if n == 2:
                out_tan[0] = in_tan[1] = pts[1] - pts[0]
            else:
                out_tan[0] = (3.0 * (pts[1] - pts[0]) - in_tan[1]) / 2.0
                in_tan[-1] = (3.0 * (pts[-1] - pts[-2]) - out_tan[-2]) / 2.0
            self.out_tan = out_tan
            self.in_tan = in_tan
            self.segments = n - 1

    def evaluate(self, t):
        t = np.asarray(t, dtype=np.float64)
        scalar_in = t.ndim == 0
        t = np.atleast_1d(t)
        if self.closed:
            t = np.mod(t, self.segments)
        else:
            t = np.clip(t, 0.0, self.segments)
        i = np.minimum(t.astype(int), self.segments - 1)
        u = (t - i)[:, None]
        n = self.points.shape[0]
        p0 = self.points[i % n]
        p1 = self.points[(i + 1) % n]
        m0 = self.out_tan[i % n]
        m1 = self.in_tan[(i + 1) % n]
        u2, u3 = u * u, u * u * u
        h00 = 2 * u3 - 3 * u2 + 1
        h10 = u3 - 2 * u2 + u
        h01 = -2 * u3 + 3 * u2
        h11 = u3 - u2
        out = h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1
        if self._scalar:
            out = out[:, 0]
        return out[0] if scalar_in else out


# ---------------------------------------------------------------------------
# Quaternions (wxyz convention)
# ---------------------------------------------------------------------------


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_log(q: np.ndarray) -> np.ndarray:
    """Unit quaternion -> rotation vector (axis * angle)."""
    q = quat_normalize(np.asarray(q, dtype=np.float64))
    w = np.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn = np.linalg.norm(v, axis=-1, keepdims=True)
    angle = 2.0 * np.arctan2(vn[..., 0], w)
    small = vn[..., 0] < 1e-12
    scale = np.where(small, 2.0, angle / np.where(vn[..., 0] == 0, 1.0, vn[..., 0]))
    return v * scale[..., None]


def quat_exp(rotvec: np.ndarray) -> np.ndarray:
    """Rotation vector -> unit quaternion."""
    rotvec = np.asarray(rotvec, dtype=np.float64)
    angle = np.linalg.norm(rotvec, axis=-1, keepdims=True)
    half = angle / 2.0
    small = angle[..., 0] < 1e-12
    k = np.where(small[..., None], 0.5, np.sin(half) / np.where(angle == 0, 1.0, angle))
    w = np.cos(half)
    return np.concatenate([w, rotvec * k], axis=-1)


def quat_slerp(q0: np.ndarray, q1: np.ndarray, u) -> np.ndarray:
    u = np.asarray(u, dtype=np.float64)[..., None]
    rel = quat_mul(quat_conj(q0), q1)
    return quat_mul(q0, quat_exp(quat_log(rel) * u))


def quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """(…, 3, 3) rotation matrices -> wxyz quaternions."""
    R = np.asarray(R, dtype=np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q = np.empty(R.shape[:-2] + (4,), dtype=np.float64)
    # numerically robust branch per element
    it = np.nditer(tr, flags=["multi_index"])
    for _ in it:
        idx = it.multi_index
        t = tr[idx]
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            q[idx] = [0.25 * s, (m21[idx] - m12[idx]) / s,
                      (m02[idx] - m20[idx]) / s, (m10[idx] - m01[idx]) / s]
        elif m00[idx] > m11[idx] and m00[idx] > m22[idx]:
            s = np.sqrt(1.0 + m00[idx] - m11[idx] - m22[idx]) * 2
            q[idx] = [(m21[idx] - m12[idx]) / s, 0.25 * s,
                      (m01[idx] + m10[idx]) / s, (m02[idx] + m20[idx]) / s]
        elif m11[idx] > m22[idx]:
            s = np.sqrt(1.0 + m11[idx] - m00[idx] - m22[idx]) * 2
            q[idx] = [(m02[idx] - m20[idx]) / s, (m01[idx] + m10[idx]) / s,
                      0.25 * s, (m12[idx] + m21[idx]) / s]
        else:
            s = np.sqrt(1.0 + m22[idx] - m00[idx] - m11[idx]) * 2
            q[idx] = [(m10[idx] - m01[idx]) / s, (m02[idx] + m20[idx]) / s,
                      (m12[idx] + m21[idx]) / s, 0.25 * s]
    return quat_normalize(q)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    q = quat_normalize(np.asarray(q, dtype=np.float64))
    w, x, y, z = np.moveaxis(q, -1, 0)
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


class KochanekBartelsQuaternion:
    """TCB spline on SO(3): cubic Bezier in quaternion space evaluated by
    De Casteljau slerp, with tangent (angular velocity) control points from
    the TCB formulas. Keyframes are canonicalized to the same hemisphere."""

    def __init__(self, quats_wxyz, tcb=(0.0, 0.0, 0.0), endconditions="natural"):
        qs = quat_normalize(np.asarray(quats_wxyz, dtype=np.float64))
        # canonicalize: successive dot products non-negative
        for i in range(1, len(qs)):
            if np.dot(qs[i - 1], qs[i]) < 0:
                qs[i] = -qs[i]
        assert qs.shape[0] >= 2
        self.closed = endconditions == "closed"
        self.quats = qs
        n = qs.shape[0]
        T, C, B = tcb
        a, b, c, d = _tcb_coeffs(T, C, B)

        def rel(i, j):  # rotation vector from q_i to q_j
            return quat_log(quat_mul(quat_conj(qs[i % n]), qs[j % n]))

        out_tan = np.zeros((n, 3))
        in_tan = np.zeros((n, 3))
        rng = range(n) if self.closed else range(1, n - 1)
        for i in rng:
            prev_d = rel(i - 1, i)
            next_d = rel(i, i + 1)
            out_tan[i] = a * prev_d + b * next_d
            in_tan[i] = c * prev_d + d * next_d
        if not self.closed:
            if n == 2:
                out_tan[0] = in_tan[1] = rel(0, 1)
            else:
                out_tan[0] = (3.0 * rel(0, 1) - in_tan[1]) / 2.0
                in_tan[-1] = (3.0 * rel(n - 2, n - 1) - out_tan[-2]) / 2.0
        self.out_tan = out_tan
        self.in_tan = in_tan
        self.segments = n if self.closed else n - 1

    def evaluate(self, t):
        t = np.asarray(t, dtype=np.float64)
        scalar_in = t.ndim == 0
        t = np.atleast_1d(t)
        if self.closed:
            t = np.mod(t, self.segments)
        else:
            t = np.clip(t, 0.0, self.segments)
        i = np.minimum(t.astype(int), self.segments - 1)
        u = t - i
        n = self.quats.shape[0]
        q0 = self.quats[i % n]
        q3 = self.quats[(i + 1) % n]
        q1 = quat_mul(q0, quat_exp(self.out_tan[i % n] / 3.0))
        q2 = quat_mul(q3, quat_exp(-self.in_tan[(i + 1) % n] / 3.0))
        # De Casteljau with slerp
        a0 = quat_slerp(q0, q1, u)
        a1 = quat_slerp(q1, q2, u)
        a2 = quat_slerp(q2, q3, u)
        b0 = quat_slerp(a0, a1, u)
        b1 = quat_slerp(a1, a2, u)
        out = quat_normalize(quat_slerp(b0, b1, u))
        return out[0] if scalar_in else out


def pchip_time_parameterization(
    transition_times_cumsum: np.ndarray, loop: bool = False
):
    """Monotone seconds -> spline-t mapping."""
    import scipy.interpolate

    spline_indices = np.arange(transition_times_cumsum.shape[0])
    if loop:
        interpolator = scipy.interpolate.PchipInterpolator(
            x=np.concatenate(
                [
                    [-(transition_times_cumsum[-1] - transition_times_cumsum[-2])],
                    transition_times_cumsum,
                    transition_times_cumsum[-1:] + transition_times_cumsum[1:2],
                ]
            ),
            y=np.concatenate([[-1], spline_indices, [spline_indices[-1] + 1]]),
        )
    else:
        interpolator = scipy.interpolate.PchipInterpolator(
            x=transition_times_cumsum, y=spline_indices
        )

    def mapping(time):
        return np.clip(interpolator(time), 0, spline_indices[-1])

    return mapping
