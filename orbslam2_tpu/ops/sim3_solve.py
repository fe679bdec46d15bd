"""Sim(3)/SE(3) RANSAC from 3D-3D correspondences (loop alignment).

JAX equivalent of ``Sim3Solver`` (src/Sim3Solver.cc, SURVEY.md
§2.1): Horn's 1987 closed-form absolute orientation on minimal 3-point
samples, all RANSAC hypotheses as one batch; inlier check by projecting
each cloud into the OTHER camera with per-octave thresholds
(Sim3Solver::CheckInliers, ≈260).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.camera import CameraModel


def horn_sim3(
    p1: jnp.ndarray, p2: jnp.ndarray, fix_scale: bool
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closed-form similarity from paired points (M, 3) x (M, 3):
    returns (R12, t12, s12) with p1 ~ s R p2 + t  (camera-1 <- camera-2).
    """
    c1 = p1.mean(axis=0)
    c2 = p2.mean(axis=0)
    q1 = p1 - c1
    q2 = p2 - c2
    M = q1.T @ q2  # (3, 3)
    # Horn's 4x4 quaternion matrix.
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    N = jnp.array(
        [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
    )
    vals, vecs = jnp.linalg.eigh(N)
    q = vecs[:, -1]  # max eigenvalue -> quaternion (w, x, y, z)
    w, x, y, z = q[0], q[1], q[2], q[3]
    R = jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    ).T  # with M = q1^T q2 the quaternion encodes p1->p2; we want p2->p1
    rot_q2 = q2 @ R.T
    s = jnp.where(
        fix_scale,
        1.0,
        jnp.sum(q1 * rot_q2) / jnp.maximum(jnp.sum(rot_q2 * rot_q2), 1e-12),
    )
    t = c1 - s * (R @ c2)
    return R, t, s


class Sim3Result(NamedTuple):
    R12: jnp.ndarray
    t12: jnp.ndarray
    s12: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    ok: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("iters", "fix_scale"))
def sim3_ransac(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    valid: jnp.ndarray,
    max_err1: jnp.ndarray,
    max_err2: jnp.ndarray,
    cam: CameraModel,
    key: jnp.ndarray,
    iters: int = 128,
    fix_scale: bool = False,
    min_inliers: int = 20,
) -> Sim3Result:
    """RANSAC Horn alignment.

    p1/p2: (M, 3) matched map points in camera-1/camera-2 frames.
    max_err*: (M,) squared-pixel thresholds (9.21/7.78 x sigma2(octave),
    the reference's values).
    """
    M = p1.shape[0]
    w = valid.astype(jnp.float32)
    prob = w / jnp.maximum(w.sum(), 1.0)
    samples = jax.random.choice(key, M, shape=(iters, 3), replace=True, p=prob)

    Rs, ts, ss = jax.vmap(
        lambda s: horn_sim3(p1[s], p2[s], fix_scale)
    )(samples)

    def project(p):
        z = jnp.maximum(p[:, 2], 1e-6)
        return jnp.stack(
            [cam.fx * p[:, 0] / z + cam.cx, cam.fy * p[:, 1] / z + cam.cy], -1
        )

    uv1_obs = project(p1)
    uv2_obs = project(p2)

    def score(R, t, s):
        p2_in_1 = s * (p2 @ R.T) + t
        sinv = 1.0 / jnp.maximum(s, 1e-9)
        p1_in_2 = sinv * ((p1 - t) @ R)
        e1 = jnp.sum((project(p2_in_1) - uv1_obs) ** 2, -1)
        e2 = jnp.sum((project(p1_in_2) - uv2_obs) ** 2, -1)
        inl = valid & (e1 < max_err1) & (e2 < max_err2)
        return jnp.sum(inl), inl

    n_in, inls = jax.vmap(score)(Rs, ts, ss)
    best = jnp.argmax(n_in)
    return Sim3Result(
        R12=Rs[best], t12=ts[best], s12=ss[best],
        inliers=inls[best], n_inliers=n_in[best],
        ok=n_in[best] >= min_inliers,
    )
