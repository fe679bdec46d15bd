"""Sim3 refinement between two keyframes (loop-closure alignment).

JAX equivalent of ``Optimizer::OptimizeSim3``
(src/Optimizer.cc:≈1080): one Sim3 vertex, bidirectional projection
residuals (EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ), Huber, the
reference's 5-iterations -> cut chi2 > 10 -> 10 more schedule.

Jacobians come from forward-mode autodiff on the 7-dim tangent — the
problem is tiny (one vertex), so autodiff beats hand-derived code with
zero accuracy cost.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..utils.camera import CameraModel
from .lie import sim3_apply, sim3_exp, sim3_from_mat, sim3_inverse_mat, sim3_to_mat

CHI2_TH = 10.0  # reference's th2 for OptimizeSim3


def _project(cam: CameraModel, p: jnp.ndarray) -> jnp.ndarray:
    z = jnp.maximum(p[..., 2], 1e-6)
    return jnp.stack(
        [cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], -1
    )


class Sim3OptResult(NamedTuple):
    S12: jnp.ndarray       # packed 4x4 (sR | t)
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("phases", "fix_scale"))
def optimize_sim3(
    S12_init: jnp.ndarray,
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    valid: jnp.ndarray,
    cam: CameraModel,
    fix_scale: bool = False,
    phases: Tuple[int, int] = (5, 10),
) -> Sim3OptResult:
    """Refine S12 (camera1 <- camera2, packed sR|t).

    p1/p2: (M, 3) matched points in each camera frame; uv1/uv2: their
    observed keypoints in each image.
    """
    fix = jnp.float32(1.0 if fix_scale else 0.0)

    def residuals(xi, base_S12):
        # Left-multiplied increment; scale component frozen when fix_scale.
        xi = xi.at[6].multiply(1.0 - fix)
        S = sim3_exp(xi) @ base_S12
        Sinv = sim3_inverse_mat(S)
        r1 = _project(cam, sim3_apply(S, p2)) - uv1       # in image 1
        r2 = _project(cam, sim3_apply(Sinv, p1)) - uv2    # in image 2
        return r1, r2

    def chi2_of(S):
        r1, r2 = residuals(jnp.zeros(7), S)
        c1 = jnp.sum(r1 * r1, -1) * inv_sigma2_1
        c2 = jnp.sum(r2 * r2, -1) * inv_sigma2_2
        return c1, c2

    def gn_iters(S, mask, n_iters, robust):
        def body(i, carry):
            S, lam = carry

            def flat_res(xi):
                r1, r2 = residuals(xi, S)
                w1 = jnp.sqrt(inv_sigma2_1 * mask)
                w2 = jnp.sqrt(inv_sigma2_2 * mask)
                return jnp.concatenate(
                    [r1 * w1[:, None], r2 * w2[:, None]], axis=0
                ).reshape(-1)

            r0 = flat_res(jnp.zeros(7))
            J = jax.jacfwd(flat_res)(jnp.zeros(7))  # (2M*2, 7)
            if robust:
                # Huber IRLS on per-point residual norms.
                rn = jnp.sqrt(
                    jnp.sum(r0.reshape(-1, 2) ** 2, -1) + 1e-12
                )
                delta = jnp.sqrt(CHI2_TH)
                wh = jnp.sqrt(jnp.minimum(1.0, delta / jnp.maximum(rn, 1e-12)))
                r0 = (r0.reshape(-1, 2) * wh[:, None]).reshape(-1)
                J = (J.reshape(-1, 2, 7) * wh[:, None, None]).reshape(-1, 7)
            H = J.T @ J + lam * jnp.eye(7)
            b = J.T @ r0
            dx = -jnp.linalg.solve(H, b)
            S_new = sim3_exp(dx.at[6].multiply(1.0 - fix)) @ S
            e0 = jnp.sum(flat_res(jnp.zeros(7)) ** 2)

            def err_at(Sx):
                r1, r2 = residuals(jnp.zeros(7), Sx)
                return jnp.sum(
                    (r1 * r1).sum(-1) * inv_sigma2_1 * mask
                    + (r2 * r2).sum(-1) * inv_sigma2_2 * mask
                )

            accept = err_at(S_new) < err_at(S)
            S = jnp.where(accept, S_new, S)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e3)
            return (S, lam)

        S, _ = jax.lax.fori_loop(0, n_iters, body, (S, jnp.float32(1e-4)))
        return S

    mask = valid.astype(jnp.float32)
    S = S12_init
    S = gn_iters(S, mask, phases[0], robust=True)
    c1, c2 = chi2_of(S)
    inlier = valid & (c1 < CHI2_TH) & (c2 < CHI2_TH)
    S = gn_iters(S, inlier.astype(jnp.float32), phases[1], robust=False)
    c1, c2 = chi2_of(S)
    inlier = valid & (c1 < CHI2_TH) & (c2 < CHI2_TH)
    return Sim3OptResult(S12=S, inliers=inlier, n_inliers=jnp.sum(inlier))
