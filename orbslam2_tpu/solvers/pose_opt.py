"""Motion-only bundle adjustment (pose optimization).

JAX replacement for ``Optimizer::PoseOptimization``
(src/Optimizer.cc:≈240): the per-frame 6-DoF pose refine the reference runs
through g2o (VertexSE3Expmap + unary reprojection edges, Huber, 4 rounds x
10 LM iterations with chi2 outlier re-flagging between rounds, last rounds
un-robustified).

Here the whole schedule is ONE jitted program: residuals/Jacobians for all
observations are batched (N = feature capacity, masked), the 6x6 normal
system is a reduction, and the 4x10 round structure is a `lax.fori_loop`
with outlier masks updated by `jnp.where` — no early exit, fixed cost,
which is exactly what an accelerator wants for a per-frame hot path.

Chi-square gates (the capability, kept verbatim): 5.991 (mono, 2-DoF),
7.815 (stereo, 3-DoF); Huber deltas sqrt of those.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils.camera import CameraModel
from .lie import hat, se3_exp

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObs(NamedTuple):
    """Batched observations of known 3-D points from one frame.

    points_w: (N, 3) world positions of matched map points
    uv:       (N, 2) undistorted pixel measurements
    ur:       (N,) right-image u (stereo); < 0 where mono-only
    inv_sigma2: (N,) 1/sigma^2 of the keypoint's octave
    valid:    (N,) real observations
    """

    points_w: jnp.ndarray
    uv: jnp.ndarray
    ur: jnp.ndarray
    inv_sigma2: jnp.ndarray
    valid: jnp.ndarray


class PoseOptResult(NamedTuple):
    T_cw: jnp.ndarray      # (4, 4) optimized pose
    inlier: jnp.ndarray    # (N,) final inlier mask
    n_inliers: jnp.ndarray
    chi2: jnp.ndarray      # (N,) final per-obs chi2


def _residual_jacobian(T_cw: jnp.ndarray, obs: PoseObs, cam: CameraModel):
    """Batched residual (N, 3) and Jacobian (N, 3, 6) w.r.t. left-multiplied
    se3 increment [rho, phi].  Third row is the stereo u_r residual, masked
    later where ur < 0."""
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    pc = obs.points_w @ R.T + t  # (N, 3)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zi = 1.0 / jnp.maximum(z, 1e-6)
    zi2 = zi * zi

    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    ur = u - cam.bf * zi

    r = jnp.stack(
        [u - obs.uv[:, 0], v - obs.uv[:, 1], ur - obs.ur], axis=-1
    )

    # d(proj)/d(pc): (N, 3, 3)
    zeros = jnp.zeros_like(x)
    J_proj = jnp.stack(
        [
            jnp.stack([cam.fx * zi, zeros, -cam.fx * x * zi2], -1),
            jnp.stack([zeros, cam.fy * zi, -cam.fy * y * zi2], -1),
            jnp.stack([cam.fx * zi, zeros, (-cam.fx * x + cam.bf) * zi2], -1),
        ],
        axis=-2,
    )
    # d(pc)/d(delta) = [I | -hat(pc)]: (N, 3, 6)
    I3 = jnp.broadcast_to(jnp.eye(3), (pc.shape[0], 3, 3))
    J_pt = jnp.concatenate([I3, -hat(pc)], axis=-1)
    J = J_proj @ J_pt  # (N, 3, 6)

    behind = z <= 1e-6
    return r, J, behind


@jax.jit
def reprojection_chi2(T_cw: jnp.ndarray, obs: PoseObs, cam: CameraModel):
    """Per-observation chi2 (normalized squared error; 2-DoF mono, 3-DoF
    stereo) and the stereo mask."""
    r, _, behind = _residual_jacobian(T_cw, obs, cam)
    has_ur = obs.ur >= 0.0
    r = r.at[:, 2].set(jnp.where(has_ur, r[:, 2], 0.0))
    chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
    chi2 = jnp.where(behind, 1e9, chi2)
    return chi2, has_ur


@functools.partial(jax.jit, static_argnames=("rounds", "iters_per_round"))
def pose_optimization(
    T_cw_init: jnp.ndarray,
    obs: PoseObs,
    cam: CameraModel,
    rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """The 4x10 LM schedule with chi2 re-flagging between rounds."""
    has_ur = obs.ur >= 0.0
    chi2_th = jnp.where(has_ur, CHI2_STEREO, CHI2_MONO)
    delta_h = jnp.sqrt(chi2_th)

    def lm_round(carry, robust: bool):
        T, inlier = carry

        def lm_iter(i, st):
            T, lam, best_err = st
            r, J, behind = _residual_jacobian(T, obs, cam)
            r = r.at[:, 2].set(jnp.where(has_ur, r[:, 2], 0.0))
            J = J.at[:, 2, :].set(
                jnp.where(has_ur[:, None], J[:, 2, :], 0.0)
            )
            w_info = obs.inv_sigma2 * inlier.astype(jnp.float32) * (
                ~behind
            ).astype(jnp.float32)
            # Huber IRLS weight on the normalized residual norm.
            rn = jnp.sqrt(jnp.sum(r * r, -1) * obs.inv_sigma2 + 1e-12)
            w_huber = (
                jnp.minimum(1.0, delta_h / jnp.maximum(rn, 1e-12))
                if robust
                else jnp.ones_like(rn)
            )
            w = w_info * w_huber

            H = jnp.einsum("nij,n,nik->jk", J, w, J)
            b = jnp.einsum("nij,n,ni->j", J, w, r)
            err = jnp.sum(w * jnp.sum(r * r, -1))

            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
            # jnp.linalg.solve + reusing the full residual/Jacobian
            # evaluation for the candidate (XLA CSEs the candidate's J with
            # the next iteration).  On the GPU the tracking step's LU and
            # triangular-solve kernels are a large share of its device
            # time (PERF.md); an unrolled 6x6 Cholesky is the alternative
            # to measure there.
            delta = -jnp.linalg.solve(Hd, b)
            T_new = se3_exp(delta) @ T

            # Evaluate candidate
            r2, _, behind2 = _residual_jacobian(T_new, obs, cam)
            r2 = r2.at[:, 2].set(jnp.where(has_ur, r2[:, 2], 0.0))
            rn2 = jnp.sqrt(jnp.sum(r2 * r2, -1) * obs.inv_sigma2 + 1e-12)
            w2 = w_info * (
                jnp.minimum(1.0, delta_h / jnp.maximum(rn2, 1e-12))
                if robust
                else 1.0
            )
            err_new = jnp.sum(w2 * jnp.sum(r2 * r2, -1))

            accept = err_new < err
            T = jnp.where(accept, T_new, T)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            lam = jnp.clip(lam, 1e-8, 1e4)
            return (T, lam, jnp.minimum(err, err_new))

        T, _, _ = jax.lax.fori_loop(
            0, iters_per_round, lm_iter, (T, jnp.float32(1e-3), jnp.float32(jnp.inf))
        )
        chi2, _ = reprojection_chi2(T, obs, cam)
        inlier = obs.valid & (chi2 <= chi2_th)
        return (T, inlier)

    T = T_cw_init
    inlier = obs.valid
    # Rounds 1-2 robust (Huber), rounds 3-4 plain — the reference's schedule.
    for k in range(rounds):
        T, inlier = lm_round((T, inlier), robust=(k < 2))

    chi2, _ = reprojection_chi2(T, obs, cam)
    return PoseOptResult(
        T_cw=T,
        inlier=inlier,
        n_inliers=jnp.sum(inlier),
        chi2=chi2,
    )
