"""Perspective-n-Point RANSAC for relocalization.

Role of the reference's ``PnPsolver`` (src/PnPsolver.cc, EPnP + RANSAC —
SURVEY.md §2.1).  Batched substitution: the hypothesis solver is a
batched 6-point DLT (one (12,12) SVD per hypothesis, all hypotheses one
tensor) with orthogonal Procrustes rotation extraction, scored by
reprojection chi2 exactly like PnPsolver::CheckInliers; the winner is
polished by the shared LM pose optimizer (solvers/pose_opt), which plays
the role of EPnP's gauss_newton + the reference's follow-up
PoseOptimization.  Same capability (robust pose from 2D-3D matches under
outliers), kernel chosen for batch-friendliness.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..solvers.lie import rt_to_mat
from ..utils.camera import CameraModel


def _dlt_pose(xn: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """6+ point DLT: normalized image coords (M, 2) + world points (M, 3)
    -> T_cw (4, 4).  Rotation re-orthogonalized by SVD (Procrustes)."""
    u, v = xn[:, 0], xn[:, 1]
    zeros = jnp.zeros_like(X)
    ones = jnp.ones_like(u)[:, None]
    Xh = jnp.concatenate([X, ones], axis=1)  # (M, 4)
    z4 = jnp.zeros_like(Xh)
    r1 = jnp.concatenate([Xh, z4, -u[:, None] * Xh], axis=1)  # (M, 12)
    r2 = jnp.concatenate([z4, Xh, -v[:, None] * Xh], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2M, 12)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    Pm = vt[-1].reshape(3, 4)
    # Fix scale + sign: ||R rows|| ~ 1, points in front.
    R_raw = Pm[:, :3]
    scale = jnp.cbrt(jnp.abs(jnp.linalg.det(R_raw)) + 1e-12)
    Pm = Pm / jnp.where(scale < 1e-9, 1e-9, scale)
    # Sign: mean depth of the points should be positive.
    depths = X @ Pm[2, :3] + Pm[2, 3]
    Pm = jnp.where(jnp.mean(depths) < 0, -Pm, Pm)
    # Procrustes: nearest rotation.
    U, _, Vt = jnp.linalg.svd(Pm[:, :3])
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]))
    det = jnp.linalg.det(U @ Vt)
    D = D.at[2, 2].set(jnp.sign(det))
    R = U @ D @ Vt
    t = Pm[:, 3]
    return rt_to_mat(R, t)


class PnPResult(NamedTuple):
    T_cw: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    ok: jnp.ndarray


# ---------------------------------------------------------------------------
# P3P minimal solver (Grunert's triangle equations) — the planar-safe
# hypothesis generator, batched.  The reference's EPnP (PnPsolver.cc) handles
# coplanar world points; the 6-point DLT above does NOT (projective ambiguity
# on a plane), so RANSAC over DLT samples silently fails on wall-/floor-
# dominated scenes.  P3P+1 also cuts the minimal sample from 6 to 4 points:
# at inlier ratio w the per-hypothesis success odds improve from w^6 to w^4.
# ---------------------------------------------------------------------------


def _quartic_roots_dk(coeffs: jnp.ndarray, iters: int = 48) -> jnp.ndarray:
    """Durand-Kerner all-roots iteration for a batch of quartics.

    coeffs: (..., 5) with [c4, c3, c2, c1, c0].  Returns (..., 4) complex
    roots.  Pure arithmetic (no eig), so it runs under jit anywhere."""
    c4 = coeffs[..., 0:1]
    monic = coeffs / jnp.where(jnp.abs(c4) < 1e-12, 1e-12, c4)
    c3, c2, c1, c0 = (monic[..., i] for i in range(1, 5))

    def poly(z):
        return (((z + c3[..., None]) * z + c2[..., None]) * z
                + c1[..., None]) * z + c0[..., None]

    w = jnp.asarray(0.4 + 0.9j, jnp.complex64)
    z = jnp.broadcast_to(
        w ** jnp.arange(4), coeffs.shape[:-1] + (4,)
    ).astype(jnp.complex64)

    def body(_, z):
        p = poly(z)
        diff = z[..., :, None] - z[..., None, :]          # (..., 4, 4)
        diff = diff + jnp.eye(4, dtype=z.dtype)           # avoid /0 on diag
        denom = jnp.prod(diff, axis=-1)
        return z - p / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)

    return jax.lax.fori_loop(0, iters, body, z)


def _p3p_poses(xn: jnp.ndarray, X: jnp.ndarray):
    """Grunert P3P: normalized image coords (4, 2) + world points (4, 3).

    Points 0..2 form the minimal triangle; point 3 disambiguates among the
    up-to-4 solutions.  The quartic in the distance ratio v = s3/s1 is
    derived NUMERICALLY: the elimination polynomial g(v) (a closed-form
    quartic) is evaluated at 5 nodes and its coefficients recovered by a
    fixed 5x5 Vandermonde solve — no hand-expanded algebra to get wrong.

    Returns (Ts (4, 4, 4), valid (4,), err3 (4,) reprojection error of the
    4th point under each solution)."""
    from ..ops.sim3_solve import horn_sim3

    f = jnp.concatenate([xn, jnp.ones_like(xn[:, :1])], axis=1)
    f = f / jnp.linalg.norm(f, axis=1, keepdims=True)     # bearings (4, 3)
    j1, j2, j3 = f[0], f[1], f[2]
    P1, P2, P3 = X[0], X[1], X[2]
    a2 = jnp.sum((P2 - P3) ** 2)
    b2 = jnp.sum((P1 - P3) ** 2)
    c2 = jnp.sum((P1 - P2) ** 2)
    cos_a = jnp.dot(j2, j3)
    cos_b = jnp.dot(j1, j3)
    cos_g = jnp.dot(j1, j2)
    b2s = jnp.maximum(b2, 1e-12)
    q = (a2 - c2) / b2s
    r_c = c2 / b2s

    def g_of(v):
        # D(v) u = N(v) is the linear elimination of u; g(v)=0 is Grunert's
        # quartic:  D^2 + N^2 - 2 N D cos_g - r(v) D^2 = 0  with
        # r(v) = (c^2/b^2)(1 + v^2 - 2 v cos_b).
        D = 2.0 * (cos_g - v * cos_a)
        N = q * (1.0 + v * v - 2.0 * v * cos_b) + 1.0 - v * v
        r = r_c * (1.0 + v * v - 2.0 * v * cos_b)
        return D * D + N * N - 2.0 * N * D * cos_g - r * D * D

    nodes = jnp.asarray([-2.0, -1.0, 0.0, 1.0, 2.0])
    gv = jax.vmap(g_of)(nodes)                            # (5,)
    V = nodes[:, None] ** jnp.arange(4, -1, -1)[None, :]  # [v^4 .. v^0]
    coeffs = jnp.linalg.solve(V, gv)                      # (5,) c4..c0

    roots = _quartic_roots_dk(coeffs)                     # (4,) complex
    v = jnp.real(roots)
    real_ok = jnp.abs(jnp.imag(roots)) < 1e-3 * (1.0 + jnp.abs(v))

    D = 2.0 * (cos_g - v * cos_a)
    N = q * (1.0 + v * v - 2.0 * v * cos_b) + 1.0 - v * v
    u = N / jnp.where(jnp.abs(D) < 1e-9, 1e-9, D)
    s1_sq = b2 / jnp.maximum(1.0 + v * v - 2.0 * v * cos_b, 1e-12)
    s1 = jnp.sqrt(jnp.maximum(s1_sq, 0.0))
    s2 = u * s1
    s3 = v * s1
    # Triangle consistency (eq. for side a) + positive depths.
    eq_a = s2 * s2 + s3 * s3 - 2.0 * s2 * s3 * cos_a
    ok = (
        real_ok & (s1 > 1e-6) & (s2 > 1e-6) & (s3 > 1e-6)
        & (jnp.abs(eq_a - a2) < 1e-2 * (1.0 + a2))
    )

    def pose_of(si, ui, vi):
        Xc = jnp.stack([si * j1, ui * si * j2, vi * si * j3])  # (3, 3) cam
        R, t, _ = horn_sim3(Xc, X[:3], fix_scale=True)
        return rt_to_mat(R, t)

    Ts = jax.vmap(pose_of)(s1, u, v)                      # (4, 4, 4)
    # Disambiguate with the 4th point's reprojection.
    pc = jnp.einsum("kij,j->ki", Ts[:, :3, :3], X[3]) + Ts[:, :3, 3]
    z = jnp.maximum(pc[:, 2], 1e-6)
    err3 = jnp.sum((pc[:, :2] / z[:, None] - xn[3]) ** 2, axis=-1)
    err3 = jnp.where(ok & (pc[:, 2] > 0), err3, 1e12)
    return Ts, ok, err3


@functools.partial(jax.jit, static_argnames=("iters",))
def p3p_ransac(
    uv: jnp.ndarray,
    points_w: jnp.ndarray,
    valid: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    cam: CameraModel,
    key: jnp.ndarray,
    iters: int = 1024,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> PnPResult:
    """Batched P3P+1 RANSAC (the reference's PnPsolver::iterate shape with
    a planar-safe minimal solver).  Each hypothesis draws 4 points: P3P on
    the first 3, the 4th picks among the quartic's solutions; the winner
    (by full inlier count) is returned for the caller's LM polish."""
    M = uv.shape[0]
    xn = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], -1
    )
    w = valid.astype(jnp.float32)
    p = w / jnp.maximum(w.sum(), 1.0)
    samples = jax.random.choice(key, M, shape=(iters, 4), replace=True, p=p)

    Ts, sol_ok, err3 = jax.vmap(
        lambda s: _p3p_poses(xn[s], points_w[s])
    )(samples)                                            # (I,4,4,4) etc.
    best_sol = jnp.argmin(err3, axis=1)                   # (I,)
    Ts = jnp.take_along_axis(
        Ts, best_sol[:, None, None, None], axis=1
    )[:, 0]
    hyp_ok = jnp.take_along_axis(sol_ok, best_sol[:, None], axis=1)[:, 0]

    def score(T):
        pc = points_w @ T[:3, :3].T + T[:3, 3]
        z = jnp.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
        inl = valid & (chi2 < chi2_th) & (pc[:, 2] > 0.01)
        return jnp.sum(inl), inl

    n_in, inls = jax.vmap(score)(Ts)
    n_in = jnp.where(hyp_ok, n_in, 0)
    best = jnp.argmax(n_in)
    ok = n_in[best] >= min_inliers
    return PnPResult(
        T_cw=Ts[best], inliers=inls[best], n_inliers=n_in[best], ok=ok
    )


@functools.partial(jax.jit, static_argnames=("iters",))
def pnp_ransac(
    uv: jnp.ndarray,
    points_w: jnp.ndarray,
    valid: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    cam: CameraModel,
    key: jnp.ndarray,
    iters: int = 256,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> PnPResult:
    """Batched-hypothesis PnP RANSAC (PnPsolver::iterate, ≈170).

    uv: (M, 2) undistorted pixel obs; points_w: (M, 3); valid: (M,).
    """
    M = uv.shape[0]
    xn = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], -1
    )
    w = valid.astype(jnp.float32)
    p = w / jnp.maximum(w.sum(), 1.0)
    samples = jax.random.choice(key, M, shape=(iters, 6), replace=True, p=p)

    Ts = jax.vmap(lambda s: _dlt_pose(xn[s], points_w[s]))(samples)

    def score(T):
        pc = points_w @ T[:3, :3].T + T[:3, 3]
        z = jnp.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
        inl = valid & (chi2 < chi2_th) & (pc[:, 2] > 0.01)
        return jnp.sum(inl), inl

    n_in, inls = jax.vmap(score)(Ts)
    best = jnp.argmax(n_in)
    ok = n_in[best] >= min_inliers
    return PnPResult(
        T_cw=Ts[best], inliers=inls[best], n_inliers=n_in[best], ok=ok
    )
