"""SE(3)/Sim(3) Lie-group operations in pure JAX.

JAX replacement for the reference's g2o Lie types
(``Thirdparty/g2o/g2o/types/se3quat.h``, ``sim3.h``, ``se3_ops.h`` — see
SURVEY.md §2.2).  Everything here is batched-friendly (leading dims broadcast)
and differentiable, so the GN/LM solvers can autodiff through retractions.

Conventions
-----------
* Rotations are 3x3 matrices (float32 by default; solvers promote to f64-free
  f32 math — accelerators are slow in f64, and SLAM-scale problems are
  fine in f32).
* SE3 is stored as a 4x4 homogeneous matrix ``T`` with ``T[..., :3, :3] = R``,
  ``T[..., :3, 3] = t``.
* Tangent vectors: se3 = ``[rho(3), phi(3)]`` (translation first, matching
  g2o's ``SE3Quat::exp`` ordering ``[omega, upsilon]`` is rotation-first; we
  use ``[phi, rho]``? -- No: we standardize on ``[rho, phi]`` = (v, omega)).
* sim3 tangent = ``[rho(3), phi(3), sigma(1)]`` with scale ``s = exp(sigma)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(Phi: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack(
        [Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], axis=-1
    )


def _sinc_terms(theta2):
    """Taylor-safe (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    theta = jnp.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS))
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / (theta2 + _EPS))
    return A, B, C


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    A, B, _ = _sinc_terms(theta2)
    Phi = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Phi.shape)
    return I + A[..., None, None] * Phi + B[..., None, None] * (Phi @ Phi)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Log map: (..., 3, 3) -> (..., 3) axis-angle.  Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    # Clamp strictly inside (-1, 1): arccos' blows up at the endpoints and
    # poisons autodiff (the pose-graph/Sim3 solvers differentiate through
    # this log at zero-residual edges, i.e. exactly at the endpoint).
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_t)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    sin_t = jnp.sin(theta)
    # Generic branch: phi = theta / (2 sin theta) * vee(R - R^T); near theta=0
    # the factor tends to 1/2 (1 + theta^2/6).
    small_scale = 0.5 + theta * theta / 12.0
    scale = jnp.where(sin_t > 1e-6, theta / (2.0 * sin_t + _EPS), small_scale)
    phi_generic = 2.0 * w * scale[..., None]
    # Near theta ~ pi: axis from diagonal of (R + I)/2 = axis axis^T components
    # R + I has columns proportional to axis; take the largest diagonal.
    Rp = R + jnp.eye(3, dtype=R.dtype)
    diag = jnp.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(Rp, k[..., None, None].repeat(3, axis=-2), axis=-1)[..., 0]
    axis = col / (jnp.linalg.norm(col, axis=-1, keepdims=True) + _EPS)
    # Fix the sign so that it is consistent with w (w ~ sin(theta)*axis ~ 0 at pi,
    # sign is ambiguous there; either is a valid log).
    phi_pi = axis * theta[..., None]
    # Threshold must exceed the arccos clamp margin (arccos(-1 + 1e-7) =
    # pi - ~4.5e-4) so angles at the clamp still take the pi branch.
    near_pi = (jnp.pi - theta) < 1e-3
    return jnp.where(near_pi[..., None], phi_pi, phi_generic)


def _left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian J_l(phi): V matrix in the SE3 exp."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    _, B, C = _sinc_terms(theta2)
    Phi = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Phi.shape)
    return I + B[..., None, None] * Phi + C[..., None, None] * (Phi @ Phi)


def _left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    Phi = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Phi.shape)
    half = 0.5 * theta
    cot = jnp.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half * jnp.cos(half) / (jnp.sin(half) + _EPS)) / (theta2 + _EPS))
    return I - 0.5 * Phi + cot[..., None, None] * (Phi @ Phi)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exp: (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    V = _left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return rt_to_mat(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log: (..., 4, 4) -> (..., 6) [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    Vinv = _left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def rt_to_mat(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) homogeneous."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def se3_apply(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to points (..., 3)."""
    return jnp.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


# ---------------------------------------------------------------------------
# Sim(3) — 7-DoF similarity transforms for loop closing / essential graph.
# Stored as (R: (...,3,3), t: (...,3), s: (...,)) tuples or packed 4x4 with
# scaled rotation sR in the upper-left block.
# ---------------------------------------------------------------------------


def sim3_to_mat(R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Pack Sim3 as 4x4 with sR block (the g2o::Sim3 convention)."""
    return rt_to_mat(s[..., None, None] * R, t)


def sim3_from_mat(S: jnp.ndarray):
    sR = S[..., :3, :3]
    s = jnp.cbrt(jnp.abs(jnp.linalg.det(sR)) + _EPS)
    R = sR / s[..., None, None]
    t = S[..., :3, 3]
    return R, t, s


def sim3_inverse_mat(S: jnp.ndarray) -> jnp.ndarray:
    R, t, s = sim3_from_mat(S)
    Rinv = jnp.swapaxes(R, -1, -2)
    sinv = 1.0 / s
    tinv = -sinv[..., None] * jnp.einsum("...ij,...j->...i", Rinv, t)
    return sim3_to_mat(Rinv, tinv, sinv)


def sim3_apply(S: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply packed Sim3 (sR | t) to points."""
    return jnp.einsum("...ij,...j->...i", S[..., :3, :3], p) + S[..., :3, 3]


def sim3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """sim(3) exp: (..., 7) [rho, phi, sigma] -> packed 4x4 (sR | t).

    Closed-form W matrix per Strasdat, "Local Accuracy and Global Consistency
    for Efficient Visual SLAM" (the formulation g2o's Sim3 type implements).
    """
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(phi)
    W = _sim3_W(phi, sigma, dtype=xi.dtype)
    t = jnp.einsum("...ij,...j->...i", W, rho)
    return sim3_to_mat(R, t, s)


def sim3_log(S: jnp.ndarray) -> jnp.ndarray:
    """Packed Sim3 -> (..., 7) [rho, phi, sigma] by solving W rho = t."""
    R, t, s = sim3_from_mat(S)
    phi = so3_log(R)
    sigma = jnp.log(s)
    W = _sim3_W(phi, sigma, dtype=S.dtype)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def _sim3_W(phi: jnp.ndarray, sigma: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    s = jnp.exp(sigma)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    I = jnp.broadcast_to(jnp.eye(3, dtype=dtype), Phi.shape)
    eps_sigma = jnp.abs(sigma) < 1e-5
    small_theta = theta2 < 1e-8
    sig = jnp.where(eps_sigma, 1.0, sigma)
    s_cos = s * jnp.cos(theta)
    s_sin = s * jnp.sin(theta)
    denom = sig * sig + theta2
    A = jnp.where(eps_sigma, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig)
    b_gen = (sig * s_sin + (1.0 - s_cos) * theta) / (jnp.where(small_theta, 1.0, theta) * denom)
    c_gen = (A - ((s_cos - 1.0) * sig + s_sin * theta) / denom) / jnp.where(small_theta, 1.0, theta2)
    _, B0, C0 = _sinc_terms(theta2)
    b = jnp.where(eps_sigma, B0, b_gen)
    c = jnp.where(eps_sigma, C0, c_gen)
    b_t0 = (sig * s + 1.0 - s) / (sig * sig)
    b = jnp.where(small_theta & ~eps_sigma, b_t0, b)
    c = jnp.where(small_theta, jnp.where(eps_sigma, 1.0 / 6.0, c), c)
    return A[..., None, None] * I + b[..., None, None] * Phi + c[..., None, None] * Phi2


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (adjugate) inverse of batched (..., 3, 3) matrices.

    jnp.linalg.inv lowers small batched inverses to an LU factorization;
    this fully-vectorized cofactor form is elementwise arithmetic.  It
    sits inside every LM iteration of the Schur solvers (landmark-block
    inversion)
    per bundle adjustment."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], -1),
            jnp.stack([A21, A22, A23], -1),
            jnp.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def orthonormalize_se3(T: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """Project the rotation block of (..., 4, 4) SE3 back onto SO(3).  The
    tracking velocity model composes T_t (T_{t-1})^-1 every frame, which
    amplifies any determinant error geometrically — re-projection at the
    tracking boundary keeps the chain on the manifold.

    Newton-Schulz polar iteration (X <- 0.5 X (3I - X^T X)) instead of the
    SVD polar factor: inputs here are NEAR-rotations (drifted by float
    accumulation, singular values ~1), where 3 iterations reach ~1e-7 of
    the SVD answer, and batched small SVD lowers to an iterative solver
    while this is three batched 3x3 matmuls.  It preserves the
    determinant sign, so near-SO(3) inputs stay proper rotations."""
    R = T[..., :3, :3]
    # Scale into the Newton-Schulz convergence region (||X||_2 <= sqrt(3)).
    norm = jnp.sqrt(
        jnp.sum(R * R, axis=(-2, -1), keepdims=True)
    )
    X = R / jnp.maximum(norm / jnp.sqrt(3.0), 1.0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), X.shape)
    for _ in range(iters):
        XtX = jnp.einsum("...ji,...jk->...ik", X, X)
        X = 0.5 * jnp.einsum("...ij,...jk->...ik", X, 3.0 * eye - XtX)
    return rt_to_mat(X, T[..., :3, 3])
