"""Essential-graph (Sim3 pose graph) optimization.

JAX equivalent of ``Optimizer::OptimizeEssentialGraph``
(src/Optimizer.cc:≈700): all keyframes as Sim3 variables (7-DoF mono,
scale-frozen stereo/RGB-D), edges = loop edges + spanning tree +
strong-covisibility (weight >= 100), 20 GN/LM iterations, then poses
recovered by dividing translation by scale and map points transformed by
their reference keyframe's correction.

Design: edges live in fixed-capacity arrays (the covisibility graph is
already a dense matrix, ms.covisibility); residual r_e = log(S_meas_ji *
S_i * S_j^{-1}) on all edges batched; the Gauss-Newton normal system is
assembled by scatter-add into a dense (7K, 7K) matrix (K <= a few hundred
-> the dense Cholesky solve is matmul-friendly).  Jacobians by forward-mode
autodiff through the batched residual.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .lie import se3_inverse, sim3_exp, sim3_from_mat, sim3_inverse_mat, sim3_log, sim3_to_mat


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity edge list: S_ji measurements between keyframes.

    i/j:    (E,) int32 endpoints
    S_ji:   (E, 4, 4) packed sim3 measurement (frame j <- frame i)
    weight: (E,) float32 (1 for tree/loop edges; covisibility normalized)
    valid:  (E,)
    """

    i: jnp.ndarray
    j: jnp.ndarray
    S_ji: jnp.ndarray
    weight: jnp.ndarray
    valid: jnp.ndarray


def edges_from_map(
    kf_pose_cw: jnp.ndarray,
    kf_valid: jnp.ndarray,
    kf_parent: jnp.ndarray,
    covis: jnp.ndarray,
    loop_i: jnp.ndarray,
    loop_j: jnp.ndarray,
    loop_S_ji: jnp.ndarray,
    loop_valid: jnp.ndarray,
    min_covis_weight: int = 100,
    corrected_S_cw: jnp.ndarray | None = None,
    max_covis_per_node: int = 16,
) -> PoseGraphEdges:
    """Build the essential-graph edge set.

    Measurements for tree/covisibility edges come from CURRENT relative
    poses (the reference computes them from the poses at correction time);
    loop edges carry their own Sim3 measurements.

    Covisibility edges are each node's TOP-``max_covis_per_node`` neighbors
    with weight >= min_covis_weight — E stays O(K), not the K^2/2 triangle
    (the reference's essential graph is equally sparse: >=100-shared-point
    pairs are a node's strongest few neighbors).  A pair strong in both
    directions appears twice; duplicate consistent constraints only
    re-weight, as in the reference's insertion set.
    """
    K = kf_pose_cw.shape[0]
    S_cw = sim3_of_se3(kf_pose_cw)

    # Spanning-tree edges: (child, parent).
    child = jnp.arange(K, dtype=jnp.int32)
    parent = kf_parent
    tree_ok = kf_valid & (parent >= 0) & kf_valid[jnp.maximum(parent, 0)]
    tree_i = jnp.maximum(parent, 0)
    tree_j = child

    # Covisibility edges: per-node top-k with weight >= min.
    kk = min(max_covis_per_node, K)
    w_top, nbr = jax.lax.top_k(covis, kk)                   # (K, kk)
    cov_i = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[:, None], (K, kk)
    ).reshape(-1)
    cov_j = nbr.astype(jnp.int32).reshape(-1)
    cov_ok = (
        (w_top.reshape(-1) >= min_covis_weight)
        & kf_valid[cov_i] & kf_valid[cov_j] & (cov_i != cov_j)
    )

    def rel(Si, Sj):
        # S_ji = S_j * S_i^-1
        return Sj @ sim3_inverse_mat(Si)

    S_tree = jax.vmap(rel)(S_cw[tree_i], S_cw[tree_j])
    S_cov = jax.vmap(rel)(S_cw[cov_i], S_cw[cov_j])

    i_all = jnp.concatenate([tree_i, cov_i, loop_i])
    j_all = jnp.concatenate([tree_j, cov_j, loop_j])
    S_all = jnp.concatenate([S_tree, S_cov, loop_S_ji])
    v_all = jnp.concatenate([tree_ok, cov_ok, loop_valid])
    w_all = jnp.ones_like(v_all, jnp.float32)
    return PoseGraphEdges(i=i_all, j=j_all, S_ji=S_all, weight=w_all, valid=v_all)


def sim3_of_se3(T: jnp.ndarray) -> jnp.ndarray:
    """SE3 (..., 4, 4) -> packed Sim3 with s=1 (same matrix)."""
    return T


@functools.partial(jax.jit, static_argnames=("iters", "fix_scale"))
def optimize_essential_graph(
    kf_pose_cw: jnp.ndarray,     # (K, 4, 4) current SE3 poses
    kf_valid: jnp.ndarray,       # (K,)
    edges: PoseGraphEdges,
    fixed_mask: jnp.ndarray,     # (K,) keyframes held fixed (loop KF)
    init_S_cw: jnp.ndarray | None = None,  # (K, 4, 4) packed sim3 seeds
    iters: int = 20,
    fix_scale: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (corrected SE3 poses (K, 4, 4), scales (K,)).

    Map-point correction (per reference: transform each point by its
    reference KF's old->new Sim3) is the caller's job with the returned
    scales/poses.
    """
    K = kf_pose_cw.shape[0]
    S0 = kf_pose_cw if init_S_cw is None else init_S_cw
    xi0 = jnp.zeros((K, 7))
    fix = jnp.float32(1.0 if fix_scale else 0.0)

    ei, ej = edges.i, edges.j
    w_e = edges.weight * edges.valid.astype(jnp.float32)

    def edge_residuals(xi_all):
        xi_all = xi_all.at[:, 6].multiply(1.0 - fix)
        S_all = jax.vmap(lambda x, s0: sim3_exp(x) @ s0)(xi_all, S0)
        Si = S_all[ei]
        Sj = S_all[ej]
        # r = log(S_ji_meas * S_i * S_j^-1)
        M = jnp.einsum(
            "eij,ejk,ekl->eil", edges.S_ji, Si, jax.vmap(sim3_inverse_mat)(Sj)
        )
        return jax.vmap(sim3_log)(M)  # (E, 7)

    def total_err(xi_all):
        r = edge_residuals(xi_all)
        return jnp.sum(w_e[:, None] * r * r)

    # Freeze nodes with no valid edges (no constraints -> the dense solve
    # would hand them garbage updates).
    degree = (
        jnp.zeros(K).at[ei].add(edges.valid.astype(jnp.float32))
        .at[ej].add(edges.valid.astype(jnp.float32))
    )
    free = kf_valid & ~fixed_mask & (degree > 0)

    # Beyond this, the dense (7K, 7K) assemble + Cholesky is replaced by a
    # matrix-free block-Jacobi-preconditioned CG (the reference's g2o uses
    # sparse Cholesky here; PCG with edge-local matvecs is the batched
    # sparse solver — O(E) per matvec, no K^2 memory).
    use_cg = K * 7 > 4096

    def body(_, carry):
        xi, lam = carry
        r = edge_residuals(xi)  # (E, 7)

        # Jacobians of each edge wrt its two endpoint tangents, via jvp on
        # a per-edge function (batched over E and the 7 basis directions).
        def edge_res_of(xi_i, xi_j, Si0, Sj0, S_meas):
            xi_i = xi_i.at[6].multiply(1.0 - fix)
            xi_j = xi_j.at[6].multiply(1.0 - fix)
            Si = sim3_exp(xi_i) @ Si0
            Sj = sim3_exp(xi_j) @ Sj0
            return sim3_log(S_meas @ Si @ sim3_inverse_mat(Sj))

        J_i = jax.vmap(
            jax.jacfwd(edge_res_of, argnums=0),
            in_axes=(0, 0, 0, 0, 0),
        )(xi[ei], xi[ej], S0[ei], S0[ej], edges.S_ji)  # (E, 7, 7)
        J_j = jax.vmap(
            jax.jacfwd(edge_res_of, argnums=1),
            in_axes=(0, 0, 0, 0, 0),
        )(xi[ei], xi[ej], S0[ei], S0[ej], edges.S_ji)

        wJe_i = J_i * w_e[:, None, None]
        wJe_j = J_j * w_e[:, None, None]
        b = jnp.zeros((K, 7))
        b = b.at[ei].add(jnp.einsum("eri,er->ei", wJe_i, r))
        b = b.at[ej].add(jnp.einsum("eri,er->ei", wJe_j, r))

        free_dims = free[:, None] & jnp.ones((1, 7), bool)
        if fix_scale:
            # Pin every scale dimension explicitly — its Hessian row is
            # ~zero (residuals don't depend on it) and would make the
            # solve near-singular, polluting all other dims.
            free_dims = free_dims & (jnp.arange(7) != 6)[None, :]

        # Block-diagonal of H (used by both paths: damping + preconditioner).
        H_diag = jnp.zeros((K, 7, 7))
        H_diag = H_diag.at[ei].add(jnp.einsum("eri,erj->eij", J_i, wJe_i))
        H_diag = H_diag.at[ej].add(jnp.einsum("eri,erj->eij", J_j, wJe_j))
        d_elem = jnp.maximum(
            jnp.diagonal(H_diag, axis1=-2, axis2=-1), 1e-6
        )  # (K, 7)

        if not use_cg:
            H = jnp.zeros((K, 7, K, 7))
            H = H.at[ei, :, ei, :].add(jnp.einsum("eri,erj->eij", J_i, wJe_i))
            H = H.at[ej, :, ej, :].add(jnp.einsum("eri,erj->eij", J_j, wJe_j))
            H = H.at[ei, :, ej, :].add(jnp.einsum("eri,erj->eij", J_i, wJe_j))
            H = H.at[ej, :, ei, :].add(jnp.einsum("eri,erj->eij", J_j, wJe_i))
            Hd = H.reshape(K * 7, K * 7)
            bd = b.reshape(-1)
            free7 = free_dims.reshape(-1)
            Hd = Hd + jnp.diag((lam * d_elem).reshape(-1))
            Hd = jnp.where(free7[:, None] & free7[None, :], Hd, 0.0)
            Hd = Hd + jnp.diag(jnp.where(free7, 0.0, 1.0))
            bd = jnp.where(free7, bd, 0.0)
            dx = -jnp.linalg.solve(Hd, bd).reshape(K, 7)
        else:
            bm = jnp.where(free_dims, b, 0.0)

            def matvec(x):
                x = jnp.where(free_dims, x, 0.0)
                y = (
                    jnp.einsum("erc,ec->er", J_i, x[ei])
                    + jnp.einsum("erc,ec->er", J_j, x[ej])
                ) * w_e[:, None]
                out = jnp.zeros_like(x)
                out = out.at[ei].add(jnp.einsum("erc,er->ec", J_i, y))
                out = out.at[ej].add(jnp.einsum("erc,er->ec", J_j, y))
                out = out + lam * d_elem * x
                return jnp.where(free_dims, out, x)

            # Block-Jacobi preconditioner: damped 7x7 block inverses.
            M = H_diag + jax.vmap(jnp.diag)(lam * d_elem + 1e-6)
            M_inv = jnp.linalg.inv(M)

            def precond(x):
                return jnp.where(
                    free_dims, jnp.einsum("kij,kj->ki", M_inv, x), x
                )

            dx_neg, _ = jax.scipy.sparse.linalg.cg(
                matvec, bm, M=precond, maxiter=100, tol=1e-6
            )
            dx = -jnp.where(free_dims, dx_neg, 0.0)

        xi_new = xi + dx
        accept = total_err(xi_new) < total_err(xi)
        xi = jnp.where(accept, xi_new, xi)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e3)
        return (xi, lam)

    xi, _ = jax.lax.fori_loop(0, iters, body, (xi0, jnp.float32(1e-4)))
    xi = xi.at[:, 6].multiply(1.0 - fix)
    S_final = jax.vmap(lambda x, s0: sim3_exp(x) @ s0)(xi, S0)
    R, t, s = sim3_from_mat(S_final)
    # Recover SE3: divide translation by scale (Optimizer.cc:≈1050).
    from .lie import rt_to_mat

    T = rt_to_mat(R, t / s[..., None])
    return T, s
