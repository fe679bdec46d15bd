"""Distributed essential-graph (Sim3 pose-graph) optimization.

Multi-chip version of ``solvers/pose_graph.optimize_essential_graph``
(the reference's ``Optimizer::OptimizeEssentialGraph``, src/Optimizer.cc:≈700,
which runs single-threaded under the global map lock): EDGES are sharded
over the mesh axis ``"map"``; each device evaluates residuals + Jacobians
for its edge shard and assembles a partial dense normal system, which is
reduced with one ``psum`` per Gauss-Newton iteration.  The (small,
dense) (7K, 7K) solve is replicated — identical on every device — so the
corrected poses come out replicated with no further communication.

This is the SURVEY.md §2.5/§5 "pose-graph relaxation as a global collective
solve": per-iteration comms = one all-reduce of (7K)^2 + 7K floats, compute
scales with E/n_devices.

Parity: bit-identical math to the single-device solver (same residual,
damping schedule, gauge handling); the test suite checks the 8-virtual-
device result matches the single-device one.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..solvers.lie import rt_to_mat, sim3_exp, sim3_from_mat, sim3_inverse_mat, sim3_log
from ..solvers.pose_graph import PoseGraphEdges
from .mesh import MAP_AXIS


def pad_edges(edges: PoseGraphEdges, n_devices: int) -> PoseGraphEdges:
    """Pad the edge arrays to a multiple of n_devices (invalid padding)."""
    E = edges.i.shape[0]
    Ep = ((E + n_devices - 1) // n_devices) * n_devices
    if Ep == E:
        return edges
    pad = Ep - E
    eye = jnp.broadcast_to(jnp.eye(4), (pad, 4, 4))
    return PoseGraphEdges(
        i=jnp.concatenate([edges.i, jnp.zeros(pad, jnp.int32)]),
        j=jnp.concatenate([edges.j, jnp.zeros(pad, jnp.int32)]),
        S_ji=jnp.concatenate([edges.S_ji, eye]),
        weight=jnp.concatenate([edges.weight, jnp.zeros(pad)]),
        valid=jnp.concatenate([edges.valid, jnp.zeros(pad, bool)]),
    )


_PG_CACHE = {}


def make_distributed_pose_graph(
    mesh: Mesh, iters: int = 20, fix_scale: bool = False
):
    key = (mesh, iters, fix_scale)
    if key in _PG_CACHE:
        return _PG_CACHE[key]
    run = _make_distributed_pose_graph(mesh, iters, fix_scale)
    _PG_CACHE[key] = run
    return run


def _make_distributed_pose_graph(
    mesh: Mesh, iters: int = 20, fix_scale: bool = False
):
    """Build the pjit'd distributed essential-graph solve.

    Returns run(S0, kf_valid, edges, fixed_mask) -> (T (K,4,4), s (K,)),
    both replicated.  ``S0`` are packed-Sim3 seeds (SE3 matrices are valid
    seeds with s=1); edge arrays must be padded to a multiple of the mesh
    size (``pad_edges``).
    """
    fix = jnp.float32(1.0 if fix_scale else 0.0)

    def shard_fn(S0, kf_valid, ei, ej, S_ji, weight, valid, fixed_mask):
        K = S0.shape[0]
        w_e = weight * valid.astype(jnp.float32)

        def edge_residuals(xi_all):
            xi_all = xi_all.at[:, 6].multiply(1.0 - fix)
            S_all = jax.vmap(lambda x, s0: sim3_exp(x) @ s0)(xi_all, S0)
            Si = S_all[ei]
            Sj = S_all[ej]
            M = jnp.einsum(
                "eij,ejk,ekl->eil", S_ji, Si, jax.vmap(sim3_inverse_mat)(Sj)
            )
            return jax.vmap(sim3_log)(M)

        def total_err(xi_all):
            r = edge_residuals(xi_all)
            return jax.lax.psum(jnp.sum(w_e[:, None] * r * r), MAP_AXIS)

        degree = jax.lax.psum(
            jnp.zeros(K).at[ei].add(valid.astype(jnp.float32))
            .at[ej].add(valid.astype(jnp.float32)),
            MAP_AXIS,
        )
        free = kf_valid & ~fixed_mask & (degree > 0)

        def body(_, carry):
            xi, lam = carry
            r = edge_residuals(xi)

            def edge_res_of(xi_i, xi_j, Si0, Sj0, S_meas):
                xi_i = xi_i.at[6].multiply(1.0 - fix)
                xi_j = xi_j.at[6].multiply(1.0 - fix)
                Si = sim3_exp(xi_i) @ Si0
                Sj = sim3_exp(xi_j) @ Sj0
                return sim3_log(S_meas @ Si @ sim3_inverse_mat(Sj))

            J_i = jax.vmap(jax.jacfwd(edge_res_of, argnums=0),
                           in_axes=(0, 0, 0, 0, 0))(
                xi[ei], xi[ej], S0[ei], S0[ej], S_ji)
            J_j = jax.vmap(jax.jacfwd(edge_res_of, argnums=1),
                           in_axes=(0, 0, 0, 0, 0))(
                xi[ei], xi[ej], S0[ei], S0[ej], S_ji)

            H = jnp.zeros((K, 7, K, 7))
            b = jnp.zeros((K, 7))
            wJe_i = J_i * w_e[:, None, None]
            wJe_j = J_j * w_e[:, None, None]
            H = H.at[ei, :, ei, :].add(jnp.einsum("eri,erj->eij", J_i, wJe_i))
            H = H.at[ej, :, ej, :].add(jnp.einsum("eri,erj->eij", J_j, wJe_j))
            H = H.at[ei, :, ej, :].add(jnp.einsum("eri,erj->eij", J_i, wJe_j))
            H = H.at[ej, :, ei, :].add(jnp.einsum("eri,erj->eij", J_j, wJe_i))
            b = b.at[ei].add(jnp.einsum("eri,er->ei", wJe_i, r))
            b = b.at[ej].add(jnp.einsum("eri,er->ei", wJe_j, r))

            # ONE all-reduce per iteration: partial normal equations.
            H = jax.lax.psum(H, MAP_AXIS)
            b = jax.lax.psum(b, MAP_AXIS)

            Hd = H.reshape(K * 7, K * 7)
            bd = b.reshape(-1)
            free7 = jnp.repeat(free, 7)
            if fix_scale:
                is_scale = jnp.arange(K * 7) % 7 == 6
                free7 = free7 & ~is_scale
            diag = jnp.maximum(jnp.diag(Hd), 1e-6)
            Hd = Hd + jnp.diag(lam * diag)
            Hd = jnp.where(free7[:, None] & free7[None, :], Hd, 0.0)
            Hd = Hd + jnp.diag(jnp.where(free7, 0.0, 1.0))
            bd = jnp.where(free7, bd, 0.0)

            dx = -jnp.linalg.solve(Hd, bd).reshape(K, 7)
            xi_new = xi + dx
            accept = total_err(xi_new) < total_err(xi)
            xi = jnp.where(accept, xi_new, xi)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e3)
            return (xi, lam)

        xi0 = jnp.zeros((K, 7))
        xi, _ = jax.lax.fori_loop(0, iters, body, (xi0, jnp.float32(1e-4)))
        xi = xi.at[:, 6].multiply(1.0 - fix)
        S_final = jax.vmap(lambda x, s0: sim3_exp(x) @ s0)(xi, S0)
        R, t, s = sim3_from_mat(S_final)
        T = rt_to_mat(R, t / s[..., None])
        return T, s

    step = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(
                P(), P(), P(MAP_AXIS), P(MAP_AXIS), P(MAP_AXIS),
                P(MAP_AXIS), P(MAP_AXIS), P(),
            ),
            out_specs=(P(), P()),
            check_vma=False,  # outputs ARE replicated (psum-derived)
        )
    )

    def run(S0, kf_valid, edges: PoseGraphEdges, fixed_mask):
        edges = pad_edges(edges, mesh.devices.size)
        return step(S0, kf_valid, edges.i, edges.j, edges.S_ji,
                    edges.weight, edges.valid, fixed_mask)

    return run
