"""Local bundle adjustment with landmark Schur complement.

JAX replacement for ``Optimizer::LocalBundleAdjustment``
(src/Optimizer.cc:≈460) and its g2o machinery (BlockSolver_6_3 + sparse
Cholesky — SURVEY.md §2.2): a batched Gauss-Newton/LM solver where

  * the local window = current KF + top covisible KFs (vs the reference's
    full covisible set), fixed KFs = next covisible ring, all as fixed-size
    gathers;
  * H_pp (3x3 landmark blocks) is built with scatter-adds over the forward
    observation index and inverted in closed form (batched);
  * the reduced camera system S = H_cc - H_cp H_pp^-1 H_pc is a dense
    (6C, 6C) matrix (C <= 16 cameras) solved with a dense Cholesky;
  * the reference's 5-then-10 iteration schedule with chi2 outlier removal
    in between (Optimizer.cc:≈560) is two unrolled LM phases, outliers
    masked not erased, and finally unbound from the keyframes.

The same kernel with a `psum` over per-shard (H, b) becomes the
multi-host distributed BA (parallel/dist_ba.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..models import map_state as ms
from ..utils.camera import CameraModel
from .lie import hat, inv3x3, se3_exp
from .pose_opt import CHI2_MONO, CHI2_STEREO


def _gather_problem(m: ms.MapState, kf_id, n_local: int, n_fixed: int):
    """Camera set = [kf_id, top local covisible..., fixed ring...].

    Returns (cam_ids (C,), is_fixed (C,), cam_used (C,)).
    """
    row = ms.covisible_row(m, kf_id)
    _, order = jax.lax.top_k(row, n_local + n_fixed - 1)
    cam_ids = jnp.concatenate([kf_id[None], order[: n_local - 1],
                               order[n_local - 1 :]])
    used = m.kf_valid[cam_ids] & (
        (jnp.arange(cam_ids.shape[0]) == 0) | (row[cam_ids] > 0)
    )
    is_fixed = jnp.arange(cam_ids.shape[0]) >= n_local
    # Gauge: the lowest keyframe id in the used set is held fixed (the
    # reference fixes KF0 and all out-of-window observers).
    masked_ids = jnp.where(used, cam_ids, jnp.int32(2**30))
    gauge = jnp.argmin(masked_ids)
    is_fixed = is_fixed | (jnp.arange(cam_ids.shape[0]) == gauge)
    return cam_ids, is_fixed, used


def _residuals(poses, pts, uv, ur, pid, w_valid, cam: CameraModel):
    """Batched residual + Jacobians over (C, N) observations.

    Returns r (C,N,3), J_cam (C,N,3,6), J_pt (C,N,3,3), behind (C,N).
    """
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    X = pts[pid]  # (C, N, 3)
    pc = jnp.einsum("cij,cnj->cni", R, X) + t[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / jnp.maximum(z, 1e-6)
    zi2 = zi * zi
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    upred_r = u - cam.bf * zi
    has_ur = ur >= 0
    r = jnp.stack(
        [u - uv[..., 0], v - uv[..., 1],
         jnp.where(has_ur, upred_r - ur, 0.0)], axis=-1
    )
    zeros = jnp.zeros_like(x)
    J_proj = jnp.stack(
        [
            jnp.stack([cam.fx * zi, zeros, -cam.fx * x * zi2], -1),
            jnp.stack([zeros, cam.fy * zi, -cam.fy * y * zi2], -1),
            jnp.stack(
                [cam.fx * zi, zeros, (-cam.fx * x + cam.bf) * zi2], -1
            ),
        ],
        axis=-2,
    )  # (C, N, 3, 3)
    J_proj = J_proj.at[..., 2, :].set(
        jnp.where(has_ur[..., None], J_proj[..., 2, :], 0.0)
    )
    I3 = jnp.broadcast_to(jnp.eye(3), pc.shape + (3,))
    J_cam = J_proj @ jnp.concatenate([I3, -hat(pc)], axis=-1)  # (C,N,3,6)
    J_pt = J_proj @ R[:, None, :, :]  # dpc/dX = R
    behind = z <= 1e-6
    return r, J_cam, J_pt, behind


def schur_ba_core(
    poses0: jnp.ndarray,       # (C, 4, 4)
    pts0: jnp.ndarray,         # (P, 3) point array that pid indexes
    uv: jnp.ndarray,           # (C, N, 2)
    ur: jnp.ndarray,           # (C, N)  (-1 = mono observation)
    inv_s2: jnp.ndarray,       # (C, N)
    pid: jnp.ndarray,          # (C, N) into pts0 (clipped-valid)
    obs_ok: jnp.ndarray,       # (C, N)
    is_fixed: jnp.ndarray,     # (C,)
    used: jnp.ndarray,         # (C,)
    cam: CameraModel,
    phase_iters: Tuple[int, int] = (5, 10),
    initial_prune: float = 0.0,
    axis_name: str = None,
    n_shards: int = 1,
):
    """The Schur-complement LM engine shared by local BA (window), the
    joint global BA (all active keyframes compacted), and the DISTRIBUTED
    variants (parallel/dist_ba.py): landmark blocks inverted batched,
    dense reduced camera system, 5-robust + 10-plain phase schedule with
    chi2 pruning between (Optimizer.cc:≈560).

    ``initial_prune`` > 0 masks observations whose chi2 at the INITIAL
    geometry exceeds ``initial_prune * chi2_th`` before any iteration — a
    loose association-hygiene gate for maps whose outlier bindings were
    never unbound by local BA (a clean map is unaffected; gross wrong
    associations would otherwise drag the plain phase quadratically).

    When ``axis_name`` is set (inside shard_map over a mesh), the camera
    axis of every (C, ...) input is the LOCAL shard (C_local = C_global /
    n_shards; points replicated) and the SAME math runs cooperatively:
    landmark blocks psum-reduced across devices, per-camera blocks all-gathered
    for the replicated reduced solve, each shard applying its slice of the
    pose update.  Collectives are identity when axis_name is None, so the
    single-device and distributed paths cannot diverge semantically.

    Returns (poses (C,4,4), pts (P,3), obs_mask (C,N) inlier mask,
    pt_in (P,) participating-point mask) — camera-axis outputs local to
    the shard, point-axis outputs replicated.
    """
    C = poses0.shape[0] * n_shards   # global camera count
    P = pts0.shape[0]
    has_ur = ur >= 0
    chi2_th = jnp.where(has_ur, CHI2_STEREO, CHI2_MONO)
    delta_h = jnp.sqrt(chi2_th)

    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    def gather(x, axis=0):
        if axis_name:
            return jax.lax.all_gather(x, axis_name, axis=axis, tiled=True)
        return x

    # Which points participate (observed by >= 1 used camera anywhere).
    # scatter-.max (not .set) so duplicate indices — every invalid obs
    # writes slot 0 — can never race a genuine True with a False.
    pt_in = (
        psum(
            jnp.zeros((P,), jnp.int32)
            .at[pid.reshape(-1)]
            .max(obs_ok.reshape(-1).astype(jnp.int32), mode="drop")
        )
        > 0
    )
    # Hold points fixed if ONLY fixed cameras see them locally?  The
    # reference optimizes all local points; fixed-cam-only points have no
    # local observer and get zero gradient anyway.

    def chi2_of(poses, pts, mask):
        r, _, _, behind = _residuals(poses, pts, uv, ur, pid, mask, cam)
        c = jnp.sum(r * r, -1) * inv_s2
        return jnp.where(behind, 1e9, c)

    def _blocks(poses, pts, obs_mask, robust):
        r, J_cam, J_pt, behind = _residuals(poses, pts, uv, ur, pid, obs_mask, cam)
        w = inv_s2 * obs_mask.astype(jnp.float32) * (~behind).astype(jnp.float32)
        if robust:
            rn = jnp.sqrt(jnp.sum(r * r, -1) * inv_s2 + 1e-12)
            w = w * jnp.minimum(1.0, delta_h / jnp.maximum(rn, 1e-12))
        # Zero camera Jacobians of fixed cameras.
        J_cam = jnp.where(is_fixed[:, None, None, None], 0.0, J_cam)

        # Per-camera blocks (local shard).
        H_cc = jnp.einsum("cnij,cn,cnik->cjk", J_cam, w, J_cam)  # (Cl,6,6)
        b_c = jnp.einsum("cnij,cn,cni->cj", J_cam, w, r)         # (Cl,6)
        flat_pid = pid.reshape(-1)
        Hpp_contrib = jnp.einsum("cnij,cn,cnik->cnjk", J_pt, w, J_pt).reshape(-1, 3, 3)
        bp_contrib = jnp.einsum("cnij,cn,cni->cnj", J_pt, w, r).reshape(-1, 3)
        H_pp = jnp.zeros((P, 3, 3)).at[flat_pid].add(Hpp_contrib, mode="drop")
        b_p = jnp.zeros((P, 3)).at[flat_pid].add(bp_contrib, mode="drop")
        # Cross-block contributions as 18 N-minor planes (Cl, 18, N):
        # plane (i*3+j) holds G[i, j] per observation.
        G_contrib = jnp.einsum("cnij,cn,cnik->cjkn", J_cam, w, J_pt)
        return H_cc, b_c, H_pp, b_p, G_contrib.reshape(
            G_contrib.shape[0], 18, -1
        )

    # Inverse observation index: inv_slot[c, p] = the keypoint slot of
    # point p in camera c (sentinel N when unobserved).  With one
    # observation per (camera, point) pair the cross-block tensor G[p, c]
    # is a PERMUTATION of the per-observation contributions — built with a
    # cheap gather instead of a (6,3,P*C) scatter-add.  Computed ONCE per
    # call: pid and obs_ok are loop-invariant.
    Nn = pid.shape[1]
    Cl0 = pid.shape[0]
    _cam_iota = jax.lax.broadcasted_iota(jnp.int32, pid.shape, 0)
    _obs_iota = jax.lax.broadcasted_iota(jnp.int32, pid.shape, 1)
    inv_slot = (
        jnp.full((Cl0, P), Nn, jnp.int32)
        .at[_cam_iota.reshape(-1),
            jnp.where(obs_ok, pid, P).reshape(-1)]
        .min(jnp.where(obs_ok, _obs_iota, Nn).reshape(-1), mode="drop")
    )
    # DEDUPLICATE (camera, point) observations against that index: a
    # one-directional matcher CAN bind two keypoints of one frame to the
    # same map point; keeping only the first slot makes H_cc/H_pp/b and
    # the gathered G see the SAME observation set.  (A first version kept
    # duplicates in the scattered blocks but not in the gathered G — the
    # inconsistent Schur complement degraded steps enough to triple
    # odometric drift on the mono circle.)  Dropped duplicates are also
    # excluded from the returned obs_mask, so the caller's outlier
    # unbinding erases them from the map — the hygiene the reference gets
    # from Fuse.
    obs_ok = obs_ok & (
        inv_slot[_cam_iota, jnp.clip(pid, 0, P - 1)] == _obs_iota
    )

    def _gather_G(G_planes):
        """(Cl, 18, N) per-obs cross-block planes -> (Cl, 6, 3, P),
        P-minor throughout: with this layout and the matmul-form Schur
        reduction below, no large intermediate has a trailing dim of 3
        or 6."""
        Cl = G_planes.shape[0]
        Gc_pad = jnp.concatenate(
            [G_planes, jnp.zeros((Cl, 18, 1), G_planes.dtype)], axis=2
        )
        Gp = jnp.take_along_axis(
            Gc_pad, inv_slot[:, None, :], axis=2
        )  # (Cl, 18, P)
        return Gp.reshape(Cl, 6, 3, P)

    def lm_step(poses, pts, obs_mask, lam, robust):
        Cl = poses.shape[0]  # local camera count (== C when not sharded)
        H_cc, b_c, H_pp, b_p, G_planes = _blocks(poses, pts, obs_mask, robust)
        H_pp = psum(H_pp)
        b_p = psum(b_p)
        Gp = gather(_gather_G(G_planes), axis=0)  # (C, 6, 3, P)
        H_cc_all = gather(H_cc)                # (C, 6, 6)
        b_c_all = gather(b_c)                  # (C, 6)
        fixed_all = gather(is_fixed)
        used_all = gather(used)

        # Damped landmark inverse.
        H_pp_d = H_pp + (lam * jnp.eye(3))[None] * jnp.maximum(
            jnp.trace(H_pp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
        )
        active = pt_in & (jnp.trace(H_pp, axis1=-2, axis2=-1) > 1e-9)
        Hpp_inv = jnp.where(
            active[:, None, None],
            inv3x3(H_pp_d + 1e-9 * jnp.eye(3)[None]),
            0.0,
        )

        # Reduced camera system (replicated across shards), matmul form:
        # with G[p,c] available as planes Gp[c,i,j,p],
        #   A[c,i,k,p] = sum_j Gp[c,i,j,p] Hpp_inv[p,j,k]
        #   S_red[(c,i),(d,l)] = sum_{k,p} A[c,i,k,p] Gp[d,l,k,p]
        # — ONE (C*6, 3P) x (3P, C*6) matmul instead of the
        # (P,C,6,3)-tensor einsum chain.
        A = jnp.einsum("cijp,pjk->cikp", Gp, Hpp_inv)
        S_red = jnp.einsum("cikp,dlkp->cidl", A, Gp)
        S = (
            _blockdiag(H_cc_all) - S_red.reshape(C * 6, C * 6)
        )
        rhs = (b_c_all - jnp.einsum("cikp,pk->ci", A, b_p)).reshape(-1)
        # LM damping on cameras + fix handling: identity rows for fixed/unused.
        diag_scale = jnp.maximum(jnp.diag(S), 1e-6)
        S = S + jnp.diag(lam * diag_scale)
        free = (~fixed_all) & used_all
        free6 = jnp.repeat(free, 6)
        S = jnp.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + jnp.diag(jnp.where(free6, 0.0, 1.0))
        rhs = jnp.where(free6, rhs, 0.0)

        # Cholesky, not LU: S is SPD after damping + identity fix rows, and
        # this sits in every LM iteration.
        delta_c_all = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(S, lower=True), rhs
        ).reshape(C, 6)
        # Back-substitute points: delta_p = -Hpp_inv (b_p + G^T delta_c).
        Gt_dc = jnp.einsum("cijp,ci->pj", Gp, delta_c_all)
        delta_p = -jnp.einsum("pij,pj->pi", Hpp_inv, b_p + Gt_dc)
        delta_p = jnp.where(active[:, None], delta_p, 0.0)

        if axis_name:
            my = jax.lax.axis_index(axis_name)
            delta_c = jax.lax.dynamic_slice_in_dim(delta_c_all, my * Cl, Cl, 0)
        else:
            delta_c = delta_c_all
        poses_new = jax.vmap(lambda d, T: se3_exp(d) @ T)(delta_c, poses)
        poses_new = jnp.where(is_fixed[:, None, None], poses, poses_new)
        pts_new = pts + delta_p
        return poses_new, pts_new

    poses = poses0
    pts = pts0
    obs_mask = obs_ok
    if initial_prune > 0.0:
        obs_mask = obs_mask & (
            chi2_of(poses, pts, obs_mask) <= initial_prune * chi2_th
        )
    lam = jnp.float32(1e-4)
    for phase, (iters, robust) in enumerate(
        zip(phase_iters, (True, False) if len(phase_iters) > 1 else (True,))
    ):
        # Carry the accepted cost across iterations: ONE residual pass per
        # LM iteration instead of two (the candidate's cost becomes the
        # incumbent's on accept).  psum'd scalar costs -> the accept
        # decision and lam schedule are identical on every shard.
        err_cur = psum(
            jnp.sum(jnp.where(obs_mask, chi2_of(poses, pts, obs_mask), 0.0))
        )
        for _ in range(iters):
            poses_new, pts_new = lm_step(poses, pts, obs_mask, lam, robust)
            err_new = psum(jnp.sum(
                jnp.where(obs_mask, chi2_of(poses_new, pts_new, obs_mask), 0.0)
            ))
            accept = err_new < err_cur
            poses = jnp.where(accept, poses_new, poses)
            pts = jnp.where(accept, pts_new, pts)
            err_cur = jnp.where(accept, err_new, err_cur)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e2)
        # chi2 outlier pruning between phases (and after the last).
        chi2 = chi2_of(poses, pts, obs_mask)
        obs_mask = obs_mask & (chi2 <= chi2_th)
    return poses, pts, obs_mask, pt_in


@functools.partial(
    jax.jit, static_argnames=("n_local", "n_fixed", "phase_iters", "pt_cap")
)
def local_bundle_adjustment(
    m: ms.MapState,
    kf_id: jnp.ndarray,
    cam: CameraModel,
    inv_sigma2_lut: jnp.ndarray,
    n_local: int = 8,
    n_fixed: int = 8,
    phase_iters: Tuple[int, int] = (5, 10),
    pt_cap: int = 4096,
) -> ms.MapState:
    cam_ids, is_fixed, used = _gather_problem(m, kf_id, n_local, n_fixed)

    poses0 = m.kf_pose_cw[cam_ids]           # (C, 4, 4)
    uv = m.kf_xy[cam_ids]                    # (C, N, 2)
    ur = jnp.where(used[:, None], m.kf_ur[cam_ids], -1.0)
    lvl = m.kf_level[cam_ids]
    pid_raw = m.kf_point[cam_ids]            # (C, N)
    obs_ok = (
        (pid_raw >= 0) & m.kf_kp_valid[cam_ids] & used[:, None]
    )
    pid = jnp.where(obs_ok, pid_raw, 0)
    obs_ok = obs_ok & m.pt_valid[pid]
    inv_s2 = inv_sigma2_lut[jnp.clip(lvl, 0, inv_sigma2_lut.shape[0] - 1)]

    # COMPACT the landmark axis: the solver's per-iteration cost is linear
    # in its point-array length (landmark-block inversion, Schur G tensor,
    # scatter-adds), and the window's points are a small fraction of the
    # full pool.  Gather the participating points (ranked by in-window
    # observation count) into a (pt_cap,) set, remap pid, and scatter the
    # optimized positions back.  pt_cap >= C*N/4 covers every realistic
    # window; beyond-cap stragglers keep their old positions (their
    # observations are masked out of the solve).
    P = m.pt_capacity
    pt_cap = min(pt_cap, P)
    obs_cnt = (
        jnp.zeros((P,), jnp.int32)
        .at[pid.reshape(-1)]
        .add(obs_ok.reshape(-1).astype(jnp.int32), mode="drop")
    )
    _, sel = jax.lax.top_k(obs_cnt, pt_cap)
    sel = sel.astype(jnp.int32)
    sel_in = obs_cnt[sel] > 0                # (pt_cap,)
    g2l = jnp.full((P,), pt_cap, jnp.int32).at[sel].set(
        jnp.arange(pt_cap, dtype=jnp.int32)
    )
    pid_l = g2l[pid]                         # (C, N) into the compact set
    obs_ok_l = obs_ok & (pid_l < pt_cap)
    pid_l = jnp.where(obs_ok_l, pid_l, 0)
    pts0 = m.pt_pos[sel]                     # (pt_cap, 3)

    poses, pts_l, obs_mask, pt_in_l = schur_ba_core(
        poses0, pts0, uv, ur, inv_s2, pid_l, obs_ok_l, is_fixed, used, cam,
        phase_iters,
    )

    # Write back: poses, points (scatter the compact set), and unbind
    # outlier observations.  Only used cameras are written: cam_ids can
    # repeat kf_id in an unused slot (a young map has fewer covisible
    # keyframes than the window), and the order of a scatter among
    # duplicate indices is unspecified on the GPU.
    from .lie import orthonormalize_se3

    cam_w = jnp.where(used, cam_ids, m.kf_capacity)
    new_rows = jnp.where(
        obs_ok_l & ~obs_mask, ms.NO_POINT, m.kf_point[cam_ids]
    )
    kf_point = m.kf_point.at[cam_w].set(new_rows, mode="drop")
    kf_pose = m.kf_pose_cw.at[cam_w].set(
        orthonormalize_se3(poses), mode="drop"
    )
    upd = pt_in_l & sel_in
    pt_pos = m.pt_pos.at[sel].set(
        jnp.where(upd[:, None], pts_l, m.pt_pos[sel]), mode="drop"
    )
    return m._replace(kf_pose_cw=kf_pose, kf_point=kf_point, pt_pos=pt_pos)


def _blockdiag(blocks: jnp.ndarray) -> jnp.ndarray:
    """(C, 6, 6) -> (6C, 6C) block diagonal."""
    C = blocks.shape[0]
    out = jnp.zeros((C, 6, C, 6))
    idx = jnp.arange(C)
    out = out.at[idx, :, idx, :].set(blocks)
    return out.reshape(C * 6, C * 6)
