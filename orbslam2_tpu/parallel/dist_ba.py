"""Distributed bundle adjustment over a device mesh.

The multi-chip version of solvers/local_ba.py: keyframes (cameras) are
sharded along the mesh axis ``"map"``; each device assembles the solver
blocks for ITS keyframe shard, then

  * landmark blocks H_pp, b_p are reduced with ``psum`` (points
    are shared across keyframe shards),
  * per-camera blocks (H_cc, b_c) and camera-point cross blocks G are
    ``all_gather``-ed so every device can form the (small, dense) reduced
    camera system S = H_cc - G H_pp^-1 G^T,
  * each device solves S (replicated) and applies its shard's pose update
    plus the replicated landmark update.

This is the SURVEY.md §2.5 "collectives replace shared-memory mutexes"
design: the reference's g2o runs single-threaded under a global map lock;
here the same normal equations are formed cooperatively with two
collectives and no locks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers.lie import hat, inv3x3, se3_exp
from ..utils.camera import CameraModel
from .mesh import MAP_AXIS


class ShardedBAProblem(NamedTuple):
    """Per-shard observation arrays (leading axis = keyframes, sharded).

    poses:    (C, 4, 4)  keyframe poses (sharded along C)
    uv:       (C, N, 2)  measurements
    pid:      (C, N)     point index per observation (-1 invalid)
    obs_ok:   (C, N)     validity
    inv_s2:   (C, N)     information weights
    is_fixed: (C,)       gauge/fixed mask
    points:   (P, 3)     landmarks (replicated)
    ur:       (C, N)     stereo right-u measurement (<0 = mono observation)
    """

    poses: jnp.ndarray
    uv: jnp.ndarray
    pid: jnp.ndarray
    obs_ok: jnp.ndarray
    inv_s2: jnp.ndarray
    is_fixed: jnp.ndarray
    points: jnp.ndarray
    ur: jnp.ndarray = None  # None = all-mono problem


def _residuals_mono(poses, pts, uv, pid, cam: CameraModel, ur=None):
    """Residuals + Jacobians for the one-step primitive.  With ``ur`` the
    third (stereo right-u) residual row is included per observation where
    ur >= 0 — the EdgeStereoSE3ProjectXYZ term the reference's BA carries
    for stereo/RGB-D bindings (Optimizer.cc:≈500); without it the kept
    minimal-latency step silently dropped ur residuals on stereo data."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    X = pts[jnp.maximum(pid, 0)]
    pc = jnp.einsum("cij,cnj->cni", R, X) + t[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / jnp.maximum(z, 1e-6)
    zi2 = zi * zi
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    if ur is None:
        ur = jnp.full_like(u, -1.0)
    has_ur = ur >= 0
    upred_r = u - cam.bf * zi
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
    )
    J_proj = J_proj.at[..., 2, :].set(
        jnp.where(has_ur[..., None], J_proj[..., 2, :], 0.0)
    )
    I3 = jnp.broadcast_to(jnp.eye(3), pc.shape + (3,))
    J_cam = J_proj @ jnp.concatenate([I3, -hat(pc)], axis=-1)
    J_pt = J_proj @ R[:, None, :, :]
    return r, J_cam, J_pt, z <= 1e-6


def make_distributed_ba_step(mesh: Mesh, cam: CameraModel, n_total_cams: int,
                             lam: float = 1e-4):
    """Build the pjit'd one-iteration distributed BA step.

    Returns step(problem) -> (new_poses (C,4,4) sharded, new_points (P,3)
    replicated).
    """
    n_dev = mesh.devices.size
    c_local = n_total_cams // n_dev

    def shard_step(poses, uv, pid, obs_ok, inv_s2, is_fixed, points, ur):
        # --- local assembly over this device's keyframe shard ---
        P_cap = points.shape[0]
        r, J_cam, J_pt, behind = _residuals_mono(
            poses, points, uv, pid, cam, ur=ur
        )
        w = inv_s2 * obs_ok.astype(jnp.float32) * (~behind).astype(jnp.float32)
        J_cam = jnp.where(is_fixed[:, None, None, None], 0.0, J_cam)

        H_cc = jnp.einsum("cnij,cn,cnik->cjk", J_cam, w, J_cam)
        b_c = jnp.einsum("cnij,cn,cni->cj", J_cam, w, r)
        flat_pid = jnp.maximum(pid, 0).reshape(-1)
        H_pp_local = jnp.zeros((P_cap, 3, 3)).at[flat_pid].add(
            jnp.einsum("cnij,cn,cnik->cnjk", J_pt, w, J_pt).reshape(-1, 3, 3),
            mode="drop",
        )
        b_p_local = jnp.zeros((P_cap, 3)).at[flat_pid].add(
            jnp.einsum("cnij,cn,cni->cnj", J_pt, w, r).reshape(-1, 3),
            mode="drop",
        )
        cam_idx = jax.lax.broadcasted_iota(jnp.int32, pid.shape, 0).reshape(-1)
        G_local = jnp.zeros((P_cap, c_local, 6, 3)).at[flat_pid, cam_idx].add(
            jnp.einsum("cnij,cn,cnik->cnjk", J_cam, w, J_pt).reshape(-1, 6, 3),
            mode="drop",
        )

        # --- collectives: reduce landmark blocks, gather camera blocks ---
        H_pp = jax.lax.psum(H_pp_local, MAP_AXIS)              # all-reduce
        b_p = jax.lax.psum(b_p_local, MAP_AXIS)
        G = jax.lax.all_gather(G_local, MAP_AXIS, axis=1, tiled=True)  # (P, C, 6, 3)
        H_cc_all = jax.lax.all_gather(H_cc, MAP_AXIS, tiled=True)      # (C, 6, 6)
        b_c_all = jax.lax.all_gather(b_c, MAP_AXIS, tiled=True)        # (C, 6)
        fixed_all = jax.lax.all_gather(is_fixed, MAP_AXIS, tiled=True)

        C = n_total_cams
        tr = jnp.trace(H_pp, axis1=-2, axis2=-1)
        active = tr > 1e-9
        H_pp_d = H_pp + (lam * jnp.eye(3))[None] * jnp.maximum(
            tr[:, None, None] / 3.0, 1e-6
        )
        Hpp_inv = jnp.where(
            active[:, None, None], inv3x3(H_pp_d + 1e-9 * jnp.eye(3)), 0.0
        )

        M = jnp.einsum("pcij,pjk->pcik", G, Hpp_inv)
        S_red = jnp.einsum("pcik,pdlk->cidl", M, G).reshape(C * 6, C * 6)
        S = _blockdiag(H_cc_all) - S_red
        rhs = (b_c_all - jnp.einsum("pcik,pk->ci", M, b_p)).reshape(-1)

        free = ~fixed_all
        free6 = jnp.repeat(free, 6)
        S = S + jnp.diag(lam * jnp.maximum(jnp.diag(S), 1e-6))
        S = jnp.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + jnp.diag(jnp.where(free6, 0.0, 1.0))
        rhs = jnp.where(free6, rhs, 0.0)

        # Cholesky, not LU — see solvers/local_ba.py lm_step.
        delta_c_all = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(S, lower=True), rhs
        ).reshape(C, 6)
        Gt_dc = jnp.einsum("pcij,ci->pj", G, delta_c_all)
        delta_p = -jnp.einsum("pij,pj->pi", Hpp_inv, b_p + Gt_dc)
        delta_p = jnp.where(active[:, None], delta_p, 0.0)

        # Apply this shard's slice of the camera update.
        my = jax.lax.axis_index(MAP_AXIS)
        delta_local = jax.lax.dynamic_slice_in_dim(
            delta_c_all, my * c_local, c_local, 0
        )
        poses_new = jax.vmap(lambda d, T: se3_exp(d) @ T)(delta_local, poses)
        poses_new = jnp.where(is_fixed[:, None, None], poses, poses_new)
        return poses_new, points + delta_p

    step = jax.jit(
        jax.shard_map(
            shard_step,
            mesh=mesh,
            in_specs=(
                P(MAP_AXIS), P(MAP_AXIS), P(MAP_AXIS), P(MAP_AXIS),
                P(MAP_AXIS), P(MAP_AXIS), P(), P(MAP_AXIS),
            ),
            out_specs=(P(MAP_AXIS), P()),
            check_vma=False,  # points output IS replicated (derived from
                              # psum-reduced blocks); inference can't see it
        )
    )

    def run(prob: ShardedBAProblem):
        ur = prob.ur
        if ur is None:
            ur = jnp.full(prob.uv.shape[:2], -1.0, jnp.float32)
        return step(
            prob.poses, prob.uv, prob.pid, prob.obs_ok, prob.inv_s2,
            prob.is_fixed, prob.points, ur,
        )

    return run


def _blockdiag(blocks: jnp.ndarray) -> jnp.ndarray:
    C = blocks.shape[0]
    out = jnp.zeros((C, 6, C, 6))
    idx = jnp.arange(C)
    out = out.at[idx, :, idx, :].set(blocks)
    return out.reshape(C * 6, C * 6)


# ---------------------------------------------------------------------------
# Full-schedule sharded Schur BA: the SAME schur_ba_core as the single-device
# local/joint BA (solvers/local_ba.py), run under shard_map with the camera
# axis sharded over the mesh — landmark blocks psum-reduced, camera blocks
# all-gathered, identical LM/pruning schedule (the collectives are identity
# when axis_name is None, so the two paths cannot diverge semantically).
# This is what LocalMapper/LoopCloser dispatch to when constructed with a
# multi-device mesh.
# ---------------------------------------------------------------------------

_SHARDED_CORE_CACHE = {}


def _sharded_core(mesh: Mesh, cam: CameraModel, phase_iters, initial_prune):
    from ..solvers.local_ba import schur_ba_core

    key = (
        mesh, float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
        float(cam.bf), tuple(phase_iters), float(initial_prune),
    )
    if key in _SHARDED_CORE_CACHE:
        return _SHARDED_CORE_CACHE[key]
    n_dev = mesh.devices.size

    def core(poses0, pts0, uv, ur, inv_s2, pid, obs_ok, is_fixed, used):
        return schur_ba_core(
            poses0, pts0, uv, ur, inv_s2, pid, obs_ok, is_fixed, used, cam,
            phase_iters=tuple(phase_iters), initial_prune=initial_prune,
            axis_name=MAP_AXIS, n_shards=n_dev,
        )

    step = jax.jit(
        jax.shard_map(
            core,
            mesh=mesh,
            in_specs=(
                P(MAP_AXIS), P(), P(MAP_AXIS), P(MAP_AXIS), P(MAP_AXIS),
                P(MAP_AXIS), P(MAP_AXIS), P(MAP_AXIS), P(MAP_AXIS),
            ),
            out_specs=(P(MAP_AXIS), P(), P(MAP_AXIS), P()),
            check_vma=False,  # pts/pt_in outputs ARE replicated (psum-derived)
        )
    )
    _SHARDED_CORE_CACHE[key] = step
    return step


def _pad_cams(n: int, n_dev: int) -> int:
    return ((n + n_dev - 1) // n_dev) * n_dev


def distributed_local_ba(
    m,
    kf_id,
    mesh: Mesh,
    cam: CameraModel,
    inv_sigma2_lut: jnp.ndarray,
    n_local: int = 8,
    n_fixed: int = 8,
    phase_iters: Tuple[int, int] = (5, 10),
    pt_cap: int = 4096,
):
    """Local bundle adjustment with the camera window sharded over the mesh.

    Same problem gather + landmark compaction + write-back as
    ``local_bundle_adjustment`` (solvers/local_ba.py; Optimizer.cc:≈460),
    with the Schur LM engine run cooperatively across devices.  The window
    is padded to a multiple of the mesh size with unused cameras
    (zero-weight, identity rows in the reduced system) so every shard holds
    an equal slice; the compacted landmark set is replicated.
    """
    from ..models import map_state as ms
    from ..solvers.lie import orthonormalize_se3
    from ..solvers.local_ba import _gather_problem

    n_dev = mesh.devices.size
    Cw = n_local + n_fixed
    Cp = _pad_cams(Cw, n_dev)

    kf_id = jnp.asarray(kf_id, jnp.int32)
    cam_ids, is_fixed, used = _gather_problem(m, kf_id, n_local, n_fixed)
    if Cp != Cw:
        # Pad with an OUT-OF-RANGE slot id (kf_capacity): padding with 0
        # would make the write-back scatter hit keyframe 0 twice — once
        # with the pad slot's unchanged row and once with the BA result —
        # and XLA picks a nondeterministic winner.  Out-of-range indices
        # are dropped by the mode="drop" scatters below.
        pad_id = jnp.full(Cp - Cw, m.kf_capacity, jnp.int32)
        cam_ids = jnp.concatenate([cam_ids, pad_id])
        is_fixed = jnp.concatenate([is_fixed, jnp.ones(Cp - Cw, bool)])
        used = jnp.concatenate([used, jnp.zeros(Cp - Cw, bool)])

    poses0 = m.kf_pose_cw[cam_ids]
    uv = m.kf_xy[cam_ids]
    ur = jnp.where(used[:, None], m.kf_ur[cam_ids], -1.0)
    lvl = m.kf_level[cam_ids]
    pid_raw = m.kf_point[cam_ids]
    obs_ok = (pid_raw >= 0) & m.kf_kp_valid[cam_ids] & used[:, None]
    pid = jnp.where(obs_ok, pid_raw, 0)
    obs_ok = obs_ok & m.pt_valid[pid]
    inv_s2 = inv_sigma2_lut[jnp.clip(lvl, 0, inv_sigma2_lut.shape[0] - 1)]

    # Landmark compaction — IDENTICAL to local_bundle_adjustment so the
    # sharded and single-device paths stay numerically twin (tests compare
    # them): same top_k ranking, same remap, same scatter-back.
    P = m.pt_capacity
    pt_cap = min(pt_cap, P)
    obs_cnt = (
        jnp.zeros((P,), jnp.int32)
        .at[pid.reshape(-1)]
        .add(obs_ok.reshape(-1).astype(jnp.int32), mode="drop")
    )
    _, sel = jax.lax.top_k(obs_cnt, pt_cap)
    sel = sel.astype(jnp.int32)
    sel_in = obs_cnt[sel] > 0
    g2l = jnp.full((P,), pt_cap, jnp.int32).at[sel].set(
        jnp.arange(pt_cap, dtype=jnp.int32)
    )
    pid_l = g2l[pid]
    obs_ok_l = obs_ok & (pid_l < pt_cap)
    pid_l = jnp.where(obs_ok_l, pid_l, 0)
    pts0 = m.pt_pos[sel]

    core = _sharded_core(mesh, cam, phase_iters, 0.0)
    poses, pts_l, obs_mask, pt_in_l = core(
        poses0, pts0, uv, ur, inv_s2, pid_l, obs_ok_l, is_fixed, used,
    )

    # Only used cameras are written (see local_bundle_adjustment).
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


def distributed_joint_global_ba(
    m,
    mesh: Mesh,
    cam: CameraModel,
    inv_sigma2_lut: jnp.ndarray,
    phase_iters: Tuple[int, int] = (5, 10),
    max_cams: int = 512,
    initial_prune: float = 0.0,
    unbind_outliers: bool = True,
):
    """Joint global BA sharded over the mesh: the distributed twin of
    ``run_joint_global_ba`` (solvers/global_ba.py; the reference's
    LoopClosing::RunGlobalBundleAdjustment, src/LoopClosing.cc:≈530).
    Identical host-side compaction; the Schur LM engine runs with the
    compacted camera set sharded over the mesh axis.
    """
    import numpy as np

    from ..models import map_state as ms
    from ..solvers.global_ba import _next_pow2
    from ..solvers.lie import orthonormalize_se3

    n_dev = mesh.devices.size
    kf_valid = np.asarray(m.kf_valid)
    pt_valid = np.asarray(m.pt_valid)
    kf_ids = np.nonzero(kf_valid)[0]
    pt_ids = np.nonzero(pt_valid)[0]
    if len(kf_ids) < 2 or len(pt_ids) == 0 or len(kf_ids) > max_cams:
        return m
    C = _pad_cams(_next_pow2(len(kf_ids)), n_dev)
    Pa = _next_pow2(len(pt_ids), lo=256)

    kf_pad = np.zeros(C, np.int32)
    kf_pad[: len(kf_ids)] = kf_ids
    used = np.zeros(C, bool)
    used[: len(kf_ids)] = True
    is_fixed = np.zeros(C, bool)
    is_fixed[0] = True  # gauge: lowest valid keyframe id

    pt_slot = np.full(m.pt_capacity, -1, np.int64)
    pt_slot[pt_ids] = np.arange(len(pt_ids))

    kf_pad_j = jnp.asarray(kf_pad)
    pid_raw = np.asarray(m.kf_point)[kf_pad]
    obs_ok = (
        (pid_raw >= 0) & np.asarray(m.kf_kp_valid)[kf_pad] & used[:, None]
    )
    slot = np.where(obs_ok, pt_slot[np.maximum(pid_raw, 0)], -1)
    obs_ok = obs_ok & (slot >= 0)
    pid = np.where(obs_ok, np.maximum(slot, 0), 0).astype(np.int32)

    lvl = jnp.clip(
        jnp.asarray(np.asarray(m.kf_level)[kf_pad]),
        0, inv_sigma2_lut.shape[0] - 1,
    )
    inv_s2 = inv_sigma2_lut[lvl]
    ur = jnp.where(jnp.asarray(used)[:, None],
                   jnp.asarray(np.asarray(m.kf_ur)[kf_pad]), -1.0)
    pts0 = jnp.zeros((Pa, 3)).at[: len(pt_ids)].set(m.pt_pos[jnp.asarray(pt_ids)])

    core = _sharded_core(mesh, cam, phase_iters, initial_prune)
    poses, pts, obs_mask, _ = core(
        m.kf_pose_cw[kf_pad_j], pts0, m.kf_xy[kf_pad_j], ur, inv_s2,
        jnp.asarray(pid), jnp.asarray(obs_ok),
        jnp.asarray(is_fixed), jnp.asarray(used),
    )

    n_k = len(kf_ids)
    kf_pose = m.kf_pose_cw.at[jnp.asarray(kf_ids)].set(
        orthonormalize_se3(poses[:n_k])
    )
    pt_pos = m.pt_pos.at[jnp.asarray(pt_ids)].set(pts[: len(pt_ids)])
    kf_point = m.kf_point
    if unbind_outliers:
        pruned = jnp.asarray(obs_ok) & ~obs_mask
        rows = jnp.where(pruned[:n_k], ms.NO_POINT, m.kf_point[kf_pad_j[:n_k]])
        kf_point = kf_point.at[jnp.asarray(kf_ids)].set(rows)
    return m._replace(kf_pose_cw=kf_pose, pt_pos=pt_pos, kf_point=kf_point)
