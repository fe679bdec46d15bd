"""Global bundle adjustment by batched resection-intersection.

Role of ``Optimizer::GlobalBundleAdjustemnt`` (sic — upstream typo;
src/Optimizer.cc:≈60) and the loop-closing background GBA
(LoopClosing::RunGlobalBundleAdjustment, ≈530).

Design: full-map Schur would need the dense camera-point cross blocks for
ALL keyframes at once (O(P*K) memory — fine locally, not globally), so
global refinement alternates two *perfectly batched* half-steps instead:

  1. resection  — every keyframe pose refined independently against fixed
     points: a vmapped motion-only LM (reuses solvers/pose_opt math);
  2. intersection — every landmark refined independently against fixed
     poses: batched 3x3 Gauss-Newton over its observations (segment
     sums over the forward index).

Alternation converges to the same stationary points as joint BA (it IS
block-coordinate descent on the same cost), trades some convergence rate
for O(P + K) memory and total batch-parallelism — the batched choice
for the background polish pass, which in the reference runs for only 10
LM iterations anyway.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..models import map_state as ms
from ..utils.camera import CameraModel
from .lie import hat, inv3x3, se3_exp
from .pose_opt import CHI2_MONO, CHI2_STEREO


@functools.partial(jax.jit, static_argnames=("rounds", "unbind_outliers"))
def global_bundle_adjustment(
    m: ms.MapState,
    cam: CameraModel,
    inv_sigma2_lut: jnp.ndarray,
    rounds: int = 6,
    unbind_outliers: bool = True,
) -> ms.MapState:
    """Alternating global refinement of all valid keyframes + points."""
    K, N = m.kf_point.shape
    P = m.pt_capacity

    uv = m.kf_xy
    ur = m.kf_ur
    lvl = jnp.clip(m.kf_level, 0, inv_sigma2_lut.shape[0] - 1)
    inv_s2 = inv_sigma2_lut[lvl]
    pid_raw = m.kf_point
    obs_ok = (pid_raw >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pid = jnp.where(obs_ok, pid_raw, 0)
    obs_ok = obs_ok & m.pt_valid[pid]
    has_ur = ur >= 0
    chi2_th = jnp.where(has_ur, CHI2_STEREO, CHI2_MONO)

    # Keyframe 0 is the gauge (reference GBA fixes KF0 via mvpKeyFrameOrigins).
    kf_free = m.kf_valid & (jnp.arange(K) > 0)

    def residual_all(poses, pts):
        R = poses[:, :3, :3]
        t = poses[:, :3, 3]
        X = pts[pid]
        pc = jnp.einsum("kij,knj->kni", R, X) + t[:, None, :]
        z = jnp.maximum(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        urp = u - cam.bf / z
        r = jnp.stack(
            [u - uv[..., 0], v - uv[..., 1],
             jnp.where(has_ur, urp - ur, 0.0)], -1
        )
        return r, pc

    def chi2_all(poses, pts):
        r, pc = residual_all(poses, pts)
        c = jnp.sum(r * r, -1) * inv_s2
        return jnp.where(pc[..., 2] <= 1e-6, 1e9, c)

    def resection(poses, pts, w_obs):
        """Batched per-keyframe pose GN step (all KFs in parallel)."""
        r, pc = residual_all(poses, pts)
        z = jnp.maximum(pc[..., 2], 1e-6)
        zi = 1.0 / z
        zi2 = zi * zi
        x, y = pc[..., 0], pc[..., 1]
        zeros = jnp.zeros_like(x)
        J_proj = jnp.stack(
            [
                jnp.stack([cam.fx * zi, zeros, -cam.fx * x * zi2], -1),
                jnp.stack([zeros, cam.fy * zi, -cam.fy * y * zi2], -1),
                jnp.stack([cam.fx * zi, zeros, (-cam.fx * x + cam.bf) * zi2], -1),
            ],
            axis=-2,
        )
        J_proj = J_proj.at[..., 2, :].set(
            jnp.where(has_ur[..., None], J_proj[..., 2, :], 0.0)
        )
        I3 = jnp.broadcast_to(jnp.eye(3), pc.shape + (3,))
        J = J_proj @ jnp.concatenate([I3, -hat(pc)], -1)  # (K, N, 3, 6)
        H = jnp.einsum("knij,kn,knil->kjl", J, w_obs, J)  # (K, 6, 6)
        b = jnp.einsum("knij,kn,kni->kj", J, w_obs, r)
        diag = jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(H))  # LM damping term
        delta = -jnp.linalg.solve(
            H + 1e-3 * diag + 1e-6 * jnp.eye(6)[None], b[..., None]
        )[..., 0]
        poses_new = jax.vmap(lambda d, T: se3_exp(d) @ T)(delta, poses)
        return jnp.where(kf_free[:, None, None], poses_new, poses)

    def intersection(poses, pts, w_obs):
        """Batched per-point 3x3 GN step via segment sums."""
        r, pc = residual_all(poses, pts)
        z = jnp.maximum(pc[..., 2], 1e-6)
        zi = 1.0 / z
        zi2 = zi * zi
        x, y = pc[..., 0], pc[..., 1]
        zeros = jnp.zeros_like(x)
        J_proj = jnp.stack(
            [
                jnp.stack([cam.fx * zi, zeros, -cam.fx * x * zi2], -1),
                jnp.stack([zeros, cam.fy * zi, -cam.fy * y * zi2], -1),
                jnp.stack([cam.fx * zi, zeros, (-cam.fx * x + cam.bf) * zi2], -1),
            ],
            axis=-2,
        )
        J_proj = J_proj.at[..., 2, :].set(
            jnp.where(has_ur[..., None], J_proj[..., 2, :], 0.0)
        )
        Jp = J_proj @ poses[:, None, :3, :3]  # (K, N, 3, 3)
        flat = pid.reshape(-1)
        Hc = jnp.einsum("knij,kn,knil->knjl", Jp, w_obs, Jp).reshape(-1, 3, 3)
        bc = jnp.einsum("knij,kn,kni->knj", Jp, w_obs, r).reshape(-1, 3)
        H = jnp.zeros((P, 3, 3)).at[flat].add(Hc, mode="drop")
        b = jnp.zeros((P, 3)).at[flat].add(bc, mode="drop")
        tr = jnp.trace(H, axis1=-2, axis2=-1)
        ok = m.pt_valid & (tr > 1e-9)
        Hd = H + (1e-3 * jnp.maximum(tr, 1e-6) / 3.0)[:, None, None] * jnp.eye(3)
        delta = -(inv3x3(Hd + 1e-9 * jnp.eye(3)) @ b[..., None])[..., 0]
        return jnp.where(ok[:, None], pts + delta, pts)

    poses = m.kf_pose_cw
    pts = m.pt_pos
    obs_mask = obs_ok
    err_initial = jnp.sum(
        jnp.where(obs_ok, jnp.minimum(chi2_all(poses, pts), chi2_th), 0.0)
    )
    for k in range(rounds):
        # Huber IRLS weights on current residuals (robust first half).
        c = chi2_all(poses, pts)
        delta_h = jnp.sqrt(chi2_th)
        wh = jnp.minimum(1.0, delta_h / jnp.sqrt(jnp.maximum(c, 1e-12)))
        if k >= rounds // 2:
            obs_mask = obs_mask & (c <= chi2_th)
            wh = jnp.ones_like(wh)
        w_obs = inv_s2 * obs_mask.astype(jnp.float32) * wh
        # Round-level safeguard: block-coordinate GN can overshoot; keep a
        # half-step only if it reduces the total robust cost, else revert
        # (the round is then a no-op, matching LM's reject semantics).
        err0 = jnp.sum(jnp.where(obs_mask, jnp.minimum(c, chi2_th), 0.0))

        def total_err(p_, x_):
            cc = chi2_all(p_, x_)
            return jnp.sum(jnp.where(obs_mask, jnp.minimum(cc, chi2_th), 0.0))

        poses_new = resection(poses, pts, w_obs)
        poses = jnp.where(total_err(poses_new, pts) < err0, poses_new, poses)
        err1 = total_err(poses, pts)
        pts_new = intersection(poses, pts, w_obs)
        pts = jnp.where(total_err(poses, pts_new) < err1, pts_new, pts)

    kf_point = m.kf_point
    if unbind_outliers:
        # Persist the chi2 hygiene (see run_joint_global_ba): wrong
        # associations pruned during the plain half must not be re-admitted
        # by the next GBA segment or drag subsequent local BA windows.
        # GATED ON PROGRESS: at an unconverged geometry (every round
        # reverted — err did not drop) the chi2 classification is
        # unreliable, and unbinding is irreversible; the reference's GBA
        # never erases observations at all (only local BA does,
        # Optimizer.cc:≈640), so only prune when this solve actually
        # improved the map.
        # Measured over the SAME mask as err_initial (obs_ok): an
        # observation pruned mid-solve contributed chi2_th to err_initial
        # and must keep contributing (capped) here, otherwise mask
        # shrinkage alone reads as "improved" even when every GN round
        # reverted — exactly the unconverged case this gate exists for.
        err_final = jnp.sum(
            jnp.where(obs_ok, jnp.minimum(chi2_all(poses, pts), chi2_th),
                      0.0)
        )
        improved = err_final < err_initial
        bad = obs_ok & ((chi2_all(poses, pts) > chi2_th) | ~obs_mask)
        kf_point = jnp.where(bad & improved, ms.NO_POINT, kf_point)
    return m._replace(kf_pose_cw=poses, pt_pos=pts, kf_point=kf_point)


# ---------------------------------------------------------------------------
# Joint global BA (the reference's actual GBA shape: one LM problem over all
# keyframes + points, g2o BundleAdjustment, Optimizer.cc:≈80) — feasible
# up to a few hundred keyframes by compacting the active map and running
# the SAME Schur-complement engine as local BA over all of it.  Beyond
# max_cams, the caller should fall back to the alternation solver above.
# ---------------------------------------------------------------------------


def _next_pow2(n: int, lo: int = 16) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


_JOINT_CORE_CACHE = {}


def _joint_core(phase_iters: Tuple[int, int], initial_prune: float = 0.0):
    """Cached jitted schur_ba_core per phase schedule (a fresh jax.jit per
    call would recompile the full Schur program on every GBA segment)."""
    key = (phase_iters, initial_prune)
    if key not in _JOINT_CORE_CACHE:
        from .local_ba import schur_ba_core

        _JOINT_CORE_CACHE[key] = jax.jit(
            functools.partial(
                schur_ba_core, phase_iters=phase_iters,
                initial_prune=initial_prune,
            )
        )
    return _JOINT_CORE_CACHE[key]


def run_joint_global_ba(
    m: ms.MapState,
    cam: CameraModel,
    inv_sigma2_lut: jnp.ndarray,
    phase_iters: Tuple[int, int] = (5, 10),
    max_cams: int = 512,
    initial_prune: float = 0.0,
    unbind_outliers: bool = True,
) -> ms.MapState:
    """Joint Schur GBA over ALL active keyframes/points (compacted).

    Host-side prep (GBA runs once per loop closure; not a hot path):
    gather the valid keyframes and points into dense prefixes padded to a
    power of two, remap the observation index, run ``schur_ba_core`` with
    every camera free except the lowest-id keyframe (the reference fixes
    KF0, Optimizer.cc:≈100), and scatter the refined poses/points back.
    Returns ``m`` unchanged if the map exceeds ``max_cams`` keyframes.

    ``unbind_outliers`` PERSISTS the solver's chi2 pruning into the map by
    unbinding pruned observations (the reference's equivalent hygiene runs
    continuously in local BA, Optimizer.cc:≈560 erase loop; without it,
    every abortable GBA segment re-admits the same wrong associations and
    the plain phase drags the solution back toward the pre-loop drift).
    """
    import numpy as np

    from .lie import orthonormalize_se3

    kf_valid = np.asarray(m.kf_valid)
    pt_valid = np.asarray(m.pt_valid)
    kf_ids = np.nonzero(kf_valid)[0]
    pt_ids = np.nonzero(pt_valid)[0]
    if len(kf_ids) < 2 or len(pt_ids) == 0 or len(kf_ids) > max_cams:
        return m
    C = _next_pow2(len(kf_ids))
    Pa = _next_pow2(len(pt_ids), lo=256)

    kf_pad = np.zeros(C, np.int32)
    kf_pad[: len(kf_ids)] = kf_ids
    used = np.zeros(C, bool)
    used[: len(kf_ids)] = True
    # Gauge: the lowest valid keyframe id (KF0 unless culled).
    is_fixed = np.zeros(C, bool)
    is_fixed[0] = True  # kf_ids is sorted ascending

    # Compact point index: full-pool id -> [0, Pa) slot.
    pt_slot = np.full(m.pt_capacity, -1, np.int64)
    pt_slot[pt_ids] = np.arange(len(pt_ids))

    kf_pad_j = jnp.asarray(kf_pad)
    pid_raw = np.asarray(m.kf_point)[kf_pad]          # (C, N)
    obs_ok = (
        (pid_raw >= 0)
        & np.asarray(m.kf_kp_valid)[kf_pad]
        & used[:, None]
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
    core = _joint_core(phase_iters, initial_prune)
    poses, pts, obs_mask, _ = core(
        m.kf_pose_cw[kf_pad_j], pts0,
        m.kf_xy[kf_pad_j], ur, inv_s2,
        jnp.asarray(pid), jnp.asarray(obs_ok),
        jnp.asarray(is_fixed), jnp.asarray(used),
        cam,
    )

    n_k = len(kf_ids)
    kf_pose = m.kf_pose_cw.at[jnp.asarray(kf_ids)].set(
        orthonormalize_se3(poses[:n_k])
    )
    pt_pos = m.pt_pos.at[jnp.asarray(pt_ids)].set(pts[: len(pt_ids)])
    kf_point = m.kf_point
    if unbind_outliers:
        pruned = jnp.asarray(obs_ok) & ~obs_mask          # (C, N)
        rows = jnp.where(pruned[:n_k], ms.NO_POINT, m.kf_point[kf_pad_j[:n_k]])
        kf_point = kf_point.at[jnp.asarray(kf_ids)].set(rows)
    return m._replace(kf_pose_cw=kf_pose, pt_pos=pt_pos, kf_point=kf_point)
