"""Local mapping: per-keyframe map maintenance.

JAX equivalent of the LocalMapping thread (src/LocalMapping.cc,
SURVEY.md §3.3).  The reference's Run() loop becomes a per-keyframe
``process_keyframe`` invoked by the tracker after insertion (synchronous in
round 1; the async pipelined version is the parallel/ milestone):

  MapPointCulling      (LocalMapping.cc:≈140) — found-ratio < 0.25 or
                       too few observers shortly after creation
  CreateNewMapPoints   (≈190) — epipolar triangulation with the best
                       covisible neighbors
  SearchInNeighbors    (≈370) — fuse duplicate points (round-1: descriptor+
                       projection duplicate suppression at creation)
  LocalBundleAdjustment (Optimizer.cc:≈460) — solvers/local_ba
  KeyFrameCulling      (≈500) — redundant keyframe masking
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Settings
from ..ops import matcher
from ..ops import pyramid as pyr_ops
from ..ops import twoview
from ..ops.extractor import Features
from ..solvers.lie import se3_apply, se3_inverse
from ..solvers.local_ba import local_bundle_adjustment
from ..utils.camera import CameraModel, in_image
from . import map_state as ms

NO_POINT = ms.NO_POINT


def _bucket(cap: int, n: int, lo: int = 8) -> int:
    """TWO-level window bucket: ``lo`` while the map is small, ``cap``
    (the reference-scale window) once it outgrows it.

    The reference's association windows are bounded by the number of
    covisible keyframes that EXIST; with fixed compiled shapes we bucket
    the window to the map's current size so a young map compiles small,
    fast problems and a mature map reaches the full reference-scale cap.
    Exactly two compiled variants per stage: keyframe insertion ids drift
    between runs (async mapping timing), so a finer ladder would recompile
    MID-RUN whenever a run crosses a bucket boundary warmup never saw.  LocalMapper.warm() precompiles both."""
    lo = min(lo, cap)
    return lo if n <= lo else cap


@jax.jit
def cull_map_points(m: ms.MapState) -> ms.MapState:
    """MapPointCulling (LocalMapping.cc:≈140) with the reference's
    PROBATION-WINDOW semantics: only RECENTLY created points (the
    mlpRecentAddedMapPoints list — points less than ~3 keyframes old) are
    eligible for the found-ratio < 0.25 and min-observation culls; a point
    that survives 3 keyframes graduates and is never ratio-culled again.
    An earlier forever-eligible form here culled OLD map points exactly
    when a loop revisit made them frustum-visible but hard to match
    (found ratio decays on approach), eroding the revisit-side keyframes'
    bound-feature sets and starving the loop SearchByBoW >= 20 gate
    (measured: 600+ raw-descriptor matches on a true revisit pair vs <= 19
    bound-point matches).

    Pool-pressure extension (no reference analog — its heap is unbounded):
    when the fixed point pool is > 90% full the weakest survivors are also
    dropped down to the budget, ranked by observation count then found
    ratio, with freshly created points protected.  Without this, a full
    pool silently stops triangulation and tracking starves ~20 frames
    later."""
    found_ratio = m.pt_found.astype(jnp.float32) / jnp.maximum(
        m.pt_visible.astype(jnp.float32), 1.0
    )
    n_obs = ms.point_observation_counts(m)
    age = m.n_kf - m.pt_first_kf  # keyframes since creation
    probation = age <= 3
    bad = probation & (
        (found_ratio < 0.25) | ((age >= 2) & (n_obs < 2))
    )
    keep = m.pt_valid & ~bad

    P = m.pt_capacity
    budget = int(0.90 * P)
    over = jnp.sum(keep) > budget
    value = (
        jnp.minimum(n_obs, 16).astype(jnp.float32) + found_ratio
        + jnp.where(age < 3, 100.0, 0.0)  # protect fresh points
    )
    _, top_ids = jax.lax.top_k(jnp.where(keep, value, -jnp.inf), budget)
    in_budget = jnp.zeros((P,), bool).at[top_ids].set(True)
    keep = jnp.where(over, keep & in_budget, keep)
    # Scrub keyframe bindings to culled points NOW: their pool slots are
    # reusable (tracking.add_points free-list), and a stale binding would
    # silently re-attach to whatever point takes the slot next.
    pid = jnp.maximum(m.kf_point, 0)
    still = keep[pid] & (m.kf_point >= 0)
    kf_point = jnp.where(still, m.kf_point, ms.NO_POINT)
    return m._replace(pt_valid=keep, kf_point=kf_point)


@functools.partial(jax.jit, static_argnames=("n_neighbors",))
def triangulate_new_points(
    m: ms.MapState,
    kf_id: jnp.ndarray,
    cam: CameraModel,
    scale_factors: jnp.ndarray,
    sigma2: jnp.ndarray,
    n_neighbors: int = 4,
) -> ms.MapState:
    """CreateNewMapPoints: for each of the best covisible neighbors, match
    unbound keypoints along epipolar lines and triangulate.

    The reference loops 10 (mono: 20) neighbors with early exits; we process
    a fixed ``n_neighbors`` as a batched loop (compile-time unrolled).
    """
    neighbor_ids, weights = ms.best_covisible(m, kf_id, n_neighbors)

    f1 = Features(
        xy=m.kf_xy[kf_id], level=m.kf_level[kf_id], angle=m.kf_angle[kf_id],
        response=jnp.ones_like(m.kf_angle[kf_id]),
        desc=m.kf_desc[kf_id],
        valid=m.kf_kp_valid[kf_id] & (m.kf_point[kf_id] < 0),  # unbound only
    )
    T1 = m.kf_pose_cw[kf_id]
    Kinv = jnp.linalg.inv(cam.K)
    P1 = cam.K @ T1[:3, :4]
    O1 = -T1[:3, :3].T @ T1[:3, 3]

    def match_neighbor(kf2, w):
        """Epipolar match + triangulation + CheckRT for ONE neighbor —
        vmapped over the neighborhood so the n matchers run as one batched
        program (the reference's sequential neighbor loop is latency-bound
        here; the matches are independent, only the BINDING is ordered)."""
        ok_neighbor = (w >= 10) & m.kf_valid[kf2] & (kf2 != kf_id)
        f2 = Features(
            xy=m.kf_xy[kf2], level=m.kf_level[kf2], angle=m.kf_angle[kf2],
            response=jnp.ones_like(m.kf_angle[kf2]),
            desc=m.kf_desc[kf2],
            valid=m.kf_kp_valid[kf2] & (m.kf_point[kf2] < 0) & ok_neighbor,
        )
        T2 = m.kf_pose_cw[kf2]
        # Fundamental from relative pose: build from T21 = T2 * T1^-1.
        T21 = T2 @ se3_inverse(T1)
        R21 = T21[:3, :3]
        t21 = T21[:3, 3]
        # Baseline gate (reference: skip if baseline < scene depth ratio).
        baseline = jnp.linalg.norm(t21)
        tx = jnp.array(
            [
                [0.0, -t21[2], t21[1]],
                [t21[2], 0.0, -t21[0]],
                [-t21[1], t21[0], 0.0],
            ]
        )
        E21 = tx @ R21
        F21 = Kinv.T @ E21 @ Kinv  # x2^T F21 x1 = 0; line2 = F21 @ x1
        # matcher.search_for_triangulation expects F12 with line2 = x1 @ F12
        # i.e. F12 = F21^T (its epipolar distance lives in image 2).
        mres = matcher.search_for_triangulation(
            f1, f2, F21.T, sigma2,
        )
        good_pair = mres.ok & (baseline > 1e-3)

        # Triangulate matched pairs.
        P2 = cam.K @ T2[:3, :4]
        xy2 = f2.xy[mres.idx]
        X = twoview.triangulate_linear(P1, P2, f1.xy, xy2)
        # Cheirality + reprojection + scale-consistency checks (CheckRT-like).
        pc1 = se3_apply(T1, X)
        pc2 = se3_apply(T2, X)
        z_ok = (pc1[:, 2] > 0.05) & (pc2[:, 2] > 0.05)

        def reproj_err(pc, xy):
            u = cam.fx * pc[:, 0] / jnp.maximum(pc[:, 2], 1e-6) + cam.cx
            v = cam.fy * pc[:, 1] / jnp.maximum(pc[:, 2], 1e-6) + cam.cy
            return (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2

        s2a = sigma2[jnp.clip(f1.level, 0, sigma2.shape[0] - 1)]
        s2b = sigma2[jnp.clip(f2.level[mres.idx], 0, sigma2.shape[0] - 1)]
        e1_ok = reproj_err(pc1, f1.xy) <= 5.991 * s2a
        e2_ok = reproj_err(pc2, xy2) <= 5.991 * s2b
        # Parallax gate: rays from both camera centers.
        O2 = -T2[:3, :3].T @ T2[:3, 3]
        r1 = X - O1
        r2 = X - O2
        cos_par = jnp.sum(r1 * r2, -1) / jnp.maximum(
            jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-9
        )
        good = good_pair & z_ok & e1_ok & e2_ok & (cos_par < 0.9998)
        return X, mres.idx, good

    X_all, idx_all, good_all = jax.vmap(match_neighbor)(
        neighbor_ids[:n_neighbors], weights[:n_neighbors]
    )
    # Sequential binding (first neighbor wins a slot, like the reference's
    # in-order CreateNewMapPoints) — cheap scatters only.
    for i in range(n_neighbors):
        m, _ = _add_and_bind(
            m, X_all[i], f1, idx_all[i], good_all[i], kf_id,
            neighbor_ids[i],
        )
    return m


def _add_and_bind(m, X, f1, idx2, good, kf1, kf2):
    """Append triangulated points and bind them in BOTH keyframes."""
    from .tracking import add_points  # local import to avoid cycle

    # Don't re-add slots that got bound by an earlier neighbor iteration.
    still_unbound = m.kf_point[kf1] < 0
    good = good & still_unbound
    m, pids = add_points(m, X, f1.desc, good, kf1)
    ok = good & (pids >= 0)
    kf_point_1 = jnp.where(ok, pids, m.kf_point[kf1])
    m = m._replace(kf_point=m.kf_point.at[kf1].set(kf_point_1))
    # Bind in neighbor: slot idx2[i] of kf2 -> pids[i]
    row2 = m.kf_point[kf2]
    incoming = ms.scatter_slots(row2.shape[0], idx2, pids, ok)
    row2 = jnp.where((row2 < 0) & (incoming >= 0), incoming, row2)
    m = m._replace(kf_point=m.kf_point.at[kf2].set(row2))
    return m, pids


@functools.partial(jax.jit, static_argnames=("n_levels", "bf", "th_depth"))
def cull_keyframes(
    m: ms.MapState,
    current_kf: jnp.ndarray,
    n_levels: int = 8,
    bf: float = 0.0,
    th_depth: float = 0.0,
) -> ms.MapState:
    """KeyFrameCulling (LocalMapping.cc:≈500): mask keyframes >= 90% of
    whose points are redundantly observed.  Keyframes 0/1 and the current
    keyframe are protected.

    Scale-aware redundancy (the reference's exact condition): an
    observation of point p at octave l counts as redundant only when at
    least 3 OTHER keyframes observe p at the same or finer scale
    (scaleLevel <= l + 1) — computed here as one (P, L) per-level scatter
    count + cumsum instead of the reference's per-point observer loop.
    For stereo/RGB-D (bf > 0), only close observations (depth < th_depth)
    participate, as in the reference's !mbMonocular depth gate."""
    pts = m.kf_point
    ok = (pts >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    # Stereo/RGB-D close gate: applies ONLY to the candidate keyframe's own
    # counted observations (the reference gates mvDepth of the examined KF,
    # LocalMapping.cc:≈520) — other keyframes' far observations still count
    # toward the per-level observer totals below.
    ok_counted = ok
    if bf > 0.0 and th_depth > 0.0:
        # depth = bf / (u - ur); close <=> disparity > bf / th_depth.
        disp = m.kf_xy[..., 0] - m.kf_ur
        close = (m.kf_ur >= 0) & (disp > bf / th_depth)
        ok_counted = ok & close
    pid = jnp.where(ok, pts, 0)
    P = m.pt_capacity
    lvl = jnp.clip(m.kf_level, 0, n_levels - 1)
    flat = jnp.where(ok, pid * n_levels + lvl, P * n_levels).reshape(-1)
    cnt = (
        jnp.zeros((P * n_levels,), jnp.int32)
        .at[flat].add(1, mode="drop")
        .reshape(P, n_levels)
    )
    cum = jnp.cumsum(cnt, axis=1)  # observers at octave <= l
    band = jnp.minimum(lvl + 1, n_levels - 1)
    # -1: exclude the observation itself (it is within its own band).
    redundant_obs = ok_counted & (cum[pid, band] - 1 >= 3)
    n_pts = jnp.sum(ok_counted, axis=1)
    n_red = jnp.sum(redundant_obs, axis=1)
    kf_ids = jnp.arange(m.kf_capacity)
    cullable = (
        m.kf_valid
        & (kf_ids >= 2)
        & (kf_ids != current_kf)
        & (kf_ids < m.n_kf)
        & (n_red.astype(jnp.float32) > 0.9 * n_pts.astype(jnp.float32))
        & (n_pts > 0)
    )
    kf_valid = m.kf_valid & ~cullable
    # Re-parent children of culled keyframes up the tree (the reference's
    # KeyFrame::SetBadFlag MST repair, KeyFrame.cc:≈460) so no node is left
    # unconstrained in the essential graph.
    parent = m.kf_parent
    for _ in range(4):  # chains of culled ancestors are short
        p_ok = (parent >= 0) & kf_valid[jnp.maximum(parent, 0)]
        grand = parent[jnp.maximum(parent, 0)]
        parent = jnp.where(p_ok | (parent < 0), parent, grand)
    return m._replace(kf_valid=kf_valid, kf_parent=parent)


def _fuse_match(
    m: ms.MapState,
    kf_a: jnp.ndarray,
    kf_b: jnp.ndarray,
    cam: CameraModel,
    scale_factors: jnp.ndarray,
    inv_sigma2_lut: jnp.ndarray,
    enabled=None,
):
    """Match stage of one Fuse direction (ORBmatcher::Fuse projection +
    windowed TH_LOW + chi2 gate): project kf_a's bound points into kf_b.
    Returns (pid (N,), idx (N,), ok (N,)) — source point, matched kf_b
    keypoint slot, validity.  vmapped over directions by the caller."""
    from ..ops.hamming import TH_LOW, match_descriptors

    pts_a = m.kf_point[kf_a]
    src_ok = (pts_a >= 0) & m.kf_kp_valid[kf_a] & m.kf_valid[kf_a] & m.kf_valid[kf_b]
    if enabled is not None:
        # Zero-covisibility second-order slots are disabled outright: a
        # valid-but-unrelated keyframe must never become a fuse target
        # (coincidental projection+Hamming agreement on repetitive texture
        # would wrongly merge unrelated points).
        src_ok = src_ok & enabled
    pid = jnp.where(pts_a >= 0, pts_a, 0)
    src_ok = src_ok & m.pt_valid[pid]

    T = m.kf_pose_cw[kf_b]
    p_c = se3_apply(T, m.pt_pos[pid])
    z = p_c[:, 2]
    uv = jnp.stack(
        [cam.fx * p_c[:, 0] / jnp.maximum(z, 1e-6) + cam.cx,
         cam.fy * p_c[:, 1] / jnp.maximum(z, 1e-6) + cam.cy], -1
    )
    O_w = -T[:3, :3].T @ T[:3, 3]
    dist = jnp.linalg.norm(m.pt_pos[pid] - O_w, axis=-1)
    # Viewing-angle gate (reference Fuse: ray vs point normal < 60 deg);
    # points whose normal is not yet computed (zero) pass the gate.
    nrm = jnp.linalg.norm(m.pt_normal[pid], axis=-1)
    view_cos = jnp.where(
        nrm < 1e-6, 1.0,
        jnp.sum((m.pt_pos[pid] - O_w) * m.pt_normal[pid], axis=-1)
        / jnp.maximum(dist, 1e-9),
    )
    vis = (
        src_ok & (z > 0.1) & in_image(cam, uv)
        & (dist >= 0.8 * m.pt_min_dist[pid])
        & (dist <= 1.2 * m.pt_max_dist[pid])
        & (view_cos > 0.5)
    )
    pred_level = ms.predict_scale(dist, m.pt_max_dist[pid], scale_factors)
    d2 = jnp.sum((uv[:, None, :] - m.kf_xy[kf_b][None, :, :]) ** 2, axis=-1)
    rr = (3.0 * scale_factors[pred_level]) ** 2
    lvl_ok = jnp.abs(m.kf_level[kf_b][None, :] - pred_level[:, None]) <= 1
    mres = match_descriptors(
        m.pt_desc[pid], vis, m.kf_desc[kf_b], m.kf_kp_valid[kf_b],
        pair_mask=(d2 <= rr[:, None]) & lvl_ok, max_dist=TH_LOW, ratio=1.0,
    )
    # Per-observation chi2 gate at the matched keypoint's octave.
    idx = jnp.where(mres.ok, mres.idx, 0)
    err2 = jnp.sum((uv - m.kf_xy[kf_b][idx]) ** 2, axis=-1)
    lvl_b = jnp.clip(m.kf_level[kf_b][idx], 0, inv_sigma2_lut.shape[0] - 1)
    ok = mres.ok & (err2 * inv_sigma2_lut[lvl_b] <= 5.991)
    return pid, mres.idx, ok


def _fuse_apply(
    m: ms.MapState,
    kf_b: jnp.ndarray,
    pid: jnp.ndarray,
    idx: jnp.ndarray,
    ok: jnp.ndarray,
):
    """Binding/Replace stage of one Fuse direction (MapPoint::Replace,
    MapPoint.cc:≈180): a match on an unbound keypoint adds an observation;
    a match on a keypoint bound to a DIFFERENT point replaces, keeping the
    better-observed point.  Sequential across directions (Replace results
    must be visible to the next direction's binding), while the expensive
    match stage is batched by the caller.

    Returns (m, repl): ``repl`` (P,) maps each point id to its survivor
    (identity where untouched) so the caller can redirect later
    directions' matches through this pass's merges — the sequential
    reference loop sees those merges because it re-reads bindings."""
    P = m.pt_capacity
    ok = ok & m.pt_valid[jnp.clip(pid, 0, P - 1)]
    row = m.kf_point[kf_b]
    incoming = ms.scatter_slots(row.shape[0], idx, pid, ok)
    dup = (row >= 0) & (incoming >= 0) & (row != incoming)
    n_obs = ms.point_observation_counts(m)
    a_survives = n_obs[jnp.clip(incoming, 0, P - 1)] >= n_obs[
        jnp.clip(row, 0, P - 1)
    ]
    old = jnp.where(a_survives, row, incoming)
    new = jnp.where(a_survives, incoming, row)
    old_do = jnp.where(dup, old, -1)
    m = ms.apply_point_replacements(m, old_do, new, dup)
    repl = (
        jnp.arange(P, dtype=jnp.int32)
        .at[jnp.where(dup, old_do, P)]
        .set(jnp.where(dup, new, 0).astype(jnp.int32), mode="drop")
    )
    # Bind still-unbound slots (new observations) after the rebind pass.
    row2 = m.kf_point[kf_b]
    row_new = jnp.where((row2 < 0) & (incoming >= 0), incoming, row2)
    return m._replace(kf_point=m.kf_point.at[kf_b].set(row_new)), repl


@jax.jit
def fuse_with_neighbor(
    m: ms.MapState,
    kf_a: jnp.ndarray,
    kf_b: jnp.ndarray,
    cam: CameraModel,
    scale_factors: jnp.ndarray,
    inv_sigma2_lut: jnp.ndarray,
) -> ms.MapState:
    """One direction of SearchInNeighbors (LocalMapping.cc:≈370) with the
    reference's FULL Fuse semantics (ORBmatcher::Fuse, src/ORBmatcher.cc:
    ≈950)."""
    pid, idx, ok = _fuse_match(
        m, kf_a, kf_b, cam, scale_factors, inv_sigma2_lut
    )
    m, _ = _fuse_apply(m, kf_b, pid, idx, ok)
    return m


@jax.jit
def fuse_neighborhood(
    m: ms.MapState,
    pairs_a: jnp.ndarray,   # (D,) source keyframes
    pairs_b: jnp.ndarray,   # (D,) target keyframes
    cam: CameraModel,
    scale_factors: jnp.ndarray,
    inv_sigma2_lut: jnp.ndarray,
    pair_valid: jnp.ndarray = None,
) -> ms.MapState:
    """SearchInNeighbors over the whole neighborhood in one program: the D
    directional match stages (the (N, N) projection matchers — the
    expensive part) run as ONE vmapped batch against the pre-fuse map,
    then the binding/Replace passes apply sequentially in pair order.
    Semantics vs the fully sequential reference loop: a later direction's
    MATCHES come from the pre-fuse map, but its source point ids are
    redirected through the accumulated Replace maps of the earlier
    directions (``repl`` composition), so merges propagate exactly as in
    the sequential loop; the only residual difference is descriptor/
    position drift of merged points between match and apply — noise-level
    (the descriptors are near-duplicates by construction of Fuse)."""
    if pair_valid is None:
        pair_valid = jnp.ones(pairs_a.shape[0], bool)
    pid_all, idx_all, ok_all = jax.vmap(
        lambda a, b, en: _fuse_match(
            m, a, b, cam, scale_factors, inv_sigma2_lut, enabled=en
        )
    )(pairs_a, pairs_b, pair_valid)
    # Sequential binding/Replace with DEFERRED global rebind: the original
    # form called apply_point_replacements per direction — D full-table
    # (K, N) kf_point rebinds + D observation-count recomputes at the
    # production neighborhood (D = 30).  Here each direction only composes the (P,) replacement
    # map, transfers observation counts incrementally, and updates its ONE
    # target row (later directions read earlier merges through `cur` and
    # the updated rows — the visibility the sequential reference loop
    # has); the expensive global rebind + stat merge + invalidation runs
    # ONCE at the end with every merge redirected to its TERMINAL
    # survivor.  Residual approximation: the incremental n_obs transfer
    # double-counts a point that appears as `old` twice within one
    # direction (duplicate pre-fuse bindings only) — survivor choice is a
    # heuristic and the final Replace pass is exact.
    P = m.pt_capacity
    D = pairs_a.shape[0]
    n_obs = ms.point_observation_counts(m)
    cur = jnp.arange(P, dtype=jnp.int32)
    kf_point = m.kf_point
    merges_old, merges_new, merges_do = [], [], []
    for d in range(D):
        kf_b = pairs_b[d]
        pid_raw = jnp.clip(pid_all[d], 0, P - 1)
        pid_d = cur[pid_raw]
        ok = ok_all[d] & m.pt_valid[pid_raw]
        row = kf_point[kf_b]
        row = jnp.where(row >= 0, cur[jnp.clip(row, 0, P - 1)], row)
        incoming = ms.scatter_slots(row.shape[0], idx_all[d], pid_d, ok)
        dup = (row >= 0) & (incoming >= 0) & (row != incoming)
        inc_safe = jnp.clip(incoming, 0, P - 1)
        row_safe = jnp.clip(row, 0, P - 1)
        a_survives = n_obs[inc_safe] >= n_obs[row_safe]
        old = jnp.where(a_survives, row, incoming)
        new = jnp.where(a_survives, incoming, row)
        old_do = jnp.where(dup, old, -1)
        merges_old.append(old_do)
        merges_new.append(new)
        merges_do.append(dup)
        old_safe = jnp.clip(old_do, 0, P - 1)
        repl_d = (
            jnp.arange(P, dtype=jnp.int32)
            .at[jnp.where(dup, old_do, P)]
            .set(jnp.where(dup, new, 0).astype(jnp.int32), mode="drop")
        )
        cur = repl_d[cur]
        moved = jnp.where(dup, n_obs[old_safe], 0)
        n_obs = n_obs.at[jnp.clip(new, 0, P - 1)].add(moved, mode="drop")
        n_obs = n_obs.at[old_safe].add(-moved, mode="drop")
        #

        row2 = jnp.where(row >= 0, repl_d[row_safe], row)
        incoming2 = jnp.where(incoming >= 0, repl_d[inc_safe], incoming)
        newly = (row2 < 0) & (incoming2 >= 0)
        row_new = jnp.where(newly, incoming2, row2)
        n_obs = n_obs.at[
            jnp.where(newly, incoming2, P)
        ].add(1, mode="drop")
        kf_point = kf_point.at[kf_b].set(row_new)
    m = m._replace(kf_point=kf_point)
    mo = jnp.concatenate(merges_old)
    mn = jnp.concatenate(merges_new)
    md = jnp.concatenate(merges_do)
    # Redirect every merge to its TERMINAL survivor so chained merges
    # (old1 -> s at d1, s -> s2 at d2) survive apply_point_replacements'
    # retired-target drop as (old1 -> s2, s -> s2).
    mn_t = jnp.where(md, cur[jnp.clip(mn, 0, P - 1)], mn)
    return ms.apply_point_replacements(m, mo, mn_t, md)


class LocalMapper:
    """Host-side driver for the per-keyframe mapping sequence."""

    def __init__(self, settings: Settings, enable_ba: bool = True,
                 enable_kf_culling: bool = True, enable_fuse: bool = True,
                 sensor: str = "mono", n_fuse_neighbors: int = None,
                 mesh=None):
        # enable_fuse: SearchInNeighbors duplicate fusion (LocalMapping.cc:
        # ≈370), ON by default with the reference's full Fuse semantics:
        # per-observation chi2 gate + best-observed MapPoint::Replace
        # (round 1's bind-only fuse was off by default because the plain
        # windowed TH_LOW bind poisoned BA on repetitive texture).
        self.settings = settings
        tpu = settings.tpu
        # Association-window CAPS (reference scale, config-driven).  The per-keyframe window actually compiled is
        # bucketed to the map's current size (_bucket) so a small map never
        # pays the padded worst case, while large maps reach the
        # reference's windows.
        # Every cap is clamped to the keyframe pool: the top_k gathers
        # inside _gather_problem/best_covisible fail outright for
        # k > kf_capacity (small-capacity test configs hit this).
        K = tpu.max_keyframes
        self.n_fuse_neighbors = min(
            n_fuse_neighbors if n_fuse_neighbors is not None
            else tpu.fuse_first_neighbors,
            max(1, K - 1),
        )
        self.n_fuse_second = min(
            tpu.fuse_second_neighbors,
            max(0, K - 1 - self.n_fuse_neighbors),
        )
        self.ba_n_local = min(tpu.ba_local_window, max(2, K // 2))
        self.ba_n_fixed = min(
            tpu.ba_fixed_window, max(0, K - self.ba_n_local)
        )
        self.cam = settings.camera_model()
        orb = settings.orb
        # numpy (NOT jnp): closure-captured by jitted programs, where a
        # device array would be baked in as a constant (utils/noconsts.py).
        self.scale_factors = np.asarray(
            pyr_ops.scale_factors(orb.n_levels, orb.scale_factor), np.float32
        )
        self.sigma2 = np.asarray(
            pyr_ops.level_sigma2(orb.n_levels, orb.scale_factor), np.float32
        )
        self.inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        self.enable_ba = enable_ba
        self.enable_kf_culling = enable_kf_culling
        self.enable_fuse = enable_fuse
        # mesh: a jax.sharding.Mesh with >1 device dispatches local BA to
        # the keyframe-sharded distributed solver (parallel/dist_ba.py) —
        # same Schur LM engine, landmark blocks psum-reduced across devices.
        self.mesh = mesh if (mesh is not None and mesh.devices.size > 1) else None
        # Mono needs a wider triangulation neighborhood for parallax: the
        # reference uses 20 covisible neighbors mono vs 10 stereo/RGB-D
        # (LocalMapping.cc:≈190).
        self.n_tri_neighbors = min(
            tpu.tri_neighbors_mono if sensor == "mono"
            else tpu.tri_neighbors_stereo,
            max(1, K - 1),
        )
        # Scale-aware KF culling params: the stereo/RGB-D close-point gate
        # (LocalMapping.cc:≈520) only applies when a baseline exists.
        self._bf = float(settings.camera.bf) if sensor != "mono" else 0.0
        self._cull_th_depth = float(getattr(settings.camera, "th_depth", 0.0))

    def warm(self, m: ms.MapState, kf_id: int = 1) -> None:
        """Precompile BOTH window buckets of every mapping stage on the
        current pool shapes.  Called once after a driver's warmup pass —
        without this, the first keyframe past a bucket boundary pays a
        mid-run compile."""
        import jax as _jax

        for n_now in (1, 1 << 30):
            out = self.process_keyframe(m, kf_id, n_now=n_now)
            _jax.block_until_ready(out.kf_pose_cw)

    def _local_ba(self, m: ms.MapState, kf_id, n_now: int = None) -> ms.MapState:
        # Window bucketed to the map's current size: the reference frees
        # ALL covisibles + fixes all other observers (Optimizer.cc:≈460);
        # our caps are config.tpu.ba_local_window/ba_fixed_window and the
        # compiled problem grows with the map up to those caps.
        if n_now is None:
            n_now = int(jax.device_get(m.n_kf))
        n_local = _bucket(self.ba_n_local, n_now)
        n_fixed = min(self.ba_n_fixed, n_local)
        # Landmark-compaction cap: scale with the number of free cameras —
        # each camera contributes at most one frame's worth of features,
        # heavily shared within the window.
        pt_cap = min(8192, max(2, n_local // 2) * m.feat_capacity)
        if self.mesh is not None:
            from ..parallel.dist_ba import distributed_local_ba

            return distributed_local_ba(
                m, kf_id, self.mesh, self.cam, self.inv_sigma2,
                n_local=n_local, n_fixed=n_fixed, pt_cap=pt_cap,
            )
        return local_bundle_adjustment(
            m, kf_id, self.cam, self.inv_sigma2,
            n_local=n_local, n_fixed=n_fixed, pt_cap=pt_cap,
        )

    def on_initial_map(self, m: ms.MapState) -> ms.MapState:
        """Post-initialization polish (the reference runs GBA(20) here)."""
        if self.enable_ba:
            m = self._local_ba(m, jnp.int32(1), n_now=2)
            m = ms.update_point_stats(m, self.scale_factors)
        return m

    def process_keyframe(self, m: ms.MapState, kf_id: int,
                         abort=None, n_now: int = None) -> ms.MapState:
        """Per-keyframe mapping sequence.  ``abort``: optional
        threading.Event — the InterruptBA analog (src/LocalMapping.cc
        mbAbortBA): when set mid-job, the remaining OPTIONAL stages (local
        BA, distinctive descriptors, keyframe culling) are skipped so the
        job finishes within one stage's latency; the structural stages
        (culling, triangulation, fuse, stats) always complete — the
        reference likewise always finishes ProcessNewKeyFrame/
        CreateNewMapPoints and only aborts the BA."""

        def aborted():
            return abort is not None and abort.is_set()

        kf = jnp.int32(kf_id)
        # Window buckets for this keyframe: sized to the map's current
        # keyframe count (kf_id + 1 rows in use at insertion time).
        # ``n_now`` override: warm() forces both buckets at compile time.
        # ONE shared small/large switch for every stage so exactly TWO
        # compiled variants of the whole job exist (warm() covers both);
        # per-stage thresholds would multiply combos and recompile mid-run.
        if n_now is None:
            n_now = int(kf_id) + 1
        small = n_now <= 8
        nn_tri = min(8, self.n_tri_neighbors) if small else self.n_tri_neighbors
        m = cull_map_points(m)
        tri_ids, _ = ms.best_covisible(m, kf, nn_tri)
        m = triangulate_new_points(
            m, kf, self.cam, self.scale_factors, self.sigma2,
            n_neighbors=nn_tri,
        )
        fuse_ids = None
        if self.enable_fuse:
            # SearchInNeighbors: fuse duplicates with the first-order
            # covisible neighbors PLUS the second-order neighborhood of
            # that group, both directions (LocalMapping.cc:≈370 uses ~10
            # first + 5 second-order), matched as one batched program.
            nn = min(8, self.n_fuse_neighbors) if small \
                else self.n_fuse_neighbors
            nn2 = 0 if small else self.n_fuse_second
            neighbor_ids, weights = ms.best_covisible(m, kf, nn)
            ring = neighbor_ids[:nn]
            if nn2 > 0:
                # Second-order = keyframes most covisible with the first
                # RING (not with kf itself): vote by shared points with the
                # ring's point union — the batched equivalent of each ring
                # member's GetBestCovisibilityKeyFrames(5).
                ring_pts = m.kf_point[ring]
                ring_ok = (
                    (ring_pts >= 0) & m.kf_kp_valid[ring]
                    & m.kf_valid[ring][:, None]
                )
                member = (
                    jnp.zeros((m.pt_capacity,), jnp.int32)
                    .at[jnp.where(ring_ok, ring_pts, m.pt_capacity)
                        .reshape(-1)].max(1, mode="drop")
                ) > 0
                obs_ok = (
                    (m.kf_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
                )
                votes2 = jnp.sum(
                    member[jnp.where(obs_ok, m.kf_point, 0)] & obs_ok,
                    axis=1,
                ).astype(jnp.float32)
                in_ring = (
                    jnp.zeros((m.kf_capacity,), bool).at[ring].set(True)
                    .at[kf].set(True)
                )
                v2, second = jax.lax.top_k(
                    jnp.where(in_ring, -1.0, votes2), nn2
                )
                fuse_targets = jnp.concatenate([ring, second])
                # Zero-covisibility slots (ring padding or unrelated
                # second-order winners) are DISABLED, not merely hoped to
                # no-op: a valid-but-unrelated keyframe as fuse target can
                # wrongly merge points on repetitive texture.
                target_ok = jnp.concatenate(
                    [weights[:nn] > 0, v2 > 0]
                )
            else:
                fuse_targets = ring
                target_ok = weights[:nn] > 0
            fuse_ids = fuse_targets
            nbs = [fuse_targets[i] for i in range(fuse_targets.shape[0])]
            pairs_a = jnp.concatenate(
                [jnp.stack([kf, nb]) for nb in nbs]
            )
            pairs_b = jnp.concatenate(
                [jnp.stack([nb, kf]) for nb in nbs]
            )
            pair_valid = jnp.repeat(target_ok, 2)
            m = fuse_neighborhood(
                m, pairs_a, pairs_b, self.cam, self.scale_factors,
                self.inv_sigma2, pair_valid=pair_valid,
            )
        m = ms.update_point_stats(m, self.scale_factors)
        if self.enable_ba and not aborted():
            m = self._local_ba(m, kf, n_now=n_now)
            # NOTE: no stats refresh after BA — the reference recomputes
            # UpdateNormalAndDepth on creation/fuse/Replace, never after
            # LocalBundleAdjustment (src/LocalMapping.cc:≈190-500); the
            # slight post-BA staleness of the scale bands matches it.
        if aborted():
            return m
        # Exact min-median-Hamming distinctive descriptors for the points
        # this pass touched: those observed by the new keyframe, its
        # triangulation partners and its fuse partners (the reference
        # recomputes per TOUCHED point on observation change,
        # MapPoint.cc:≈260 — never map-wide).  One batched incremental
        # pass, ~4x cheaper than the full-pool recompute.
        touched = [kf[None], tri_ids]
        if fuse_ids is not None:
            touched.append(fuse_ids)
        if self.enable_ba:
            # Local BA's outlier unbinding changes observation sets of
            # points whose remaining observers can lie anywhere in the BA
            # window — include the window keyframes so their descriptors
            # are refreshed too (the reference recomputes on every
            # EraseObservation, MapPoint.cc:≈140).
            row = ms.covisible_row(m, kf)
            _, ba_window = jax.lax.top_k(
                row, min(self.ba_n_local + self.ba_n_fixed,
                         int(row.shape[0]))
            )
            touched.append(ba_window.astype(jnp.int32))
        m = ms.compute_distinctive_descriptors(
            m, touched_kfs=jnp.concatenate(touched)
        )
        if self.enable_kf_culling:
            m = cull_keyframes(
                m, kf, n_levels=self.settings.orb.n_levels,
                bf=self._bf, th_depth=self._cull_th_depth,
            )
        return m
