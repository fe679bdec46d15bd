"""Tracking: the per-frame front-end state machine.

JAX equivalent of ``Tracking`` (src/Tracking.cc, SURVEY.md §3.2).
The data-dependent state machine (NOT_INITIALIZED / OK / LOST, fallback
order) runs on host exactly as the reference's ``Track()`` does in its
caller thread; every compute step is a fixed-shape jitted program:

  track_motion_model    = SearchByProjection(cur,last) + PoseOptimization
                          (Tracking::TrackWithMotionModel, Tracking.cc:≈860)
  track_reference_kf    = descriptor matching vs ref KF + PoseOptimization
                          (Tracking::TrackReferenceKeyFrame, ≈770; BoW node
                          gating is an acceleration, not a capability — we
                          match densely, BoW arrives with loop closing)
  track_local_map       = local-point harvest + frustum cull +
                          SearchByProjection + PoseOptimization
                          (Tracking::TrackLocalMap + SearchLocalPoints,
                          ≈930/≈1140)
  monocular init        = SearchForInitialization + batched H/F RANSAC
                          (ops/twoview) + map bootstrap (≈560-740)
  stereo/RGB-D init     = keyframe 0 + depth-unprojected points (≈500)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Settings
from ..ops import matcher, twoview
from ..ops import pyramid as pyr_ops
from ..ops.extractor import Features, OrbExtractor
from ..ops.hamming import TH_HIGH, TH_LOW, match_descriptors
from ..solvers.lie import orthonormalize_se3, se3_apply, se3_inverse
from ..solvers.pose_opt import PoseObs, pose_optimization
from ..utils.camera import CameraModel, in_image
from . import map_state as ms
from .frame import Frame, build_mono_frame, build_rgbd_frame, build_stereo_frame

NO_POINT = ms.NO_POINT


# ---------------------------------------------------------------------------
# Jitted tracking steps
# ---------------------------------------------------------------------------


def _pose_obs_from_bindings(
    m: ms.MapState, frame: Frame, bindings: jnp.ndarray, inv_sigma2_lut: jnp.ndarray
) -> PoseObs:
    """Assemble PoseObs for all frame slots bound to a map point."""
    bound = bindings >= 0
    pid = jnp.where(bound, bindings, 0)
    return PoseObs(
        points_w=m.pt_pos[pid],
        uv=frame.xy,
        ur=frame.ur,
        inv_sigma2=inv_sigma2_lut[jnp.clip(frame.level, 0, inv_sigma2_lut.shape[0] - 1)],
        valid=bound & frame.valid & m.pt_valid[pid],
    )


@functools.partial(jax.jit, static_argnames=())
def track_motion_model(
    m: ms.MapState,
    frame: Frame,
    T_pred: jnp.ndarray,
    last_xy: jnp.ndarray,
    last_bindings: jnp.ndarray,
    last_level: jnp.ndarray,
    cam: CameraModel,
    scale_factors: jnp.ndarray,
    inv_sigma2_lut: jnp.ndarray,
    radius: jnp.ndarray,
    last_depth: Optional[jnp.ndarray] = None,
    last_desc: Optional[jnp.ndarray] = None,
    last_valid: Optional[jnp.ndarray] = None,
    T_last: Optional[jnp.ndarray] = None,
    temp_depth_cap: float = 1e9,
    use_temp: Optional[jnp.ndarray] = None,
    last_angle: Optional[jnp.ndarray] = None,
    baseline: Optional[jnp.ndarray] = None,
):
    """Project last frame's map points with the predicted pose, match in a
    window, optimize pose.

    Temporary visual-odometry points (Tracking::UpdateLastFrame,
    src/Tracking.cc:≈810): unbound last-frame keypoints with close stereo/
    RGB-D depth are unprojected at the LAST pose and used as extra motion-
    model observations — the reference materializes them as temp MapPoints
    and deletes them after; here they are a pure function of the last frame
    so they never touch the map (auto-"culled").  They anchor tracking
    through unmapped regions (localization-only mode / keyframe starvation).

    Returns (T, bindings, n_inliers_map, n_matches, n_inliers_total).
    """
    bound = last_bindings >= 0
    pid = jnp.where(bound, last_bindings, 0)
    is_map = bound & m.pt_valid[pid]

    # Temp VO sources: unbound, close-depth last-frame keypoints.  The
    # reference creates them ONLY in localization-only mode
    # (UpdateLastFrame's early return on !mbOnlyTracking): during SLAM the
    # keyframes themselves spawn close points, and temp observations would
    # only add noise to the motion-model pose.
    if last_depth is not None:
        gate = use_temp if use_temp is not None else jnp.asarray(True)
        has_temp = (
            gate & (~is_map) & last_valid & (last_depth > 0)
            & (last_depth < temp_depth_cap)
        )
        x = (last_xy[:, 0] - cam.cx) / cam.fx * last_depth
        y = (last_xy[:, 1] - cam.cy) / cam.fy * last_depth
        p_c_last = jnp.stack([x, y, last_depth], -1)
        p_w_temp = se3_apply(se3_inverse(T_last), p_c_last)
        p_w = jnp.where(is_map[:, None], m.pt_pos[pid], p_w_temp)
        desc_src = jnp.where(is_map[:, None], m.pt_desc[pid], last_desc)
        valid_src = is_map | has_temp
    else:
        has_temp = jnp.zeros_like(is_map)
        p_w = m.pt_pos[pid]
        desc_src = m.pt_desc[pid]
        valid_src = is_map

    p_c = se3_apply(T_pred, p_w)
    z_ok = p_c[:, 2] > 0.1
    uv = jnp.stack(
        [cam.fx * p_c[:, 0] / jnp.maximum(p_c[:, 2], 1e-6) + cam.cx,
         cam.fy * p_c[:, 1] / jnp.maximum(p_c[:, 2], 1e-6) + cam.cy], -1
    )
    valid_src = valid_src & z_ok & in_image(cam, uv)

    # Depth-direction octave gate (ORBmatcher.cc:≈1180): under forward
    # motion a point reprojects LARGER (search higher octaves only), under
    # backward motion smaller; gated on |tz| > baseline, stereo/RGB-D only.
    level_dir = None
    if baseline is not None and T_last is not None:
        tz = (T_pred @ se3_inverse(T_last))[2, 3]
        level_dir = jnp.where(
            tz > baseline, jnp.int32(1),
            jnp.where(-tz > baseline, jnp.int32(-1), jnp.int32(0)),
        )
    mres = matcher.search_by_projection(
        uv, last_level, desc_src, valid_src, frame.features,
        scale_factors, radius=radius, max_dist=TH_HIGH, ratio=0.9,
        level_dir=level_dir,
    )
    if last_angle is not None:
        # Rotation-consistency histogram (ComputeThreeMaxima,
        # ORBmatcher.cc:≈1600) over source->target angle deltas.
        from ..ops.hamming import rotation_consistency

        rot_ok = rotation_consistency(
            last_angle, frame.angle, mres.idx, mres.ok
        )
        mres = mres._replace(ok=rot_ok)
    # bindings: frame slot -> point id (scatter MAP match results; temp
    # sources never enter bindings — they must not reach the map).
    N = frame.xy.shape[0]
    ok_map = mres.ok & is_map
    bindings = ms.scatter_slots(N, mres.idx, pid.astype(jnp.int32), ok_map)
    # ^ colliding sources: one writer wins (reference keeps best-dist; the
    # pose optimizer's outlier gate cleans up the rest).

    # Temp matches per frame slot (map bindings win collisions).
    ok_temp = mres.ok & has_temp
    temp_src = ms.scatter_slots(
        N, mres.idx, jnp.arange(last_xy.shape[0], dtype=jnp.int32), ok_temp,
        fill=-1,
    )
    temp_src = jnp.where(bindings >= 0, -1, temp_src)
    t_ok = (temp_src >= 0) & frame.valid

    map_obs = _pose_obs_from_bindings(m, frame, bindings, inv_sigma2_lut)
    # Retry gate counts MAP matches only: temp matches must not talk the
    # caller out of the doubled-window retry that recovers map anchors.
    n_matches = jnp.sum(map_obs.valid)
    res = pose_optimization(T_pred, map_obs, cam)
    if last_depth is not None:
        # Two-stage scarcity: optimize on map anchors alone first; only if
        # that leaves tracking weak (< 20 inliers) re-optimize with the
        # temp VO observations included.  Where the map is rich, temp
        # points would outvote the absolute anchors with dead-reckoned
        # positions and bias the pose; where it is thin they are the only
        # thing keeping tracking alive (the point of VO mode).
        pts_w = jnp.where(
            t_ok[:, None], p_w[jnp.maximum(temp_src, 0)], map_obs.points_w
        )
        obs_full = map_obs._replace(
            points_w=pts_w, valid=map_obs.valid | t_ok
        )
        res = jax.lax.cond(
            (res.n_inliers < 20) & jnp.any(t_ok),
            lambda: pose_optimization(T_pred, obs_full, cam),
            lambda: res,
        )
    is_map_obs = bindings >= 0
    n_map = jnp.sum(res.inlier & is_map_obs)
    bindings = jnp.where(res.inlier, bindings, NO_POINT)
    return res.T_cw, bindings, n_map, n_matches, res.n_inliers


@jax.jit
def track_reference_keyframe(
    m: ms.MapState,
    frame: Frame,
    ref_kf: jnp.ndarray,
    T_init: jnp.ndarray,
    inv_sigma2_lut: jnp.ndarray,
    cam: CameraModel,
):
    """Match the frame against the reference keyframe's bound descriptors,
    then optimize.  (TrackReferenceKeyFrame; dense matching stands in for
    SearchByBoW's node-gated matching.)"""
    kf_desc = m.kf_desc[ref_kf]
    kf_pts = m.kf_point[ref_kf]
    kf_has_pt = (kf_pts >= 0) & m.kf_kp_valid[ref_kf]
    pid = jnp.where(kf_has_pt, kf_pts, 0)
    src_valid = kf_has_pt & m.pt_valid[pid]

    mres = match_descriptors(
        kf_desc, src_valid, frame.desc, frame.valid,
        max_dist=TH_LOW, ratio=0.7, cross_check=True,
    )
    bindings = ms.scatter_slots(
        frame.xy.shape[0], mres.idx, pid.astype(jnp.int32), mres.ok
    )
    obs = _pose_obs_from_bindings(m, frame, bindings, inv_sigma2_lut)
    n_matches = jnp.sum(obs.valid)
    res = pose_optimization(T_init, obs, cam)
    bindings = jnp.where(res.inlier, bindings, NO_POINT)
    return res.T_cw, bindings, res.n_inliers, n_matches


@functools.partial(jax.jit, static_argnames=("n_local", "n_local_kfs"))
def gather_local_points(
    m: ms.MapState, bindings: jnp.ndarray, n_local: int = 4096,
    n_local_kfs: int = 80,
):
    """Local map = points observed by the keyframes sharing the most points
    with the current frame (K1) plus the covisible neighborhood of that
    group (K2) — Tracking::UpdateLocalKeyFrames/Points
    (Tracking.cc:≈1190-1300), K1+K2 capped at ``n_local_kfs`` (the
    reference's 80).  Fixed-size gathers.

    Returns (pt_ids (n_local,), valid (n_local,)).

    Segment-op formulation (no (P, K) observation matrix): frame-bound
    points become a (P,) membership mask; per-KF votes are one (K, N)
    gather over the forward index; the local union is one scatter from the
    selected keyframes' rows.  O(P + K*N) — flat in map size.
    """
    n_local = min(n_local, m.pt_capacity)
    n_local_kfs = min(n_local_kfs, m.kf_capacity)
    # K1 gets ~60% of the cap, K2 the rest (the reference bounds only the
    # total; K1 members always outrank K2 in relevance).
    n_k1 = max(1, (n_local_kfs * 3) // 5)
    n_k2 = n_local_kfs - n_k1
    bound = bindings >= 0
    pid = jnp.where(bound, bindings, m.pt_capacity)
    in_frame = (
        jnp.zeros((m.pt_capacity,), jnp.int32)
        .at[pid].max(bound.astype(jnp.int32), mode="drop")
    ) > 0
    obs_ok = (
        (m.kf_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    )
    pts_all = jnp.where(obs_ok, m.kf_point, 0)
    votes = jnp.sum(
        in_frame[pts_all] & obs_ok, axis=1
    ).astype(jnp.float32)  # (K,)
    _, local_kfs = jax.lax.top_k(votes, n_k1)
    k1_hit = votes[local_kfs] > 0

    def union_points(kf_ids, ok_rows):
        sel_pts = m.kf_point[kf_ids]
        sel_ok = (
            (sel_pts >= 0) & m.kf_kp_valid[kf_ids]
            & m.kf_valid[kf_ids][:, None] & ok_rows[:, None]
        )
        sel_idx = jnp.where(sel_ok, sel_pts, m.pt_capacity)
        return (
            jnp.zeros((m.pt_capacity,), jnp.int32)
            .at[sel_idx.reshape(-1)].max(1, mode="drop")
        ) > 0

    seen = union_points(local_kfs, k1_hit)
    if n_k2 > 0:
        # K2 = keyframes most covisible with the K1 GROUP (neighbors of the
        # local window, Tracking.cc:≈1240 expands each K1 member's top
        # covisibles + spanning-tree family; the group-covisibility count
        # is the batched equivalent): votes2 = #points each KF shares with
        # K1's point union.
        in_k1 = (
            jnp.zeros((m.kf_capacity,), jnp.int32)
            .at[local_kfs].max(k1_hit.astype(jnp.int32), mode="drop")
        ) > 0
        votes2 = jnp.sum(
            seen[pts_all] & obs_ok, axis=1
        ).astype(jnp.float32)
        votes2 = jnp.where(in_k1, -1.0, votes2)
        v2, k2_kfs = jax.lax.top_k(votes2, n_k2)
        seen = seen | union_points(k2_kfs, v2 > 0)
    seen = seen & m.pt_valid
    # Fixed-size id list: top_k over the mask (arbitrary order within ties).
    score = seen.astype(jnp.float32)
    _, pt_ids = jax.lax.top_k(score, n_local)
    valid = seen[pt_ids]
    return pt_ids.astype(jnp.int32), valid


@jax.jit
def track_local_map(
    m: ms.MapState,
    frame: Frame,
    T: jnp.ndarray,
    bindings: jnp.ndarray,
    local_ids: jnp.ndarray,
    local_valid: jnp.ndarray,
    cam: CameraModel,
    scale_factors: jnp.ndarray,
    inv_sigma2_lut: jnp.ndarray,
    radius_mult: jnp.ndarray = jnp.float32(1.0),
):
    """SearchLocalPoints + final pose optimization (Tracking.cc:≈930-1180).

    Frustum test per local point (Frame::isInFrustum, Frame.cc:≈280):
    positive depth, in image, distance within [0.8 min, 1.2 max] scale band,
    viewing angle < 60 deg; search radius from viewing angle and predicted
    scale.
    """
    p_w = m.pt_pos[local_ids]
    p_c = se3_apply(T, p_w)
    z = p_c[:, 2]
    zok = z > 0.1
    uv = jnp.stack(
        [cam.fx * p_c[:, 0] / jnp.maximum(z, 1e-6) + cam.cx,
         cam.fy * p_c[:, 1] / jnp.maximum(z, 1e-6) + cam.cy], -1
    )
    O_w = -T[:3, :3].T @ T[:3, 3]
    po = p_w - O_w
    dist = jnp.linalg.norm(po, axis=-1)
    dist_ok = (dist >= 0.8 * m.pt_min_dist[local_ids]) & (
        dist <= 1.2 * m.pt_max_dist[local_ids]
    )
    view_cos = jnp.sum(
        po * m.pt_normal[local_ids], axis=-1
    ) / jnp.maximum(dist, 1e-9)
    view_ok = view_cos > 0.5
    # Already-bound points are not searched again (reference skips
    # mnLastFrameSeen == current).
    already = jnp.zeros(m.pt_capacity, bool).at[
        jnp.where(bindings >= 0, bindings, m.pt_capacity)
    ].set(True, mode="drop")
    vis = (
        local_valid & zok & in_image(cam, uv) & dist_ok & view_ok
        & ~already[local_ids]
    )

    pred_level = ms.predict_scale(dist, m.pt_max_dist[local_ids], scale_factors)
    # Viewing-angle-dependent radius (reference: 2.5 px if cos>0.998 else
    # 4.0, times the predicted octave's scale factor).
    r = jnp.where(view_cos > 0.998, 2.5, 4.0) * radius_mult
    rr = (r * scale_factors[pred_level]) ** 2
    mres = matcher.projection_match(
        uv, rr, pred_level, m.pt_desc[local_ids], vis,
        frame.xy, frame.level, frame.desc, frame.valid,
        level_band=1, max_dist=TH_HIGH, ratio=0.8,
    )

    new_bindings = bindings
    # Only fill slots not already bound.
    incoming = ms.scatter_slots(
        bindings.shape[0], mres.idx, local_ids.astype(bindings.dtype), mres.ok
    )
    new_bindings = jnp.where(
        (new_bindings < 0) & (incoming >= 0), incoming, new_bindings
    )

    obs = _pose_obs_from_bindings(m, frame, new_bindings, inv_sigma2_lut)
    res = pose_optimization(T, obs, cam)
    new_bindings = jnp.where(res.inlier, new_bindings, NO_POINT)

    # Visibility statistics for point culling (IncreaseVisible/Found).
    vis_ids = jnp.where(vis, local_ids, 0)
    pt_visible = m.pt_visible.at[vis_ids].add(vis.astype(jnp.int32))
    found_mask = new_bindings >= 0
    fid = jnp.where(found_mask, new_bindings, 0)
    pt_found = m.pt_found.at[fid].add(found_mask.astype(jnp.int32))
    m = m._replace(pt_visible=pt_visible, pt_found=pt_found)

    return res.T_cw, new_bindings, res.n_inliers, m


# ---------------------------------------------------------------------------
# Map bootstrap + keyframe insertion (jitted map updates)
# ---------------------------------------------------------------------------


@jax.jit
def insert_keyframe(
    m: ms.MapState,
    frame: Frame,
    T_cw: jnp.ndarray,
    frame_id: jnp.ndarray,
    bindings: jnp.ndarray,
    parent: jnp.ndarray,
) -> Tuple[ms.MapState, jnp.ndarray]:
    """Append the frame as keyframe row n_kf (Tracking::CreateNewKeyFrame +
    LocalMapping::ProcessNewKeyFrame's binding half).  Returns (map, kf_id)."""
    k = m.n_kf
    m = m._replace(
        kf_pose_cw=m.kf_pose_cw.at[k].set(T_cw),
        kf_xy=m.kf_xy.at[k].set(frame.xy),
        kf_level=m.kf_level.at[k].set(frame.level),
        kf_angle=m.kf_angle.at[k].set(frame.angle),
        kf_desc=m.kf_desc.at[k].set(frame.desc),
        kf_ur=m.kf_ur.at[k].set(frame.ur),
        kf_kp_valid=m.kf_kp_valid.at[k].set(frame.valid),
        kf_point=m.kf_point.at[k].set(jnp.where(frame.valid, bindings, NO_POINT)),
        kf_valid=m.kf_valid.at[k].set(True),
        kf_frame_id=m.kf_frame_id.at[k].set(frame_id),
        kf_parent=m.kf_parent.at[k].set(parent),
        n_kf=k + 1,
    )
    return m, k


@functools.partial(jax.jit, static_argnames=("reverse",))
def add_points(
    m: ms.MapState,
    pos: jnp.ndarray,        # (M, 3) world positions
    desc: jnp.ndarray,       # (M, 8)
    good: jnp.ndarray,       # (M,) which slots are real new points
    ref_kf: jnp.ndarray,     # scalar keyframe id
    reverse: bool = False,
) -> Tuple[ms.MapState, jnp.ndarray]:
    """Insert up to M points into FREE pool slots (slots of culled points
    are reused — the pool is a free-list, not an append-only log; without
    reuse a long sequence exhausts the pool and the map stops growing).

    ``reverse``: allocate from the HIGH end of the free list.  The
    TRACKER allocates reverse and the async MAPPING WORKER forward so
    their concurrent allocations never collide while the pool has free
    slots — the invariant that makes adoption's keyframe-queue merge
    (async_pipeline.adopt_mapped_state) conflict-free.

    Returns (map, ids (M,) with -1 where not added).
    """
    M = pos.shape[0]
    P = m.pt_capacity
    order = jnp.argsort(~good)  # good entries first (stable)
    pos_s = pos[order]
    desc_s = desc[order]
    good_s = good[order]
    n_new = jnp.sum(good).astype(jnp.int32)
    # Free slots first; lowest index first (or highest, reversed).
    idx_bias = jnp.arange(P) * (1.0 / P)
    free_score = jnp.where(m.pt_valid, -1.0, 1.0) + (
        idx_bias if reverse else -idx_bias
    )
    _, free_slots = jax.lax.top_k(free_score, M)
    slot = free_slots.astype(jnp.int32)
    slot_free = ~m.pt_valid[slot]
    write = good_s & slot_free

    m = m._replace(
        pt_pos=m.pt_pos.at[slot].set(
            jnp.where(write[:, None], pos_s, m.pt_pos[slot])
        ),
        pt_desc=m.pt_desc.at[slot].set(
            jnp.where(write[:, None], desc_s, m.pt_desc[slot])
        ),
        pt_ref_kf=m.pt_ref_kf.at[slot].set(
            jnp.where(write, ref_kf, m.pt_ref_kf[slot])
        ),
        pt_first_kf=m.pt_first_kf.at[slot].set(
            jnp.where(write, ref_kf, m.pt_first_kf[slot])
        ),
        pt_valid=m.pt_valid.at[slot].set(
            jnp.where(write, True, m.pt_valid[slot])
        ),
        pt_visible=m.pt_visible.at[slot].set(
            jnp.where(write, 1, m.pt_visible[slot])
        ),
        pt_found=m.pt_found.at[slot].set(
            jnp.where(write, 1, m.pt_found[slot])
        ),
        n_pt=jnp.minimum(m.n_pt + n_new, m.pt_capacity),
    )
    # ids in ORIGINAL (unsorted) order:
    inv = jnp.argsort(order)
    ids_sorted = jnp.where(write, slot, NO_POINT)
    return m, ids_sorted[inv]


@jax.jit
def unproject_frame_depth(
    frame: Frame, T_cw: jnp.ndarray, cam: CameraModel
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """World positions for keypoints with valid depth (StereoInitialization /
    CreateNewKeyFrame's close-point spawning, Tracking.cc:≈500/≈1060)."""
    z = frame.depth
    ok = (z > 0) & frame.valid
    x = (frame.xy[:, 0] - cam.cx) / cam.fx * z
    y = (frame.xy[:, 1] - cam.cy) / cam.fy * z
    p_c = jnp.stack([x, y, z], -1)
    T_wc = se3_inverse(T_cw)
    return se3_apply(T_wc, p_c), ok


# ---------------------------------------------------------------------------
# Host-side tracker (the state machine)
# ---------------------------------------------------------------------------


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class Tracker:
    """Host orchestrator for per-frame tracking.

    Mirrors Tracking's members: motion model (mVelocity), last frame,
    reference keyframe, relative-pose log for trajectory export
    (mlRelativeFramePoses, Tracking.cc:≈480).
    """

    def __init__(self, settings: Settings, local_mapper=None,
                 database=None, loop_closer=None, use_fused: bool = True,
                 pipeline: bool = False, chunk: int = 0,
                 mapping_pipeline=None):
        self.settings = settings
        self.database = database
        self.loop_closer = loop_closer
        self.use_fused = use_fused
        # Async mapping pipeline (models/async_pipeline.AsyncMappingPipeline):
        # when set, keyframe mapping + loop closing run in a worker thread
        # on a map snapshot (the reference's LocalMapping/LoopClosing
        # threads, System.cc:≈90-100) and the tracker adopts the result at
        # a later frame boundary; when None, they run synchronously inline.
        self.mapping_pipeline = mapping_pipeline
        # Deferred-keyframe urgency: with the pipeline busy, a keyframe
        # request is dropped (SetAcceptKeyFrames(false)) unless the gap
        # since the last keyframe reaches this many frames, in which case
        # the tracker block-adopts (InterruptBA) and inserts anyway.
        self.kf_urgent_gap = settings.tpu.kf_urgent_gap
        # Grace period for the urgent adopt: covers a normally-finishing
        # mapping job's tail while bounding the worst-case tracking stall.
        self.kf_urgent_wait_s = settings.tpu.kf_urgent_wait_s
        # Chunked driver mode: C frames per dispatch via lax.scan with
        # ON-DEVICE keyframe decision + insertion (track_fused.py's
        # make_fused_chunk_tracker).  Mapping/loop-closing resolve after
        # each chunk — the reference's tracking-thread -> LocalMapping
        # queue hand-off with a bounded lag of <= C frames.  Amortizes the
        # per-dispatch and readback latency over C frames; the scan stays
        # strictly serial over frames.
        self.chunk = int(chunk)
        self._chunk_buf = []   # [(inputs tuple), ...] awaiting dispatch
        self._pending_chunk = None  # lag-1 in-flight chunk (fid0, buf, out)
        self._kf_deferred = False   # a chunk signaled need_kf while blocked
        # Pending-keyframe FIFO (the reference's mlNewKeyFrames queue,
        # LocalMapping.h:≈110): keyframes INSERT immediately and queue
        # here for the async worker; insertion defers only when the queue
        # is full (the reference's queue<3 gate, Tracking.cc:≈1050).
        # Correctness rests on adopt_mapped_state folding post-snapshot
        # insertions back in (async_pipeline).
        self._kf_queue: list = []
        self.kf_queue_depth = settings.tpu.kf_queue_depth
        self._chunk_step = None
        # Pipelined driver mode: per-frame decision flags are read back
        # with a ONE-FRAME lag so the host never blocks on the device —
        # the dispatch-pipeline analog of the reference's tracking-thread /
        # mapping-thread split (keyframes enter the map one frame after
        # their decision, exactly like the reference's KF queue).
        self.pipeline = pipeline
        # How many frames may be in flight before their decision flags are
        # read (1 = classic lag-1; 2 hides the full D2H round trip on
        # high-latency links — keyframe decisions then lag 2 frames, the
        # same latency class as the reference's KF queue hand-off).
        self.pipeline_depth = 1
        self._pending = None    # [(frame_id, TrackOut), ...] oldest first
        self._next_ctx = None   # device-chained ctx for the next dispatch
        self._fused_step = None  # built lazily per sensor
        self.cam = settings.camera_model()
        orb = settings.orb
        self.extractor = OrbExtractor(orb, settings.tpu)
        self._init_extractor = None  # 2x-feature mono-init extractor (lazy)
        # numpy (NOT jnp): these LUTs are closure-captured by the fused
        # tracking programs, where a device array would be baked in as a
        # constant (utils/noconsts.py).
        self.scale_factors = np.asarray(
            pyr_ops.scale_factors(orb.n_levels, orb.scale_factor), np.float32
        )
        self.inv_sigma2 = np.asarray(
            1.0 / pyr_ops.level_sigma2(orb.n_levels, orb.scale_factor),
            np.float32,
        )
        self.map = ms.make_empty_map(
            settings.tpu.max_keyframes,
            settings.tpu.max_points,
            settings.tpu.max_keypoints,
        )
        self.local_mapper = local_mapper
        self.localization_only = False  # Tracking::InformOnlyTracking
        self.state = TrackState.NOT_INITIALIZED
        self.frame_id = 0
        self.last_frame: Optional[Frame] = None
        self.last_T = jnp.eye(4)
        self.last_bindings = None
        self.velocity: Optional[jnp.ndarray] = None
        self.ref_kf = 0
        self.last_kf_frame_id = 0
        self.init_ref: Optional[Frame] = None
        self.init_key = jax.random.PRNGKey(0)
        # Host copies of the pool state from the last chunk readback (see
        # _dispatch_chunk / _adopt) — maintenance reads these instead of
        # paying a dedicated device sync.
        self._host_kf_valid = None
        # Post-relocalization keyframe suppression (Tracking.cc:≈990): no
        # insertion within MaxFrames of a relocalization on a mature map.
        self._no_kf_before = 0
        self._host_n_kf = None
        # Trajectory: list of (frame_id, T_cw 4x4 numpy, ref_kf, is_lost)
        self.trajectory = []
        self.n_tracked_history = []
        # Structured per-frame metrics (SURVEY.md §5 observability: the
        # FrameDrawer status line + TRO-table counters as data).
        self.metrics = {
            "frames": 0,
            "frames_lost": 0,
            "relocalizations": 0,
            "keyframes_created": 0,
            "last_inliers": 0,
            "track_path": "",  # motion | refkf | reloc | none
        }

    # -- frame entry points ------------------------------------------------

    def track_mono(self, image, timestamp: float = 0.0):
        if self.use_fused and self.state != TrackState.NOT_INITIALIZED:
            return self._track_fused("mono", (jnp.asarray(image),))
        # During monocular initialization the reference extracts with a
        # DOUBLED feature budget (mpIniORBextractor, 2*nFeatures,
        # Tracking.cc:≈150); successful init downselects back to the
        # steady-state capacity before keyframe insertion.
        ext = (
            self._get_init_extractor()
            if self.state == TrackState.NOT_INITIALIZED
            else self.extractor
        )
        frame = build_mono_frame(image, ext, self.cam)
        return self._track(frame, timestamp, sensor="mono")

    def _get_init_extractor(self) -> OrbExtractor:
        if self._init_extractor is None:
            import dataclasses

            orb2 = dataclasses.replace(
                self.settings.orb, n_features=2 * self.settings.orb.n_features
            )
            tpu2 = dataclasses.replace(
                self.settings.tpu,
                max_keypoints=2 * self.settings.tpu.max_keypoints,
            )
            # cell=16: the doubled budget must come from MORE cells, not
            # denser per-cell picks — per-cell candidates are capped, and
            # near-duplicate corners die under the 0.9 ratio test (the
            # reference gets the same spread from DistributeOctTree's
            # deeper quadtree subdivision at 2x targets).
            self._init_extractor = OrbExtractor(orb2, tpu2, cell=16)
        return self._init_extractor

    def track_stereo(self, image_left, image_right, timestamp: float = 0.0):
        if self.use_fused and self.state != TrackState.NOT_INITIALIZED:
            return self._track_fused(
                "stereo", (jnp.asarray(image_left), jnp.asarray(image_right))
            )
        frame = build_stereo_frame(
            image_left, image_right, self.extractor, self.cam, self.scale_factors
        )
        return self._track(frame, timestamp, sensor="stereo")

    def track_rgbd(self, image, depth_map, timestamp: float = 0.0):
        if self.use_fused and self.state != TrackState.NOT_INITIALIZED:
            return self._track_fused(
                "rgbd", (jnp.asarray(image), jnp.asarray(depth_map))
            )
        frame = build_rgbd_frame(
            image, depth_map, self.extractor, self.cam,
            self.settings.camera.depth_map_factor,
        )
        return self._track(frame, timestamp, sensor="rgbd")

    # -- fused per-frame path (ONE device dispatch + one scalar readback) ---

    def _get_fused_step(self, sensor: str):
        if self._fused_step is None or getattr(self, "_fused_sensor", None) != sensor:
            from .track_fused import make_fused_frame_tracker

            self._fused_step = make_fused_frame_tracker(
                self.extractor, self.cam, self.scale_factors,
                self.inv_sigma2, sensor, self._th_depth(),
                self.settings.camera.depth_map_factor,
                local_window=self.settings.tpu.local_window,
                kf_max_gap=self.settings.tpu.kf_max_gap,
                kf_busy_frames=self.settings.tpu.kf_busy_frames,
            )
            self._fused_sensor = sensor
        return self._fused_step

    def _make_ctx(self):
        from .track_fused import TrackCtx

        has_vel = self.velocity is not None
        vel = self.velocity if has_vel else jnp.eye(4, dtype=jnp.float32)
        weak = (
            len(self.n_tracked_history) == 0
            or self.n_tracked_history[-1] < 50
        )
        lf = self.last_frame
        return TrackCtx(
            T_last=jnp.asarray(self.last_T, jnp.float32),
            velocity=jnp.asarray(vel, jnp.float32),
            has_velocity=jnp.asarray(has_vel),
            last_xy=lf.xy,
            last_level=lf.level,
            last_bindings=self.last_bindings,
            ref_kf=jnp.int32(self.ref_kf),
            weak=jnp.asarray(weak),
            frames_since_kf=jnp.int32(self.frame_id - self.last_kf_frame_id),
            last_depth=lf.depth,
            last_desc=lf.desc,
            last_valid=lf.valid,
            only_tracking=jnp.asarray(self.localization_only),
            last_angle=lf.angle,
        )

    def _track_fused(self, sensor: str, inputs):
        from .track_fused import (
            FLAG_N_INLIERS, FLAG_NEED_KF, FLAG_OK, FLAG_PATH,
        )

        if self.chunk > 1:
            return self._track_fused_chunked(sensor, inputs)
        if self.pipeline:
            return self._track_fused_pipelined(sensor, inputs)

        self._poll_adopt()
        step = self._get_fused_step(sensor)
        out = step(*inputs, self.map, self._make_ctx())
        self.map = out.m
        frame = out.frame
        flags = np.asarray(out.flags)  # the ONE per-frame device readback
        ok = bool(flags[FLAG_OK])
        n_in = int(flags[FLAG_N_INLIERS])
        need_kf = bool(flags[FLAG_NEED_KF])
        # Post-relocalization suppression (Tracking.cc:≈990): the chunked
        # path threads min_kf_fid into the device policy; the single-frame
        # fused and pipelined paths enforce it here.
        if self.frame_id < self._no_kf_before:
            need_kf = False
        path = int(flags[FLAG_PATH])

        self.metrics["frames"] += 1
        self.metrics["track_path"] = {0: "none", 1: "motion", 2: "refkf", 3: "vo"}[path]
        created = False
        if ok:
            self.state = TrackState.OK
            self.velocity = out.velocity
            self.last_T = out.T_cw
            self.n_tracked_history.append(n_in)
            self.metrics["last_inliers"] = n_in
            if need_kf and not self.localization_only and self._kf_gate():
                self._create_keyframe(frame, out.T_cw, out.bindings, sensor)
                created = True
        else:
            self.state = TrackState.LOST
            self.velocity = None
            self.metrics["frames_lost"] += 1

        relocated = False
        # Reloc on LOST, and also during VO dead-reckoning (the reference's
        # mbVO mode relocalizes in parallel and prefers the reloc solution,
        # Tracking.cc:≈420) — else the pose never re-anchors to the map.
        vo_frame = path == 3
        if (
            (self.state == TrackState.LOST or vo_frame)
            and self.database is not None
        ):
            ok_reloc, T, bindings_r, n_r = self._relocalize(frame)
            if ok_reloc:
                self.state = TrackState.OK
                self.last_T = T
                self.velocity = None
                self.n_tracked_history.append(int(n_r))
                self.metrics["relocalizations"] += 1
                self.metrics["track_path"] = "reloc"
                self._mark_reloc()
                relocated = True

        if created or relocated:
            # Rare, sync-heavy frames: use the host-side log (the new ref-KF
            # pose may have just been BA-adjusted).
            self._log_pose(frame)
        else:
            self.trajectory.append(
                (self.frame_id, out.T_cr, self.ref_kf,
                 self.state != TrackState.OK)
            )
        self._finish_frame(
            frame, out.bindings if (ok and not created and not relocated)
            else None
        )
        return self.last_T

    # -- pipelined fused path (lag-1 flags readback, never blocks) ---------

    def _track_fused_pipelined(self, sensor: str, inputs):
        self._poll_adopt()
        step = self._get_fused_step(sensor)
        ctx = self._next_ctx if self._next_ctx is not None else self._make_ctx()
        out = step(*inputs, self.map, ctx)
        self.map = out.m
        self._next_ctx = out.next_ctx
        fid = self.frame_id
        self.frame_id += 1
        self.last_frame = out.frame
        # Start the tiny flags D2H NOW so it rides alongside device compute;
        # by resolve time np.asarray() returns from the local copy instead
        # of paying a blocking round trip.
        try:
            out.flags.copy_to_host_async()
        except AttributeError:
            pass
        if self._pending is None:
            self._pending = []
        self._pending.append((fid, out))
        while len(self._pending) > self.pipeline_depth:
            # Resolve the OLDEST in-flight frame while this one executes.
            self._resolve_pending(self._pending.pop(0), sensor)
        self.last_T = out.T_cw  # best current estimate (unresolved)
        return out.T_cw

    def flush(self):
        """Resolve all in-flight frames (call at sequence end / before
        trajectory export)."""
        if self._pending_chunk is not None:
            pc, self._pending_chunk = self._pending_chunk, None
            self._resolve_chunk(getattr(self, "_fused_sensor", "mono"), *pc)
        if self._chunk_buf:
            # Tail of a chunked run (< C frames buffered): run them through
            # the single-frame fused path on the same device-chained ctx.
            buf, self._chunk_buf = self._chunk_buf, []
            sensor = getattr(self, "_fused_sensor", "mono")
            for inputs in buf:
                self._track_fused_pipelined(sensor, inputs)
        pending, self._pending = self._pending, None
        for p in pending or []:
            self._resolve_pending(p, getattr(self, "_fused_sensor", "mono"))
        if self.mapping_pipeline is not None:
            # Drain the in-flight job AND the queued keyframes (each adopt
            # dispatches the next queued job).
            self._adopt(self.mapping_pipeline.wait())
            while self._kf_queue or not self.mapping_pipeline.accept_keyframes():
                self._submit_next_kf()
                self._adopt(self.mapping_pipeline.wait())

    def _resolve_pending(self, pending, sensor: str):
        from .track_fused import (
            FLAG_N_INLIERS, FLAG_NEED_KF, FLAG_OK, FLAG_PATH,
        )

        fid, out = pending
        flags = np.asarray(out.flags)
        ok = bool(flags[FLAG_OK])
        n_in = int(flags[FLAG_N_INLIERS])
        need_kf = bool(flags[FLAG_NEED_KF])
        # Post-relocalization suppression (Tracking.cc:≈990): the chunked
        # path threads min_kf_fid into the device policy; the single-frame
        # fused and pipelined paths enforce it here.
        if self.frame_id < self._no_kf_before:
            need_kf = False
        path = int(flags[FLAG_PATH])
        self.metrics["frames"] += 1
        self.metrics["track_path"] = {0: "none", 1: "motion", 2: "refkf", 3: "vo"}[path]

        ref_at_dispatch = int(np.asarray(out.next_ctx.ref_kf))
        if ok:
            self.state = TrackState.OK
            self.last_T = out.T_cw
            self.n_tracked_history.append(n_in)
            self.metrics["last_inliers"] = n_in
            self.trajectory.append((fid, out.T_cr, ref_at_dispatch, False))
            if need_kf and not self.localization_only and not self._kf_gate():
                need_kf = False  # deferred: mapping job in flight
            if path == 3 and self.database is not None:
                # VO dead-reckoning: try to re-anchor to the map (mbVO
                # parallel relocalization, Tracking.cc:≈420).
                ok_r, T, _, n_r = self._relocalize(out.frame)
                if ok_r:
                    self.last_T = T
                    self.metrics["relocalizations"] += 1
                    self.metrics["track_path"] = "reloc"
                    if self._next_ctx is not None:
                        # Re-anchor at the reloc pose but KEEP the measured
                        # VO velocity: the camera is still moving, and an
                        # identity-velocity prediction puts the next
                        # frame's temp-point projections outside the match
                        # window — one stale prediction and the VO
                        # dead-reckoning chain (the whole point of mbVO
                        # mode) dies right after a successful re-anchor.
                        self._next_ctx = self._next_ctx._replace(
                            T_last=jnp.asarray(T, jnp.float32),
                            has_velocity=jnp.asarray(True),
                            velocity=out.velocity,
                            last_bindings=jnp.where(
                                self.last_bindings >= 0, self.last_bindings,
                                jnp.full_like(self.last_bindings, NO_POINT),
                            ),
                            ref_kf=jnp.int32(self.ref_kf),
                        )
            if need_kf and not self.localization_only:
                self._create_keyframe(
                    out.frame, out.T_cw, out.bindings, sensor, frame_id=fid
                )
                # Keyframe events are the only host writes into the device
                # context chain: new reference KF, reset KF-gap counter,
                # scrub bindings against post-mapping point validity.
                if self._next_ctx is not None:
                    lb = self._next_ctx.last_bindings
                    lb = jnp.where(
                        (lb >= 0) & self.map.pt_valid[jnp.maximum(lb, 0)],
                        lb, NO_POINT,
                    )
                    self._next_ctx = self._next_ctx._replace(
                        ref_kf=jnp.int32(self.ref_kf),
                        frames_since_kf=jnp.int32(
                            self.frame_id - self.last_kf_frame_id
                        ),
                        last_bindings=lb,
                    )
            return

        self.state = TrackState.LOST
        self.metrics["frames_lost"] += 1
        relocated = False
        if self.database is not None:
            ok_r, T, bindings_r, n_r = self._relocalize(out.frame)
            if ok_r:
                self.state = TrackState.OK
                self.last_T = T
                self.n_tracked_history.append(int(n_r))
                self.metrics["relocalizations"] += 1
                self.metrics["track_path"] = "reloc"
                self._mark_reloc()
                relocated = True
                if self._next_ctx is not None:
                    # Re-anchor the chain at the relocalized pose with the
                    # reloc bindings and identity velocity: the next frame
                    # motion-tracks the 2D-3D matches reloc just verified
                    # (windowed projection matching with 2x retry), instead
                    # of falling back to descriptor-global ref-KF matching.
                    lb = bindings_r
                    self._next_ctx = self._next_ctx._replace(
                        T_last=jnp.asarray(T, jnp.float32),
                        has_velocity=jnp.asarray(True),
                        velocity=jnp.eye(4, dtype=jnp.float32),
                        last_bindings=jnp.where(
                            lb >= 0, lb, jnp.full_like(lb, NO_POINT)
                        ),
                        ref_kf=jnp.int32(self.ref_kf),
                    )
        if relocated:
            # Log the RELOCALIZED pose (relative to the new reference KF),
            # not the dispatch-time garbage estimate.
            T_cr = np.asarray(T) @ np.linalg.inv(
                np.asarray(self.map.kf_pose_cw[self.ref_kf])
            )
            self.trajectory.append((fid, T_cr, self.ref_kf, False))
        else:
            self.trajectory.append((fid, out.T_cr, ref_at_dispatch, True))

    # -- chunked fused path (C frames per dispatch, lax.scan) ---------------

    def _get_chunk_step(self, sensor: str):
        if (
            self._chunk_step is None
            or getattr(self, "_fused_sensor", None) != sensor
        ):
            from .track_fused import make_fused_chunk_tracker

            self._chunk_step = make_fused_chunk_tracker(
                self.extractor, self.cam, self.scale_factors,
                self.inv_sigma2, sensor, self._th_depth(),
                self.settings.camera.depth_map_factor,
                local_window=self.settings.tpu.local_window,
                kf_max_gap=self.settings.tpu.kf_max_gap,
                kf_busy_frames=self.settings.tpu.kf_busy_frames,
            )
            self._fused_sensor = sensor
        return self._chunk_step

    def _track_fused_chunked(self, sensor: str, inputs):
        self._chunk_buf.append(tuple(jnp.asarray(x) for x in inputs))
        if len(self._chunk_buf) >= self.chunk:
            self._dispatch_chunk(sensor)
        return self.last_T

    def _dispatch_chunk(self, sensor: str):
        # Lag policy: while a mapping job is in flight, the previous
        # chunk's resolution is deferred to AFTER this dispatch (lag-1) so
        # its readback sync and host bookkeeping overlap this chunk's
        # device compute — keyframes are
        # deferred during job flight anyway, so nothing is delayed by it.
        # When the pipeline is idle, resolve FIRST (lag-0): the pending
        # chunk may hold a keyframe whose mapping job should start NOW —
        # an extra chunk of mapping lag costs measurable drift on
        # fast-turning sequences.  flush() resolves the final pending.
        mp = self.mapping_pipeline
        self._poll_adopt()
        if self._pending_chunk is not None and (
            mp is None or mp.accept_keyframes()
        ):
            pc, self._pending_chunk = self._pending_chunk, None
            self._resolve_chunk(sensor, *pc)
            self._poll_adopt()

        buf, self._chunk_buf = self._chunk_buf, []
        fid0 = self.frame_id
        self.frame_id += len(buf)
        stacks = tuple(
            jnp.stack([b[i] for b in buf]) for i in range(len(buf[0]))
        )
        # While a job is in flight the chunk runs with keyframes disabled
        # (SetAcceptKeyFrames(false)) unless the gap is urgent, in which
        # case block-adopt first.
        allow_kf = not self.localization_only
        if mp is not None and len(self._kf_queue) >= self.kf_queue_depth:
            if self._kf_deferred or (
                fid0 - self.last_kf_frame_id >= self.kf_urgent_gap
            ):
                # BOUNDED urgent adopt (InterruptBA class): the abort flag
                # is raised and the job given a short grace; a job that
                # still doesn't finish only defers keyframes further — it
                # never stalls the frame cadence (the reference's tracking
                # thread never blocks on LocalMapping).  Triggered by the
                # max-gap rule AND by a deferred NEED from the previous
                # chunk (_kf_deferred): per-chunk deferral granularity
                # otherwise caps the keyframe cadence at one per two
                # chunks (16 frames) when the policy asks for one every
                # 2-3 frames on exploration — measured mono tracking loss
                # from exactly that map starvation.
                self._kf_deferred = False  # re-armed by the next chunk's
                res = mp.wait(timeout=self.kf_urgent_wait_s)  # flags if the
                if res is not None:                           # need persists
                    self._adopt(res)
                else:
                    allow_kf = False
            else:
                allow_kf = False
        ctx = self._next_ctx if self._next_ctx is not None else self._make_ctx()
        step = self._get_chunk_step(sensor)
        # min_kf_fid: 2**30 disables keyframes for this chunk; otherwise
        # the post-relocalization suppression threshold (Tracking.cc:≈990:
        # no insertion within MaxFrames of a relocalization on a mature
        # map).
        min_kf_fid = (2**30) if not allow_kf else self._no_kf_before
        out = step(
            *stacks, self.map, ctx, jnp.int32(fid0),
            jnp.int32(min_kf_fid),
        )
        self.map = out.m
        self._next_ctx = out.next_ctx
        # Start the chunk-readback D2H copies now so they overlap device
        # compute; by resolve time (lag-1, after the next dispatch)
        # device_get returns from the host copies.
        for arr in (out.flags, out.T_cw, out.T_cr, out.log_ref,
                    out.kf_id, out.kf_valid, out.n_kf):
            arr.copy_to_host_async()
        prev, self._pending_chunk = self._pending_chunk, (fid0, buf, out)
        if prev is not None:
            self._resolve_chunk(sensor, *prev)

    def _resolve_chunk(self, sensor: str, fid0: int, buf, out):
        from .track_fused import (
            FLAG_N_INLIERS, FLAG_NEED_KF, FLAG_OK, FLAG_PATH,
        )

        self._resolving = True
        try:
            return self._resolve_chunk_inner(sensor, fid0, buf, out)
        finally:
            self._resolving = False

    def _resolve_chunk_inner(self, sensor: str, fid0: int, buf, out):
        from .track_fused import (
            FLAG_N_INLIERS, FLAG_NEED_KF, FLAG_OK, FLAG_PATH,
        )
        # ONE readback per chunk: flags + poses + keyframe events, fetched
        # as a single device_get (one host sync; a per-array np.asarray
        # loop would pay one per array).
        (flags, T_cw, T_cr, log_ref, kf_ids, kf_valid_np, n_kf_np) = (
            jax.device_get((
                out.flags, out.T_cw, out.T_cr, out.log_ref, out.kf_id,
                out.kf_valid, out.n_kf,
            ))
        )
        self._host_kf_valid = kf_valid_np
        self._host_n_kf = int(n_kf_np)

        mapped = False
        for j in range(len(buf)):
            fid = fid0 + j
            ok = bool(flags[j, FLAG_OK])
            n_in = int(flags[j, FLAG_N_INLIERS])
            path = int(flags[j, FLAG_PATH])
            kid = int(kf_ids[j])
            self.metrics["frames"] += 1
            self.metrics["track_path"] = (
                {0: "none", 1: "motion", 2: "refkf", 3: "vo"}[path]
            )
            if ok:
                self.state = TrackState.OK
                self.last_T = T_cw[j]  # numpy; converted at the arg boundary
                self.n_tracked_history.append(n_in)
                self.metrics["last_inliers"] = n_in
            else:
                self.state = TrackState.LOST
                self.metrics["frames_lost"] += 1
            self.trajectory.append((fid, T_cr[j], int(log_ref[j]), not ok))
            if kid < 0 and bool(flags[j, FLAG_NEED_KF]) and ok:
                # The device policy wanted a keyframe but insertion was
                # gated (mapping job in flight): give the next dispatch's
                # urgent-adopt a reason to drain the job promptly.
                self._kf_deferred = True
            if kid >= 0:
                # The device already inserted the keyframe; resolve the
                # host half: place-recognition index + local mapping +
                # loop closing (the reference's LocalMapping queue,
                # consumed here with <= C frames of lag).
                self.metrics["keyframes_created"] += 1
                self._kf_deferred = False
                self.ref_kf = kid
                self.last_kf_frame_id = fid
                if self.database is not None:
                    self.database.add_keyframe(
                        kid, self.map.kf_desc[kid], self.map.kf_kp_valid[kid]
                    )
                if self.mapping_pipeline is not None:
                    # Async hand-off through the keyframe FIFO; the worker
                    # picks it up now if idle, else at the next adoption.
                    self._kf_queue.append(kid)
                    self._submit_next_kf()
                elif self.local_mapper is not None:
                    self.map = self.local_mapper.process_keyframe(
                        self.map, kid
                    )
                    mapped = True
                if self.mapping_pipeline is None and self.loop_closer is not None:
                    self.map = self.loop_closer.process_keyframe(
                        self.map, kid
                    )

        if mapped:
            # Mapping may have culled points whose slots can be reused;
            # scrub the chained bindings so the next chunk can't re-attach
            # to reused slots.
            lb = self._next_ctx.last_bindings
            lb = jnp.where(
                (lb >= 0) & self.map.pt_valid[jnp.maximum(lb, 0)],
                lb, NO_POINT,
            )
            self._next_ctx = self._next_ctx._replace(last_bindings=lb)
            self._reanchor_culled_refs()
            self._maybe_compact()

        last_vo = int(flags[-1, FLAG_PATH]) == 3
        ok_col = flags[:, FLAG_OK].astype(bool)
        if not ok_col.all() and not ok_col[int(np.argmax(~ok_col)):].any():
            # Lost mid-chunk and never recovered in-scan: relocalize AT the
            # losing frame and REQUEUE the rest of the chunk so those
            # frames are re-tracked from the relocalized state instead of
            # logging up to C-1 garbage trajectory entries (the reference
            # relocalizes on the very next frame after a loss).
            j_r = int(np.argmax(~ok_col))
        elif self.state == TrackState.LOST or last_vo:
            # Lost at the chunk end (possibly after an in-scan recovery),
            # or VO dead-reckoning (mbVO parallel reloc): relocalize on the
            # last frame so the pose re-anchors at chunk cadence.
            j_r = len(buf) - 1
        else:
            j_r = -1
        if j_r >= 0 and self.database is not None:
            # Rebuilt host-side from the raw inputs — reloc is rare, one
            # extra extraction.  Like the reference (Relocalization runs
            # every frame until it succeeds, Tracking.cc:≈1290), walk
            # forward through the chunk's lost frames until one
            # relocalizes (a featureless blackout frame can't).
            ok_r = False
            while j_r < len(buf):
                frame = self._build_frame(sensor, buf[j_r])
                ok_r, T, bindings_r, n_r = self._relocalize(frame)
                if ok_r or ok_col[j_r:].any():
                    break
                j_r += 1
            if ok_r:
                # Lag-1 interplay: a NEXT chunk may already be in flight,
                # dispatched from the pre-reloc (garbage) context.  If it
                # created no keyframes (the overwhelmingly common case for
                # garbage tracking — need_kf requires ok), discard it and
                # requeue its frames after this chunk's tail so everything
                # re-tracks in order from the relocalized context.  If it
                # DID create a keyframe it recovered on its own: keep it,
                # resolve it in order, and skip the rewind (the frames
                # between loss and its recovery stay lost — exactly the
                # reference's behavior while Relocalization keeps failing).
                extra = []
                pend_recovered = False
                if self._pending_chunk is not None:
                    pf0, pbuf, pout = self._pending_chunk
                    pend_kfs = jax.device_get(pout.kf_id)
                    if (np.asarray(pend_kfs) >= 0).any():
                        pend_recovered = True
                    else:
                        self._pending_chunk = None
                        extra = list(pbuf)
                        self.frame_id -= len(pbuf)
                n_requeue = (len(buf) - 1 - j_r) if not pend_recovered else 0
                if n_requeue > 0:
                    # Rewind the garbage tail: those frames re-enter the
                    # buffer and are re-tracked from the relocalized ctx
                    # with the next dispatch (flush() covers sequence end);
                    # self.trajectory[-1] then points at frame j_r's entry
                    # for the reloc-pose update below.
                    # Known bias, accepted as noise: the discarded chunk's
                    # device-side pt_visible/pt_found updates from the
                    # garbage-tracked frames are NOT undone, so requeued
                    # frames count twice toward the found-ratio culling
                    # statistics.  Lost-context frames track few points, a
                    # double count of near-zero contributions; snapshotting
                    # the stats columns per chunk to undo them would cost
                    # more than the bias is worth.
                    del self.trajectory[-n_requeue:]
                    self.frame_id -= n_requeue
                    self.metrics["frames"] -= n_requeue
                    self.metrics["frames_lost"] -= int(
                        (~ok_col[j_r + 1:]).sum()
                    )
                    self._chunk_buf = (
                        list(buf[j_r + 1:]) + extra + self._chunk_buf
                    )
                elif extra:
                    self._chunk_buf = extra + self._chunk_buf
                self.state = TrackState.OK
                self.last_T = T
                self.n_tracked_history.append(int(n_r))
                self.metrics["relocalizations"] += 1
                self.metrics["track_path"] = "reloc"
                self._mark_reloc()
                self.trajectory[-1] = (
                    self.trajectory[-1][0],
                    np.asarray(T) @ np.linalg.inv(
                        np.asarray(self.map.kf_pose_cw[self.ref_kf])
                    ),
                    self.ref_kf,
                    False,
                )
                # Identity-velocity motion continuation from the reloc
                # bindings (see _resolve_pending): stronger than the
                # descriptor-global ref-KF fallback on ambiguous texture.
                # Skipped when the in-flight chunk recovered on its own —
                # its chained context is live and must not be clobbered.
                if not pend_recovered:
                    self._next_ctx = self._next_ctx._replace(
                        T_last=jnp.asarray(T, jnp.float32),
                        has_velocity=jnp.asarray(True),
                        velocity=jnp.eye(4, dtype=jnp.float32),
                        last_bindings=jnp.where(
                            bindings_r >= 0, bindings_r,
                            jnp.full_like(bindings_r, NO_POINT),
                        ),
                        last_xy=frame.xy,
                        last_level=frame.level,
                        last_depth=frame.depth,
                        last_desc=frame.desc,
                        last_valid=frame.valid,
                        last_angle=frame.angle,
                        ref_kf=jnp.int32(self.ref_kf),
                    )

    def _build_frame(self, sensor: str, inputs) -> Frame:
        if sensor == "mono":
            return build_mono_frame(inputs[0], self.extractor, self.cam)
        if sensor == "stereo":
            return build_stereo_frame(
                inputs[0], inputs[1], self.extractor, self.cam,
                self.scale_factors,
            )
        return build_rgbd_frame(
            inputs[0], inputs[1], self.extractor, self.cam,
            self.settings.camera.depth_map_factor,
        )

    # -- core --------------------------------------------------------------

    def _track(self, frame: Frame, timestamp: float, sensor: str):
        if self.state == TrackState.NOT_INITIALIZED:
            if sensor == "mono":
                # On success this returns the current frame DOWNSELECTED to
                # steady-state capacity (init ran at 2x features).
                frame = self._mono_initialize(frame) or frame
            else:
                self._stereo_initialize(frame)
            self._log_pose(frame)
            self._finish_frame(frame)
            return self.last_T

        # --- pose prediction + motion-model tracking ---
        ok = False
        vo_mode = False
        if self.velocity is not None:
            T_pred = self.velocity @ self.last_T
            th = 15.0 if sensor == "mono" else 7.0
            lf = self.last_frame
            use_temp = sensor != "mono" and self.localization_only
            temp_args = dict(
                last_depth=None if not use_temp else lf.depth,
                last_desc=None if not use_temp else lf.desc,
                last_valid=None if not use_temp else lf.valid,
                T_last=jnp.asarray(self.last_T, jnp.float32),
                temp_depth_cap=self._th_depth(),
                last_angle=lf.angle,
                baseline=(
                    None if sensor == "mono"
                    else jnp.float32(self.cam.bf / self.cam.fx)
                ),
            )
            T, bindings, n_in, n_match, n_tot = track_motion_model(
                self.map, frame, T_pred, self.last_frame.xy,
                self.last_bindings, self.last_frame.level, self.cam,
                self.scale_factors, self.inv_sigma2, jnp.float32(th),
                **temp_args,
            )
            if int(n_match) < 20:
                # Reference retries with a doubled window when the motion
                # model found too few matches (Tracking.cc:≈880).
                T, bindings, n_in, n_match, n_tot = track_motion_model(
                    self.map, frame, T_pred, self.last_frame.xy,
                    self.last_bindings, self.last_frame.level, self.cam,
                    self.scale_factors, self.inv_sigma2, jnp.float32(2 * th),
                    **temp_args,
                )
            ok = int(n_in) >= 10
            # Localization-only VO candidate (Tracking.cc:≈900 mbVO):
            # enough TOTAL (map + temp VO point) inliers to dead-reckon if
            # the map-anchored chain below fails.
            if self.localization_only and int(n_tot) >= 20:
                vo_mode = (T, bindings, int(n_tot))
        used_motion = ok
        if not ok:
            T, bindings, n_in, n_match = track_reference_keyframe(
                self.map, frame, jnp.int32(self.ref_kf), self.last_T,
                self.inv_sigma2, self.cam,
            )
            ok = int(n_in) >= 10

        weak = (
            len(self.n_tracked_history) == 0
            or self.n_tracked_history[-1] < 50
        )
        rmult = jnp.float32(2.0 if weak else 1.0)
        if ok:
            local_ids, local_valid = gather_local_points(
                self.map, bindings,
                n_local_kfs=self.settings.tpu.local_window,
            )
            T, bindings, n_in, self.map = track_local_map(
                self.map, frame, T, bindings, local_ids, local_valid,
                self.cam, self.scale_factors, self.inv_sigma2, rmult,
            )
            ok = int(n_in) >= 30

        if not ok and used_motion:
            # The motion-model pose can converge to a marginal local minimum
            # (accepted at >=10 inliers) that then fails TrackLocalMap; give
            # the reference-keyframe path one chance before declaring LOST
            # (the reference's backstop here is Relocalization).
            T, bindings, n_in, n_match = track_reference_keyframe(
                self.map, frame, jnp.int32(self.ref_kf), self.last_T,
                self.inv_sigma2, self.cam,
            )
            if int(n_in) >= 6:
                # Even a weak ref-KF pose is often rescued by the local-map
                # top-up (wide windows) — gate on the FINAL inlier count.
                local_ids, local_valid = gather_local_points(
                self.map, bindings,
                n_local_kfs=self.settings.tpu.local_window,
            )
                T, bindings, n_in, self.map = track_local_map(
                    self.map, frame, T, bindings, local_ids, local_valid,
                    self.cam, self.scale_factors, self.inv_sigma2,
                    jnp.float32(2.0),
                )
                ok = int(n_in) >= 30

        vo_fired = False
        if not ok and vo_mode:
            # VO-mode fallback: the map-anchored chain failed; accept the
            # motion-model dead-reckoned pose (localization-only).
            T, bindings, n_in = vo_mode
            ok = True
            used_motion = True
            vo_fired = True
        self.metrics["frames"] += 1
        self.metrics["track_path"] = (
            "vo" if vo_fired
            else "motion" if used_motion and ok
            else ("refkf" if ok else "none")
        )
        created_kf = False
        if ok:
            self.state = TrackState.OK
            T = orthonormalize_se3(T)
            if self.last_T is not None:
                self.velocity = T @ np.asarray(se3_inverse(self.last_T))
            self.last_T = T
            self.n_tracked_history.append(int(n_in))
            self.metrics["last_inliers"] = int(n_in)
            if (
                self._need_new_keyframe(frame, bindings, int(n_in), sensor)
                and self._kf_gate()
            ):
                self._create_keyframe(frame, T, bindings, sensor)
                created_kf = True
        else:
            self.state = TrackState.LOST
            self.velocity = None
            self.metrics["frames_lost"] += 1

        if (
            self.state == TrackState.LOST or vo_fired
        ) and self.database is not None:
            ok_reloc, T_r, bindings_r, n_r = self._relocalize(frame)
            if ok_reloc:
                T, bindings, n_in = T_r, bindings_r, int(n_r)
                self.state = TrackState.OK
                self.last_T = T
                self.velocity = None
                self.n_tracked_history.append(int(n_in))
                self.metrics["relocalizations"] += 1
                self.metrics["track_path"] = "reloc"
                self._mark_reloc()

        self._log_pose(frame)
        # When a keyframe was created, _create_keyframe already stored the
        # spawned+scrubbed bindings; don't overwrite them with the stale
        # pre-spawn ones.
        self._finish_frame(
            frame, bindings if (ok and not created_kf) else None
        )
        return self.last_T

    # -- initialization ----------------------------------------------------

    @staticmethod
    def _downselect_frame(frame: Frame, bindings, n_out: int):
        """Keep the n_out best slots of a 2x-capacity init frame: bound
        (triangulated) keypoints first, then by response.  Host-side — runs
        once per successful initialization."""
        bound = np.asarray(bindings) >= 0
        valid = np.asarray(frame.valid)
        resp = np.asarray(frame.response).astype(np.float64)
        rmax = float(resp.max()) + 1.0
        key = (
            bound.astype(np.float64) * (2.0 * rmax)
            + np.where(valid, resp, -rmax)
        )
        sel = np.argsort(-key, kind="stable")[:n_out]
        new_frame = Frame(*[jnp.asarray(np.asarray(a)[sel]) for a in frame])
        return new_frame, jnp.asarray(np.asarray(bindings)[sel])

    def _mono_initialize(self, frame: Frame) -> Optional[Frame]:
        min_m = self.settings.tpu.min_init_matches
        if self.init_ref is None or int(frame.valid.sum()) <= min_m:
            if int(frame.valid.sum()) > min_m:
                self.init_ref = frame
            return None
        mres = matcher.search_for_initialization(
            self.init_ref.features, frame.features
        )
        n_matches = int(mres.ok.sum())
        if n_matches < min_m:
            self.init_ref = frame  # reference's re-seeding behavior
            return None
        self.init_key, sub = jax.random.split(self.init_key)
        xy1 = self.init_ref.xy
        xy2 = frame.xy[mres.idx]
        res = twoview.initialize_two_view(
            xy1, xy2, mres.ok, self.cam.K, sub
        )
        if not bool(res.success):
            return None

        # Scale by inverse median scene depth (CreateInitialMapMonocular,
        # Tracking.cc:≈640: median depth -> 1).
        good = np.asarray(res.good)
        pts = np.asarray(res.points)
        med_depth = float(np.median(pts[good][:, 2]))
        scale = 1.0 / max(med_depth, 1e-6)
        pts_scaled = jnp.asarray(pts * scale)
        T21 = np.array(res.T21)  # writable copy
        T21[:3, 3] *= scale
        T21 = jnp.asarray(T21)

        # KF0 at identity with ref frame; KF1 at T21 with current frame.
        m = self.map
        desc0 = self.init_ref.desc
        m, pids = add_points(
            m, pts_scaled, desc0, jnp.asarray(good), jnp.int32(0),
            reverse=True,
        )
        # Bindings: slot i of ref frame -> pids[i]; matched slot of cur.
        bind0 = jnp.where(jnp.asarray(good), pids, NO_POINT)
        bind1 = jnp.full(frame.xy.shape[0], NO_POINT, jnp.int32)
        tgt = np.asarray(mres.idx)
        okm = np.asarray(mres.ok) & good
        bind1 = bind1.at[jnp.asarray(tgt)].set(
            jnp.where(jnp.asarray(okm), pids, NO_POINT), mode="drop"
        )
        # Init ran at 2x features (mpIniORBextractor); keyframes and the
        # steady-state tracking programs use capacity N — keep triangulated
        # slots first, then strongest responses.
        N = self.settings.tpu.max_keypoints
        ref_n, bind0_n = self._downselect_frame(self.init_ref, bind0, N)
        cur_n, bind1_n = self._downselect_frame(frame, bind1, N)
        m, kf0 = insert_keyframe(
            m, ref_n, jnp.eye(4), jnp.int32(self.frame_id - 1),
            bind0_n, jnp.int32(-1),
        )
        m, kf1 = insert_keyframe(
            m, cur_n, T21, jnp.int32(self.frame_id), bind1_n, jnp.int32(0)
        )
        m = ms.update_point_stats(m, self.scale_factors)
        self.map = m
        if self.database is not None:
            self.database.add_keyframe(int(kf0), ref_n.desc, ref_n.valid)
            self.database.add_keyframe(int(kf1), cur_n.desc, cur_n.valid)
        self.ref_kf = int(kf1)
        self.last_T = T21
        self.last_bindings = bind1_n
        self.velocity = None
        self.state = TrackState.OK
        self.last_kf_frame_id = self.frame_id
        if self.local_mapper is not None:
            self.map = self.local_mapper.on_initial_map(self.map)
        return cur_n

    def _stereo_initialize(self, frame: Frame):
        # Reference gate: initialize when the frame carries > 500 features
        # (Tracking.cc:≈500, StereoInitialization's N>500).  At production
        # feature budgets (>= 1000) that gate applies verbatim; fixture
        # configs with < 500-feature capacity scale it to half the capacity
        # so the tests' 96x128 frames can still initialize.
        cap = int(frame.valid.shape[0])
        gate = 500 if cap >= 1000 else max(20, cap // 2)
        n_depth = int(((frame.depth > 0) & frame.valid).sum())
        if n_depth < gate and int(frame.valid.sum()) < gate:
            return
        T0 = jnp.eye(4)
        pos_w, ok = unproject_frame_depth(frame, T0, self.cam)
        m, pids = add_points(self.map, pos_w, frame.desc, ok, jnp.int32(0),
                             reverse=True)
        bind = jnp.where(ok, pids, NO_POINT)
        m, kf0 = insert_keyframe(
            m, frame, T0, jnp.int32(self.frame_id), bind, jnp.int32(-1)
        )
        m = ms.update_point_stats(m, self.scale_factors)
        self.map = m
        if self.database is not None:
            self.database.add_keyframe(int(kf0), frame.desc, frame.valid)
        self.ref_kf = int(kf0)
        self.last_T = T0
        self.last_bindings = bind
        self.state = TrackState.OK
        self.last_kf_frame_id = self.frame_id

    # -- keyframe policy ---------------------------------------------------

    def _need_new_keyframe(
        self, frame: Frame, bindings, n_inliers: int, sensor: str
    ) -> bool:
        """Tracking::NeedNewKeyFrame (Tracking.cc:≈980): reference-keyframe
        match ratio (min-obs-3 reference matches) + max frame gap +
        close-point starvation (stereo/RGB-D) + post-relocalization
        suppression.  The mapper-idle / queue-length conditions live in
        _kf_gate (SetAcceptKeyFrames / InterruptBA / bounded urgent
        adopt)."""
        if self.localization_only:  # mbOnlyTracking: never insert
            return False
        if int(self.map.n_kf) >= self.map.kf_capacity - 1:
            return False
        if self.frame_id < self._no_kf_before:
            return False
        frames_since = self.frame_id - self.last_kf_frame_id
        n_kf_now = int(self.map.n_kf)
        # Bootstrap exception for n_kf == 1 — see track_fused.py's policy
        # block: with one keyframe every point has one observer and
        # nMinObs=2 freezes the map.
        min_obs = 3 if n_kf_now > 2 else (2 if n_kf_now > 1 else 1)
        obs_counts = ms.point_observation_counts(self.map)
        ref_pid = self.map.kf_point[self.ref_kf]
        ref_bound = (ref_pid >= 0) & self.map.kf_kp_valid[self.ref_kf]
        kf_tracked = int(
            (
                ref_bound
                & (obs_counts[jnp.maximum(ref_pid, 0)] >= min_obs)
            ).sum()
        )
        # Reference-exact (c1a||c1b||c1c)&&c2 — see _fused_track's policy
        # block (track_fused.py) for the rationale and the deterministic
        # mapper-occupancy model behind c1b.
        ratio_th = 0.9 if sensor == "mono" else 0.75
        close_starved = False
        if sensor != "mono":
            n_close_tracked = int(
                ((frame.depth > 0) & (frame.depth < self._th_depth())
                 & (bindings >= 0)).sum()
            )
            n_close_total = int(
                ((frame.depth > 0) & (frame.depth < self._th_depth())
                 & frame.valid).sum()
            )
            close_starved = (n_close_tracked < 100 and n_close_total > 70)
        c1a = frames_since >= self.settings.tpu.kf_max_gap
        c1b = frames_since >= self.settings.tpu.kf_busy_frames
        c1c = sensor != "mono" and (
            n_inliers < 0.25 * kf_tracked or close_starved
        )
        c2 = (
            (n_inliers < ratio_th * kf_tracked or close_starved)
            and n_inliers > 15
        )
        need = (c1a or c1b or c1c) and c2
        return need and frames_since >= 1

    def _mark_reloc(self):
        """Suppress keyframe insertion for MaxFrames(=10 frames here) after
        a relocalization on a mature map (Tracking.cc:≈990: `mnId <
        mnLastRelocFrameId + mMaxFrames && nKFs > mMaxFrames` → no
        insertion) — right after reloc the pose is anchored to OLD
        keyframes and inserting immediately duplicates them."""
        n_kf = (
            self._host_n_kf if self._host_n_kf is not None
            else int(jax.device_get(self.map.n_kf))
        )
        if n_kf > 10:
            self._no_kf_before = self.frame_id + 10

    def _relocalize(self, frame: Frame):
        """Tracking::Relocalization (Tracking.cc:≈1310): BoW candidates ->
        PnP RANSAC -> pose polish -> local-map top-up; accept at the local
        inlier gate."""
        cands = self.database.detect_relocalization_candidates(
            self.map, frame.desc, frame.valid
        )
        frame_nodes = (
            self.database.frame_nodes(frame.desc, frame.valid)
            if len(cands) else None
        )
        retries_left = 3
        for c in cands:
            self.init_key, sub = jax.random.split(self.init_key)
            kf_nodes = self.database.nodes_for(int(c))
            T, bindings, n_in, n_match, pnp_ok = relocalize_candidate(
                self.map, frame, jnp.int32(int(c)), self.inv_sigma2,
                self.cam, sub,
                kf_nodes=kf_nodes, frame_nodes=frame_nodes,
            )
            if (not bool(pnp_ok) or int(n_in) < 10) and (
                int(n_match) >= 8 and retries_left > 0
            ):
                # Second chance with a looser ratio, no node gate, and more
                # PnP hypotheses — the analog of the reference's widening
                # SearchByProjection retry (Tracking.cc:≈1370): when the
                # vocabulary is weak or the texture ambiguous, the 0.75
                # ratio starves RANSAC below its minimal-sample odds.
                # Retried only when the first pass found a plausible match
                # count, and at most 3x per relocalization call: 8 wide-
                # ratio 8192-hypothesis retries per lost frame was a large
                # wall-clock hit on textured-but-unmappable frames.
                retries_left -= 1
                self.init_key, sub = jax.random.split(self.init_key)
                T, bindings, n_in, n_match, pnp_ok = relocalize_candidate(
                    self.map, frame, jnp.int32(int(c)), self.inv_sigma2,
                    self.cam, sub, ratio=0.9, pnp_iters=8192,
                )
            if not bool(pnp_ok) or int(n_in) < 10:
                continue
            local_ids, local_valid = gather_local_points(
                self.map, bindings,
                n_local_kfs=self.settings.tpu.local_window,
            )
            T, bindings, n_in, self.map = track_local_map(
                self.map, frame, T, bindings, local_ids, local_valid,
                self.cam, self.scale_factors, self.inv_sigma2,
            )
            if int(n_in) >= 30:
                self.ref_kf = int(c)
                self.last_bindings = bindings
                return True, T, bindings, int(n_in)
        return False, None, None, 0

    def _th_depth(self) -> float:
        c = self.settings.camera
        return c.th_depth * c.bf / c.fx if c.bf > 0 else 1e9

    def _create_keyframe(self, frame: Frame, T, bindings, sensor: str,
                         frame_id: Optional[int] = None):
        fid = self.frame_id if frame_id is None else frame_id
        m = self.map
        if sensor != "mono":
            # Spawn close-depth points for unbound keypoints (Tracking.cc:≈1060).
            pos_w, ok = unproject_frame_depth(frame, T, self.cam)
            ok = ok & (bindings < 0) & (frame.depth < self._th_depth())
            m, pids = add_points(m, pos_w, frame.desc, ok, m.n_kf,
                                 reverse=True)
            bindings = jnp.where(ok & (pids >= 0), pids, bindings)
        m, kf_id = insert_keyframe(
            m, frame, T, jnp.int32(fid), bindings,
            jnp.int32(self.ref_kf),
        )
        m = ms.update_point_stats(m, self.scale_factors)
        self.map = m
        self.metrics["keyframes_created"] += 1
        self.ref_kf = int(kf_id)
        self.last_kf_frame_id = fid
        self.last_bindings = bindings
        if self.database is not None:
            self.database.add_keyframe(int(kf_id), frame.desc, frame.valid)
        if self.mapping_pipeline is not None:
            # Async hand-off (the reference's LocalMapping queue): tracking
            # keeps ITS map (already containing the new keyframe); mapping
            # + loop closing run on a snapshot in the worker and are
            # adopted at a later frame boundary (_poll_adopt).
            self._kf_queue.append(int(kf_id))
            self._submit_next_kf()
            return
        if self.local_mapper is not None:
            self.map = self.local_mapper.process_keyframe(self.map, int(kf_id))
        if self.loop_closer is not None:
            self.map = self.loop_closer.process_keyframe(self.map, int(kf_id))
        # Mapping may have culled points whose slots can be reused; scrub
        # the host-held bindings so they can't re-attach to reused slots.
        self.last_bindings = jnp.where(
            self.map.pt_valid[jnp.maximum(self.last_bindings, 0)]
            & (self.last_bindings >= 0),
            self.last_bindings, NO_POINT,
        )
        if self.local_mapper is not None:
            self._reanchor_culled_refs()
        self._maybe_compact()

    # -- async mapping adoption ----------------------------------------------

    def _kf_gate(self) -> bool:
        """May a keyframe be created right now?  True when no async job is
        in flight; on an urgent gap, adopt the in-flight job with a BOUNDED
        wait (InterruptBA) and return True — a job that overruns the grace
        period only defers the keyframe, never stalls tracking."""
        mp = self.mapping_pipeline
        if mp is None or len(self._kf_queue) < self.kf_queue_depth:
            return True
        if self.frame_id - self.last_kf_frame_id >= self.kf_urgent_gap:
            res = mp.wait(timeout=self.kf_urgent_wait_s)
            if res is not None:
                self._adopt(res)
            if len(self._kf_queue) < self.kf_queue_depth:
                return True
        return False  # deferred: SetAcceptKeyFrames(false)

    def _poll_adopt(self):
        if self.mapping_pipeline is not None:
            self._adopt(self.mapping_pipeline.poll())

    def _adopt(self, result):
        """Adopt an async mapping/loop result: merge tracking-side stats,
        re-anchor the tracker pose through the reference keyframe (the
        reference's UpdateLastFrame pose refresh, Tracking.cc:≈810), scrub
        bindings against the post-mapping point pool."""
        if result is None:
            return
        from .async_pipeline import adopt_mapped_state

        mapped, snapshot, job_kf, pool_state = result
        new_map = adopt_mapped_state(
            mapped, snapshot, self.map, jnp.int32(job_kf)
        )
        # World re-anchor: T_cw_new = T_cw_old * T_rw_old^-1 * T_rw_new
        # through the JOB's keyframe — guaranteed to exist in the snapshot
        # (the tracker's current ref_kf may post-date it now that
        # insertion doesn't wait for the worker).  Velocity is invariant
        # to this right-multiplication.  Computed ON DEVICE — adoption
        # itself performs NO host sync: the pool state its maintenance
        # needs rides the loop-detection readback the worker already paid
        # (pool_state), falling back to the last chunk readback's copy.
        ref = jnp.int32(job_kf)
        R = jnp.where(
            new_map.kf_valid[ref],
            se3_inverse(snapshot.kf_pose_cw[ref]) @ new_map.kf_pose_cw[ref],
            jnp.eye(4, dtype=jnp.float32),
        )
        self.map = new_map
        self.last_T = jnp.asarray(self.last_T, jnp.float32) @ R
        if self.last_bindings is not None:
            self.last_bindings = jnp.where(
                (self.last_bindings >= 0)
                & self.map.pt_valid[jnp.maximum(self.last_bindings, 0)],
                self.last_bindings, NO_POINT,
            )
        if self._next_ctx is not None:
            lb = self._next_ctx.last_bindings
            lb = jnp.where(
                (lb >= 0) & self.map.pt_valid[jnp.maximum(lb, 0)],
                lb, NO_POINT,
            )
            self._next_ctx = self._next_ctx._replace(
                last_bindings=lb,
                T_last=self._next_ctx.T_last @ R,
            )
        if pool_state is not None:
            kf_valid_np, n_kf = pool_state
        elif self._host_kf_valid is not None:
            # Chunk-readback copy: at most one chunk stale, which is safe —
            # keyframe slots are only reused at compaction, and compaction
            # re-fetches (it block-adopts + reads exactly).
            kf_valid_np, n_kf = self._host_kf_valid, self._host_n_kf
        else:
            kf_valid_np, n_kf = jax.device_get(
                (self.map.kf_valid, self.map.n_kf)
            )
            n_kf = int(n_kf)
        self._reanchor_culled_refs(kf_valid=kf_valid_np)
        self._maybe_compact(n_kf=n_kf)
        self._submit_next_kf()

    def _submit_next_kf(self):
        """Dispatch the oldest queued keyframe to the mapping worker (the
        LocalMapping thread popping mlNewKeyFrames)."""
        mp = self.mapping_pipeline
        if getattr(self, "_no_submit", False):
            return  # compaction drain in progress: ids about to be remapped
        if mp is not None and self._kf_queue and mp.accept_keyframes():
            kid = self._kf_queue.pop(0)
            mp.submit(self.map, kid)

    # -- keyframe-pool maintenance ------------------------------------------

    def _reanchor_culled_refs(self, kf_valid=None):
        """Re-anchor trajectory entries whose reference keyframe was culled
        to its nearest valid ancestor — the reference replays bad keyframes
        through their spanning-tree parents at save time
        (System::SaveTrajectoryTUM, System.cc:≈270).  We do it eagerly while
        the culled pose is still consistent with the live map, so later
        loop/BA corrections reach these frames through the ancestor.

        ``kf_valid``: host copy of map.kf_valid when the caller already
        fetched one (adoption batches it) — saves a host sync."""
        if kf_valid is None:
            kf_valid = np.asarray(self.map.kf_valid)
        refs = np.array([e[2] for e in self.trajectory], np.int64)
        if refs.size == 0:
            return
        bad = np.unique(refs[(refs >= 0) & ~kf_valid[np.maximum(refs, 0)]])
        if bad.size == 0:
            return
        poses, parent = jax.device_get(
            (self.map.kf_pose_cw, self.map.kf_parent)
        )
        anc = {}
        for r in bad.tolist():
            a = r
            for _ in range(64):
                a = int(parent[a]) if a >= 0 else -1
                if a < 0 or kf_valid[a]:
                    break
            if a < 0 or not kf_valid[a]:
                a = 0  # root keyframe is never culled
            # T_c<-anc = T_c<-r @ T_r<-w @ T_w<-anc
            anc[r] = (a, poses[r] @ np.linalg.inv(poses[a]))
        self.trajectory = [
            (fid, np.asarray(T_cr) @ anc[ref][1], anc[ref][0], lost)
            if ref in anc else (fid, T_cr, ref, lost)
            for fid, T_cr, ref, lost in self.trajectory
        ]

    def _maybe_compact(self, n_kf=None):
        """Compact the keyframe pool when it nears capacity (culled slots
        are reclaimed; every id reference host and device side is remapped).
        No-op while the pool has headroom or when nothing was culled.

        ``n_kf``: host copy of map.n_kf when the caller already fetched one
        (adoption batches it) — saves a host sync."""
        cap = self.map.kf_capacity
        if n_kf is None:
            n_kf = int(self.map.n_kf)
        if n_kf < cap - 4:
            return
        if self._pending_chunk is not None:
            # Compaction renumbers keyframe slots; the in-flight chunk's
            # unread outputs (created-KF ids, trajectory refs) use the old
            # numbering — resolve it first.  Rare (pool-full events only).
            # Mid-resolution (re-entrant via _adopt) this defers instead:
            # resolving the newer chunk out of order would scramble the
            # trajectory, and the cap-4 margin covers one cycle of delay.
            if getattr(self, "_resolving", False):
                return
            pc, self._pending_chunk = self._pending_chunk, None
            self._resolve_chunk(getattr(self, "_fused_sensor", "mono"), *pc)
            return self._maybe_compact()  # re-check with post-resolve state
        if (
            self.mapping_pipeline is not None
            and not self.mapping_pipeline.accept_keyframes()
        ):
            # Compaction remaps keyframe ids; an in-flight mapping job holds
            # a pre-compaction snapshot — adopt it first, WITHOUT letting
            # adoption dispatch the next queued job (its snapshot would be
            # pre-compaction and its id is about to be remapped).
            self._no_submit = True
            try:
                self._adopt(self.mapping_pipeline.wait())
            finally:
                self._no_submit = False
        self._reanchor_culled_refs()
        m2, kf_map = ms.compact_map(self.map)
        if int(m2.n_kf) >= int(self.map.n_kf):
            self._submit_next_kf()  # keep the worker fed
            return  # nothing reclaimed; pool genuinely full
        self.map = m2

        def r(k):
            return int(kf_map[k]) if k >= 0 else -1

        self.ref_kf = max(r(self.ref_kf), 0)
        # Queued-but-unmapped keyframes survive compaction (they are valid
        # rows); remap their ids, dropping any the compactor culled.
        self._kf_queue = [r(k) for k in self._kf_queue if r(k) >= 0]
        self.metrics["compactions"] = self.metrics.get("compactions", 0) + 1
        self.trajectory = [
            (fid, T_cr, max(r(ref), 0), lost)
            for fid, T_cr, ref, lost in self.trajectory
        ]
        if self.last_bindings is not None:
            # Point ids are untouched by keyframe compaction.
            pass
        if self._next_ctx is not None:
            self._next_ctx = self._next_ctx._replace(
                ref_kf=jnp.int32(self.ref_kf)
            )
        if self.database is not None:
            self.database.remap(kf_map)
        if self.loop_closer is not None:
            self.loop_closer.remap(kf_map)
        # Restart the worker on the post-compaction map/ids.
        self._submit_next_kf()

    # -- bookkeeping -------------------------------------------------------

    def _log_pose(self, frame: Frame):
        # Store the RELATIVE pose to the reference keyframe (the reference's
        # mlRelativeFramePoses, Tracking.cc:≈480): the absolute trajectory
        # is replayed against the CURRENT (loop-corrected) keyframe poses
        # at export time, so corrections reach every frame.
        T_rw = np.asarray(self.map.kf_pose_cw[self.ref_kf])
        T_cr = np.asarray(self.last_T) @ np.linalg.inv(T_rw)
        self.trajectory.append(
            (
                self.frame_id,
                T_cr,
                self.ref_kf,
                self.state != TrackState.OK,
            )
        )

    def _finish_frame(self, frame: Frame, bindings=None):
        self.last_frame = frame
        if bindings is not None:
            self.last_bindings = bindings
        elif self.last_bindings is None:
            self.last_bindings = jnp.full(
                frame.xy.shape[0], NO_POINT, jnp.int32
            )
        self.frame_id += 1

    # -- outputs -----------------------------------------------------------

    def poses_wc(self) -> np.ndarray:
        """(F, 4, 4) camera-to-world trajectory, replayed against the
        current (loop-corrected) keyframe poses (System::SaveTrajectory*'s
        Tcr * Trw reconstruction)."""
        self.flush()
        kf_poses = np.asarray(self.map.kf_pose_cw)
        out = []
        for _, T_cr, ref, _ in self.trajectory:
            T_cw = np.asarray(T_cr) @ kf_poses[ref]
            out.append(np.linalg.inv(T_cw))
        return np.stack(out)


# ---------------------------------------------------------------------------
# Relocalization (Tracking::Relocalization, src/Tracking.cc:≈1310)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("ratio", "pnp_iters"))
def relocalize_candidate(
    m: ms.MapState,
    frame: Frame,
    kf_id: jnp.ndarray,
    inv_sigma2_lut: jnp.ndarray,
    cam: CameraModel,
    key: jnp.ndarray,
    kf_nodes: Optional[jnp.ndarray] = None,
    frame_nodes: Optional[jnp.ndarray] = None,
    ratio: float = 0.75,
    pnp_iters: int = 2048,
):
    """One relocalization attempt against a candidate keyframe: match the
    frame's descriptors to the keyframe's bound map points (node-gated
    SearchByBoW when vocabulary node ids are provided — candidate pairs
    restricted to the same DBoW2 FeatureVector node, ORBmatcher.cc:≈250),
    batched PnP RANSAC, then the shared LM pose polish.

    ``pnp_iters`` is deliberately large: global (non-windowed) descriptor
    matching can run at 20-30% precision on ambiguous texture and the
    minimal sample needs inlier_rate^4 luck per hypothesis — batched
    hypotheses are nearly free on the device, so buy the robustness.  The
    hypothesis solver is P3P+1 (planar-safe, like the reference's EPnP —
    PnPsolver.cc; the 6-point DLT degenerates on wall-dominated scenes)."""
    from ..ops.pnp import p3p_ransac

    kf_pts = m.kf_point[kf_id]
    kf_has = (kf_pts >= 0) & m.kf_kp_valid[kf_id]
    pid = jnp.where(kf_has, kf_pts, 0)
    src_ok = kf_has & m.pt_valid[pid]
    pair_mask = None
    if kf_nodes is not None and frame_nodes is not None:
        pair_mask = (
            (kf_nodes[:, None] == frame_nodes[None, :])
            & (kf_nodes[:, None] >= 0)
        )
    mres = match_descriptors(
        m.kf_desc[kf_id], src_ok, frame.desc, frame.valid,
        pair_mask=pair_mask, max_dist=TH_LOW, ratio=ratio, cross_check=True,
    )
    # 2D-3D correspondences: frame keypoint <- map point.
    bindings = ms.scatter_slots(
        frame.xy.shape[0], mres.idx, pid.astype(jnp.int32), mres.ok
    )
    bound = bindings >= 0
    bpid = jnp.where(bound, bindings, 0)
    inv_s2 = inv_sigma2_lut[jnp.clip(frame.level, 0, inv_sigma2_lut.shape[0] - 1)]
    pres = p3p_ransac(
        frame.xy, m.pt_pos[bpid], bound & frame.valid & m.pt_valid[bpid],
        inv_s2, cam, key, iters=pnp_iters,
    )
    obs = _pose_obs_from_bindings(m, frame, bindings, inv_sigma2_lut)
    res = pose_optimization(pres.T_cw, obs, cam)
    bindings = jnp.where(res.inlier, bindings, NO_POINT)
    n_matches = jnp.sum(obs.valid)
    return res.T_cw, bindings, res.n_inliers, n_matches, pres.ok
