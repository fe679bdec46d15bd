"""The map as functional struct-of-arrays state.

JAX replacement for the reference's pointer-graph data model
(``Map``/``KeyFrame``/``MapPoint``, src/Map.cc, src/KeyFrame.cc,
src/MapPoint.cc — SURVEY.md §2.1 L2): fixed-capacity pools with validity
masks instead of heap objects, pure-function updates instead of per-object
mutexes (SURVEY.md §2.5 P6 'eliminated').

Key design points:
* Observations are stored ONLY forward (keyframe slot -> point id), the
  transpose of the reference's MapPoint::mObservations.  Everything the
  reference derives from the backward index (covisibility weights,
  distinctive descriptors, normals, local-BA incidence) is recomputed on
  device from the forward index with segment ops / one matmul — cheap,
  and immune to index-inconsistency bugs.
* Covisibility = B^T B where B[p, k] = point p observed by keyframe k:
  the covisibility graph of KeyFrame::UpdateConnections (KeyFrame.cc:≈210)
  as a single matmul.
* Keyframe ids are monotonic pool slots; culled entries are masked invalid
  (the pool is sized for the sequence; compaction is a host-side op).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NO_POINT = -1


class MapState(NamedTuple):
    # --- keyframes (capacity K, feature capacity N) ---
    kf_pose_cw: jnp.ndarray   # (K, 4, 4) world->camera
    kf_xy: jnp.ndarray        # (K, N, 2) undistorted level-0 keypoint coords
    kf_level: jnp.ndarray     # (K, N) octave
    kf_angle: jnp.ndarray     # (K, N)
    kf_desc: jnp.ndarray      # (K, N, 8) uint32
    kf_ur: jnp.ndarray        # (K, N) stereo right-u; <0 = mono
    kf_kp_valid: jnp.ndarray  # (K, N)
    kf_point: jnp.ndarray     # (K, N) int32 map-point id per slot; -1 = none
    kf_valid: jnp.ndarray     # (K,)
    kf_frame_id: jnp.ndarray  # (K,) source frame index (for trajectory)
    kf_parent: jnp.ndarray    # (K,) spanning-tree parent (-1 root)
    # --- map points (capacity P) ---
    pt_pos: jnp.ndarray       # (P, 3)
    pt_normal: jnp.ndarray    # (P, 3) mean viewing direction
    pt_desc: jnp.ndarray      # (P, 8) uint32 distinctive descriptor
    pt_min_dist: jnp.ndarray  # (P,) scale-invariance band
    pt_max_dist: jnp.ndarray  # (P,)
    pt_ref_kf: jnp.ndarray    # (P,) reference keyframe id
    pt_first_kf: jnp.ndarray  # (P,) keyframe id at creation (culling window)
    pt_valid: jnp.ndarray     # (P,)
    pt_visible: jnp.ndarray   # (P,) int32 tracking statistics
    pt_found: jnp.ndarray     # (P,) int32
    # --- counters (device scalars so jitted updates stay fixed-shape) ---
    n_kf: jnp.ndarray         # int32 next keyframe slot
    n_pt: jnp.ndarray         # int32 next point slot

    @property
    def kf_capacity(self) -> int:
        return self.kf_pose_cw.shape[0]

    @property
    def pt_capacity(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def feat_capacity(self) -> int:
        return self.kf_xy.shape[1]


def make_empty_map(kf_capacity: int, pt_capacity: int, feat_capacity: int) -> MapState:
    K, P, N = kf_capacity, pt_capacity, feat_capacity
    return MapState(
        kf_pose_cw=jnp.tile(jnp.eye(4, dtype=jnp.float32), (K, 1, 1)),
        kf_xy=jnp.zeros((K, N, 2), jnp.float32),
        kf_level=jnp.zeros((K, N), jnp.int32),
        kf_angle=jnp.zeros((K, N), jnp.float32),
        kf_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_ur=jnp.full((K, N), -1.0, jnp.float32),
        kf_kp_valid=jnp.zeros((K, N), bool),
        kf_point=jnp.full((K, N), NO_POINT, jnp.int32),
        kf_valid=jnp.zeros((K,), bool),
        kf_frame_id=jnp.zeros((K,), jnp.int32),
        kf_parent=jnp.full((K,), -1, jnp.int32),
        pt_pos=jnp.zeros((P, 3), jnp.float32),
        pt_normal=jnp.zeros((P, 3), jnp.float32),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_min_dist=jnp.zeros((P,), jnp.float32),
        pt_max_dist=jnp.full((P,), 1e9, jnp.float32),
        pt_ref_kf=jnp.zeros((P,), jnp.int32),
        pt_first_kf=jnp.zeros((P,), jnp.int32),
        pt_valid=jnp.zeros((P,), bool),
        pt_visible=jnp.ones((P,), jnp.int32),
        pt_found=jnp.ones((P,), jnp.int32),
        n_kf=jnp.int32(0),
        n_pt=jnp.int32(0),
    )


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------


def _valid_obs(m: MapState):
    """(K, N) validity + point ids of the forward observation index."""
    pts = m.kf_point
    ok = (
        (pts >= 0)
        & m.kf_kp_valid
        & m.kf_valid[:, None]
        & (pts < m.pt_capacity)
    )
    ok = ok & m.pt_valid[jnp.where(ok, pts, 0)]
    return ok, pts


@jax.jit
def observation_matrix(m: MapState) -> jnp.ndarray:
    """B (P, K) float32: B[p, k] = 1 iff point p is bound to a valid keypoint
    of valid keyframe k.  One scatter over the forward index.

    NOTE: O(P*K) memory — loop-rate consumers only.  Per-frame code paths
    use the segment-op helpers below (points_seen_by / covisible_row /
    point_observation_counts), which never materialize (P, K)."""
    K, N = m.kf_point.shape
    P = m.pt_capacity
    kf_ids = jax.lax.broadcasted_iota(jnp.int32, (K, N), 0)
    ok, pts = _valid_obs(m)
    pts_safe = jnp.where(ok, pts, 0)
    B = jnp.zeros((P, K), jnp.float32)
    B = B.at[pts_safe.reshape(-1), kf_ids.reshape(-1)].add(
        ok.reshape(-1).astype(jnp.float32)
    )
    return jnp.minimum(B, 1.0)


@jax.jit
def points_seen_by(m: MapState, kf_mask: jnp.ndarray) -> jnp.ndarray:
    """(P,) bool: points observed by any keyframe in ``kf_mask`` (K,) —
    one scatter over the forward index, no (P, K) intermediate."""
    ok, pts = _valid_obs(m)
    ok = ok & kf_mask[:, None]
    idx = jnp.where(ok, pts, m.pt_capacity)
    seen = jnp.zeros((m.pt_capacity,), jnp.int32).at[idx.reshape(-1)].max(
        jnp.ones_like(idx.reshape(-1)), mode="drop"
    )
    return seen > 0


@jax.jit
def covisible_row(m: MapState, kf_id: jnp.ndarray) -> jnp.ndarray:
    """(K,) int32: shared-point counts of ``kf_id`` vs every keyframe — one
    row of the covisibility matrix (KeyFrame::GetCovisiblesByWeight) via a
    point-membership scatter + a (K, N) gather.  O(P + K*N), no (P, K)."""
    row_pts = m.kf_point[kf_id]
    ok_row = (
        (row_pts >= 0) & m.kf_kp_valid[kf_id] & m.kf_valid[kf_id]
        & m.pt_valid[jnp.maximum(row_pts, 0)]
    )
    idx = jnp.where(ok_row, row_pts, m.pt_capacity)
    member = jnp.zeros((m.pt_capacity,), jnp.int32).at[idx].max(
        jnp.ones_like(idx), mode="drop"
    ) > 0
    ok, pts = _valid_obs(m)
    hit = member[jnp.where(ok, pts, 0)] & ok
    w = jnp.sum(hit, axis=1).astype(jnp.int32)
    return w.at[kf_id].set(0)


@functools.partial(jax.jit, static_argnames=("chunk",))
def covisibility(m: MapState, chunk: int = 16384) -> jnp.ndarray:
    """(K, K) int32 covisibility weights (shared-point counts, diag zeroed).

    The whole covisibility graph (KeyFrame::UpdateConnections) as
    matmuls over POINT CHUNKS: W = sum_c B_c^T B_c with B_c (chunk, K)
    scattered from the forward index — O(chunk*K) memory instead of the
    full (P, K).  Loop-rate consumers only (pose graph, loop grouping);
    per-frame paths use covisible_row / points_seen_by."""
    K, N = m.kf_point.shape
    P = m.pt_capacity
    CH = min(chunk, P)
    n_chunks = -(-P // CH)
    ok, pts = _valid_obs(m)
    kf_ids = jax.lax.broadcasted_iota(jnp.int32, (K, N), 0).reshape(-1)
    pts_flat = jnp.where(ok, pts, P).reshape(-1)

    def body(W, c):
        start = c * CH
        local = pts_flat - start
        in_ch = (local >= 0) & (local < CH)
        li = jnp.where(in_ch, local, CH)
        B = jnp.zeros((CH + 1, K), jnp.float32).at[li, kf_ids].add(
            in_ch.astype(jnp.float32)
        )
        B = jnp.minimum(B[:CH], 1.0)
        return W + B.T @ B, None

    W, _ = jax.lax.scan(
        body, jnp.zeros((K, K), jnp.float32), jnp.arange(n_chunks)
    )
    W = W * (1.0 - jnp.eye(K))
    return W.astype(jnp.int32)


@jax.jit
def point_observation_counts(m: MapState) -> jnp.ndarray:
    """(P,) number of keyframes observing each point — one scatter-add."""
    ok, pts = _valid_obs(m)
    idx = jnp.where(ok, pts, m.pt_capacity)
    counts = jnp.zeros((m.pt_capacity,), jnp.int32).at[idx.reshape(-1)].add(
        1, mode="drop"
    )
    return counts


@functools.partial(jax.jit, static_argnames=("n_best",))
def best_covisible(m: MapState, kf_id: jnp.ndarray, n_best: int = 10):
    """Ids + weights of the top-n covisible keyframes of ``kf_id``
    (KeyFrame::GetBestCovisibilityKeyFrames, src/KeyFrame.cc:≈185)."""
    row = covisible_row(m, kf_id)
    w, ids = jax.lax.top_k(row, n_best)
    return ids.astype(jnp.int32), w


@jax.jit
def update_point_stats(m: MapState, scale_factors: jnp.ndarray = None) -> MapState:
    """Recompute distinctive descriptors, normals and scale bands for all
    valid points from the forward index — the batch equivalent of
    MapPoint::ComputeDistinctiveDescriptors (MapPoint.cc:≈260) and
    MapPoint::UpdateNormalAndDepth (MapPoint.cc:≈320).

    Distinctive-descriptor note: the reference picks the observation
    descriptor minimizing median Hamming distance to the others; computing
    that exactly needs the per-point observation lists.  We use the
    reference-keyframe observation's descriptor instead (the point's
    creation descriptor), updated to the LATEST observing keyframe's
    descriptor — cheap, and matching quality is gated by tests.
    """
    K, N = m.kf_point.shape
    P = m.pt_capacity

    ok = (m.kf_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pts_safe = jnp.where(ok, m.kf_point, 0)
    flat_pts = pts_safe.reshape(-1)
    okf = ok.reshape(-1)

    # Mean viewing direction: sum over observations of normalized (X - O_k).
    cam_centers = -jnp.einsum(
        "kij,ki->kj", m.kf_pose_cw[:, :3, :3].transpose(0, 2, 1), m.kf_pose_cw[:, :3, 3]
    )  # (K, 3) camera centers in world
    kf_ids = jax.lax.broadcasted_iota(jnp.int32, (K, N), 0).reshape(-1)
    vec = m.pt_pos[flat_pts] - cam_centers[kf_ids]
    vec = vec / jnp.maximum(jnp.linalg.norm(vec, axis=-1, keepdims=True), 1e-9)
    normal_sum = jnp.zeros((P, 3), jnp.float32).at[flat_pts].add(
        vec * okf[:, None]
    )
    n_obs = jnp.zeros((P,), jnp.float32).at[flat_pts].add(okf.astype(jnp.float32))
    normal = normal_sum / jnp.maximum(n_obs[:, None], 1.0)
    normal = normal / jnp.maximum(jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)

    # Scale band from the reference keyframe's observation distance + octave.
    ref_kf = jnp.clip(m.pt_ref_kf, 0, K - 1)
    dist_ref = jnp.linalg.norm(m.pt_pos - cam_centers[ref_kf], axis=-1)
    # Octave/descriptor of the observation in the ref kf, via ONE scatter
    # over the forward index (an observation (k, n) of point p writes when
    # k == pt_ref_kf[p]) — no (P, N) intermediate.
    kf_ids2 = jax.lax.broadcasted_iota(jnp.int32, (K, N), 0)
    sel = ok & (kf_ids2 == m.pt_ref_kf[pts_safe])
    sel_idx = jnp.where(sel, pts_safe, P).reshape(-1)
    has_slot = (
        jnp.zeros((P,), jnp.int32).at[sel_idx].max(1, mode="drop") > 0
    )
    octave = jnp.zeros((P,), jnp.int32).at[sel_idx].max(
        jnp.broadcast_to(m.kf_level, (K, N)).reshape(-1), mode="drop"
    )
    # Scale band from the ACTUAL pyramid (the reference uses the
    # extractor's mvScaleFactors / nLevels, MapPoint.cc:≈320); defaulting
    # to 8x1.2 when the caller predates the scale_factors argument.
    if scale_factors is None:
        scale_factors = 1.2 ** jnp.arange(8, dtype=jnp.float32)
    L = scale_factors.shape[0]
    scale = scale_factors[jnp.clip(octave, 0, L - 1)]
    max_dist = dist_ref * scale
    min_dist = max_dist / scale_factors[L - 1]
    # Ref-KF observation descriptor, same scatter (a point is bound at most
    # once per keyframe row, so the elementwise max is the single value).
    desc = jnp.zeros((P, 8), m.kf_desc.dtype).at[sel_idx].max(
        m.kf_desc.reshape(-1, 8), mode="drop"
    )

    upd = m.pt_valid & has_slot
    return m._replace(
        pt_normal=jnp.where(upd[:, None], normal, m.pt_normal),
        pt_max_dist=jnp.where(upd, max_dist, m.pt_max_dist),
        pt_min_dist=jnp.where(upd, min_dist, m.pt_min_dist),
        pt_desc=jnp.where(upd[:, None], desc, m.pt_desc),
    )


@functools.partial(jax.jit, static_argnames=("max_obs", "subset_cap"))
def compute_distinctive_descriptors(
    m: MapState,
    max_obs: int = 16,
    touched_kfs: jnp.ndarray = None,
    subset_cap: int = 4096,
) -> MapState:
    """EXACT MapPoint::ComputeDistinctiveDescriptors (MapPoint.cc:≈260):
    for every point, pick the observation descriptor minimizing the MEDIAN
    Hamming distance to the point's other observation descriptors.

    Batched shape: the per-point observation lists the reference walks via
    mObservations are materialized as one (P', max_obs, 8) table built from
    the forward index with a segment-rank sort (argsort by point id; rank
    within run = position - run start), then all pairwise distances come
    from max_obs^2 batched XOR+popcounts and one sorted-gather median.
    Exact for points with <= max_obs observations (the common case by
    far); beyond that the first max_obs observers vote.

    ``touched_kfs``: optional (T,) int32 keyframe ids.  When given, only
    points observed by those keyframes are recomputed (capped at
    ``subset_cap``, ranked by membership) — the incremental form for the
    per-keyframe mapping pass, matching the reference which recomputes
    per TOUCHED point on observation changes, not map-wide.  P' is then
    subset_cap instead of the full pool, an ~4x cheaper pass at the
    default capacities.

    Call once per keyframe-processing pass AFTER update_point_stats (which
    maintains the cheap ref-KF descriptor for freshly created points)."""
    K, N = m.kf_point.shape
    P = m.pt_capacity
    ok = (m.kf_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    flat_pid = jnp.where(ok, m.kf_point, P).reshape(-1)

    if touched_kfs is not None:
        kf_mask = jnp.zeros((K,), bool).at[touched_kfs].set(True, mode="drop")
        member = points_seen_by(m, kf_mask)           # (P,)
        Psub = min(subset_cap, P)
        _, sel = jax.lax.top_k(member.astype(jnp.float32), Psub)
        sel = sel.astype(jnp.int32)
        sel_ok = member[sel]
        g2l = jnp.full((P + 1,), Psub, jnp.int32).at[sel].set(
            jnp.arange(Psub, dtype=jnp.int32)
        )
        flat_pid = g2l[jnp.minimum(flat_pid, P)]      # into subset ids
        P_eff = Psub
    else:
        sel = None
        P_eff = P
    desc_flat = m.kf_desc.reshape(-1, 8)

    # Sorted-segment GATHER (not scatter): sort observations by point id,
    # then table[p, r] = sorted_desc[base(p) + r] — a (P', max_obs) gather
    # from the sorted copy, instead of a scatter over the K*N observation
    # rows.
    order = jnp.argsort(flat_pid)  # stable; sentinel P_eff sorts last
    sorted_pid = flat_pid[order]
    sorted_desc = desc_flat[order]
    pids = jnp.arange(P_eff, dtype=sorted_pid.dtype)
    base = jnp.searchsorted(sorted_pid, pids, side="left")   # (P',)
    end = jnp.searchsorted(sorted_pid, pids, side="right")   # (P',)
    idx = base[:, None] + jnp.arange(max_obs)[None, :]       # (P', max_obs)
    valid = idx < end[:, None]
    idx = jnp.minimum(idx, sorted_pid.shape[0] - 1)
    table = sorted_desc[idx]                                  # (P', max_obs, 8)

    # Pairwise Hamming distances, accumulated per 32-bit word to bound the
    # intermediate at (P', M, M) instead of (P', M, M, 8).
    d = jnp.zeros((P_eff, max_obs, max_obs), jnp.int32)
    for w in range(8):
        x = table[:, :, None, w] ^ table[:, None, :, w]
        d = d + jax.lax.population_count(x).astype(jnp.int32)
    BIG = jnp.int32(1 << 12)
    pair_ok = valid[:, :, None] & valid[:, None, :]
    d = jnp.where(pair_ok, d, BIG)

    # Median over each candidate row (self-distance 0 included, matching
    # the reference's Dists[i][i]=0 and median index 0.5*(N-1)).
    cnt = jnp.sum(valid, axis=1)  # (P',)
    d_sorted = jnp.sort(d, axis=2)  # invalid -> BIG, at the end
    med_idx = jnp.clip((cnt - 1) // 2, 0, max_obs - 1)
    median = jnp.take_along_axis(
        d_sorted,
        jnp.broadcast_to(med_idx[:, None, None], (P_eff, max_obs, 1)),
        axis=2,
    )[..., 0]
    median = jnp.where(valid, median, BIG)
    best = jnp.argmin(median, axis=1)  # (P',)
    best_desc = jnp.take_along_axis(
        table, jnp.broadcast_to(best[:, None, None], (P_eff, 1, 8)), axis=1
    )[:, 0, :]

    if touched_kfs is not None:
        upd = m.pt_valid[sel] & (cnt > 0) & sel_ok
        pt_desc = m.pt_desc.at[sel].set(
            jnp.where(upd[:, None], best_desc, m.pt_desc[sel]), mode="drop"
        )
        return m._replace(pt_desc=pt_desc)
    upd = m.pt_valid & (cnt > 0)
    return m._replace(
        pt_desc=jnp.where(upd[:, None], best_desc, m.pt_desc)
    )


def scatter_slots(n: int, idx: jnp.ndarray, val: jnp.ndarray,
                  ok: jnp.ndarray, fill=NO_POINT) -> jnp.ndarray:
    """(n,) array holding ``val[i]`` at slot ``idx[i]`` where ``ok[i]``,
    ``fill`` elsewhere.  Rows that are not ok go to an out-of-bounds slot
    and are dropped: the order of a scatter among duplicate indices is
    unspecified on the GPU, so routing them to a real slot could overwrite
    a genuine write there."""
    tgt = jnp.where(ok, idx, n)
    return jnp.full((n,), fill, val.dtype).at[tgt].set(val, mode="drop")


@jax.jit
def dedup_binding_rows(kf_point: jnp.ndarray) -> jnp.ndarray:
    """Unbind duplicate point bindings within each keyframe row (keep the
    lowest slot) — the reference's EraseMapPointMatch branch of
    MapPoint::Replace (MapPoint.cc:≈180).  Sort-based, vmapped per row."""

    def one_row(row):
        order = jnp.argsort(row)
        sv = row[order]
        dup_sorted = jnp.concatenate(
            [jnp.zeros((1,), bool), (sv[1:] == sv[:-1]) & (sv[1:] >= 0)]
        )
        dup = jnp.zeros_like(dup_sorted).at[order].set(dup_sorted)
        return jnp.where(dup, NO_POINT, row)

    return jax.vmap(one_row)(kf_point)


@jax.jit
def apply_point_replacements(
    m: MapState,
    old_pt: jnp.ndarray,   # (M,) point ids to retire
    new_pt: jnp.ndarray,   # (M,) surviving point ids
    do: jnp.ndarray,       # (M,) bool
) -> MapState:
    """Batched ``MapPoint::Replace`` (src/MapPoint.cc:≈180): rebind EVERY
    observation of each retired point (across all keyframes) to its
    survivor, merge found/visible statistics, invalidate the retired point,
    and unbind per-keyframe duplicate bindings of the survivor.

    Compose-safe: a survivor that is itself being retired at another slot
    drops that replacement (no chains into invalidated points); duplicate
    retirements of the same old point merge statistics exactly once.
    """
    P = m.pt_capacity
    M = old_pt.shape[0]
    do = do & (old_pt >= 0) & (new_pt >= 0) & (old_pt != new_pt)
    old_safe = jnp.clip(old_pt, 0, P - 1)
    new_safe = jnp.clip(new_pt, 0, P - 1)
    # Drop replacements whose TARGET is itself retired elsewhere.
    being_replaced = jnp.zeros((P,), bool).at[
        jnp.where(do, old_pt, P)
    ].set(True, mode="drop")
    do = do & ~being_replaced[new_safe]
    # First occurrence per old point (for deterministic winner + exactly-
    # once stat merge).
    slot_ids = jnp.arange(M, dtype=jnp.int32)
    first_slot = jnp.full((P,), M, jnp.int32).at[
        jnp.where(do, old_pt, P)
    ].min(slot_ids, mode="drop")
    is_first = do & (first_slot[old_safe] == slot_ids)

    old_idx = jnp.where(is_first, old_pt, P)
    repl = (
        jnp.arange(P, dtype=m.kf_point.dtype)
        .at[old_idx].set(jnp.where(is_first, new_pt, 0), mode="drop")
    )
    kf_point = jnp.where(
        m.kf_point >= 0, repl[jnp.clip(m.kf_point, 0, P - 1)], m.kf_point
    )
    kf_point = dedup_binding_rows(kf_point)

    new_idx = jnp.where(is_first, new_pt, P)
    pt_visible = m.pt_visible.at[new_idx].add(
        jnp.where(is_first, m.pt_visible[old_safe], 0), mode="drop"
    )
    pt_found = m.pt_found.at[new_idx].add(
        jnp.where(is_first, m.pt_found[old_safe], 0), mode="drop"
    )
    pt_valid = m.pt_valid.at[old_idx].set(False, mode="drop")
    return m._replace(
        kf_point=kf_point, pt_valid=pt_valid,
        pt_visible=pt_visible, pt_found=pt_found,
    )


def compact_map(m: MapState):
    """Host-side keyframe-pool compaction (SURVEY.md §2.1 Map note:
    'compaction is a host-side op').

    The keyframe pool is append-only on device (monotonic slot ids keep the
    jitted programs free of free-list logic in the hot path); culled
    keyframes (KeyFrameCulling / SetBadFlag, LocalMapping.cc:≈500) leave
    masked holes.  When the pool nears capacity the host compacts: valid
    keyframes slide down to dense slots 0..K'-1 in id order, every id
    reference (parents, point ref-KFs) is remapped, and the freed tail is
    reusable.  Point slots already reuse a free-list (tracking.add_points)
    and are left in place.

    Callers must first re-anchor any external id references (trajectory
    logs, databases) using the returned map.

    Returns (m2, kf_new_from_old): (K,) int32, -1 where the old id was
    culled/dropped.
    """
    K = m.kf_capacity
    kf_valid = np.asarray(m.kf_valid)
    n_kf = int(m.n_kf)
    kf_valid = kf_valid.copy()
    kf_valid[n_kf:] = False
    old_ids = np.nonzero(kf_valid)[0]
    kf_map = np.full(K, -1, np.int64)
    kf_map[old_ids] = np.arange(len(old_ids))

    def take_kf(arr, fill=0):
        a = np.asarray(arr)
        out = np.full_like(a, fill)
        out[: len(old_ids)] = a[old_ids]
        return jnp.asarray(out)

    # Parents: walk up through culled ancestors to the nearest survivor.
    parent = np.asarray(m.kf_parent).astype(np.int64)
    resolved = parent.copy()
    for _ in range(8):
        bad = (resolved >= 0) & (kf_map[np.maximum(resolved, 0)] < 0)
        if not bad.any():
            break
        resolved[bad] = parent[np.maximum(resolved[bad], 0)]
    new_parent = np.where(resolved >= 0, kf_map[np.maximum(resolved, 0)], -1)
    new_parent = new_parent[old_ids]
    new_parent_full = np.full(K, -1, np.int64)
    new_parent_full[: len(old_ids)] = new_parent

    ref = kf_map[np.clip(np.asarray(m.pt_ref_kf), 0, K - 1)]
    first = kf_map[np.clip(np.asarray(m.pt_first_kf), 0, K - 1)]

    # Freed pose slots -> identity (never a zero matrix: padded covisibility
    # gathers in BA may touch invalid slots and must stay finite).
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[: len(old_ids)] = np.asarray(m.kf_pose_cw)[old_ids]

    m2 = m._replace(
        kf_pose_cw=jnp.asarray(poses),
        kf_xy=take_kf(m.kf_xy),
        kf_level=take_kf(m.kf_level),
        kf_angle=take_kf(m.kf_angle),
        kf_desc=take_kf(m.kf_desc),
        kf_ur=take_kf(m.kf_ur, fill=-1),
        kf_kp_valid=take_kf(m.kf_kp_valid, fill=False),
        kf_point=take_kf(m.kf_point, fill=NO_POINT),
        kf_valid=take_kf(m.kf_valid, fill=False),
        kf_frame_id=take_kf(m.kf_frame_id),
        kf_parent=jnp.asarray(new_parent_full.astype(np.int32)),
        pt_ref_kf=jnp.asarray(np.maximum(ref, 0).astype(np.int32)),
        pt_first_kf=jnp.asarray(np.maximum(first, 0).astype(np.int32)),
        n_kf=jnp.int32(len(old_ids)),
    )
    return m2, kf_map


@jax.jit
def predict_scale(
    dist: jnp.ndarray, max_dist: jnp.ndarray,
    scale_factors: jnp.ndarray = None,
) -> jnp.ndarray:
    """MapPoint::PredictScale (MapPoint.cc:≈400): octave from distance ratio.

    ``scale_factors`` is the extractor's per-level scale LUT; the predicted
    octave is the count of levels whose scale is below the distance ratio
    (== ceil(log(ratio)/log(sf)) for a geometric LUT), clipped to the
    actual pyramid depth exactly as the reference clips to nLevels-1 —
    using the LUT keeps predictions consistent with the real pyramid
    instead of a hardcoded 8-level 1.2x one.
    """
    if scale_factors is None:
        scale_factors = 1.2 ** jnp.arange(8, dtype=jnp.float32)
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-9), 1e-9)
    lvl = jnp.sum(
        scale_factors[None, :] < ratio[..., None], axis=-1
    ).astype(jnp.int32)
    return jnp.clip(lvl, 0, scale_factors.shape[0] - 1)
