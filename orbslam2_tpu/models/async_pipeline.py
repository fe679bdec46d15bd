"""Asynchronous local mapping + loop closing — the reference's thread
pipeline as a device dispatch pipeline.

The reference spawns ``LocalMapping::Run`` and ``LoopClosing::Run`` as
long-lived threads (src/System.cc:≈90-100) consuming keyframe queues, so
tracking NEVER waits on local BA (~100-300 ms/KF) or loop correction
(~0.3-1.5 s); the shared map is protected by per-object mutexes.

Here the map is a functional struct-of-arrays snapshot, so the same overlap
needs no locks at all:

  * keyframe fires -> the tracker keeps ITS map (which already contains the
    new keyframe) and submits a SNAPSHOT to a worker; the worker runs the
    mapping sequence (cull / triangulate / fuse / local BA / KF-cull) and
    then loop closing on that snapshot — its device programs interleave
    with tracking's dispatches (or run on a separate device when one is
    given), and the HOST tracking loop never blocks;
  * while a job is in flight ``accept_keyframes()`` is False — exactly the
    reference's ``SetAcceptKeyFrames(false)`` (LocalMapping.cc:≈30): the
    tracker defers further keyframes unless urgent (InterruptBA class, in
    which case it block-adopts);
  * at the next frame boundary the tracker ADOPTS the mapped state,
    merging the visibility statistics tracking accumulated meanwhile
    (``merge_tracking_stats``) — the functional-state equivalent of the
    reference's tracking thread reading the map while LocalMapping mutates
    it under ``Map::mMutexMapUpdate``.

At most one job is in flight: the reference's LocalMapping also processes
its queue strictly serially; queued keyframes there are keyframes we defer
at the decision site instead (same cadence class, no divergent-map merge
problem).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from . import map_state as ms


@jax.jit
def merge_tracking_stats(
    m_mapped: ms.MapState,
    snapshot: ms.MapState,
    m_tracked: ms.MapState,
) -> ms.MapState:
    """Fold the visibility/found statistics tracking accumulated since
    ``snapshot`` into the mapped state.  Deltas only apply to points that
    survived mapping with their identity intact (same creation keyframe —
    culled-and-reused slots must not inherit foreign counters)."""
    same = (
        m_mapped.pt_valid
        & snapshot.pt_valid
        & (m_mapped.pt_first_kf == snapshot.pt_first_kf)
    )
    dv = m_tracked.pt_visible - snapshot.pt_visible
    df = m_tracked.pt_found - snapshot.pt_found
    return m_mapped._replace(
        pt_visible=m_mapped.pt_visible + jnp.where(same, dv, 0),
        pt_found=m_mapped.pt_found + jnp.where(same, df, 0),
    )


@jax.jit
def adopt_mapped_state(
    m_mapped: ms.MapState,
    snapshot: ms.MapState,
    m_tracked: ms.MapState,
    job_kf: jnp.ndarray = None,
) -> ms.MapState:
    """Full adoption merge: the worker's mapped result + everything the
    TRACKER changed since the snapshot.

    The reference's LocalMapping works on the live shared map under
    mutexes; our worker runs on a snapshot, so keyframes the tracker
    inserted meanwhile (the mlNewKeyFrames queue discipline: insertion
    never waits for the mapper, Tracking.cc:≈1050) must be folded back in:

      * tracking statistics deltas (merge_tracking_stats),
      * keyframe rows created after the snapshot (rows are allocated by
        the monotonic n_kf counter and only the tracker inserts, so the
        rows [snapshot.n_kf, tracked.n_kf) are tracker-owned),
      * map points the tracker spawned after the snapshot (close-depth
        spawns at keyframe creation).  The tracker allocates point slots
        from the HIGH end of the free list and the worker's triangulation
        from the LOW end (tracking.add_points ``reverse``), so their
        slots are disjoint while the pool has headroom; a collision
        (pool-pressure only) keeps the WORKER's point and the keyframe
        binding scrub below drops the tracker's reference,
      * binding hygiene on the merged rows: a binding survives only if
        the final pool slot still holds the point it meant (same
        pt_first_kf) — points the worker culled or Replace-merged
        disappear from the new keyframes exactly as EraseObservation
        would,
      * WORLD RE-ANCHORING of the merged rows (``job_kf`` given): the
        tracker rows and their spawned points are expressed in the
        SNAPSHOT's world frame; after a loop-correction (or BA) job moved
        the map, they must be re-expressed through the job keyframe's
        pose delta R = T_j_snap^-1 T_j_mapped — pose rows become
        T_i R, point positions p become R^-1 p (and normals rotate
        accordingly) — the reference CorrectLoop's correction of
        mvpCurrentConnectedKFs + their MapPoints (LoopClosing.cc:≈330)
        applied to the keyframes the queue inserted during the job.
    """
    m = merge_tracking_stats(m_mapped, snapshot, m_tracked)
    K = m.kf_capacity
    rows = jnp.arange(K)
    new_kf = (rows >= snapshot.n_kf) & (rows < m_tracked.n_kf)

    if job_kf is None:
        R = jnp.eye(4, dtype=jnp.float32)
    else:
        j = jnp.int32(job_kf)
        T_snap = snapshot.kf_pose_cw[j]
        T_new = m_mapped.kf_pose_cw[j]
        R = jnp.where(
            snapshot.kf_valid[j] & m_mapped.kf_valid[j],
            jnp.linalg.inv(T_snap) @ T_new,
            jnp.eye(4, dtype=jnp.float32),
        )
    R_inv = jnp.linalg.inv(R)

    def take_kf(a_mapped, a_tracked):
        mask = new_kf.reshape((K,) + (1,) * (a_mapped.ndim - 1))
        return jnp.where(mask, a_tracked, a_mapped)

    # Tracker-spawned points: new since snapshot, and not overwritten by a
    # worker-created point in the same slot (slot collision).
    trk_new = m_tracked.pt_valid & ~snapshot.pt_valid
    wrk_new = m_mapped.pt_valid & ~snapshot.pt_valid
    take_pt = trk_new & ~wrk_new
    P = m.pt_capacity

    def take_point(a_merged, a_tracked):
        mask = take_pt.reshape((P,) + (1,) * (a_merged.ndim - 1))
        return jnp.where(mask, a_tracked, a_merged)

    m = m._replace(
        kf_pose_cw=take_kf(m.kf_pose_cw, m_tracked.kf_pose_cw @ R),
        kf_xy=take_kf(m.kf_xy, m_tracked.kf_xy),
        kf_level=take_kf(m.kf_level, m_tracked.kf_level),
        kf_angle=take_kf(m.kf_angle, m_tracked.kf_angle),
        kf_desc=take_kf(m.kf_desc, m_tracked.kf_desc),
        kf_ur=take_kf(m.kf_ur, m_tracked.kf_ur),
        kf_kp_valid=take_kf(m.kf_kp_valid, m_tracked.kf_kp_valid),
        kf_point=take_kf(m.kf_point, m_tracked.kf_point),
        kf_valid=take_kf(m.kf_valid, m_tracked.kf_valid),
        kf_frame_id=take_kf(m.kf_frame_id, m_tracked.kf_frame_id),
        kf_parent=take_kf(m.kf_parent, m_tracked.kf_parent),
        pt_pos=take_point(
            m.pt_pos, m_tracked.pt_pos @ R_inv[:3, :3].T + R_inv[:3, 3]
        ),
        pt_normal=take_point(m.pt_normal, m_tracked.pt_normal @ R_inv[:3, :3].T),
        pt_desc=take_point(m.pt_desc, m_tracked.pt_desc),
        pt_min_dist=take_point(m.pt_min_dist, m_tracked.pt_min_dist),
        pt_max_dist=take_point(m.pt_max_dist, m_tracked.pt_max_dist),
        pt_ref_kf=take_point(m.pt_ref_kf, m_tracked.pt_ref_kf),
        pt_first_kf=take_point(m.pt_first_kf, m_tracked.pt_first_kf),
        pt_valid=take_point(m.pt_valid, m_tracked.pt_valid),
        pt_visible=take_point(m.pt_visible, m_tracked.pt_visible),
        pt_found=take_point(m.pt_found, m_tracked.pt_found),
        n_kf=jnp.maximum(m.n_kf, m_tracked.n_kf),
        n_pt=jnp.maximum(m.n_pt, m_tracked.n_pt),
    )
    # Binding scrub on the merged (tracker-owned) keyframe rows: keep a
    # binding only if the final pool still holds the point it meant.
    pid = jnp.maximum(m.kf_point, 0)
    meant = m_tracked.pt_first_kf[pid]
    still = (
        (m.kf_point >= 0)
        & m.pt_valid[pid]
        & (m.pt_first_kf[pid] == meant)
    )
    kf_point = jnp.where(
        new_kf[:, None], jnp.where(still, m.kf_point, ms.NO_POINT),
        m.kf_point,
    )
    return m._replace(kf_point=kf_point)


class AsyncMappingPipeline:
    """Worker-thread driver for the per-keyframe mapping + loop sequence.

    JAX dispatch is thread-safe; the worker's jitted programs enqueue on
    the same device stream as tracking's (interleaved execution — the
    single-chip analog of the reference sharing one CPU's cores across its
    threads), or on ``device`` when a spare chip/host device is provided
    (true pipeline parallelism across the mesh).
    """

    def __init__(self, local_mapper, loop_closer=None, device=None):
        self.local_mapper = local_mapper
        self.loop_closer = loop_closer
        self.device = device
        self._thread: Optional[threading.Thread] = None
        self._result = None        # (m_mapped, snapshot, kf_id, pool_state)
        self._error = None
        self._lock = threading.Lock()
        self.abort_gba = threading.Event()  # InterruptBA / mbStopGBA analog
        self.jobs_run = 0

    # -- protocol (SetAcceptKeyFrames / queue) ------------------------------

    def accept_keyframes(self) -> bool:
        """False while a mapping job is in flight (LocalMapping's
        SetAcceptKeyFrames(false) during its work loop)."""
        return self._thread is None

    def submit(self, m: ms.MapState, kf_id: int):
        """Start the mapping+loop job for ``kf_id`` on a snapshot of ``m``.
        Caller must hold no other job in flight (check accept_keyframes)."""
        assert self._thread is None, "one mapping job at a time"
        # Deep-copy the snapshot: the tracker's fused step DONATES its map
        # buffers each frame, which would delete them out from under the
        # worker (the snapshot must own its storage).
        snapshot = jax.tree.map(lambda x: x.copy(), m)
        if self.device is not None:
            snapshot = jax.device_put(snapshot, self.device)
        self.abort_gba.clear()
        self._error = None

        def job():
            try:
                mm = self.local_mapper.process_keyframe(
                    snapshot, int(kf_id), abort=self.abort_gba
                )
                if self.loop_closer is not None:
                    mm = self.loop_closer.process_keyframe(
                        mm, int(kf_id), abort=self.abort_gba
                    )
                # No block_until_ready here: adoption's batched
                # device_get already waits for whatever device work is
                # still in flight.  Publishing "early" only means the
                # queue keeps draining while the tracker decides when to
                # adopt.
                pool = getattr(self.loop_closer, "pool_state", None)
                with self._lock:
                    self._result = (mm, snapshot, int(kf_id), pool)
            except BaseException as e:  # propagate into the main thread
                with self._lock:
                    self._error = e

        self._thread = threading.Thread(target=job, daemon=True)
        self._thread.start()
        self.jobs_run += 1

    def _finish(self):
        """Join the (dead) worker and hand back its result, re-raising any
        worker exception in the caller's thread."""
        self._thread.join()
        self._thread = None
        with self._lock:
            err, self._error = self._error, None
            res, self._result = self._result, None
        if err is not None:
            raise err
        return res

    def poll(self) -> Optional[Tuple[ms.MapState, ms.MapState, int]]:
        """Non-blocking: the finished job's (mapped, snapshot, kf_id), or
        None while still running / nothing in flight."""
        if self._thread is None or self._thread.is_alive():
            return None
        return self._finish()

    def wait(self, timeout: Optional[float] = None):
        """Block until the in-flight job (if any) finishes; return it.
        Signals the GBA abort flag first (InterruptBA: tracking needs the
        map NOW, the background polish yields between LM segments).

        With ``timeout`` (seconds) the wait is BOUNDED: if the job is
        still running past it, returns None WITHOUT adopting — the
        reference's tracking thread never blocks on LocalMapping either
        (InterruptBA + SetAcceptKeyFrames only defer keyframes); a
        pathologically slow job must not stall the frame cadence."""
        if self._thread is None:
            return None
        self.abort_gba.set()
        if timeout is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return None
        return self._finish()
