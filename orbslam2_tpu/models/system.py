"""System facade — the public API.

JAX equivalent of ``System`` (src/System.cc, SURVEY.md §2.1 L6):
constructs the pipeline, exposes per-frame ``track_*`` calls, mode switches,
reset, and the three trajectory savers byte-compatible with the TUM/KITTI
evaluation tooling (SaveTrajectoryTUM ≈270, SaveKeyFrameTrajectoryTUM ≈330,
SaveTrajectoryKITTI ≈370).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Settings
from .local_mapping import LocalMapper
from .tracking import TrackState, Tracker


class Sensor:
    MONOCULAR = "mono"
    STEREO = "stereo"
    RGBD = "rgbd"


def _default_vocabulary(seed: int = 0):
    """Small built-in vocabulary (k=10, L=3 -> 1000 words) trained on
    seeded random descriptors.  For real datasets pass a vocabulary built
    from representative data or converted from ORBvoc.txt
    (utils/vocab.py) — the reference requires one at construction."""
    import numpy as np

    from ..ops.bow import train_vocabulary

    rng = np.random.default_rng(seed)
    train = rng.integers(0, 2**32, (6000, 8), dtype=np.uint32)
    return train_vocabulary(train, k=10, levels=3, seed=seed)


class SlamSystem:
    """``SlamSystem(settings, sensor)`` then ``track_*`` per frame.

    The reference signature System(vocFile, settingsFile, sensor, useViewer)
    maps to: vocabulary is optional (used by loop closing / relocalization
    when configured), settings accepts the same YAML files.
    """

    def __init__(
        self,
        settings: Settings,
        sensor: str = Sensor.MONOCULAR,
        enable_mapping: bool = True,
        vocabulary: Optional[object] = None,
        enable_loop_closing: bool = True,
        pipeline: bool = False,
        chunk: int = 0,
        async_mapping: bool = False,
        mapping_device=None,
        mesh=None,
    ):
        """``async_mapping``: run local mapping + loop closing in a worker
        thread on map snapshots (the reference's LocalMapping/LoopClosing
        threads, src/System.cc:≈90-100) so tracking never blocks on them;
        ``mapping_device`` optionally pins those programs to a different
        device (pipeline parallelism across chips).  Off by default because
        adoption timing is wall-clock dependent — the reference is equally
        nondeterministic (SURVEY.md §4); tests that assert bitwise
        determinism use the synchronous mode.

        ``mesh``: a multi-device ``jax.sharding.Mesh`` dispatches the map
        optimizers (local BA, joint GBA, essential graph) to the
        keyframe-/edge-sharded collective solvers in ``parallel/`` — the
        capability the reference has no analog for (single process,
        shared memory; SURVEY.md §2.5)."""
        from .kf_database import KeyframeDatabase
        from .loop_closing import LoopCloser

        self.settings = settings
        self.sensor = sensor
        self.mesh = mesh
        self.local_mapper = (
            LocalMapper(settings, sensor=sensor, mesh=mesh)
            if enable_mapping else None
        )
        self.vocabulary = (
            vocabulary if vocabulary is not None else _default_vocabulary()
        )
        self.database = KeyframeDatabase(
            self.vocabulary, settings.tpu.max_keyframes
        )
        # Scale is observable (fixed) for stereo/RGB-D (System.cc:≈95's
        # bFixScale wiring).
        self.loop_closer = (
            LoopCloser(settings, self.database,
                       fix_scale=(sensor != Sensor.MONOCULAR), mesh=mesh)
            if enable_loop_closing
            else None
        )
        self.pipeline = pipeline
        self.chunk = chunk
        self.async_mapping = async_mapping
        self.mapping_device = mapping_device
        self.mapping_pipeline = self._make_mapping_pipeline()
        self.tracker = Tracker(
            settings, local_mapper=self.local_mapper,
            database=self.database, loop_closer=self.loop_closer,
            pipeline=pipeline, chunk=chunk,
            mapping_pipeline=self.mapping_pipeline,
        )
        self.localization_only = False
        self.timestamps = []

    def _make_mapping_pipeline(self):
        if not self.async_mapping or self.local_mapper is None:
            return None
        from .async_pipeline import AsyncMappingPipeline

        return AsyncMappingPipeline(
            self.local_mapper, self.loop_closer, device=self.mapping_device
        )

    # -- per-frame API (System::TrackMonocular/Stereo/RGBD) ---------------

    def track_monocular(self, image, timestamp: float):
        self.timestamps.append(timestamp)
        return self.tracker.track_mono(image, timestamp)

    def track_stereo(self, image_left, image_right, timestamp: float):
        self.timestamps.append(timestamp)
        return self.tracker.track_stereo(image_left, image_right, timestamp)

    def track_rgbd(self, image, depth, timestamp: float):
        self.timestamps.append(timestamp)
        return self.tracker.track_rgbd(image, depth, timestamp)

    # -- modes / reset (System::ActivateLocalizationMode, Reset) ----------

    def activate_localization_mode(self):
        """Tracking-only: pause mapping and keyframe insertion (the
        reference stops LocalMapping and sets mbOnlyTracking).  Motion-model
        tracking then leans on temp VO points (Tracking::UpdateLastFrame)
        through unmapped regions."""
        self.localization_only = True
        self.tracker.local_mapper = None
        self.tracker.localization_only = True
        self._set_ctx_only_tracking(True)

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.local_mapper = self.local_mapper
        self.tracker.localization_only = False
        self._set_ctx_only_tracking(False)

    def _set_ctx_only_tracking(self, value: bool):
        import jax.numpy as jnp

        if self.tracker._next_ctx is not None:
            self.tracker._next_ctx = self.tracker._next_ctx._replace(
                only_tracking=jnp.asarray(value)
            )

    def warm_mapping(self):
        """Precompile BOTH window buckets of every mapping stage on the
        current map pools (LocalMapper.warm).  Drivers call this once
        after their warmup pass: keyframe ids drift between runs, and a
        bucket boundary first crossed MID-RUN would otherwise pay a
        compile inside the run."""
        if self.local_mapper is not None:
            if self.mapping_pipeline is not None:
                # Drain THROUGH the tracker's adoption path: a job caught
                # in flight here carries mapping/loop output that must not
                # be silently dropped (and adoption re-dispatches any
                # queued keyframes).
                self.tracker._adopt(self.mapping_pipeline.wait())
            self.local_mapper.warm(self.tracker.map)
        if self.loop_closer is not None:
            self.loop_closer.warm(self.tracker.map)

    def reset(self):
        from .kf_database import KeyframeDatabase

        if self.mapping_pipeline is not None:
            self.mapping_pipeline.wait()  # drain the in-flight job
        self.database = KeyframeDatabase(
            self.vocabulary, self.settings.tpu.max_keyframes
        )
        if self.loop_closer is not None:
            self.loop_closer.db = self.database
            self.loop_closer.loop_edges = []
            self.loop_closer.candidate_streak = {}
        self.mapping_pipeline = self._make_mapping_pipeline()
        self.tracker = Tracker(
            self.settings, local_mapper=self.local_mapper,
            database=self.database, loop_closer=self.loop_closer,
            pipeline=self.pipeline, chunk=self.chunk,
            mapping_pipeline=self.mapping_pipeline,
        )
        self.timestamps = []

    def shutdown(self):
        """Drain the in-flight frame (pipeline mode); no threads to join —
        concurrency is the device/host dispatch pipeline, not threads."""
        self.tracker.flush()

    # -- state inspection --------------------------------------------------

    @property
    def map(self):
        return self.tracker.map

    def tracking_state(self) -> int:
        return self.tracker.state

    def metrics(self) -> dict:
        """Structured observability snapshot (SURVEY.md §5): counters +
        map size, replacing the reference's cout prints and the
        FrameDrawer status bar."""
        m = dict(self.tracker.metrics)
        m["n_keyframes"] = int(self.map.kf_valid.sum())
        m["n_points"] = int(self.map.pt_valid.sum())
        m["n_loop_closures"] = (
            len(self.loop_closer.loop_edges) if self.loop_closer else 0
        )
        return m

    def poses_wc(self) -> np.ndarray:
        return self.tracker.poses_wc()

    # -- trajectory savers -------------------------------------------------

    def save_trajectory_tum(self, path: str):
        """TUM format: 'timestamp tx ty tz qx qy qz qw' per FRAME
        (System::SaveTrajectoryTUM)."""
        poses = self.poses_wc()
        with open(path, "w") as f:
            for i, T in enumerate(poses):
                ts = self.timestamps[i] if i < len(self.timestamps) else float(i)
                t = T[:3, 3]
                q = _rot_to_quat(T[:3, :3])
                f.write(
                    f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe-only TUM trajectory (System::SaveKeyFrameTrajectoryTUM)."""
        m = self.map
        n = int(m.n_kf)
        kf_poses = np.asarray(m.kf_pose_cw[:n])
        kf_frames = np.asarray(m.kf_frame_id[:n])
        kf_ok = np.asarray(m.kf_valid[:n])
        with open(path, "w") as f:
            for i in range(n):
                if not kf_ok[i]:
                    continue
                T = np.linalg.inv(kf_poses[i])
                fid = int(kf_frames[i])
                ts = (
                    self.timestamps[fid]
                    if fid < len(self.timestamps)
                    else float(fid)
                )
                t = T[:3, 3]
                q = _rot_to_quat(T[:3, :3])
                f.write(
                    f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )

    def save_trajectory_kitti(self, path: str):
        """KITTI format: 12 numbers (3x4 row-major Twc) per frame
        (System::SaveTrajectoryKITTI)."""
        poses = self.poses_wc()
        with open(path, "w") as f:
            for T in poses:
                r = T[:3, :4].reshape(-1)
                f.write(" ".join(f"{x:.9e}" for x in r) + "\n")


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), TUM order."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])
