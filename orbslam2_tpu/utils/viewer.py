"""Map / trajectory visualization (viewer-lite).

Role of the reference's Pangolin viewer stack (``Viewer``/``FrameDrawer``/
``MapDrawer``, SURVEY.md §2.1 L7) for hosts without a GL stack:
renders the map points, keyframe frusta, covisibility graph and the
trajectory to a PNG (matplotlib), plus a FrameDrawer-style annotated frame.
Headless by design — the reference's live window becomes periodic snapshots
(SURVEY.md §5 'optional lightweight viewer').
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _HAS_MPL = True
except Exception:  # pragma: no cover
    _HAS_MPL = False

from ..models import map_state as ms


def draw_map(
    m: ms.MapState,
    path: str,
    trajectory: Optional[np.ndarray] = None,
    gt_trajectory: Optional[np.ndarray] = None,
    show_covisibility: bool = True,
    min_covis_weight: int = 100,
    follow: Optional[np.ndarray] = None,
    follow_radius: float = 0.0,
) -> bool:
    """Top-down (x-z) map view: points, keyframes, covisibility, trajectory.

    The drawing set matches MapDrawer::DrawMapPoints/DrawKeyFrames/graph
    (src/MapDrawer.cc:≈40-190).  Returns False if matplotlib is missing.
    """
    if not _HAS_MPL:
        return False
    fig, ax = plt.subplots(figsize=(8, 8))

    pts = np.asarray(m.pt_pos)[np.asarray(m.pt_valid)]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1, c="k", alpha=0.3, label="map points")

    kf_ok = np.asarray(m.kf_valid)
    n = int(m.n_kf)
    kf_poses = np.asarray(m.kf_pose_cw)
    centers = []
    for k in range(n):
        if not kf_ok[k]:
            centers.append(None)
            continue
        T = kf_poses[k]
        C = -T[:3, :3].T @ T[:3, 3]
        centers.append(C)
    cs = np.array([c for c in centers if c is not None])
    if len(cs):
        ax.scatter(cs[:, 0], cs[:, 2], s=14, c="tab:blue", marker="s",
                   label="keyframes")

    if show_covisibility and n:
        W = np.asarray(ms.covisibility(m))
        for i in range(n):
            if centers[i] is None:
                continue
            for j in range(i + 1, n):
                if centers[j] is None or W[i, j] < min_covis_weight:
                    continue
                ax.plot(
                    [centers[i][0], centers[j][0]],
                    [centers[i][2], centers[j][2]],
                    c="tab:green", lw=0.4, alpha=0.5,
                )

    if trajectory is not None:
        t = np.asarray(trajectory)[:, :3, 3]
        ax.plot(t[:, 0], t[:, 2], c="tab:red", lw=1.2, label="estimate")
    if gt_trajectory is not None:
        t = np.asarray(gt_trajectory)[:, :3, 3]
        ax.plot(t[:, 0], t[:, 2], c="tab:gray", lw=1.0, ls="--", label="ground truth")

    if follow is not None and follow_radius > 0:
        # Follow-camera view (Viewer.cc menuFollowCamera): clamp the view
        # to a window centered on the current camera center.
        C = np.asarray(follow, np.float64)
        ax.set_xlim(C[0] - follow_radius, C[0] + follow_radius)
        ax.set_ylim(C[2] - follow_radius, C[2] + follow_radius)
        ax.scatter([C[0]], [C[2]], s=60, c="tab:red", marker="x",
                   label="camera")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(
        f"map: {int(np.asarray(m.pt_valid).sum())} points, "
        f"{int(kf_ok[:n].sum())} keyframes"
    )
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def draw_frame(
    image: np.ndarray,
    kp_xy: np.ndarray,
    kp_tracked: np.ndarray,
    path: str,
    state_text: str = "",
) -> bool:
    """FrameDrawer::DrawFrame equivalent: keypoints over the image, tracked
    ones in green, untracked in blue, plus the status line
    (src/FrameDrawer.cc:≈120)."""
    if not _HAS_MPL:
        return False
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(np.asarray(image), cmap="gray", vmin=0, vmax=255)
    kp = np.asarray(kp_xy)
    tracked = np.asarray(kp_tracked)
    if len(kp):
        ax.scatter(kp[~tracked, 0], kp[~tracked, 1], s=6, c="tab:blue",
                   marker="o", linewidths=0.5, facecolors="none")
        ax.scatter(kp[tracked, 0], kp[tracked, 1], s=6, c="tab:green",
                   marker="o", linewidths=0.5, facecolors="none")
    if state_text:
        ax.text(4, 12, state_text, color="yellow", fontsize=9,
                bbox=dict(facecolor="black", alpha=0.6, pad=2))
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


class LiveViewer:
    """Periodic snapshot renderer — the Viewer::Run loop's role
    (src/Viewer.cc:≈60-140) on a headless host: instead of a Pangolin
    window at 1/fps, write PNG snapshots every N keyframes and on every
    loop closure, leaving a browsable sequence of the run.

    Usage (drivers)::

        lv = LiveViewer(out_dir, every_kf=5, follow_radius=4.0)
        for each frame:  lv.update(system)      # cheap; draws only on event
        lv.finish(system, gt_trajectory=...)    # final full map view
    """

    def __init__(self, out_dir: str, every_kf: int = 5,
                 follow_radius: float = 0.0):
        import os

        self.out = out_dir
        self.every_kf = max(1, int(every_kf))
        self.follow_radius = float(follow_radius)
        self.last_kf_drawn = 0
        self.last_loops = 0
        self.n_snaps = 0
        os.makedirs(out_dir, exist_ok=True)

    def _snap(self, system, tag: str) -> None:
        import os

        m = system.map
        follow = None
        if self.follow_radius > 0:
            T = np.asarray(system.tracker.last_T)
            follow = -T[:3, :3].T @ T[:3, 3]
        draw_map(
            m,
            os.path.join(self.out, f"map_{self.n_snaps:04d}_{tag}.png"),
            trajectory=system.poses_wc(),
            follow=follow,
            follow_radius=self.follow_radius,
        )
        self.n_snaps += 1

    def update(self, system) -> None:
        """Call once per tracked frame; renders only on keyframe-interval
        or loop-closure events so the per-frame cost is a couple of int
        comparisons."""
        if not _HAS_MPL:
            return
        # NEVER force a device sync per frame: use the host copy the
        # chunked tracker already maintains from its per-chunk readback;
        # fall back to counting keyframe events from the tracker metrics.
        n_kf = getattr(system.tracker, "_host_n_kf", None)
        if n_kf is None:
            n_kf = system.tracker.metrics.get("keyframes_created", 0)
        loops = (
            len(system.loop_closer.loop_edges)
            if system.loop_closer is not None else 0
        )
        if loops > self.last_loops:
            self.last_loops = loops
            self._snap(system, "loop")
        elif n_kf - self.last_kf_drawn >= self.every_kf:
            self.last_kf_drawn = n_kf
            self._snap(system, "kf")

    def finish(self, system, gt_trajectory=None) -> None:
        import os

        if not _HAS_MPL:
            return
        draw_map(
            system.map, os.path.join(self.out, "map_final.png"),
            trajectory=system.poses_wc(), gt_trajectory=gt_trajectory,
        )
