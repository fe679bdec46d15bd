"""Synthetic-sequence driver — the smoke-test 'example binary'.

Role of the reference's Examples/ mains (SURVEY.md §2.4): run a sequence
through the full pipeline, print per-frame tracking times (median/mean at
exit, like mono_tum.cc), save trajectories, and — since the synthetic
source has exact ground truth — print ATE RMSE.

Usage:
  python examples/run_synthetic.py --sensor mono   [--frames 16] [--cpu]
  python examples/run_synthetic.py --sensor rgbd
  python examples/run_synthetic.py --sensor stereo
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"], default="mono")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--points", type=int, default=400)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--pipeline", action="store_true",
                    help="lag-1 pipelined tracking (never blocks on device)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="C frames per device dispatch (chunked driver)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run mapping/loop closing in a worker thread "
                         "(the reference's LocalMapping/LoopClosing threads)")
    ap.add_argument("--out", default="/tmp/orbslam2_tpu_out")
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--viewer", action="store_true",
                    help="write map/frame PNG snapshots (viewer-lite)")
    ap.add_argument("--viewer-every", type=int, default=0,
                    help="live viewer: snapshot every N keyframes + on "
                         "each loop closure (Viewer::Run loop role)")
    ap.add_argument("--follow-radius", type=float, default=0.0,
                    help="live viewer follow-camera window half-size")
    ap.add_argument("--profile", action="store_true",
                    help="write a jax.profiler trace to OUT/trace")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from orbslam2_tpu.config import (
        CameraSettings, OrbSettings, Settings, TpuSettings,
    )
    from orbslam2_tpu.models.system import SlamSystem
    from orbslam2_tpu.models.tracking import TrackState
    from orbslam2_tpu.utils import synthetic

    bf = 32.0 if args.sensor in ("stereo", "rgbd") else 0.0
    settings = Settings(
        camera=CameraSettings(
            fx=320.0, fy=320.0, cx=160.0, cy=120.0,
            k1=0, k2=0, p1=0, p2=0, k3=0,
            width=320, height=240, bf=bf, th_depth=40.0, depth_map_factor=1.0,
        ),
        orb=OrbSettings(n_features=800, n_levels=4),
        tpu=TpuSettings(
            max_keypoints=1024, max_keyframes=64, max_points=8192,
            min_init_matches=50,
        ),
    )
    cam = settings.camera_model()
    print(f"[synthetic] rendering {args.frames} frames ({args.sensor})...")
    seq = synthetic.make_sequence(
        cam, n_frames=args.frames, n_points=args.points,
        with_depth=(args.sensor == "rgbd"),
        stereo_baseline=(0.1 if args.sensor == "stereo" else 0.0),
        seed=7,
    )

    system = SlamSystem(settings, args.sensor, pipeline=args.pipeline,
                        chunk=args.chunk, async_mapping=args.async_mapping)
    if args.no_ba and system.local_mapper is not None:
        system.local_mapper.enable_ba = False

    live_viewer = None
    if args.viewer_every > 0:
        from orbslam2_tpu.utils.viewer import LiveViewer

        live_viewer = LiveViewer(
            args.out, every_kf=args.viewer_every,
            follow_radius=args.follow_radius,
        )

    if args.profile:
        import jax

        os.makedirs(args.out, exist_ok=True)
        jax.profiler.start_trace(os.path.join(args.out, "trace"))

    times = []
    for i in range(args.frames):
        t0 = time.perf_counter()
        if args.sensor == "mono":
            system.track_monocular(seq.images[i], seq.timestamps[i])
        elif args.sensor == "rgbd":
            system.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        else:
            system.track_stereo(
                seq.images[i][0], seq.images[i][1], seq.timestamps[i]
            )
        times.append(time.perf_counter() - t0)
        if live_viewer is not None:
            live_viewer.update(system)
        st = {0: "INIT", 1: "OK", 2: "LOST"}[system.tracking_state()]
        print(
            f"frame {i:3d}  state={st:5s}  kfs={int(system.map.n_kf):3d}  "
            f"points={int(system.map.pt_valid.sum()):5d}  "
            f"t={times[-1]*1e3:7.1f} ms"
        )

    system.shutdown()  # drain in-flight frames + async mapping jobs
    if live_viewer is not None:
        live_viewer.finish(system, gt_trajectory=seq.poses_wc)
        print(f"live viewer: {live_viewer.n_snaps} snapshots in {args.out}")
    if args.profile:
        import jax

        jax.profiler.stop_trace()
        print(f"profiler trace written to {args.out}/trace")

    times_sorted = sorted(times[2:] or times)
    print(f"median tracking time: {times_sorted[len(times_sorted)//2]*1e3:.1f} ms")
    print(f"mean tracking time:   {sum(times)/len(times)*1e3:.1f} ms")
    print("metrics:", system.metrics())

    os.makedirs(args.out, exist_ok=True)
    if args.viewer:
        import numpy as np

        from orbslam2_tpu.utils import viewer

        viewer.draw_map(
            system.map, os.path.join(args.out, "map.png"),
            trajectory=system.poses_wc(),
            gt_trajectory=seq.poses_wc,
        )
        f = system.tracker.last_frame
        viewer.draw_frame(
            seq.images[-1] if args.sensor != "stereo" else seq.images[-1][0],
            np.asarray(f.xy)[np.asarray(f.valid)],
            (np.asarray(system.tracker.last_bindings) >= 0)[np.asarray(f.valid)],
            os.path.join(args.out, "frame.png"),
            state_text=f"KFs {int(system.map.n_kf)}  "
                       f"points {int(system.map.pt_valid.sum())}",
        )
        print(f"viewer snapshots: {args.out}/map.png, frame.png")
    system.save_trajectory_tum(os.path.join(args.out, "CameraTrajectory.txt"))
    system.save_keyframe_trajectory_tum(
        os.path.join(args.out, "KeyFrameTrajectory.txt")
    )
    system.save_trajectory_kitti(os.path.join(args.out, "CameraTrajectory_kitti.txt"))
    print(f"trajectories written to {args.out}/")

    est = system.poses_wc()
    ate = synthetic.ate_rmse(
        est[1:], seq.poses_wc[1:], with_scale=(args.sensor == "mono")
    )
    align = "Sim3" if args.sensor == "mono" else "SE3"
    print(f"ATE RMSE ({align}-aligned): {ate:.4f} m over {args.frames} frames")
    return 0 if ate < 0.2 else 1


if __name__ == "__main__":
    raise SystemExit(main())
