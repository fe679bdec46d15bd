"""Real-dataset drivers — the reference's Examples/ binaries as one CLI.

Maps 1:1 to the reference's driver set (SURVEY.md §2.4):
  mono_tum      -> --dataset tum      --sensor mono
  rgbd_tum      -> --dataset tum      --sensor rgbd  --assoc <file>
  mono_kitti    -> --dataset kitti    --sensor mono
  stereo_kitti  -> --dataset kitti    --sensor stereo
  mono_euroc    -> --dataset euroc    --sensor mono  --timestamps <file>
  stereo_euroc  -> --dataset euroc    --sensor stereo --timestamps <file>
                   (online rectification from the LEFT.*/RIGHT.* yaml
                   blocks, like stereo_euroc.cc's initUndistortRectifyMap)

Usage:
  python examples/run_dataset.py --dataset tum --sensor rgbd \\
      --path /data/rgbd_dataset_freiburg1_desk \\
      --assoc associations/fr1_desk.txt --settings TUM1.yaml

Prints per-frame state + median/mean tracking time (like mono_tum.cc's
exit stats) and writes CameraTrajectory/KeyFrameTrajectory files.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["tum", "kitti", "euroc"], required=True)
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"], required=True)
    ap.add_argument("--path", required=True, help="sequence directory")
    ap.add_argument("--settings", required=True, help="reference-format YAML")
    ap.add_argument("--vocabulary", default=None,
                    help="ORBvoc.txt or packed .npz (optional)")
    ap.add_argument("--assoc", default=None, help="TUM rgbd association file")
    ap.add_argument("--timestamps", default=None, help="EuRoC timestamp file")
    ap.add_argument("--out", default=".")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="lag-1 pipelined tracking (never blocks on device)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="frames per device dispatch (lax.scan chunk; "
                         "mapping resolves with lag <= chunk)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="mapping/loop closing in a worker thread (the "
                         "reference's LocalMapping/LoopClosing threads)")
    ap.add_argument("--viewer-every", type=int, default=0,
                    help="live viewer: map snapshot every N keyframes + on "
                         "each loop closure (Viewer::Run loop role)")
    ap.add_argument("--follow-radius", type=float, default=0.0,
                    help="live viewer follow-camera window half-size")
    ap.add_argument("--gt", default=None,
                    help="ground-truth trajectory (TUM groundtruth.txt or "
                         "KITTI poses file): prints ATE/RPE at exit")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from orbslam2_tpu.config import Settings
    from orbslam2_tpu.models.system import SlamSystem
    from orbslam2_tpu.utils import datasets

    settings = Settings.from_yaml(args.settings, sensor=args.sensor)

    vocabulary = None
    if args.vocabulary:
        from orbslam2_tpu.utils import vocab as vocab_io

        t0 = time.perf_counter()
        if args.vocabulary.endswith(".npz"):
            vocabulary = vocab_io.load_vocabulary(args.vocabulary)
        else:
            vocabulary = vocab_io.load_orbvoc_text(args.vocabulary)
        print(f"vocabulary loaded in {time.perf_counter() - t0:.2f} s")

    system = SlamSystem(settings, args.sensor, vocabulary=vocabulary,
                        pipeline=args.pipeline, chunk=args.chunk,
                        async_mapping=args.async_mapping)

    # --- frame source ---
    if args.dataset == "tum" and args.sensor == "rgbd":
        if not args.assoc:
            ap.error("--assoc required for TUM RGB-D")
        frames = datasets.iter_tum_rgbd(args.path, args.assoc)
        mode = "rgbd"
    elif args.dataset == "tum":
        frames = ((ts, im, None) for ts, im in datasets.iter_tum_mono(args.path))
        mode = "mono"
    elif args.dataset == "kitti":
        frames = datasets.iter_kitti(args.path, stereo=(args.sensor == "stereo"))
        mode = args.sensor
    else:  # euroc
        if not args.timestamps:
            ap.error("--timestamps required for EuRoC")
        frames = datasets.iter_euroc(
            args.path, args.timestamps, stereo=(args.sensor == "stereo")
        )
        mode = args.sensor
        rect = settings.rectification
        maps = None
        if rect is not None and args.sensor == "stereo":
            c = settings.camera
            maps = tuple(
                datasets.build_rectify_maps(
                    rect[f"{side}.K"], rect[f"{side}.D"], rect[f"{side}.R"],
                    rect[f"{side}.P"], c.width, c.height,
                )
                for side in ("LEFT", "RIGHT")
            )

    live_viewer = None
    if args.viewer_every > 0:
        from orbslam2_tpu.utils.viewer import LiveViewer

        live_viewer = LiveViewer(
            args.out, every_kf=args.viewer_every,
            follow_radius=args.follow_radius,
        )

    times = []
    n = 0
    for item in frames:
        ts, a, b = item
        t0 = time.perf_counter()
        if mode == "rgbd":
            depth = b if b is not None else a * 0
            system.track_rgbd(a, b, ts)
        elif mode == "stereo":
            if args.dataset == "euroc" and maps is not None:
                a = datasets.remap_bilinear(a, *maps[0])
                b = datasets.remap_bilinear(b, *maps[1])
            system.track_stereo(a, b, ts)
        else:
            system.track_monocular(a, ts)
        times.append(time.perf_counter() - t0)
        if live_viewer is not None:
            live_viewer.update(system)
        n += 1
        if n % 50 == 0:
            print(f"frame {n}: state {system.tracking_state()} "
                  f"metrics {system.metrics()}")
        if args.max_frames and n >= args.max_frames:
            break

    ts_sorted = sorted(times[2:] or times)
    print(f"median tracking time: {ts_sorted[len(ts_sorted)//2]*1e3:.1f} ms")
    print(f"mean tracking time:   {sum(times)/len(times)*1e3:.1f} ms")

    system.shutdown()  # drain in-flight frames + async mapping jobs
    os.makedirs(args.out, exist_ok=True)
    if live_viewer is not None:
        live_viewer.finish(system)
        print(f"live viewer: {live_viewer.n_snaps} snapshots in {args.out}")
    traj = os.path.join(args.out, "CameraTrajectory.txt")
    if args.dataset == "kitti":
        system.save_trajectory_kitti(traj)
    else:
        system.save_trajectory_tum(traj)
    system.save_keyframe_trajectory_tum(
        os.path.join(args.out, "KeyFrameTrajectory.txt")
    )
    print(f"trajectories written to {args.out}/")

    if args.gt:
        # One-command accuracy table (BASELINE.md's metric): evaluate the
        # just-written trajectory against ground truth.
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "evaluate", os.path.join(os.path.dirname(__file__), "evaluate.py")
        )
        ev = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ev)
        res = ev.evaluate_files(
            traj, args.gt,
            fmt="kitti" if args.dataset == "kitti" else "tum",
            with_scale=(args.sensor == "mono"),
        )
        align = "Sim3" if args.sensor == "mono" else "SE3"
        print(f"ATE RMSE ({align}): {res['ate_rmse_m']:.4f} m over "
              f"{res['pairs']} pairs | RPE {res['rpe_trans_rmse_m']:.4f} m "
              f"| drift {res['drift_pct']:.2f}%")


if __name__ == "__main__":
    main()
