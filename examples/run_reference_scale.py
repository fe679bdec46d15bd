"""Reference-scale end-to-end run: a KITTI-class synthetic sequence at
production configuration.

1000+ frames at 1241x376 / 2000 features (the reference's stereo_kitti
operating point, Examples/Stereo/stereo_kitti.cc + KITTI00-02.yaml),
driving a full circle with a loop closure at the end, through the
PRODUCTION pipeline defaults: chunked tracking, async mapping with local
BA ON, fuse ON, GBA ON, loop closing ON.  The trajectory is exported in
KITTI format and scored with the examples/evaluate.py ATE implementation
(the TUM/KITTI-compatible evaluator) against the generated ground truth.

Reports: tracked-frame %, ATE, fps, keyframe/point pool high-water marks,
loop edges, and per-100-frame wall costs (flatness = no per-frame cost
growth with map size).

Run (GPU): python examples/run_reference_scale.py
Run (CPU smoke): JAX_PLATFORMS=cpu python examples/run_reference_scale.py \
    --frames 120 --width 320 --height 96 --features 512

The rendered sequence is cached under /tmp (rendering 1000 KITTI-size
stereo pairs on the host takes minutes; the cache makes re-runs cheap).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--cache", default="/tmp/refscale_seq.npz")
    ap.add_argument("--out", default="/tmp/refscale")
    args = ap.parse_args()

    import numpy as np

    from orbslam2_tpu.config import (
        CameraSettings, OrbSettings, Settings, TpuSettings,
    )
    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from orbslam2_tpu.ops.bow import train_vocabulary
    from orbslam2_tpu.ops.extractor import OrbExtractor
    from orbslam2_tpu.utils import synthetic

    # KITTI00-02.yaml operating point (scaled intrinsics for other sizes).
    sx = args.width / 1241.0
    settings = Settings(
        camera=CameraSettings(
            fx=718.856 * sx, fy=718.856 * sx,
            cx=607.1928 * sx, cy=185.2157 * args.height / 376.0,
            width=args.width, height=args.height,
            bf=386.1448 * sx, th_depth=35.0,
        ),
        orb=OrbSettings(n_features=args.features, n_levels=8),
        tpu=TpuSettings(
            max_keypoints=2048 if args.features > 1024 else 1024,
            max_keyframes=256, max_points=65536,
        ),
    )
    cam = settings.camera_model()
    baseline = float(settings.camera.bf / settings.camera.fx)

    if os.path.exists(args.cache):
        data = np.load(args.cache)
        images, poses_gt = data["images"], data["poses"]
        print(f"loaded cached sequence {images.shape} from {args.cache}")
    else:
        t0 = time.time()
        seq = synthetic.make_loop_sequence(
            cam, n_frames=args.frames, circle_radius=40.0,
            n_points=12000, seed=args.seed, stereo_baseline=baseline,
            room_half=70.0,
        )
        images, poses_gt = seq.images, seq.poses_wc
        np.savez_compressed(args.cache, images=images, poses=poses_gt)
        print(f"rendered {images.shape} in {time.time()-t0:.0f}s")

    n = images.shape[0]
    ex = OrbExtractor(settings.orb, settings.tpu)
    descs = np.concatenate([
        (lambda f: np.asarray(f.desc)[np.asarray(f.valid)])(
            ex(images[i][0])
        )
        for i in range(0, n, max(1, n // 24))
    ])
    vocab = train_vocabulary(descs, k=10, levels=4, seed=0)

    sys_ = SlamSystem(
        settings, Sensor.STEREO, vocabulary=vocab, chunk=8,
        async_mapping=True, enable_loop_closing=True,
    )
    import jax.numpy as jnp

    lost = 0
    kf_hw = pt_hw = 0
    seg_times = []
    t_seg = time.perf_counter()
    t0 = time.perf_counter()
    for i in range(n):
        sys_.track_stereo(
            jnp.asarray(images[i][0], jnp.float32),
            jnp.asarray(images[i][1], jnp.float32),
            i / 10.0,
        )
        lost += int(sys_.tracking_state() == 2)
        if (i + 1) % 100 == 0:
            seg_times.append(time.perf_counter() - t_seg)
            t_seg = time.perf_counter()
            kf_hw = max(kf_hw, int(np.asarray(sys_.map.n_kf)))
            pt_hw = max(
                pt_hw, int(np.asarray(sys_.map.pt_valid).sum())
            )
            print(f"frame {i+1}/{n}: seg={seg_times[-1]:.1f}s "
                  f"kf_hw={kf_hw} pt_hw={pt_hw} lost={lost}", flush=True)
    sys_.shutdown()
    dt = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    est_path = os.path.join(args.out, "CameraTrajectory.txt")
    gt_path = os.path.join(args.out, "gt_kitti.txt")
    sys_.save_trajectory_kitti(est_path)
    with open(gt_path, "w") as f:
        for T in poses_gt:
            f.write(" ".join(f"{v:.6e}" for v in T[:3].reshape(-1)) + "\n")

    # Score through the standalone evaluator (the external-tool role the
    # reference delegates to the KITTI devkit / TUM scripts).
    from evaluate import evaluate_files

    ev = evaluate_files(est_path, gt_path, fmt="kitti")
    ate = ev["ate_rmse_m"]
    loops = (
        [(a, b) for a, b, _ in sys_.loop_closer.loop_edges]
        if sys_.loop_closer else []
    )
    report = {
        "frames": n,
        "tracked_pct": round(100.0 * (n - lost) / n, 2),
        "ate_rmse_m": round(float(ate), 3),
        "fps": round(n / dt, 2),
        "kf_highwater": kf_hw,
        "pt_highwater": pt_hw,
        "loop_edges": loops,
        "seg_seconds_per_100": [round(t, 1) for t in seg_times],
        "compactions": sys_.tracker.metrics.get("compactions", 0),
        "drift_pct": round(ev["drift_pct"], 2),
        "gt_path_length_m": round(ev["gt_path_length_m"], 1),
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
