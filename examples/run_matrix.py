"""Reference-scale validation MATRIX.

The reference's proof of capability is running the dataset binaries over
TUM/KITTI/EuRoC and scoring ATE with external evaluators (SURVEY.md §4).
With no datasets in this sandbox, this is the best-available substitute:
every sensor at both reference operating points, production pipeline
defaults (chunked tracking, async mapping, BA+fuse+GBA+loop closing ON),
>= 500 frames around a closed loop, scored with examples/evaluate.py.

Cells:
  sensor in {mono, stereo, rgbd}
  x (640x480 @ 1000 features  — the TUM fr1/fr2 operating point)
  x (1241x376 @ 2000 features — the KITTI stereo operating point)

Writes one JSON line per cell and a summary JSON file (--out).
Run on the GPU:  python examples/run_matrix.py
CPU smoke:               JAX_PLATFORMS=cpu python examples/run_matrix.py \
                           --frames 80 --cells mono_640
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CELLS = {
    # name: (sensor, width, height, features)
    "mono_640": ("mono", 640, 480, 1000),
    "stereo_640": ("stereo", 640, 480, 1000),
    "rgbd_640": ("rgbd", 640, 480, 1000),
    "mono_1241": ("mono", 1241, 376, 2000),
    "stereo_1241": ("stereo", 1241, 376, 2000),
    "rgbd_1241": ("rgbd", 1241, 376, 2000),
}


def run_cell(name, sensor, width, height, features, n_frames, cache_dir):
    import numpy as np

    from orbslam2_tpu.config import (
        CameraSettings, OrbSettings, Settings, TpuSettings,
    )
    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from orbslam2_tpu.ops.bow import train_vocabulary
    from orbslam2_tpu.ops.extractor import OrbExtractor
    from orbslam2_tpu.utils import synthetic

    if width >= 1000:
        # KITTI00-02.yaml operating point.
        fx = 718.856
        cam_kw = dict(fx=fx, fy=fx, cx=607.1928, cy=185.2157,
                      bf=386.1448, th_depth=35.0)
        radius, room, n_pts = 40.0, 70.0, 12000
    else:
        # TUM1.yaml operating point.
        cam_kw = dict(fx=517.306, fy=516.469, cx=318.643, cy=255.314,
                      bf=40.0, th_depth=40.0)
        # Smaller circle in a denser room: sprite coverage per view must
        # not collapse at corner-facing headings (wall-shell landmarks
        # thin out diagonally; measured mono tracking loss at ~frame 210
        # of the radius-4 / room-8 / 6k-point variant).
        radius, room, n_pts = 2.5, 5.0, 10000
    settings = Settings(
        camera=CameraSettings(width=width, height=height, **cam_kw),
        orb=OrbSettings(n_features=features, n_levels=8),
        tpu=TpuSettings(
            max_keypoints=2048 if features > 1024 else 1024,
            max_keyframes=256, max_points=65536,
        ),
    )
    cam = settings.camera_model()
    baseline = float(settings.camera.bf / settings.camera.fx)

    cache = os.path.join(cache_dir, f"matrix_{name}_{n_frames}.npz")
    if os.path.exists(cache):
        data = np.load(cache)
        images, poses_gt = data["images"], data["poses"]
        depths = data["depths"] if "depths" in data else None
    else:
        t0 = time.time()
        seq = synthetic.make_loop_sequence(
            cam, n_frames=n_frames, circle_radius=radius, n_points=n_pts,
            seed=5, room_half=room,
            stereo_baseline=(baseline if sensor == "stereo" else 0.0),
            with_depth=(sensor == "rgbd"),
        )
        images, poses_gt = seq.images, seq.poses_wc
        depths = seq.depths if sensor == "rgbd" else None
        kw = dict(images=images, poses=poses_gt)
        if depths is not None:
            kw["depths"] = depths
        np.savez_compressed(cache, **kw)
        print(f"[{name}] rendered {images.shape} in {time.time()-t0:.0f}s",
              flush=True)

    n = images.shape[0]
    first_im = images[0][0] if sensor == "stereo" else images[0]
    ex = OrbExtractor(settings.orb, settings.tpu)
    descs = np.concatenate([
        (lambda f: np.asarray(f.desc)[np.asarray(f.valid)])(
            ex(images[i][0] if sensor == "stereo" else images[i])
        )
        for i in range(0, n, max(1, n // 24))
    ])
    vocab = train_vocabulary(descs, k=10, levels=4, seed=0)

    sensor_enum = {"mono": Sensor.MONOCULAR, "stereo": Sensor.STEREO,
                   "rgbd": Sensor.RGBD}[sensor]
    sys_ = SlamSystem(
        settings, sensor_enum, vocabulary=vocab, chunk=8,
        async_mapping=True, enable_loop_closing=True,
    )
    # Precompile both mapping window buckets + the loop programs so no
    # cell pays a mid-run XLA compile.
    sys_.warm_mapping()
    import jax.numpy as jnp

    n_ok = 0
    lost = 0
    t0 = time.perf_counter()
    for i in range(n):
        if sensor == "stereo":
            sys_.track_stereo(
                jnp.asarray(images[i][0], jnp.float32),
                jnp.asarray(images[i][1], jnp.float32), i / 10.0,
            )
        elif sensor == "rgbd":
            sys_.track_rgbd(
                jnp.asarray(images[i], jnp.float32),
                jnp.asarray(depths[i], jnp.float32), i / 10.0,
            )
        else:
            sys_.track_monocular(
                jnp.asarray(images[i], jnp.float32), i / 10.0
            )
        st = sys_.tracking_state()
        lost += int(st == 2)
        n_ok += int(st == 1)
        if (i + 1) % 100 == 0:
            print(f"[{name}] frame {i+1}/{n} lost={lost}", flush=True)
    sys_.shutdown()
    dt = time.perf_counter() - t0

    est = sys_.poses_wc()
    ate = synthetic.ate_rmse(est, poses_gt, with_scale=(sensor == "mono"))
    gt_len = float(np.linalg.norm(
        np.diff(poses_gt[:, :3, 3], axis=0), axis=1).sum())
    loops = (
        [(int(a), int(b)) for a, b, _ in sys_.loop_closer.loop_edges]
        if sys_.loop_closer else []
    )
    return {
        "cell": name,
        "sensor": sensor,
        "resolution": f"{width}x{height}",
        "features": features,
        "frames": n,
        "tracked_pct": round(100.0 * n_ok / n, 2),
        "ate_rmse_m": round(float(ate), 3),
        "ate_alignment": "sim3" if sensor == "mono" else "se3",
        "drift_pct": round(100.0 * float(ate) / max(gt_len, 1e-9), 3),
        "gt_path_length_m": round(gt_len, 1),
        "fps": round(n / dt, 2),
        "kf_highwater": int(np.asarray(sys_.map.n_kf)),
        "loop_edges": loops,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--cache-dir", default="/tmp")
    ap.add_argument("--out", default=None,
                    help="summary JSON path (default out/matrix.json "
                         "under the repo root)")
    args = ap.parse_args()
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "out", "matrix.json",
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    results = []
    if os.path.exists(out):
        results = json.load(open(out))
        done = {r["cell"] for r in results}
        args.cells = [c for c in args.cells if c not in done]
        print(f"resuming: {sorted(done)} done, running {args.cells}",
              flush=True)
    for name in args.cells:
        sensor, w, h, feats = CELLS[name]
        r = run_cell(name, sensor, w, h, feats, args.frames, args.cache_dir)
        print(json.dumps(r), flush=True)
        results.append(r)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"matrix written to {out}")


if __name__ == "__main__":
    main()
