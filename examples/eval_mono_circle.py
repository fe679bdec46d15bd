"""Mono circle-sequence evaluation — tracks the rotation-dominant 84-frame
circular trajectory monocularly and reports lost-frame count + Sim3 ATE.

This is a stress fixture: mono tracking can lose lock on the most
rotation-dominant arc.  Used to quantify front-end changes like
the 2x-feature init extractor (mpIniORBextractor, Tracking.cc:≈150).

Usage: JAX_PLATFORMS=cpu python examples/eval_mono_circle.py [--frames 84]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=84)
    ap.add_argument("--radius", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--fuse", action="store_true")
    ap.add_argument("--points", type=int, default=500)
    args = ap.parse_args()

    from orbslam2_tpu.config import (
        CameraSettings, OrbSettings, Settings, TpuSettings,
    )
    from orbslam2_tpu.models.system import SlamSystem, Sensor
    from orbslam2_tpu.utils import synthetic

    settings = Settings(
        camera=CameraSettings(
            fx=320.0, fy=320.0, cx=160.0, cy=120.0,
            k1=0, k2=0, p1=0, p2=0, k3=0,
            width=320, height=240, bf=0.0, th_depth=40.0,
            depth_map_factor=1.0,
        ),
        orb=OrbSettings(n_features=800, n_levels=4),
        tpu=TpuSettings(),
    )
    cam = settings.camera_model()
    seq = synthetic.make_loop_sequence(
        cam, n_frames=args.frames, circle_radius=args.radius,
        with_depth=False, seed=args.seed, n_points=args.points,
    )

    sys_ = SlamSystem(settings, Sensor.MONOCULAR)
    if args.no_ba:
        sys_.local_mapper.enable_ba = False
    if args.fuse:
        sys_.local_mapper.enable_fuse = True
    states = []
    t0 = time.time()
    for i in range(args.frames):
        sys_.track_monocular(seq.images[i], seq.timestamps[i])
        states.append(int(sys_.tracking_state()))
    wall = time.time() - t0

    lost = states.count(2)
    ok = states.count(1)
    try:
        ate = synthetic.ate_rmse(sys_.poses_wc(), seq.poses_wc, with_scale=True)
    except Exception as e:  # too few tracked poses to align
        ate = float("nan")
        print(f"ATE alignment failed: {e}")
    print(
        f"frames={args.frames} ok={ok} lost={lost} "
        f"ate_sim3={ate:.3f} wall={wall:.1f}s"
    )
    print("states:", "".join(str(s) for s in states))


if __name__ == "__main__":
    main()
