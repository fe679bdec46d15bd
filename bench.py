"""Benchmark: whole-pipeline SLAM throughput on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline: the reference's tracking-thread time on an i7-4790 CPU is
~25-40 ms/frame at 640x480 with 1000 features (TRO'17 Table V; SURVEY.md
§6), i.e. ~33 fps, with LocalMapping + LoopClosing running concurrently on
other cores.  vs_baseline = our_fps / 33.

What is measured (keyframes enabled, the full production pipeline):

  * a 640x480 / 1000-feature synthetic RGB-D sequence (landmark sprites +
    textured background plane) tracked end-to-end through the chunked
    production driver (SlamSystem(chunk=8)): C strictly-serial frames per
    device dispatch via lax.scan — frames are never batched;
  * the on-device keyframe decision + insertion runs every frame; fired
    keyframes are resolved by the host and handed to the async mapping
    pipeline (models/async_pipeline.py — the reference's LocalMapping/
    LoopClosing thread split): culling, triangulation, fuse, local BA and
    loop detection all run during the timed window, interleaved with
    tracking on the same device;
  * timing covers every frame from sequence start (post-warmup reset) to
    shutdown() (drains the last mapping job).

Frames are uploaded to the device before the timed passes, so host->device
ingest is not in the per-frame loop.

Run on the GPU, one process per card:  python bench.py
"""

from __future__ import annotations

import json
import time

import numpy as np

BASELINE_FPS = 33.0
import os as _os
CHUNK = int(_os.environ.get("ORB_BENCH_CHUNK", "8"))
N_FRAMES = int(_os.environ.get("ORB_BENCH_FRAMES", "96"))


def build_settings():
    """TUM-class 640x480 / 1000-feature settings, pools of 128 KF / 16k
    points."""
    from orbslam2_tpu.config import (
        CameraSettings, OrbSettings, Settings, TpuSettings,
    )

    return Settings(
        camera=CameraSettings(
            fx=517.3, fy=516.5, cx=318.6, cy=255.3,
            width=640, height=480, bf=40.0, th_depth=40.0,
        ),
        orb=OrbSettings(n_features=1000, n_levels=8),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=128, max_points=16384),
    )


def build():
    import jax.numpy as jnp

    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from orbslam2_tpu.utils import synthetic

    settings = build_settings()
    cam = settings.camera_model()
    seq = synthetic.make_sequence(
        cam, n_frames=N_FRAMES, n_points=1500, with_depth=True, seed=0,
        radius=0.35, forward=2.0,
    )
    imgs = [jnp.asarray(im, jnp.float32) for im in seq.images]
    deps = [jnp.asarray(d, jnp.float32) for d in seq.depths]

    def make_system():
        return SlamSystem(
            settings, Sensor.RGBD, chunk=CHUNK, async_mapping=True,
            enable_loop_closing=True,
        )

    return make_system, imgs, deps, seq


def run(sys, imgs, deps):
    for i in range(len(imgs)):
        sys.track_rgbd(imgs[i], deps[i], float(i) / 30.0)
    sys.shutdown()


def secondary_metrics(sys, imgs):
    """BASELINE.json's other north-star metrics, measured on the device
    after the warmup pass: ORB extraction latency and BA iterations/sec at the
    production local-BA window.  Printed as extra
    JSON lines BEFORE the primary metric (the driver parses the last
    line)."""
    import jax
    import jax.numpy as jnp

    from orbslam2_tpu.solvers.local_ba import local_bundle_adjustment

    tr = sys.tracker
    # --- extract_ms_per_frame: the reference budget is 11-15 ms/image
    # (TRO'17 Table V; ORBextractor.cc:≈1000). ---
    ex = tr.extractor
    feats = ex(imgs[0])
    jax.block_until_ready(feats.desc)  # compile
    t0 = time.perf_counter()
    n_it = 20
    for i in range(n_it):
        feats = ex(imgs[i % len(imgs)])
    jax.block_until_ready(feats.desc)
    extract_ms = (time.perf_counter() - t0) / n_it * 1e3
    print(json.dumps({
        "metric": "extract_ms_per_frame_640x480_1000feat",
        "value": round(extract_ms, 2),
        "unit": "ms/image",
        "vs_baseline": round(13.0 / max(extract_ms, 1e-9), 3),
    }))

    # --- ba_iterations_per_sec: the large local-BA bucket (32 free + 16
    # fixed cameras) on the warmed map; each call runs 5+10 LM iterations
    # (Optimizer.cc:≈460's schedule). ---
    m = tr.map
    tpu = tr.settings.tpu
    kf = jnp.int32(max(int(jax.device_get(m.n_kf)) - 1, 0))
    kwargs = dict(
        n_local=tpu.ba_local_window, n_fixed=tpu.ba_fixed_window,
        phase_iters=(5, 10),
    )
    out = local_bundle_adjustment(m, kf, tr.cam, tr.inv_sigma2, **kwargs)
    jax.block_until_ready(out.kf_pose_cw)  # compile
    iters_per_call = 15
    t0 = time.perf_counter()
    n_calls = 5
    for _ in range(n_calls):
        out = local_bundle_adjustment(
            m, kf, tr.cam, tr.inv_sigma2, **kwargs
        )
    jax.block_until_ready(out.kf_pose_cw)
    dt = time.perf_counter() - t0
    ba_ips = n_calls * iters_per_call / dt
    # Reference class: local BA ~100-300 ms for 15 iterations on the i7
    # (TRO'17 Table V) -> ~50-150 LM iterations/sec.
    print(json.dumps({
        "metric": "ba_iterations_per_sec_local32+16",
        "value": round(ba_ips, 1),
        "unit": "LM iters/sec",
        "vs_baseline": round(ba_ips / 100.0, 3),
    }))


def main():
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    make_system, imgs, deps, seq = build()

    # Warmup pass: compiles the chunk tracker + every mapping/loop program
    # on the shapes the timed pass will use.
    # Half the sequence suffices to compile the chunk tracker + resolution
    # + adoption paths; warm_mapping() then precompiles BOTH window-bucket
    # variants of every mapping stage and the loop-detection/verification
    # programs (keyframe ids drift run to run, and a bucket boundary first
    # crossed mid-run would pay a compile inside the timed window).
    sys = make_system()
    run(sys, imgs[: len(imgs) // 2], deps[: len(deps) // 2])
    kf_warm = sys.tracker.metrics["keyframes_created"]
    sys.warm_mapping()
    secondary_metrics(sys, imgs)
    # One full throwaway pass before the counted ones, so that no counted
    # pass pays a first-use cost (allocator growth, a late compile).
    run(make_system(), imgs, deps)

    # Median of 5 timed passes: one bad pass (stray host load) must not
    # halve the official number.
    import sys as _sys

    fps_runs = []
    for _ in range(5):
        sys = make_system()
        t0 = time.perf_counter()
        run(sys, imgs, deps)
        dt = time.perf_counter() - t0

        n_kf = sys.tracker.metrics["keyframes_created"]
        jobs = sys.mapping_pipeline.jobs_run if sys.mapping_pipeline else 0
        assert n_kf >= 3 and jobs >= 3, (
            f"bench must exercise keyframes+mapping (kf={n_kf}, "
            f"jobs={jobs}, warm kf={kf_warm})"
        )
        print(
            f"# pass: {len(imgs) / dt:.2f} fps, kf={n_kf}, jobs={jobs}",
            file=_sys.stderr,
        )
        fps_runs.append(len(imgs) / dt)
    fps = float(np.median(fps_runs))

    print(
        json.dumps(
            {
                "metric": "slam_pipeline_fps_640x480_1000feat_kf_on",
                "value": round(fps, 2),
                "unit": "frames/sec/chip",
                "vs_baseline": round(fps / BASELINE_FPS, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
