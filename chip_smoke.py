"""Smoke test of the whole SLAM pipeline on one GPU.

Run from the repository root:  python chip_smoke.py

Drives the public API (SlamSystem, the chunked tracker, async mapping and
loop closing) at full width, one phase after another:

  device  the JAX backend must be "gpu"; no CPU fallback
  rgbd    bench.py's TUM-class 640x480 / 1000-feature RGB-D sequence
  stereo  KITTI widths: 1241x376, 2000 features, keypoint capacity 2048
  mono    640x480 monocular, through the two-view initializer
  loop    the RGB-D loop circle; then joint GBA and the essential graph

Every line but the last is a JSON object carrying the card's name and
power limit (nvidia-smi); the first also holds nvidia-smi's own line.  A
failed gate raises, so the process exits non-zero and the final line
``{"ok": true, "device": {...}}`` is printed only when every phase passed.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

# ATE RMSE (m) of the rgbd phase's sequence on the CPU backend, measured
# once with the same code; the GPU run must stay within 1.5x + 0.01 m.
CPU_RGBD_ATE = 0.01645

_CARD = {}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **_CARD, **fields}), flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(",", 1))
    _CARD.update(gpu=name, power_limit=limit)
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed(fn, *args, n: int = 20):
    """(first-call seconds, steady mean seconds, result) of a jitted fn."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / n, out


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    """No CPU fallback: anything but a GPU backend ends the run before a
    line is printed."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not a GPU")
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache

    raw = card_identity()
    print(json.dumps({"nvidia_smi": raw, **_CARD}), flush=True)
    emit("device", platform=jax.devices()[0].platform,
         kind=jax.devices()[0].device_kind, count=len(jax.devices()),
         jax=jax.__version__, compile_cache=enable_compile_cache())


def _rgbd_run(make_system, imgs, deps):
    from bench import run

    t0 = time.perf_counter()
    sys_ = make_system()
    run(sys_, imgs, deps)
    return sys_, time.perf_counter() - t0


def phase_rgbd():
    import jax.numpy as jnp

    from bench import build
    from orbslam2_tpu.solvers.local_ba import local_bundle_adjustment
    from orbslam2_tpu.utils import synthetic

    make_system, imgs, deps, seq = build()
    sys_, first = _rgbd_run(make_system, imgs, deps)
    t0 = time.perf_counter()
    sys_.warm_mapping()
    warm = time.perf_counter() - t0
    sys_, wall = _rgbd_run(make_system, imgs, deps)

    tr = sys_.tracker
    n_kf = tr.metrics["keyframes_created"]
    jobs = sys_.mapping_pipeline.jobs_run
    tracked = 1.0 - tr.metrics["frames_lost"] / max(tr.metrics["frames"], 1)
    ate = synthetic.ate_rmse(sys_.poses_wc(), seq.poses_wc)

    # LM iterations/s at the production local-BA window, and one whole
    # mapping job (culling, triangulation, fuse, local BA) on the final map.
    m, s = tr.map, tr.settings.tpu
    kf = jnp.int32(max(int(m.n_kf) - 1, 0))
    kw = dict(n_local=s.ba_local_window, n_fixed=s.ba_fixed_window,
              phase_iters=(5, 10))
    ba_first, ba_s, _ = timed(
        lambda: local_bundle_adjustment(m, kf, tr.cam, tr.inv_sigma2, **kw),
        n=5,
    )
    lm = sys_.local_mapper
    map_first, map_s, _ = timed(lambda: lm.process_keyframe(m, int(kf)), n=3)

    gate = 1.5 * CPU_RGBD_ATE + 0.01
    emit("rgbd", frames=len(imgs), wall_s=wall, first_call_s=first,
         warm_mapping_s=warm, fps=len(imgs) / wall, keyframes=n_kf,
         mapping_jobs=jobs, tracked=tracked, ate_m=ate,
         cpu_ate_m=CPU_RGBD_ATE, ate_gate_m=gate,
         ba_lm_iters_per_s=15 / ba_s, ba_first_call_s=ba_first,
         mapping_job_ms=map_s * 1e3, mapping_first_call_s=map_first)
    check(n_kf >= 3 and jobs >= 3, f"rgbd: kf={n_kf} jobs={jobs}")
    check(tracked >= 0.9, f"rgbd: tracked {tracked:.3f}")
    check(ate <= gate, f"rgbd: ATE {ate:.4f} > {gate:.4f}")


def _track_all(sys_, frames, step):
    """Track every frame; (states, tracked share, wall s, first-frame s)."""
    import jax

    from orbslam2_tpu.models.tracking import TrackState

    states = []
    t0 = time.perf_counter()
    first = None
    for i, fr in enumerate(frames):
        step(sys_, fr, i)
        if first is None:
            jax.block_until_ready(sys_.map.kf_pose_cw)
            first = time.perf_counter() - t0
        states.append(sys_.tracking_state())
    sys_.shutdown()
    wall = time.perf_counter() - t0
    ok = sum(s == TrackState.OK for s in states)
    return states, ok / len(states), wall, first


def phase_stereo():
    from orbslam2_tpu.config import (
        CameraSettings, OrbSettings, Settings, TpuSettings,
    )
    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from orbslam2_tpu.utils import synthetic

    # KITTI00-02.yaml operating point.
    fx = 718.856
    settings = Settings(
        camera=CameraSettings(fx=fx, fy=fx, cx=607.1928, cy=185.2157,
                              width=1241, height=376, bf=386.1448,
                              th_depth=35.0),
        orb=OrbSettings(n_features=2000, n_levels=8),
        tpu=TpuSettings(max_keypoints=2048, max_keyframes=64,
                        max_points=16384),
    )
    cam = settings.camera_model()
    seq = synthetic.make_sequence(
        cam, n_frames=16, n_points=3000, seed=13,
        stereo_baseline=settings.camera.bf / fx, radius=0.15, forward=0.4,
    )
    sys_ = SlamSystem(settings, Sensor.STEREO)
    states, tracked, wall, first = _track_all(
        sys_, seq.images,
        lambda s, fr, i: s.track_stereo(fr[0], fr[1], seq.timestamps[i]),
    )
    ate = synthetic.ate_rmse(sys_.poses_wc(), seq.poses_wc)
    emit("stereo", frames=len(states), wall_s=wall, first_call_s=first,
         tracked=tracked, ate_m=ate, keyframes=int(sys_.map.n_kf))
    check(tracked >= 0.9, f"stereo: tracked {tracked:.3f} {states}")


def phase_mono():
    from bench import build_settings
    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from orbslam2_tpu.models.tracking import TrackState
    from orbslam2_tpu.utils import synthetic

    settings = build_settings()
    seq = synthetic.make_sequence(
        settings.camera_model(), n_frames=16, n_points=1500, seed=7,
        radius=0.15, forward=0.3,
    )
    sys_ = SlamSystem(settings, Sensor.MONOCULAR)
    states, tracked, wall, first = _track_all(
        sys_, seq.images,
        lambda s, fr, i: s.track_monocular(fr, seq.timestamps[i]),
    )
    n_kf = int(sys_.map.n_kf)
    emit("mono", frames=len(states), wall_s=wall, first_call_s=first,
         tracked=tracked, keyframes=n_kf, states=[int(s) for s in states])
    check(n_kf >= 2, f"mono: map not initialized ({n_kf} keyframes)")
    check(states[-1] == TrackState.OK, f"mono: not OK at end {states}")


def phase_loop():
    """The RGB-D loop circle of tests/test_slam_e2e.py (BA and fuse off so
    odometry drifts enough that only BoW + Sim3 can close the loop), then
    joint GBA and the essential graph once on the final map."""
    import jax
    import jax.numpy as jnp

    from orbslam2_tpu.config import (
        CameraSettings, OrbSettings, Settings, TpuSettings,
    )
    from orbslam2_tpu.models import map_state as ms
    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from orbslam2_tpu.ops.bow import train_vocabulary
    from orbslam2_tpu.ops.extractor import OrbExtractor
    from orbslam2_tpu.solvers import pose_graph as pg
    from orbslam2_tpu.solvers.global_ba import run_joint_global_ba
    from orbslam2_tpu.utils import synthetic

    s = Settings(
        camera=CameraSettings(fx=320.0, fy=320.0, cx=160.0, cy=120.0,
                              width=320, height=240, bf=160.0, th_depth=40.0,
                              depth_map_factor=1.0),
        orb=OrbSettings(n_features=800, n_levels=4),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=96,
                        max_points=8192, min_init_matches=50),
    )
    n = 84
    seq = synthetic.make_loop_sequence(
        s.camera_model(), n_frames=n, circle_radius=1.5, with_depth=True,
        seed=5,
    )
    ex = OrbExtractor(s.orb, s.tpu)
    descs = np.concatenate([
        np.asarray(f.desc)[np.asarray(f.valid)]
        for f in (ex(seq.images[i]) for i in range(0, n, 6))
    ])
    vocab = train_vocabulary(descs, k=10, levels=4, seed=0)
    sys_ = SlamSystem(s, Sensor.RGBD, vocabulary=vocab)
    sys_.local_mapper.enable_ba = False
    sys_.local_mapper.enable_fuse = False
    states, tracked, wall, first = _track_all(
        sys_, range(n),
        lambda s_, i, _: s_.track_rgbd(seq.images[i], seq.depths[i],
                                       seq.timestamps[i]),
    )
    ate = synthetic.ate_rmse(sys_.poses_wc(), seq.poses_wc)
    edges = sys_.loop_closer.loop_edges
    m = sys_.map
    n_kf = int(m.n_kf)
    span = (edges[0][1] - edges[0][0]) if edges else 0
    emit("loop", frames=n, wall_s=wall, first_call_s=first, tracked=tracked,
         ate_m=ate, loop_edges=[(int(a), int(b)) for a, b, _ in edges],
         keyframes=n_kf)
    check(bool(edges), "loop: no loop edge fired")
    check(span > 0.5 * n_kf, f"loop: edge span {span} of {n_kf} keyframes")
    check(ate < 0.5, f"loop: ATE {ate:.3f}")

    tr = sys_.tracker
    t0 = time.perf_counter()
    m_gba = run_joint_global_ba(m, tr.cam, tr.inv_sigma2)
    jax.block_until_ready(m_gba.pt_pos)
    gba_s = time.perf_counter() - t0
    a, b, S = edges[0]
    eg = pg.edges_from_map(
        m.kf_pose_cw, m.kf_valid, m.kf_parent, ms.covisibility(m),
        loop_i=jnp.asarray([a], jnp.int32),
        loop_j=jnp.asarray([b], jnp.int32),
        loop_S_ji=jnp.asarray(np.asarray(S)[None], jnp.float32),
        loop_valid=jnp.asarray([True]), min_covis_weight=100,
    )
    fixed = jnp.zeros(m.kf_capacity, bool).at[a].set(True)
    t0 = time.perf_counter()
    T_new, scales = pg.optimize_essential_graph(
        m.kf_pose_cw, m.kf_valid, eg, fixed, iters=20, fix_scale=True,
    )
    jax.block_until_ready(T_new)
    eg_s = time.perf_counter() - t0
    finite = {
        "gba_poses": bool(jnp.isfinite(m_gba.kf_pose_cw).all()),
        "gba_points": bool(jnp.isfinite(m_gba.pt_pos).all()),
        "eg_poses": bool(jnp.isfinite(T_new).all()),
        "eg_scales": bool(jnp.isfinite(scales).all()),
    }
    emit("loop_solvers", gba_first_call_s=gba_s, essential_graph_first_call_s=eg_s,
         finite=finite)
    check(all(finite.values()), f"loop solvers not finite: {finite}")


PHASES = (phase_rgbd, phase_stereo, phase_mono, phase_loop)


def main() -> None:
    import jax

    phase_device()
    for phase in PHASES:
        t0 = time.perf_counter()
        phase()
        emit(phase.__name__[len("phase_"):] + "_done",
             phase_s=time.perf_counter() - t0)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
