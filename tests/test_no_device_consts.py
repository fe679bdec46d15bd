"""Regression guard: no jitted production program may close over a
device-resident jax.Array.

Such an array is baked into the executable as a constant.  Closure
constants must be numpy; jax.Arrays are fine as arguments.  See
utils/noconsts.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.config import (
    CameraSettings, OrbSettings, Settings, TpuSettings,
)
from orbslam2_tpu.models import map_state as ms
from orbslam2_tpu.utils.noconsts import device_consts


def small_settings(sensor_bf=40.0):
    return Settings(
        camera=CameraSettings(
            fx=200.0, fy=200.0, cx=64.0, cy=48.0, width=128, height=96,
            bf=sensor_bf, th_depth=40.0,
        ),
        orb=OrbSettings(n_features=64, n_levels=3),
        tpu=TpuSettings(max_keypoints=64, max_keyframes=16, max_points=512),
    )


def check(fn, *args, **kwargs):
    bad = device_consts(fn, *args, **kwargs)
    assert not bad, (
        f"program closes over {len(bad)} device array(s): "
        + ", ".join(f"{b.dtype}{list(b.shape)}" for b in bad[:8])
    )


def test_guard_detects_device_capture():
    c = jnp.arange(4.0)
    bad = device_consts(lambda x: x + c, jnp.zeros(4))
    assert len(bad) == 1
    ok = device_consts(lambda x: x + np.arange(4.0), jnp.zeros(4))
    assert not ok


@pytest.mark.parametrize("sensor", ["mono", "rgbd", "stereo"])
def test_fused_trackers_capture_free(sensor):
    from orbslam2_tpu.models.tracking import Tracker

    settings = small_settings()
    tracker = Tracker(settings)
    step = tracker._get_fused_step(sensor)
    m = ms.make_empty_map(16, 512, 64)
    tracker.last_bindings = jnp.full((64,), -1, jnp.int32)

    class _F:  # minimal last-frame stand-in for _make_ctx
        xy = jnp.zeros((64, 2))
        level = jnp.zeros((64,), jnp.int32)
        depth = jnp.full((64,), -1.0)
        desc = jnp.zeros((64, 8), jnp.uint32)
        valid = jnp.zeros((64,), bool)
        angle = jnp.zeros((64,))

    tracker.last_frame = _F()
    ctx = tracker._make_ctx()
    img = jnp.zeros((96, 128), jnp.float32)
    if sensor == "mono":
        check(step, img, m, ctx)
    else:
        check(step, img, jnp.ones((96, 128), jnp.float32), m, ctx)


def test_chunk_tracker_capture_free():
    from orbslam2_tpu.models.tracking import Tracker

    settings = small_settings()
    tracker = Tracker(settings, chunk=2)
    step = tracker._get_chunk_step("rgbd")
    m = ms.make_empty_map(16, 512, 64)
    tracker.last_bindings = jnp.full((64,), -1, jnp.int32)

    class _F:
        xy = jnp.zeros((64, 2))
        level = jnp.zeros((64,), jnp.int32)
        depth = jnp.full((64,), -1.0)
        desc = jnp.zeros((64, 8), jnp.uint32)
        valid = jnp.zeros((64,), bool)
        angle = jnp.zeros((64,))

    tracker.last_frame = _F()
    ctx = tracker._make_ctx()
    imgs = jnp.zeros((2, 96, 128), jnp.float32)
    deps = jnp.ones((2, 96, 128), jnp.float32)
    check(step, imgs, deps, m, ctx, jnp.int32(0), jnp.asarray(True))


def test_mapping_programs_capture_free():
    from orbslam2_tpu.models import local_mapping as lmod
    from orbslam2_tpu.models.local_mapping import LocalMapper
    from orbslam2_tpu.solvers.local_ba import local_bundle_adjustment

    settings = small_settings()
    lm = LocalMapper(settings, sensor="rgbd")
    m = ms.make_empty_map(16, 512, 64)
    kf = jnp.int32(1)
    check(lmod.cull_map_points, m)
    check(
        lambda m, kf: lmod.triangulate_new_points(
            m, kf, lm.cam, lm.scale_factors, lm.sigma2, n_neighbors=2
        ),
        m, kf,
    )
    check(
        lambda m, kf: lmod.fuse_with_neighbor(
            m, kf, jnp.int32(0), lm.cam, lm.scale_factors, lm.inv_sigma2
        ),
        m, kf,
    )
    check(lambda m: ms.update_point_stats(m, lm.scale_factors), m)
    check(ms.compute_distinctive_descriptors, m)
    check(
        lambda m, kf: lmod.cull_keyframes(
            m, kf, n_levels=3, bf=40.0, th_depth=40.0
        ),
        m, kf,
    )
    check(
        lambda m, kf: local_bundle_adjustment(m, kf, lm.cam, lm.inv_sigma2),
        m, kf,
    )


def test_loop_programs_capture_free():
    from orbslam2_tpu.models import loop_closing as lcmod
    from orbslam2_tpu.solvers import pose_graph as pg
    from orbslam2_tpu.solvers.global_ba import global_bundle_adjustment

    settings = small_settings()
    cam = settings.camera_model()
    m = ms.make_empty_map(16, 512, 64)
    sf = np.asarray([1.0, 1.2, 1.44], np.float32)
    check(
        lambda m: lcmod.search_by_sim3(
            m, jnp.int32(1), jnp.int32(0), jnp.eye(4), cam, sf
        ),
        m,
    )
    check(
        lambda m: lcmod.project_loop_matches(
            m, jnp.int32(1), jnp.int32(0), jnp.zeros((16,), bool),
            jnp.eye(4), cam, sf, n_cand=128,
        ),
        m,
    )
    inv_s2 = np.ones(3, np.float32)
    check(
        lambda m: global_bundle_adjustment(m, cam, inv_s2, rounds=1), m
    )
