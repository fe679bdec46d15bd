"""Multi-device tests on the virtual 8-CPU mesh: distributed BA step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.parallel import dist_ba, mesh as mesh_mod
from orbslam2_tpu.solvers import lie
from orbslam2_tpu.utils.camera import make_camera


def make_problem(n_cams=8, n_obs=64, n_pts=128, noise=0.3, perturb=0.05,
                 seed=0, stereo=False):
    rng = np.random.default_rng(seed)
    bf = 30.0 if stereo else 0.0
    cam = make_camera(300.0, 300.0, 128.0, 96.0, width=256, height=192, bf=bf)
    X = np.stack(
        [rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
         rng.uniform(5, 9, n_pts)], -1
    ).astype(np.float32)
    poses_gt, uv, pid, ok, urs = [], [], [], [], []
    for c in range(n_cams):
        xi = np.concatenate([
            [0.2 * c, 0.01 * c, 0.0], rng.normal(0, 0.02, 3)
        ]).astype(np.float32)
        T = np.asarray(lie.se3_exp(jnp.asarray(xi)))
        poses_gt.append(T)
        ids = rng.choice(n_pts, n_obs, replace=False)
        pc = X[ids] @ T[:3, :3].T + T[:3, 3]
        u = 300.0 * pc[:, 0] / pc[:, 2] + 128.0 + rng.normal(0, noise, n_obs)
        v = 300.0 * pc[:, 1] / pc[:, 2] + 96.0 + rng.normal(0, noise, n_obs)
        uv.append(np.stack([u, v], -1))
        pid.append(ids)
        ok.append(pc[:, 2] > 0)
        if stereo:
            urs.append(u - bf / pc[:, 2] + rng.normal(0, noise, n_obs))
    poses_gt = np.stack(poses_gt)
    # Perturb all non-fixed poses + points.
    poses0 = poses_gt.copy()
    for c in range(1, n_cams):
        d = rng.normal(0, perturb, 6).astype(np.float32)
        poses0[c] = np.asarray(lie.se3_exp(jnp.asarray(d))) @ poses0[c]
    X0 = X + rng.normal(0, 0.03, X.shape).astype(np.float32)
    is_fixed = np.zeros(n_cams, bool)
    is_fixed[0] = True
    prob = dist_ba.ShardedBAProblem(
        poses=jnp.asarray(poses0),
        uv=jnp.asarray(np.stack(uv), jnp.float32),
        pid=jnp.asarray(np.stack(pid), jnp.int32),
        obs_ok=jnp.asarray(np.stack(ok)),
        inv_s2=jnp.ones((n_cams, n_obs), jnp.float32),
        is_fixed=jnp.asarray(is_fixed),
        points=jnp.asarray(X0),
        ur=(jnp.asarray(np.stack(urs), jnp.float32) if stereo else None),
    )
    return prob, poses_gt, X, cam


def mean_reproj_err(prob, poses, pts, cam):
    r, _, _, _ = dist_ba._residuals_mono(
        jnp.asarray(poses), jnp.asarray(pts), prob.uv, prob.pid, cam,
        ur=prob.ur,
    )
    e = np.asarray(jnp.linalg.norm(r, axis=-1))
    return float(np.mean(e[np.asarray(prob.obs_ok)]))


def make_pose_graph(K=12, seed=0):
    """Drift-chain fixture: K poses along a line, accumulated per-step
    drift, one loop edge carrying the true 0↔K-1 relative pose."""
    from orbslam2_tpu.solvers import pose_graph

    gt = []
    for i in range(K):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -0.5 * i
        gt.append(T)
    gt = np.stack(gt)
    est = [gt[0]]
    for i in range(1, K):
        step = np.asarray(lie.se3_exp(jnp.asarray(
            np.array([-0.5 + 0.03, 0.01, 0.0, 0.0, 0.01, 0.0], np.float32))))
        est.append((step @ est[-1]).astype(np.float32))
    est = np.stack(est)
    kf_valid = jnp.ones(K, bool)
    parent = jnp.asarray(np.arange(K) - 1, jnp.int32)
    covis = jnp.zeros((K, K), jnp.int32)
    S_ji = jnp.asarray((gt[K - 1] @ np.linalg.inv(gt[0]))[None])
    edges = pose_graph.edges_from_map(
        jnp.asarray(est), kf_valid, parent, covis,
        loop_i=jnp.asarray([0], jnp.int32),
        loop_j=jnp.asarray([K - 1], jnp.int32),
        loop_S_ji=S_ji, loop_valid=jnp.asarray([True]),
    )
    fixed = jnp.zeros(K, bool).at[0].set(True)
    return gt, est, kf_valid, edges, fixed


class TestDistributedPoseGraph:
    def test_matches_single_device_and_corrects_drift(self):
        from orbslam2_tpu.parallel import dist_pose_graph
        from orbslam2_tpu.solvers import pose_graph

        assert len(jax.devices()) >= 8
        gt, est, kf_valid, edges, fixed = make_pose_graph(K=12)
        T_ref, s_ref = pose_graph.optimize_essential_graph(
            jnp.asarray(est), kf_valid, edges, fixed, iters=30,
        )
        m8 = mesh_mod.make_mesh(8)
        run = dist_pose_graph.make_distributed_pose_graph(m8, iters=30)
        T_dist, s_dist = run(jnp.asarray(est), kf_valid, edges, fixed)
        # Same math, different reduction order: near-identical results.
        np.testing.assert_allclose(np.asarray(T_dist), np.asarray(T_ref),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(s_dist), np.asarray(s_ref),
                                   atol=2e-3)
        K = gt.shape[0]
        err_before = np.linalg.norm(
            est[K - 1] @ np.linalg.inv(gt[K - 1]) - np.eye(4))
        err_after = np.linalg.norm(
            np.asarray(T_dist)[K - 1] @ np.linalg.inv(gt[K - 1]) - np.eye(4))
        assert err_after < 0.35 * err_before, (err_before, err_after)

    def test_fix_scale_pins_scales(self):
        from orbslam2_tpu.parallel import dist_pose_graph

        gt, est, kf_valid, edges, fixed = make_pose_graph(K=12)
        m8 = mesh_mod.make_mesh(8)
        run = dist_pose_graph.make_distributed_pose_graph(
            m8, iters=20, fix_scale=True)
        T_dist, s_dist = run(jnp.asarray(est), kf_valid, edges, fixed)
        np.testing.assert_allclose(np.asarray(s_dist), 1.0, atol=1e-6)


class TestDistributedBA:
    def test_step_reduces_error_on_8_devices(self):
        assert len(jax.devices()) >= 8
        m = mesh_mod.make_mesh(8)
        prob, poses_gt, X_gt, cam = make_problem(n_cams=8)
        step = dist_ba.make_distributed_ba_step(m, cam, n_total_cams=8)
        e0 = mean_reproj_err(prob, prob.poses, prob.points, cam)
        poses, pts = prob.poses, prob.points
        for _ in range(10):
            poses, pts = step(prob._replace(poses=poses, points=pts))
        e1 = mean_reproj_err(prob, poses, pts, cam)
        assert e1 < 0.3 * e0, (e0, e1)
        assert e1 < 1.0, f"final mean reproj {e1}"

    def test_stereo_step_reduces_error_on_8_devices(self):
        """ur (right-u) residuals participate in the sharded one-step
        primitive: a stereo problem's full 3-row reprojection error drops,
        which can only happen if the disparity rows are actually solved
        (round-2 advisor finding: they were silently zeroed)."""
        assert len(jax.devices()) >= 8
        m = mesh_mod.make_mesh(8)
        prob, poses_gt, X_gt, cam = make_problem(n_cams=8, stereo=True)
        assert prob.ur is not None and float(cam.bf) > 0
        step = dist_ba.make_distributed_ba_step(m, cam, n_total_cams=8)
        e0 = mean_reproj_err(prob, prob.poses, prob.points, cam)
        poses, pts = prob.poses, prob.points
        for _ in range(10):
            poses, pts = step(prob._replace(poses=poses, points=pts))
        e1 = mean_reproj_err(prob, poses, pts, cam)
        assert e1 < 0.3 * e0, (e0, e1)
        assert e1 < 1.2, f"final mean reproj {e1}"

    def test_matches_single_device_semantics(self):
        # The sharded step on 8 devices must equal the same step on 1 device.
        prob, *_ , cam = make_problem(n_cams=8, seed=3)
        m8 = mesh_mod.make_mesh(8)
        m1 = mesh_mod.make_mesh(1)
        s8 = dist_ba.make_distributed_ba_step(m8, cam, 8)
        s1 = dist_ba.make_distributed_ba_step(m1, cam, 8)
        p8, x8 = s8(prob)
        p1, x1 = s1(prob)
        # f32 cross-device reduction order shifts the last few ulps.
        np.testing.assert_allclose(np.asarray(p8), np.asarray(p1), atol=1e-3)
        np.testing.assert_allclose(np.asarray(x8), np.asarray(x1), atol=1e-3)

    def test_fixed_pose_untouched(self):
        prob, *_ , cam = make_problem(n_cams=8, seed=5)
        m = mesh_mod.make_mesh(8)
        step = dist_ba.make_distributed_ba_step(m, cam, 8)
        poses, pts = step(prob)
        np.testing.assert_allclose(
            np.asarray(poses)[0], np.asarray(prob.poses)[0], atol=1e-7
        )
        assert not np.allclose(np.asarray(poses)[3], np.asarray(prob.poses)[3])


def make_slam_map(rng, K=12, N=96, P=512, noise=0.3, perturb=0.01, pose_noise=0.02):
    """A populated MapState with consistent observations for solver parity
    tests (the same shape LocalMapper/LoopCloser hand to the BA backends)."""
    from orbslam2_tpu.models import map_state as ms

    m = ms.make_empty_map(K, P, N)
    X = np.stack(
        [rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(5, 9, P)],
        -1,
    ).astype(np.float32)
    poses, kf_xy, kf_pt = [], [], []
    cam = make_camera(300.0, 300.0, 128.0, 96.0, width=256, height=192)
    for k in range(K):
        xi = np.concatenate(
            [[0.25 * k, 0.01 * k, 0.0], rng.normal(0, pose_noise, 3)]
        ).astype(np.float32)
        T = np.asarray(lie.se3_exp(jnp.asarray(xi)))
        poses.append(T)
        ids = rng.choice(P, N, replace=False)
        pc = X[ids] @ T[:3, :3].T + T[:3, 3]
        uv = np.stack(
            [300.0 * pc[:, 0] / pc[:, 2] + 128.0,
             300.0 * pc[:, 1] / pc[:, 2] + 96.0], -1
        ) + rng.normal(0, noise, (N, 2))
        kf_xy.append(uv)
        kf_pt.append(ids)
    poses_gt = np.stack(poses)
    pp = poses_gt.copy()
    for k in range(1, K):
        d = rng.normal(0, perturb, 6).astype(np.float32)
        pp[k] = np.asarray(lie.se3_exp(jnp.asarray(d))) @ pp[k]
    m = m._replace(
        kf_pose_cw=jnp.asarray(pp),
        kf_xy=jnp.asarray(np.stack(kf_xy), jnp.float32),
        kf_point=jnp.asarray(np.stack(kf_pt), jnp.int32),
        kf_kp_valid=jnp.ones((K, N), bool),
        kf_valid=jnp.ones(K, bool),
        pt_pos=jnp.asarray(X + rng.normal(0, 0.03, X.shape).astype(np.float32)),
        pt_valid=jnp.ones(P, bool),
        n_kf=jnp.int32(K), n_pt=jnp.int32(P),
    )
    return m, poses_gt, X, cam


class TestDistributedLocalBA:
    """The pipeline-wired distributed solvers (LocalMapper/LoopCloser with
    mesh=...) must match their single-device twins — same schur_ba_core,
    collectives identity vs psum/all_gather."""

    @pytest.mark.slow
    def test_distributed_local_ba_matches_single_device(self, rng):
        from orbslam2_tpu.solvers.local_ba import local_bundle_adjustment

        m, *_ , cam = make_slam_map(rng, K=16)
        inv_s2 = jnp.ones(8)
        m1 = local_bundle_adjustment(m, jnp.int32(3), cam, inv_s2)
        m8 = dist_ba.distributed_local_ba(
            m, jnp.int32(3), mesh_mod.make_mesh(8), cam, inv_s2
        )
        np.testing.assert_allclose(
            np.asarray(m8.kf_pose_cw), np.asarray(m1.kf_pose_cw), atol=2e-4
        )
        # f32 psum reduction order can flip a borderline LM accept; the
        # surviving differences are a few mm on a handful of points.
        np.testing.assert_allclose(
            np.asarray(m8.pt_pos), np.asarray(m1.pt_pos), atol=1e-2
        )
        assert np.array_equal(np.asarray(m8.kf_point), np.asarray(m1.kf_point))
        # And it actually optimized something.
        assert not np.allclose(
            np.asarray(m8.kf_pose_cw), np.asarray(m.kf_pose_cw)
        )

    @pytest.mark.slow
    def test_distributed_joint_gba_matches_single_device(self, rng):
        from orbslam2_tpu.solvers.global_ba import run_joint_global_ba

        m, poses_gt, _, cam = make_slam_map(rng, K=16)
        inv_s2 = jnp.ones(8)
        m1 = run_joint_global_ba(m, cam, inv_s2, phase_iters=(5, 10))
        m8 = dist_ba.distributed_joint_global_ba(
            m, mesh_mod.make_mesh(8), cam, inv_s2, phase_iters=(5, 10)
        )
        np.testing.assert_allclose(
            np.asarray(m8.kf_pose_cw), np.asarray(m1.kf_pose_cw), atol=2e-4
        )
        # f32 psum reduction order can flip a borderline LM accept; the
        # surviving differences are a few mm on a handful of points.
        np.testing.assert_allclose(
            np.asarray(m8.pt_pos), np.asarray(m1.pt_pos), atol=1e-2
        )
        assert np.array_equal(np.asarray(m8.kf_point), np.asarray(m1.kf_point))
        # Both recover near-truth poses.
        terr = np.linalg.norm(
            np.asarray(m8.kf_pose_cw)[:, :3, 3] - poses_gt[:, :3, 3], axis=-1
        )
        assert float(terr.max()) < 0.05, terr

    @pytest.mark.slow
    def test_mapper_mesh_dispatch(self, rng):
        """LocalMapper(mesh=...) routes BA to the distributed solver and
        produces the same map as the single-device mapper."""
        from orbslam2_tpu.config import (
            CameraSettings, OrbSettings, Settings, TpuSettings,
        )
        from orbslam2_tpu.models.local_mapping import LocalMapper

        s = Settings(
            camera=CameraSettings(fx=300.0, fy=300.0, cx=128.0, cy=96.0,
                                  width=256, height=192),
            orb=OrbSettings(n_features=128, n_levels=4),
            tpu=TpuSettings(max_keypoints=96, max_keyframes=16,
                            max_points=512),
        )
        m, *_ = make_slam_map(rng, K=16)
        lm1 = LocalMapper(s, sensor="rgbd", enable_fuse=False)
        lm8 = LocalMapper(s, sensor="rgbd", enable_fuse=False,
                          mesh=mesh_mod.make_mesh(8))
        assert lm8.mesh is not None
        out1 = lm1._local_ba(m, jnp.int32(3))
        out8 = lm8._local_ba(m, jnp.int32(3))
        np.testing.assert_allclose(
            np.asarray(out8.kf_pose_cw), np.asarray(out1.kf_pose_cw),
            atol=2e-4,
        )


class TestShardedLiveMap:
    """Shard the LIVE MapState (keyframe blocks), not
    only the solvers' internals — mapping programs must produce the same
    map when their inputs are placed on an 8-device mesh under GSPMD."""

    def test_shard_map_state_placement(self, rng):
        from orbslam2_tpu.parallel.distributed import (
            map_state_shardings, shard_map_state,
        )

        m, *_ = make_slam_map(rng, K=16)
        mesh = mesh_mod.make_mesh(8)
        m_sh = shard_map_state(m, mesh)
        # Keyframe pools sharded over the map axis, points replicated.
        assert not m_sh.kf_pose_cw.sharding.is_fully_replicated
        assert m_sh.pt_pos.sharding.is_fully_replicated
        np.testing.assert_array_equal(
            np.asarray(m_sh.kf_point), np.asarray(m.kf_point)
        )

    def test_process_keyframe_on_sharded_map_matches(self, rng):
        from orbslam2_tpu.config import (
            CameraSettings, OrbSettings, Settings, TpuSettings,
        )
        from orbslam2_tpu.models.local_mapping import LocalMapper
        from orbslam2_tpu.parallel.distributed import shard_map_state

        s = Settings(
            camera=CameraSettings(fx=300.0, fy=300.0, cx=128.0, cy=96.0,
                                  width=256, height=192),
            orb=OrbSettings(n_features=96, n_levels=4),
            tpu=TpuSettings(max_keypoints=96, max_keyframes=16,
                            max_points=512),
        )
        m, *_ = make_slam_map(rng, K=16)
        lm = LocalMapper(s, sensor="mono")
        out1 = lm.process_keyframe(m, 3)

        mesh = mesh_mod.make_mesh(8)
        m_sh = shard_map_state(m, mesh)
        out8 = lm.process_keyframe(m_sh, 3)
        # GSPMD partitioning of the same programs: same map, to f32
        # reduction-order noise.
        np.testing.assert_allclose(
            np.asarray(out8.kf_pose_cw), np.asarray(out1.kf_pose_cw),
            atol=2e-4,
        )
        np.testing.assert_allclose(
            np.asarray(out8.pt_pos), np.asarray(out1.pt_pos), atol=2e-3
        )
        np.testing.assert_array_equal(
            np.asarray(out8.kf_valid), np.asarray(out1.kf_valid)
        )

    def test_initialize_distributed_single_process_noop(self):
        from orbslam2_tpu.parallel.distributed import initialize_distributed

        assert initialize_distributed(num_processes=1) is False
