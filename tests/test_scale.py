"""KITTI-class capacity: the per-frame map ops must hold at 2048 keyframes
/ 131072 points (KITTI 00 needs ~1.3k live KFs, >100k pts).

These tests exercise the SEGMENT-OP formulations (no (P, K) observation
matrix on any per-frame path) at full capacity, check them against the
dense reference implementation at small scale, and run the large-K CG
essential graph.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orbslam2_tpu.models import map_state as ms


def _random_map(K, P, N, n_kf, obs_per_kf, seed=0):
    rng = np.random.default_rng(seed)
    m = ms.make_empty_map(K, P, N)
    kf_point = np.full((K, N), -1, np.int64)
    for k in range(n_kf):
        # Each keyframe observes a contiguous-ish window of points (SLAM
        # locality), no duplicates within a row.
        base = (k * obs_per_kf) // 2
        ids = (base + rng.choice(obs_per_kf * 2, obs_per_kf, replace=False)) % P
        slots = rng.choice(N, obs_per_kf, replace=False)
        kf_point[k, slots] = ids
    pt_valid = np.zeros(P, bool)
    pt_valid[np.unique(kf_point[kf_point >= 0])] = True
    m = m._replace(
        kf_point=jnp.asarray(kf_point, jnp.int32),
        kf_kp_valid=jnp.asarray(np.arange(K)[:, None] < n_kf).repeat(N, 1),
        kf_valid=jnp.asarray(np.arange(K) < n_kf),
        pt_valid=jnp.asarray(pt_valid),
        pt_pos=jnp.asarray(rng.normal(0, 2, (P, 3)), jnp.float32),
        pt_ref_kf=jnp.asarray(rng.integers(0, max(n_kf, 1), P), jnp.int32),
        n_kf=jnp.int32(n_kf),
    )
    return m


class TestSegmentOpsMatchDense:
    """Small scale: segment-op results == dense observation-matrix results."""

    def setup_method(self):
        self.m = _random_map(K=16, P=512, N=64, n_kf=12, obs_per_kf=40)

    def test_covisible_row_matches_dense(self):
        B = np.asarray(ms.observation_matrix(self.m))
        W_dense = (B.T @ B)
        np.fill_diagonal(W_dense, 0)
        for k in (0, 3, 11):
            row = np.asarray(ms.covisible_row(self.m, jnp.int32(k)))
            np.testing.assert_array_equal(row, W_dense[k].astype(np.int32))

    def test_chunked_covisibility_matches_dense(self):
        B = np.asarray(ms.observation_matrix(self.m))
        W_dense = (B.T @ B).astype(np.int32)
        np.fill_diagonal(W_dense, 0)
        W = np.asarray(ms.covisibility(self.m, chunk=128))  # forces 4 chunks
        np.testing.assert_array_equal(W, W_dense)

    def test_counts_and_seen_by(self):
        B = np.asarray(ms.observation_matrix(self.m))
        counts = np.asarray(ms.point_observation_counts(self.m))
        np.testing.assert_array_equal(counts, B.sum(1).astype(np.int32))
        mask = np.zeros(16, bool)
        mask[[2, 5]] = True
        seen = np.asarray(ms.points_seen_by(self.m, jnp.asarray(mask)))
        np.testing.assert_array_equal(seen, B[:, mask].sum(1) > 0)


class TestCapacityOps:
    """Full KITTI-class capacity: ops compile + run, O(K*N + P) memory."""

    K, P, N = 2048, 131072, 1024

    @pytest.fixture(scope="class")
    def big_map(self):
        return _random_map(
            self.K, self.P, self.N, n_kf=1500, obs_per_kf=300, seed=1
        )

    def test_per_frame_ops_at_capacity(self, big_map):
        m = big_map
        row = ms.covisible_row(m, jnp.int32(700))
        assert int(row.max()) > 0  # locality => strong neighbors exist
        counts = ms.point_observation_counts(m)
        assert int(counts.max()) >= 2
        seen = ms.points_seen_by(
            m, jnp.asarray(np.arange(self.K) % 97 == 0)
        )
        assert bool(seen.any())
        ids, w = ms.best_covisible(m, jnp.int32(700), 16)
        assert ids.shape == (16,)
        m2 = ms.update_point_stats(m)
        jax.block_until_ready(m2.pt_normal)

    def test_gather_local_points_at_capacity(self, big_map):
        from orbslam2_tpu.models.tracking import gather_local_points

        m = big_map
        bindings = jnp.asarray(
            np.where(np.arange(self.N) % 3 == 0,
                     np.asarray(m.kf_point[700]), -1), jnp.int32
        )
        pt_ids, valid = gather_local_points(m, bindings)
        assert bool(valid.any())
        # Every returned-valid id is a real point of the local neighborhood.
        assert bool(m.pt_valid[pt_ids[valid]].all())

    def test_replacements_at_capacity(self, big_map):
        m = big_map
        old = jnp.asarray(np.asarray(m.kf_point[700])[:32], jnp.int32)
        new = jnp.asarray(np.asarray(m.kf_point[701])[:32], jnp.int32)
        do = (old >= 0) & (new >= 0)
        m2 = ms.apply_point_replacements(m, old, new, do)
        jax.block_until_ready(m2.pt_valid)
        retired = np.asarray(old)[np.asarray(do)]
        if retired.size:
            assert not bool(m2.pt_valid[jnp.asarray(retired)].any())


class TestLargeKPoseGraph:
    @pytest.mark.slow
    def test_cg_essential_graph_runs_at_2048(self):
        """K=2048 pose graph (CG path, no dense (7K)^2): a noisy circle
        with one loop edge must contract toward consistency."""
        from orbslam2_tpu.solvers import pose_graph as pg
        from orbslam2_tpu.solvers.lie import se3_exp

        K = 2048
        n = 600  # valid keyframes on a drifting circle
        rng = np.random.default_rng(3)
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        # Ground truth circle; estimated poses accumulate odometric noise.
        est = np.eye(4)
        drift = []
        for k in range(n):
            step = np.asarray(
                se3_exp(jnp.asarray(
                    [0.05, 0, 0.01, 0, 2 * np.pi / n, 0], jnp.float32))
            )
            noise = np.asarray(
                se3_exp(jnp.asarray(
                    rng.normal(0, 5e-4, 6).astype(np.float32)))
            )
            est = step @ noise @ est
            poses[k] = est.astype(np.float32)
            drift.append(est)
        kf_valid = np.arange(K) < n
        parent = np.where(np.arange(K) > 0, np.arange(K) - 1, -1)
        parent[n:] = -1

        # One loop edge: last <- first with the TRUE relative pose (the
        # drift-free measurement a Sim3 solver would produce).
        loop_i = jnp.asarray([0], jnp.int32)
        loop_j = jnp.asarray([n - 1], jnp.int32)
        # True relative: n-1 steps of the clean step.
        T_true = np.eye(4)
        step = np.asarray(se3_exp(jnp.asarray(
            [0.05, 0, 0.01, 0, 2 * np.pi / n, 0], jnp.float32)))
        for _ in range(n - 1):
            T_true = step @ T_true
        S_ji = jnp.asarray(T_true, jnp.float32)[None]

        covis = np.zeros((K, K), np.int32)
        for k in range(n - 1):
            covis[k, k + 1] = covis[k + 1, k] = 150
        edges = pg.edges_from_map(
            jnp.asarray(poses), jnp.asarray(kf_valid), jnp.asarray(parent),
            jnp.asarray(covis), loop_i, loop_j, S_ji,
            jnp.asarray([True]), min_covis_weight=100,
        )
        fixed = jnp.zeros(K, bool).at[0].set(True)
        T_new, scales = pg.optimize_essential_graph(
            jnp.asarray(poses), jnp.asarray(kf_valid), edges, fixed,
            iters=8, fix_scale=True,
        )
        jax.block_until_ready(T_new)
        # Loop-closure error before vs after.
        def loop_err(P):
            rel = np.asarray(P[n - 1]) @ np.linalg.inv(np.asarray(P[0]))
            return float(np.linalg.norm(rel[:3, 3] - T_true[:3, 3]))

        e0 = loop_err(poses)
        e1 = loop_err(T_new)
        assert e1 < 0.3 * e0, (e0, e1)
