"""Profile local BA internals on the device (per-call wall times).

Run on the GPU: python tools/ba_profile.py
"""
import time, jax, jax.numpy as jnp, numpy as np
from orbslam2_tpu.models import map_state as ms
from orbslam2_tpu.solvers.local_ba import local_bundle_adjustment, schur_ba_core, _gather_problem
from orbslam2_tpu.utils.camera import make_camera

cam = make_camera(517.3, 516.5, 318.6, 255.3, bf=40.0, width=640, height=480)
K, P, N = 128, 16384, 1024
rng = np.random.default_rng(0)
m = ms.make_empty_map(K, P, N)
n_kf, n_pt = 12, 3000
pts = rng.uniform(-3, 3, (P, 3)).astype(np.float32); pts[:, 2] += 6
kf_point = np.full((K, N), -1, np.int32)
for k in range(n_kf):
    kf_point[k, :900] = rng.choice(n_pt, 900, replace=False)
poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
for k in range(n_kf):
    poses[k, 0, 3] = 0.1 * k
xy = rng.uniform(0, 600, (K, N, 2)).astype(np.float32)
m = m._replace(
    kf_point=jnp.asarray(kf_point), kf_xy=jnp.asarray(xy),
    kf_kp_valid=jnp.asarray(np.ones((K, N), bool)),
    kf_valid=jnp.asarray(np.arange(K) < n_kf),
    kf_pose_cw=jnp.asarray(poses),
    pt_pos=jnp.asarray(pts), pt_valid=jnp.asarray(np.arange(P) < n_pt),
    n_kf=jnp.int32(n_kf), n_pt=jnp.int32(n_pt),
)
inv_s2 = np.ones(8, np.float32)
kf = jnp.int32(n_kf - 1)

def timeit(name, fn, n=3):
    r = fn(); jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(); jax.block_until_ready(r)
    dt = (time.perf_counter()-t0)/n*1000
    print(f"{name}: {dt:.1f} ms")

timeit("local_ba full (5,10)", lambda: local_bundle_adjustment(m, kf, cam, inv_s2))
timeit("local_ba (1,0) 1 iter", lambda: local_bundle_adjustment(m, kf, cam, inv_s2, phase_iters=(1,)))
timeit("local_ba (2,0)", lambda: local_bundle_adjustment(m, kf, cam, inv_s2, phase_iters=(2,)))
timeit("local_ba (5,0)", lambda: local_bundle_adjustment(m, kf, cam, inv_s2, phase_iters=(5,)))
timeit("gather_problem only", lambda: jax.jit(lambda m, kf: _gather_problem(m, kf, 8, 8))(m, kf))
timeit("local_ba pt_cap=2048", lambda: local_bundle_adjustment(m, kf, cam, inv_s2, pt_cap=2048))
