"""Per-stage device time of the mapping job on the real bench state."""
import time, numpy as np, jax, jax.numpy as jnp
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import bench as B

make_system, imgs, deps, seq = B.build()
sys_ = make_system()
B.run(sys_, imgs, deps)
m = sys_.tracker.map
lm = sys_.tracker.local_mapper or sys_.mapping_pipeline.local_mapper
lc = sys_.tracker.loop_closer or sys_.mapping_pipeline.loop_closer
kf_id = int(np.asarray(m.n_kf)) - 1
print(f"n_kf={kf_id+1} n_pt={int(np.asarray(m.n_pt))}")

from orbslam2_tpu.models import map_state as ms
from orbslam2_tpu.models import local_mapping as lmod

def timeit(name, fn, n=3):
    r = fn(); jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(); jax.block_until_ready(r)
    dt = (time.perf_counter()-t0)/n*1000
    print(f"  {name}: {dt:.0f} ms (incl ~30 sync)")
    return r

kf = jnp.int32(kf_id)
m1 = timeit("cull_map_points", lambda: lmod.cull_map_points(m))
tri_ids, _ = ms.best_covisible(m1, kf, lm.n_tri_neighbors)
m2 = timeit("triangulate x%d" % lm.n_tri_neighbors,
            lambda: lmod.triangulate_new_points(m1, kf, lm.cam, lm.scale_factors, lm.sigma2, n_neighbors=lm.n_tri_neighbors))
nb, _ = ms.best_covisible(m2, kf, 2)
m3 = timeit("fuse 1 dir", lambda: lmod.fuse_with_neighbor(m2, kf, nb[0], lm.cam, lm.scale_factors, lm.inv_sigma2))
m4 = timeit("update_point_stats", lambda: ms.update_point_stats(m3, lm.scale_factors))
m5 = timeit("local_ba", lambda: lm._local_ba(m4, kf))
touched = jnp.concatenate([kf[None], tri_ids, nb])
m6 = timeit("distinctive_inc", lambda: ms.compute_distinctive_descriptors(m5, touched_kfs=touched))
m7 = timeit("cull_keyframes", lambda: lmod.cull_keyframes(m6, kf, n_levels=8, bf=lm._bf, th_depth=lm._cull_th_depth))

# whole mapping job
def job():
    return lm.process_keyframe(m, kf_id)
timeit("process_keyframe total", job)

# loop closer detect-only (no fire)
def lcjob():
    return lc.process_keyframe(m, kf_id)
t0 = time.perf_counter(); r = lcjob(); jax.block_until_ready(r.kf_pose_cw)
print(f"  lc first: {(time.perf_counter()-t0)*1000:.0f} ms")
t0 = time.perf_counter(); r = lcjob(); jax.block_until_ready(r.kf_pose_cw)
print(f"  lc warm: {(time.perf_counter()-t0)*1000:.0f} ms")
