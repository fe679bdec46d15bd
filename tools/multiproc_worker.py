"""Per-process worker for the REAL multi-process jax.distributed test.

SURVEY.md §2.5's north star is map parallelism within and across hosts.  The
virtual-8-device tests exercise the collectives single-process; this
worker is the multi-host leg: N OS
processes, each with its own CPU devices, joined by
``jax.distributed.initialize`` into ONE global mesh, running the SAME
sharded BA step the production pipeline dispatches
(parallel/dist_ba.make_distributed_ba_step) with cross-PROCESS
collectives, and asserting parity with a process-local solve of the
identical problem.

Launched by tests/test_multiprocess.py (and tools/run_multiprocess.py):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python tools/multiproc_worker.py <coordinator> <nprocs> <pid> <out>

Each process contributes 4 virtual CPU devices; the global mesh spans
nprocs * 4 devices across process boundaries — psum/all_gather ride the
cross-process (DCN-class) path, not shared memory.
"""
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main():
    coordinator, nprocs, pid, outpath = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    import jax

    # CPU processes, like the rest of the test suite (tests/conftest.py).
    jax.config.update("jax_platforms", "cpu")
    # CPU cross-process collectives: without an implementation the CPU
    # backend cannot join processes into one global topology (each would
    # see only its own devices).  Must be set before backend init.
    jax.config.update("jax_num_cpu_devices", 4)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from orbslam2_tpu.parallel.distributed import initialize_distributed

    assert initialize_distributed(
        coordinator=coordinator, num_processes=nprocs, process_id=pid
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from orbslam2_tpu.parallel import dist_ba

    devs = jax.devices()
    local = jax.local_devices()
    assert len(devs) == nprocs * len(local), (len(devs), nprocs, len(local))

    sys.path.insert(0, os.path.join(_REPO, "tests"))
    from test_parallel import make_problem, mean_reproj_err

    n_cams = len(devs)
    prob, poses_gt, X_gt, cam = make_problem(
        n_cams=n_cams, n_obs=64, n_pts=128, seed=3
    )
    prob_np = jax.tree.map(np.asarray, prob)

    def put(mesh, arr, spec):
        a = np.asarray(arr)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(a.shape, sh, lambda i: a[i])

    def solve(mesh):
        """10 iterations of the sharded Schur step on ``mesh``."""
        step = dist_ba.make_distributed_ba_step(
            mesh, cam, n_total_cams=n_cams
        )
        sharded = dist_ba.ShardedBAProblem(
            poses=put(mesh, prob_np.poses, P("map")),
            uv=put(mesh, prob_np.uv, P("map")),
            pid=put(mesh, prob_np.pid, P("map")),
            obs_ok=put(mesh, prob_np.obs_ok, P("map")),
            inv_s2=put(mesh, prob_np.inv_s2, P("map")),
            is_fixed=put(mesh, prob_np.is_fixed, P("map")),
            points=put(mesh, prob_np.points, P()),
            ur=put(mesh, np.full(prob_np.uv.shape[:2], -1.0, np.float32),
                   P("map")),
        )
        poses, pts = sharded.poses, sharded.points
        for _ in range(10):
            poses, pts = step(sharded._replace(poses=poses, points=pts))
        return poses, pts

    # --- global (cross-process) solve ---
    gmesh = Mesh(np.asarray(devs), ("map",))
    poses_g, pts_g = solve(gmesh)
    from jax.experimental import multihost_utils

    poses_gh = np.asarray(multihost_utils.process_allgather(
        poses_g, tiled=True
    ))
    pts_gh = np.asarray(multihost_utils.process_allgather(pts_g, tiled=True))

    # --- process-local solve of the IDENTICAL problem (parity witness) ---
    lmesh = Mesh(np.asarray(local), ("map",))
    poses_l, pts_l = solve(lmesh)
    poses_lh, pts_lh = np.asarray(poses_l), np.asarray(pts_l)

    err0 = float(np.asarray(mean_reproj_err(
        prob, prob_np.poses, prob_np.points, cam)))
    err_g = float(np.asarray(mean_reproj_err(prob, poses_gh, pts_gh, cam)))
    err_l = float(np.asarray(mean_reproj_err(prob, poses_lh, pts_lh, cam)))
    pose_gap = float(np.abs(poses_gh - poses_lh).max())

    out = {
        "pid": pid,
        "n_global_devices": len(devs),
        "n_local_devices": len(local),
        "err_before": err0,
        "err_global_mesh": err_g,
        "err_local_mesh": err_l,
        "pose_max_abs_gap": pose_gap,
    }
    with open(outpath, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
