"""REAL multi-process jax.distributed test.

Launches 2 OS processes x 4 virtual CPU devices each, joined by a
coordinator into one 8-device global mesh, and runs the production
sharded BA step (parallel/dist_ba) with cross-process collectives.
Parity gate: the global-mesh solve must match each process's local-mesh
solve of the identical problem to f32 reduction noise.

The reference has no distributed story at all (single process, mutexes —
SURVEY.md §2.5); this is the multi-host capability proof, run on CPU
processes.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_ba(tmp_path):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    env.pop("JAX_NUM_PROCESSES", None)
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"proc{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(_REPO, "tools",
                                          "multiproc_worker.py"),
             coordinator, "2", str(pid), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=_REPO,
        ))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    for out in outs:
        r = json.loads(out.read_text())
        assert r["n_global_devices"] == 8
        assert r["n_local_devices"] == 4
        # The sharded solver converged (same gate class as
        # tests/test_parallel.py's single-process step test)...
        assert r["err_global_mesh"] < 0.25 * r["err_before"]
        # ...and the cross-process mesh agrees with the process-local mesh
        # to f32 reduction noise.
        assert r["pose_max_abs_gap"] < 2e-4, r
