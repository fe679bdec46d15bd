"""Device-facing setup: which kernels each backend gets, the persistent
compile cache rule, chip_smoke.py's refusal to run without a GPU, and the
scatters whose duplicate indices would race on the GPU."""

import os
import pathlib
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.models import local_mapping as lmap
from orbslam2_tpu.models import map_state as ms
from orbslam2_tpu.ops import fast as fast_ops
from orbslam2_tpu.ops.hamming import hamming_matrix
from orbslam2_tpu.ops.matcher import projection_match
from orbslam2_tpu.solvers import local_ba
from orbslam2_tpu.utils import compile_cache
from orbslam2_tpu.utils.camera import make_camera

REPO = pathlib.Path(__file__).resolve().parents[1]


def _ba_args(C=3, N=16, P=24):
    rng = np.random.default_rng(0)
    cam = make_camera(100.0, 100.0, 32.0, 24.0, bf=10.0, width=64,
                      height=48)
    poses = jnp.tile(jnp.eye(4)[None], (C, 1, 1))
    pts = jnp.asarray(rng.normal(size=(P, 3)) + [0, 0, 5], jnp.float32)
    f = lambda *s: jnp.asarray(rng.random(s), jnp.float32)  # noqa: E731
    pid = jnp.asarray(rng.integers(0, P, (C, N)), jnp.int32)
    ok = jnp.ones((C, N), bool)
    is_fixed = jnp.zeros(C, bool).at[0].set(True)
    return (poses, pts, f(C, N, 2) * 48, f(C, N) * 0 - 1, f(C, N) + 0.5,
            pid, ok, is_fixed, jnp.ones(C, bool), cam)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_kernel_choice_per_backend(monkeypatch, backend):
    """No backend gets a hand-written kernel: the BA normal equations and
    the front end (FAST+NMS, Hamming, projection matching) are XLA on
    every platform, and no platform gets an interpreter."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    *args, cam = _ba_args()
    ba = str(jax.make_jaxpr(
        lambda *a: local_ba.schur_ba_core(*a, cam, phase_iters=(1,))
    )(*args))
    assert "pallas_call" not in ba

    d = jnp.zeros((8, 8), jnp.uint32)
    v = jnp.ones(8, bool)
    xy = jnp.zeros((8, 2))
    lv = jnp.zeros(8, jnp.int32)
    front = str(jax.make_jaxpr(
        lambda img: (
            fast_ops.nms3x3(fast_ops.fast_score(img)),
            hamming_matrix(d, d),
            projection_match(xy, jnp.ones(8), lv, d, v, xy, lv, d, v,
                             level_band=1, max_dist=50, ratio=0.9),
        )
    )(jnp.zeros((32, 32))))
    assert "pallas_call" not in front


def _fake_jax(calls):
    return types.SimpleNamespace(config=types.SimpleNamespace(
        update=lambda k, v: calls.append((k, v))))


def test_compile_cache_env_var_wins(monkeypatch):
    calls = []
    monkeypatch.setattr(compile_cache, "jax", _fake_jax(calls))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert calls == []   # JAX reads the variable itself; nothing else set


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    calls = []
    monkeypatch.setattr(compile_cache, "jax", _fake_jax(calls))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert compile_cache.enable_compile_cache() == path   # never moves
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored or ".jax_cache" in ignored


def _run_smoke(cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert r.stdout.strip() == ""   # fails before printing anything


def test_chip_smoke_needs_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_scatter_slots_drops_rows_that_are_not_ok():
    out = ms.scatter_slots(
        4, jnp.asarray([0, 0, 2, 0]), jnp.asarray([7, 8, 9, 5], jnp.int32),
        jnp.asarray([True, False, False, False]),
    )
    np.testing.assert_array_equal(np.asarray(out), [7, -1, -1, -1])
    temp = ms.scatter_slots(
        3, jnp.asarray([1, 1]), jnp.asarray([4, 6], jnp.int32),
        jnp.asarray([False, False]), fill=-1,
    )
    np.testing.assert_array_equal(np.asarray(temp), [-1, -1, -1])


def test_fuse_keeps_a_match_at_slot_zero():
    """A real match at feature slot 0 survives when later rows are not ok
    (they used to write NO_POINT to slot 0 after it)."""
    K, P, N = 4, 16, 8
    m = ms.make_empty_map(K, P, N)
    m = m._replace(
        kf_valid=jnp.ones(K, bool), kf_kp_valid=jnp.ones((K, N), bool),
        pt_valid=jnp.arange(P) < 10, n_kf=jnp.int32(K), n_pt=jnp.int32(10),
    )
    pid = jnp.asarray([3, 4, 5], jnp.int32)
    idx = jnp.asarray([0, 0, 0], jnp.int32)
    ok = jnp.asarray([True, False, False])
    m2, _ = lmap._fuse_apply(m, jnp.int32(1), pid, idx, ok)
    row = np.asarray(m2.kf_point[1])
    assert row[0] == 3
    assert (row[1:] == ms.NO_POINT).all()
