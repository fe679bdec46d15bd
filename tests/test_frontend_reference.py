"""The front end's XLA ops against independent NumPy references: FAST-9
score + raster-order 3x3 NMS (ops/fast), the projection matcher's
windowed best-2 search (ops/matcher.projection_match) and the packed
Hamming matrix (ops/hamming).  All outputs are compared exactly: the ops
are integer or min/max arithmetic on float32 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.ops import fast as fast_ops
from orbslam2_tpu.ops.hamming import hamming_matrix
from orbslam2_tpu.ops.matcher import projection_match

_INVALID = 10_000


def _smooth_image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h // 4 + 2, w // 4 + 2)).astype(np.float32)
    img = np.kron(img, np.ones((4, 4), np.float32))[:h, :w]
    img += rng.uniform(0, 8, (h, w)).astype(np.float32)
    return img


def _fast_nms_reference(img):
    """FAST-9 score (largest t with a 9-arc all brighter than center + t or
    all darker than center - t; 3-px border zero), then keep a pixel iff
    it is a 3x3 local maximum and no local maximum precedes it in raster
    order inside its window."""
    h, w = img.shape
    pad = np.pad(img, 3)
    d = np.stack([
        pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
        for dy, dx in fast_ops.CIRCLE_OFFSETS
    ])                                            # (16, h, w)
    ring = np.concatenate([d, d[:8]])             # circular windows
    bright = np.min(
        np.stack([ring[s:s + 9] for s in range(16)]), axis=1
    )
    dark = np.min(
        np.stack([-ring[s:s + 9] for s in range(16)]), axis=1
    )
    score = np.maximum(np.maximum(bright.max(0), dark.max(0)), 0.0)
    interior = np.zeros((h, w), bool)
    interior[3:h - 3, 3:w - 3] = True
    score = np.where(interior, score, 0.0).astype(np.float32)

    sp = np.pad(score, 1, constant_values=-np.inf)
    win = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    nmax = np.max(
        np.stack([sp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dy, dx in win]),
        axis=0,
    )
    is_max = score >= nmax
    mp = np.pad(is_max, 1)
    earlier_max = np.zeros((h, w), bool)
    for dy, dx in win:
        if dy < 0 or (dy == 0 and dx < 0):
            earlier_max |= mp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return np.where(is_max & ~earlier_max, score, 0.0)


class TestFastNms:
    @pytest.mark.parametrize("hw", [(240, 320), (96, 200), (37, 130)])
    def test_matches_numpy_reference(self, hw):
        h, w = hw
        img = _smooth_image(h, w, seed=h + w)
        out = np.asarray(fast_ops.nms3x3(fast_ops.fast_score(jnp.asarray(img))))
        ref = _fast_nms_reference(img)
        assert out.shape == ref.shape
        assert (ref > 0).sum() > 0
        np.testing.assert_array_equal(out, ref)

    def test_zero_image(self):
        img = jnp.zeros((64, 128), jnp.float32)
        out = np.asarray(fast_ops.nms3x3(fast_ops.fast_score(img)))
        assert (out == 0).all()


def _popcount_matrix(a, b):
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int32)


class TestHammingMatrix:
    @pytest.mark.parametrize("shape", [(128, 256), (37, 53), (1, 300)])
    def test_matches_numpy_popcount(self, shape):
        na, nb = shape
        rng = np.random.default_rng(na * 1000 + nb)
        a = rng.integers(0, 2**32, (na, 8), dtype=np.uint32)
        b = rng.integers(0, 2**32, (nb, 8), dtype=np.uint32)
        out = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, _popcount_matrix(a, b))


def _proj_problem(na, nb, seed, empty_rows=0):
    rng = np.random.default_rng(seed)
    p = dict(
        da=rng.integers(0, 2**32, (na, 8), dtype=np.uint32),
        db=rng.integers(0, 2**32, (nb, 8), dtype=np.uint32),
        uv=rng.uniform(0, 640, (na, 2)).astype(np.float32),
        xy=rng.uniform(0, 640, (nb, 2)).astype(np.float32),
        rr2=(rng.uniform(30, 300, (na,)) ** 2).astype(np.float32),
        la=rng.integers(0, 4, (na,)).astype(np.int32),
        lb=rng.integers(0, 4, (nb,)).astype(np.int32),
        va=rng.uniform(size=na) > 0.2,
        vb=rng.uniform(size=nb) > 0.2,
    )
    # Plant true matches: half the targets are noisy copies of sources,
    # placed near them, so the distance and ratio gates pass for some rows.
    n_plant = min(na, nb) // 2
    src = rng.choice(na, n_plant, replace=False)
    flips = rng.integers(0, 2**32, (n_plant, 8), dtype=np.uint32) & (
        rng.integers(0, 2**32, (n_plant, 8), dtype=np.uint32)
        & rng.integers(0, 2**32, (n_plant, 8), dtype=np.uint32)
    )
    p["db"][:n_plant] = p["da"][src] ^ flips
    p["xy"][:n_plant] = p["uv"][src] + rng.normal(0, 5, (n_plant, 2))
    p["rr2"][:empty_rows] = 0.0   # an empty window: no candidate at all
    return p


def _best2_reference(p, level_dir, max_dist, ratio):
    d2 = ((p["uv"][:, None, :] - p["xy"][None, :, :]) ** 2).sum(-1)
    dl = p["lb"][None, :] - p["la"][:, None]
    band = {None: np.abs(dl) <= 1, 1: dl >= 0, -1: dl <= 0}[level_dir]
    mask = (d2 <= p["rr2"][:, None]) & band & p["va"][:, None] & p["vb"][None]
    dist = np.where(mask, _popcount_matrix(p["da"], p["db"]), _INVALID)
    idx = np.argmin(dist, axis=1)
    best = dist[np.arange(len(idx)), idx]
    rest = dist.copy()
    rest[np.arange(len(idx)), idx] = _INVALID
    second = rest.min(axis=1)
    ok = (best <= max_dist) & p["va"] & (best < ratio * second)
    return idx, best, second, ok


def _run_projection_match(p, level_dir):
    return projection_match(
        jnp.asarray(p["uv"]), jnp.asarray(p["rr2"]), jnp.asarray(p["la"]),
        jnp.asarray(p["da"]), jnp.asarray(p["va"]), jnp.asarray(p["xy"]),
        jnp.asarray(p["lb"]), jnp.asarray(p["db"]), jnp.asarray(p["vb"]),
        level_band=1, max_dist=100, ratio=0.9,
        level_dir=None if level_dir is None else jnp.int32(level_dir),
    )


class TestProjectionMatch:
    @pytest.mark.parametrize(
        "shape,level_dir,empty_rows",
        [((128, 128), None, 0), ((256, 128), None, 0), ((128, 384), None, 0),
         ((128, 128), None, 16), ((128, 256), 1, 0), ((128, 256), -1, 0)],
        ids=["128x128", "256x128", "128x384", "empty-window-rows",
             "level-dir-forward", "level-dir-backward"],
    )
    def test_matches_numpy_best2(self, shape, level_dir, empty_rows):
        na, nb = shape
        p = _proj_problem(na, nb, seed=na + nb + empty_rows, empty_rows=empty_rows)
        m = _run_projection_match(p, level_dir)
        idx, best, second, ok = _best2_reference(p, level_dir, 100, 0.9)
        np.testing.assert_array_equal(np.asarray(m.dist), best)
        np.testing.assert_array_equal(np.asarray(m.dist2), second)
        np.testing.assert_array_equal(np.asarray(m.ok), ok)
        has = best < _INVALID
        np.testing.assert_array_equal(np.asarray(m.idx)[has], idx[has])
        if empty_rows:
            assert (np.asarray(m.dist)[:empty_rows] == _INVALID).all()
            assert not np.asarray(m.ok)[:empty_rows].any()
        assert np.asarray(m.ok).any()
