"""Data-association ops — the reference's ORBmatcher as masked matching.

Every ``ORBmatcher::SearchBy*`` overload (src/ORBmatcher.cc, SURVEY.md §2.1)
is the same primitive — packed-Hamming nearest neighbor under a candidate
pair mask (ops/hamming.py) — with a different mask:

  SearchForInitialization (≈450):  spatial window + ratio + rotation hist
  SearchByProjection/tracking (≈1180, ≈55): projection window scaled by
      predicted octave + octave band + TH_HIGH + ratio
  SearchForTriangulation (≈650):  epipolar band + TH_LOW + rotation hist
  Fuse (≈950):                    projection window + TH_LOW (merge pass)

All shapes fixed; invalid entries masked.  Thresholds are the reference's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .extractor import Features
from .hamming import (
    TH_HIGH,
    TH_LOW,
    Matches,
    hamming_matrix,
    masked_best2,
    match_descriptors,
    rotation_consistency,
)


def projection_match(
    proj_uv: jnp.ndarray,      # (M, 2) projected source positions
    rr2: jnp.ndarray,          # (M,) squared search radius per source
    proj_level: jnp.ndarray,   # (M,) predicted octave
    proj_desc: jnp.ndarray,    # (M, 8) u32
    proj_valid: jnp.ndarray,   # (M,) bool
    frame_xy: jnp.ndarray,     # (N, 2)
    frame_level: jnp.ndarray,  # (N,)
    frame_desc: jnp.ndarray,   # (N, 8) u32
    frame_valid: jnp.ndarray,  # (N,) bool
    level_band: int,
    max_dist: int,
    ratio: float,
    level_dir: Optional[jnp.ndarray] = None,
) -> Matches:
    """The SearchByProjection core shared by the tracking hot paths:
    nearest+second Hamming neighbor inside a per-source circular window and
    octave band (masked_best2 over the Hamming matrix; XLA fuses the mask
    and the best-2 reduction with the distance computation).

    ``level_dir`` (traced int scalar) selects the motion-model octave gate
    of ORBmatcher::SearchByProjection(cur, last) (src/ORBmatcher.cc:≈1180):
    +1 = forward motion (target octave >= source), -1 = backward (<=),
    0/None = symmetric +-level_band."""
    d2 = jnp.sum((proj_uv[:, None, :] - frame_xy[None, :, :]) ** 2, axis=-1)
    dl = frame_level[None, :] - proj_level[:, None]
    band_ok = jnp.abs(dl) <= level_band
    if level_dir is not None:
        band_ok = jnp.where(
            level_dir > 0, dl >= 0,
            jnp.where(level_dir < 0, dl <= 0, band_ok),
        )
    mask = (
        (d2 <= rr2[:, None])
        & band_ok
        & proj_valid[:, None]
        & frame_valid[None, :]
    )
    best_idx, best, second = masked_best2(
        hamming_matrix(proj_desc, frame_desc), mask
    )
    ok = (best <= max_dist) & proj_valid
    ok = ok & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    return Matches(idx=best_idx, dist=best, dist2=second, ok=ok)


@functools.partial(
    jax.jit, static_argnames=("window", "check_rotation", "max_level")
)
def search_for_initialization(
    f_ref: Features,
    f_cur: Features,
    window: int = 100,
    check_rotation: bool = True,
    max_level: int = 1,
) -> Matches:
    """Windowed matching for monocular initialization
    (ORBmatcher::SearchForInitialization, src/ORBmatcher.cc:≈450).

    Low-octave keypoints only, search window around the reference position,
    ratio 0.9, TH_LOW, rotation-consistency histogram.  (The reference
    restricts to octave 0; we admit octaves <= max_level because our
    grid-top-k selection redistributes borderline corners across octaves
    more than DistributeOctTree does.)
    """
    d2 = jnp.sum(
        (f_ref.xy[:, None, :] - f_cur.xy[None, :, :]) ** 2, axis=-1
    )
    pair_mask = (
        (d2 <= float(window) ** 2)
        & (f_ref.level[:, None] <= max_level)
        & (f_cur.level[None, :] <= max_level)
        & (f_ref.level[:, None] == f_cur.level[None, :])
    )
    m = match_descriptors(
        f_ref.desc, f_ref.valid, f_cur.desc, f_cur.valid,
        pair_mask=pair_mask, max_dist=TH_LOW, ratio=0.9, cross_check=True,
    )
    if check_rotation:
        ok = rotation_consistency(f_ref.angle, f_cur.angle, m.idx, m.ok)
        m = m._replace(ok=ok)
    return m


@functools.partial(
    jax.jit, static_argnames=("check_rotation", "level_band")
)
def search_by_projection(
    proj_uv: jnp.ndarray,
    proj_level: jnp.ndarray,
    proj_desc: jnp.ndarray,
    proj_valid: jnp.ndarray,
    frame: Features,
    scale_factors: jnp.ndarray,
    radius: float = 7.0,
    max_dist: int = TH_HIGH,
    ratio: float = 0.9,
    level_band: int = 1,
    proj_angle: Optional[jnp.ndarray] = None,
    check_rotation: bool = False,
    level_dir: Optional[jnp.ndarray] = None,
) -> Matches:
    """Projection-guided matching — the workhorse of tracking
    (ORBmatcher::SearchByProjection overloads, src/ORBmatcher.cc:≈55/≈1180).

    Args:
      proj_uv: (M, 2) projected pixel positions of source points (map points
        projected with the current pose estimate, or last-frame features
        warped by the motion model).
      proj_level: (M,) predicted octave (MapPoint::PredictScale or the
        source keypoint's own octave).
      proj_desc/proj_valid: (M, 8)/(M,) source descriptors + mask (includes
        the frustum/visibility gate computed by the caller).
      frame: target frame features.
      scale_factors: (n_levels,) per-octave scale (pyramid.scale_factors).
      radius: base search radius in pixels, scaled by the predicted octave's
        scale factor (reference: th * mvScaleFactors[nPredictedLevel]).
      level_band: accept target octaves within +-band of predicted.
      proj_angle: source angles for the optional rotation histogram.
    """
    r = radius * scale_factors[jnp.clip(proj_level, 0, scale_factors.shape[0] - 1)]
    m = projection_match(
        proj_uv, r * r, proj_level, proj_desc, proj_valid,
        frame.xy, frame.level, frame.desc, frame.valid,
        level_band=level_band, max_dist=max_dist, ratio=ratio,
        level_dir=level_dir,
    )
    if check_rotation and proj_angle is not None:
        ok = rotation_consistency(proj_angle, frame.angle, m.idx, m.ok)
        m = m._replace(ok=ok)
    return m


@jax.jit
def epipolar_distance(
    xy1: jnp.ndarray, xy2: jnp.ndarray, F12: jnp.ndarray
) -> jnp.ndarray:
    """(N1, 2) x (N2, 2) -> (N1, N2) point-to-epipolar-line distance of x2
    from the line F12^T x1 (ORBmatcher::CheckDistEpipolarLine,
    src/ORBmatcher.cc:≈45)."""
    ones1 = jnp.ones(xy1.shape[:-1] + (1,), xy1.dtype)
    x1h = jnp.concatenate([xy1, ones1], axis=-1)  # (N1, 3)
    lines = x1h @ F12  # (N1, 3) line in image 2: a x + b y + c = 0
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * xy2[None, :, 0] + b * xy2[None, :, 1] + c
    den2 = a * a + b * b
    return (num * num) / jnp.maximum(den2, 1e-12)


@functools.partial(jax.jit, static_argnames=("check_rotation",))
def search_for_triangulation(
    f1: Features,
    f2: Features,
    F12: jnp.ndarray,
    sigma2: jnp.ndarray,
    has_depth1: Optional[jnp.ndarray] = None,
    has_depth2: Optional[jnp.ndarray] = None,
    epipole2: Optional[jnp.ndarray] = None,
    check_rotation: bool = True,
) -> Matches:
    """Epipolar-constrained matching for new-point triangulation
    (ORBmatcher::SearchForTriangulation, src/ORBmatcher.cc:≈650).

    The squared epipolar distance gate is 3.84 * sigma^2(octave2), as in
    CheckDistEpipolarLine.  If ``epipole2`` is given, keypoints too close to
    the epipole in image 2 are rejected (for stereo-capable points the
    reference skips this by depth; we mirror via ``has_depth*``).
    """
    d_epi = epipolar_distance(f1.xy, f2.xy, F12)
    th = 3.84 * sigma2[jnp.clip(f2.level, 0, sigma2.shape[0] - 1)]
    pair_mask = d_epi <= th[None, :]
    if epipole2 is not None:
        de2 = jnp.sum((f2.xy - epipole2[None, :]) ** 2, axis=-1)
        min_de2 = 100.0 * sigma2[jnp.clip(f2.level, 0, sigma2.shape[0] - 1)]
        far_enough = de2 >= min_de2
        if has_depth2 is not None:
            far_enough = far_enough | has_depth2
        pair_mask = pair_mask & far_enough[None, :]
    m = match_descriptors(
        f1.desc, f1.valid, f2.desc, f2.valid,
        pair_mask=pair_mask, max_dist=TH_LOW, ratio=1.0, cross_check=True,
    )
    if check_rotation:
        ok = rotation_consistency(f1.angle, f2.angle, m.idx, m.ok)
        m = m._replace(ok=ok)
    return m
