"""FAST-9/16 corner detection as dense, branch-free tensor ops.

JAX replacement for the OpenCV ``FAST`` calls inside
``ORBextractor::ComputeKeyPointsOctTree`` (src/ORBextractor.cc:≈790).  The
reference runs FAST per 30x30 cell with threshold 20, retrying at 7 when a
cell comes up empty; we instead compute a dense *corner score* map once —
score = the maximum threshold at which the pixel is still a FAST corner —
so a single pass supports both thresholds (selection applies them later).

Everything is fixed-shape elementwise math on the full image, fused by
XLA.  No data-dependent control flow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3: 16 (dy, dx) offsets in clockwise order
# starting from (-3, 0) (12 o'clock).  Order matters: arc contiguity is
# evaluated circularly over this sequence.
CIRCLE_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)

ARC_LENGTH = 9  # FAST-9


def _shift2d(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """img[y+dy, x+dx] with edge replication (borders are masked later)."""
    return jnp.roll(img, (-dy, -dx), axis=(0, 1))


@jax.jit
def fast_score(image: jnp.ndarray) -> jnp.ndarray:
    """Dense FAST-9 corner score.

    Returns (H, W) float32: the largest threshold t such that the pixel has a
    9-contiguous arc of circle pixels all brighter than center+t (or all
    darker than center-t); 0 where no arc exists even at t=0.

    This reproduces OpenCV's FAST score semantics (max threshold for which
    the corner survives), which the reference relies on for per-cell best-
    keypoint selection in DistributeOctTree.
    """
    img = image.astype(jnp.float32)
    center = img
    # (16, H, W) differences between circle pixel and center.
    diffs = jnp.stack(
        [_shift2d(img, int(dy), int(dx)) - center for dy, dx in CIRCLE_OFFSETS]
    )

    # For each circular window of 9 consecutive circle pixels starting at s:
    #   bright_margin[s] = min_{i in window} diffs[i]
    #   dark_margin[s]   = min_{i in window} -diffs[i]
    # Corner score = max_s max(bright_margin[s], dark_margin[s]) clamped at 0.
    def window_min(x):
        m = x
        for i in range(1, ARC_LENGTH):
            m = jnp.minimum(m, jnp.roll(x, -i, axis=0))
        return m

    bright = window_min(diffs)        # (16, H, W): min over each 9-window
    dark = window_min(-diffs)
    score = jnp.maximum(jnp.max(bright, axis=0), jnp.max(dark, axis=0))
    score = jnp.maximum(score, 0.0)

    # Mask the 3-pixel border where the circle wraps around.
    h, w = img.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(interior, score, 0.0)


@jax.jit
def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression: keep score only at strict local maxima
    (ties broken toward the top-left pixel to avoid duplicate plateaus)."""
    neighborhood_max = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    is_max = score >= neighborhood_max
    # Plateau tie-break: suppress a pixel if an equal-valued neighbor precedes
    # it in raster order within the 3x3 window.
    h, w = score.shape
    idx = (
        jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) * w
        + jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    )
    idx_of_max = jax.lax.reduce_window(
        jnp.where(score >= neighborhood_max, -idx, -jnp.inf),
        -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME",
    )
    first_max = (-idx_of_max) == idx
    return jnp.where(is_max & first_max, score, 0.0)
