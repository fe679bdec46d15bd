"""Spatially-uniform keypoint selection (fixed-shape top-k).

JAX replacement for ``ORBextractor::DistributeOctTree``
(src/ORBextractor.cc:≈560).  The reference's quadtree subdivision is
inherently sequential; we approximate it with per-cell candidate top-k
followed by a global top-n — the same "best response, spread across the
image" objective, expressed as two fixed-shape top-k ops (SURVEY.md §7's
grid-top-k plan).

Cells with high-threshold (iniThFAST=20) corners win over cells that only
have low-threshold (minThFAST=7) corners automatically, because ranking is
by score and the score IS the max-threshold-at-which-corner (ops/fast.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def select_keypoints(
    score: jnp.ndarray,
    n_target: int,
    cell: int = 32,
    cand_per_cell: int = 4,
    border: int = 16,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pick up to ``n_target`` spatially-distributed keypoints.

    Args:
      score: (H, W) NMS'd corner score (0 = not a corner).
      n_target: fixed output size (padded with invalid entries).
      cell: cell edge in pixels (the reference tiles ~30px cells,
        src/ORBextractor.cc:≈790).
      cand_per_cell: per-cell candidate cap before the global top-k.
      border: margin inside which keypoints are rejected (descriptor patch
        half-size + blur reach; reference EDGE_THRESHOLD=19 minus circle 3).

    Returns:
      xy: (n_target, 2) float32 keypoint coords (x, y) in this image's frame.
      resp: (n_target,) float32 responses.
      valid: (n_target,) bool.
    """
    h, w = score.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (
        (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    )
    score = jnp.where(inside, score, 0.0)

    # Pad to a whole number of cells.
    hc = -(-h // cell)
    wc = -(-w // cell)
    padded = jnp.zeros((hc * cell, wc * cell), score.dtype).at[:h, :w].set(score)

    # (hc, cell, wc, cell) -> (hc*wc, cell*cell)
    cells = padded.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(
        hc * wc, cell * cell
    )
    cell_top, cell_idx = jax.lax.top_k(cells, cand_per_cell)  # (nc, k)

    # Recover absolute coordinates for each candidate.
    cell_row = jax.lax.broadcasted_iota(jnp.int32, (hc * wc, cand_per_cell), 0) // wc
    cell_col = jax.lax.broadcasted_iota(jnp.int32, (hc * wc, cand_per_cell), 0) % wc
    in_y = cell_idx // cell
    in_x = cell_idx % cell
    abs_y = cell_row * cell + in_y
    abs_x = cell_col * cell + in_x

    cand_score = cell_top.reshape(-1)
    cand_x = abs_x.reshape(-1)
    cand_y = abs_y.reshape(-1)

    # Global top-n over all surviving candidates.
    n_cand = cand_score.shape[0]
    k = min(n_target, n_cand)
    top_score, top_i = jax.lax.top_k(cand_score, k)
    sel_x = cand_x[top_i].astype(jnp.float32)
    sel_y = cand_y[top_i].astype(jnp.float32)
    valid = top_score > 0.0

    if k < n_target:
        pad = n_target - k
        top_score = jnp.concatenate([top_score, jnp.zeros(pad, top_score.dtype)])
        sel_x = jnp.concatenate([sel_x, jnp.zeros(pad, jnp.float32)])
        sel_y = jnp.concatenate([sel_y, jnp.zeros(pad, jnp.float32)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])

    xy = jnp.stack([sel_x, sel_y], axis=-1)
    return xy, top_score, valid
