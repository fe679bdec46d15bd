"""Packed 256-bit Hamming distance — the matching primitive.

Batched replacement for ``ORBmatcher::DescriptorDistance``
(src/ORBmatcher.cc:≈1630, bit-twiddling popcount).  Descriptors are
(N, 8) uint32; the full distance matrix is XOR + ``lax.population_count``
+ sum, which XLA fuses into one loop (and, inside a matcher, into the
masked best-2 reduction that consumes it).  All ``SearchBy*`` variants in
ops/matcher.py are masked reductions over this matrix.

Reference thresholds (ORBmatcher.cc:≈30): TH_LOW=50, TH_HIGH=100, and the
best/second-best ratio 0.9 — kept verbatim, they are the capability.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30  # rotation-consistency histogram bins

_INVALID_DIST = 10_000  # > any possible 256-bit distance


@jax.jit
def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """(Na, 8) x (Nb, 8) uint32 -> (Na, Nb) int32 Hamming distances."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


class Matches(NamedTuple):
    """Fixed-shape match result, one row per query descriptor.

    idx:    (Na,) int32 index into B (valid only where ``ok``)
    dist:   (Na,) int32 best distance
    dist2:  (Na,) int32 second-best distance (for ratio tests)
    ok:     (Na,) bool match accepted
    """

    idx: jnp.ndarray
    dist: jnp.ndarray
    dist2: jnp.ndarray
    ok: jnp.ndarray


def masked_best2(
    dist: jnp.ndarray, pair_mask: Optional[jnp.ndarray]
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Best + second-best along axis 1 under a pair mask.

    Returns (best_idx, best, second) with masked pairs at _INVALID_DIST.
    """
    if pair_mask is not None:
        dist = jnp.where(pair_mask, dist, _INVALID_DIST)
    best_idx = jnp.argmin(dist, axis=1).astype(jnp.int32)
    best = jnp.min(dist, axis=1)
    # Second best: mask out the best column per row.
    cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    dist2m = jnp.where(cols == best_idx[:, None], _INVALID_DIST, dist)
    second = jnp.min(dist2m, axis=1)
    return best_idx, best, second


@functools.partial(jax.jit, static_argnames=("cross_check",))
def match_descriptors(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    pair_mask: Optional[jnp.ndarray] = None,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    cross_check: bool = False,
) -> Matches:
    """Nearest-neighbor descriptor matching with the reference's gates.

    Args:
      desc_a/desc_b: (Na, 8)/(Nb, 8) uint32 packed descriptors.
      valid_a/valid_b: validity masks.
      pair_mask: optional (Na, Nb) bool — candidate gating (search windows,
        epipolar bands, BoW-node alignment...).  This is how every
        ``SearchBy*`` variant specializes the same primitive.
      max_dist: accept threshold (TH_LOW / TH_HIGH).
      ratio: best < ratio * second-best gate (0.9 in SearchByProjection /
        SearchForInitialization; 1.0 disables).
      cross_check: also require A be B's best match (used where the
        reference dedups by best-distance per target).

    Returns: Matches with fixed shapes.
    """
    dist = hamming_matrix(desc_a, desc_b)
    vmask = valid_a[:, None] & valid_b[None, :]
    mask = vmask if pair_mask is None else (vmask & pair_mask)

    best_idx, best, second = masked_best2(dist, mask)
    ok = (best <= max_dist) & valid_a
    ok = ok & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))

    if cross_check:
        dist_m = jnp.where(mask, dist, _INVALID_DIST)
        b_best_a = jnp.argmin(dist_m, axis=0).astype(jnp.int32)  # (Nb,)
        ok = ok & (b_best_a[best_idx] == jnp.arange(desc_a.shape[0]))

    return Matches(idx=best_idx, dist=best, dist2=second, ok=ok)


@jax.jit
def rotation_consistency(
    angle_a: jnp.ndarray,
    angle_b: jnp.ndarray,
    matches_idx: jnp.ndarray,
    matches_ok: jnp.ndarray,
) -> jnp.ndarray:
    """The reference's rotation-histogram check
    (ORBmatcher::ComputeThreeMaxima, src/ORBmatcher.cc:≈1600): bin the angle
    difference of each match into 30 bins, keep only matches in the top-3
    bins.  Returns the filtered ``ok`` mask.
    """
    two_pi = 2.0 * jnp.pi
    rot = angle_a - angle_b[matches_idx]
    rot = jnp.mod(rot, two_pi)
    bins = jnp.clip(
        (rot * (HISTO_LENGTH / two_pi)).astype(jnp.int32), 0, HISTO_LENGTH - 1
    )
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(
        matches_ok.astype(jnp.int32)
    )
    top3 = jax.lax.top_k(hist, 3)[0]
    # A bin is kept iff it is one of the top 3 AND its count >= 0.1 * best
    # count (the reference's ComputeThreeMaxima drop rule).
    in_top3 = hist >= top3[2]
    strong = hist.astype(jnp.float32) >= 0.1 * top3[0].astype(jnp.float32)
    keep_bin = in_top3 & strong
    return matches_ok & keep_bin[bins]
