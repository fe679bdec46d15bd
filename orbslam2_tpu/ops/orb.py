"""Oriented rBRIEF descriptors: orientation + rotated binary tests.

JAX replacement for the descriptor half of ``ORBextractor``:
``IC_Angle`` (src/ORBextractor.cc:≈80, intensity centroid over a radius-15
circular patch) and ``computeOrbDescriptor`` (src/ORBextractor.cc:≈110,
256 rotated pairwise intensity comparisons -> 32 bytes).

Design differences from the reference (deliberate, batched):
* All keypoints of a level are processed as one batched patch gather — no
  per-keypoint loop.  Each keypoint's 31x31 patch is sliced once; both the
  intensity-centroid orientation and the descriptor sampling read from the
  patch, so the image is touched once per keypoint instead of ~1.5k
  scattered scalar gathers.
* The steered-BRIEF sampling reads from the gathered patch with a
  per-keypoint ``take_along_axis`` at exact-angle rotated, cvRound-rounded
  offsets — bit-identical semantics to the reference's scalar loop, but a
  (N, 512)-from-(N, 961) batched row gather instead of N*512 scattered
  image reads.
* The 256-pair sampling pattern is generated deterministically (seeded
  isotropic Gaussian, the BRIEF construction the learned ORB pattern was
  selected from) instead of shipping OpenCV's learned table.  Descriptors
  are therefore NOT bit-compatible with OpenCV ORB, but are self-consistent
  across frames, which is all the SLAM pipeline requires (SURVEY.md §7:
  gate on downstream matching quality, not bitwise parity).
* Descriptors are packed 256 bits -> 8 x uint32 so Hamming distance is
  XOR + ``lax.population_count`` (ops/hamming.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HALF_PATCH = 15  # circular patch radius for orientation
PATCH = 2 * HALF_PATCH + 1


def _make_pattern(seed: int = 42, n_pairs: int = 256) -> np.ndarray:
    """(n_pairs, 2, 2) int32 sample offsets (x, y) within the 31x31 patch.

    Isotropic Gaussian with sigma = patch/5 (Calonder's BRIEF G-II), clipped
    to the radius-13 disc so rotated samples stay inside the patch.
    """
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n_pairs * 2:
        cand = rng.normal(0.0, PATCH / 5.0, size=(n_pairs * 4, 2))
        cand = np.round(cand).astype(np.int32)
        r = np.hypot(cand[:, 0], cand[:, 1])
        cand = cand[r <= 13.0]
        pts.extend(cand.tolist())
    pts = np.array(pts[: n_pairs * 2], np.int32)
    return pts.reshape(n_pairs, 2, 2)


BRIEF_PATTERN = _make_pattern()  # (256, 2, 2) int32, (x, y) offsets

# Circular mask + coordinate grids for the intensity centroid.
_yy, _xx = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
_CIRC_MASK = (_xx**2 + _yy**2 <= HALF_PATCH**2).astype(np.float32)
# (patch_pixels, 2) matvec computing (m10, m01) from a flattened patch.
_MXY = np.stack(
    [(_xx * _CIRC_MASK).reshape(-1), (_yy * _CIRC_MASK).reshape(-1)], -1
).astype(np.float32)


def extract_patches(image: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """(N, PATCH*PATCH) float32 patches centered (rounded, border-clamped)
    on each keypoint.  Row-block gather + per-keypoint column slice (full
    rows move as dense vectors; only the column offset is dynamic)."""
    h, w = image.shape
    x = jnp.clip(
        jnp.round(xy[:, 0]).astype(jnp.int32), HALF_PATCH, w - 1 - HALF_PATCH
    )
    y = jnp.clip(
        jnp.round(xy[:, 1]).astype(jnp.int32), HALF_PATCH, h - 1 - HALF_PATCH
    )
    offs = jnp.arange(-HALF_PATCH, HALF_PATCH + 1)
    rows = image[y[:, None] + offs]  # (N, PATCH, W)

    def one(rowblk, xi):
        return jax.lax.dynamic_slice(
            rowblk, (0, xi - HALF_PATCH), (PATCH, PATCH)
        )

    patches = jax.vmap(one)(rows, x)
    return patches.reshape(xy.shape[0], PATCH * PATCH)


def orientations_from_patches(patches: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle (radians) per flattened patch (IC_Angle)."""
    m = patches @ jnp.asarray(_MXY)  # (N, 2) = (m10, m01)
    return jnp.arctan2(m[:, 1], m[:, 0])


def descriptors_from_patches(
    patches: jnp.ndarray, angles: jnp.ndarray
) -> jnp.ndarray:
    """(N, 8) uint32 packed rBRIEF from flattened patches + angles.

    Steered BRIEF exactly as the reference (ORBextractor.cc:≈110): rotate
    the 256-pair pattern by the keypoint angle, round each offset to the
    nearest pixel, compare I(p0) < I(p1).

    The rotated offsets are data-dependent, so the natural lowering is a
    (N, 512)-from-(N, 961) gather.  Here the sample is instead two one-hot
    contractions over the patch axes (a row-select matmul, then a masked
    column sum), which is bit-identical under full float32 matmul
    precision and ~1 GFLOP of dense work.  Which form is cheaper on the
    GPU is not measured yet:
        sample[k,s] = sum_r onehot(ry)[k,s,r] *
                      sum_c onehot(rx)[k,s,c] * patch[k,r,c]
    """
    n = patches.shape[0]
    pat = jnp.asarray(BRIEF_PATTERN, jnp.float32)  # (256, 2, 2) (x, y)
    px = pat[:, :, 0].reshape(-1)  # (512,) = pairs x {p0, p1}
    py = pat[:, :, 1].reshape(-1)
    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]
    rx = jnp.round(px * ca - py * sa).astype(jnp.int32) + HALF_PATCH
    ry = jnp.round(px * sa + py * ca).astype(jnp.int32) + HALF_PATCH
    # (N, 512, PATCH) one-hots; offsets stay in-disc (r <= 13.5 < 15).
    grid = jnp.arange(PATCH, dtype=jnp.int32)
    oh_y = (ry[:, :, None] == grid).astype(patches.dtype)
    oh_x = (rx[:, :, None] == grid).astype(patches.dtype)
    p2d = patches.reshape(n, PATCH, PATCH)
    rows = jnp.einsum("ksr,krc->ksc", oh_y, p2d)   # row select (matmul)
    samples = jnp.sum(oh_x * rows, axis=-1).reshape(n, 256, 2)
    bits = samples[:, :, 0] < samples[:, :, 1]  # (N, 256)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(
        bits.reshape(n, 8, 32).astype(jnp.uint32) * weights, axis=-1,
        dtype=jnp.uint32,
    )


@jax.jit
def compute_orientations(image: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation for each keypoint (IC_Angle).

    Convenience wrapper: extracts patches then reduces.  The extractor
    calls the ``*_from_patches`` forms directly so the patch gather is
    shared with the descriptor computation.
    """
    return orientations_from_patches(extract_patches(image, xy))


@jax.jit
def compute_descriptors(
    image_blur: jnp.ndarray, xy: jnp.ndarray, angles: jnp.ndarray
) -> jnp.ndarray:
    """Rotated-BRIEF descriptors, packed (convenience wrapper; see
    ``descriptors_from_patches``)."""
    return descriptors_from_patches(
        extract_patches(image_blur, xy), angles
    )
