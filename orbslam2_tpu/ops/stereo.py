"""Stereo feature matching (left/right disparity).

JAX equivalent of ``Frame::ComputeStereoMatches``
(src/Frame.cc:≈470): per-row banded search of right-image features for each
left keypoint by descriptor distance.  Expressed as one masked Hamming
matching (the band is the pair mask) instead of the reference's per-row
bucket lists.

Like the reference, the feature-level match is followed by a sub-pixel SAD
refinement: an 11x11 patch around the left keypoint is correlated against
a +-5 px horizontal sweep at the matched right position, and the SAD
minimum is localized with a parabola fit (Frame.cc:≈540's sliding-window
SAD + parabola).  Without this, integer disparities put ~z^2/bf depth
noise on every stereo point.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .extractor import Features
from .hamming import TH_HIGH, match_descriptors

_PATCH = 5     # half patch size (11x11)
_SWEEP = 5     # +-5 px disparity sweep


def _bilinear(img: jnp.ndarray, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img at float (y, x) grids (clamped)."""
    h, w = img.shape
    y = jnp.clip(y, 0.0, h - 1.001)
    x = jnp.clip(x, 0.0, w - 1.001)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    fy = y - y0
    fx = x - x0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx) + v11 * fy * fx
    )


@jax.jit
def _subpixel_refine(
    img_left: jnp.ndarray,
    img_right: jnp.ndarray,
    xl: jnp.ndarray,
    yl: jnp.ndarray,
    xr0: jnp.ndarray,
    step: jnp.ndarray,
) -> jnp.ndarray:
    """Per-keypoint sub-pixel right-u via SAD sweep + parabola, AT THE
    KEYPOINT'S PYRAMID SCALE (the reference refines on the keypoint's
    octave image, src/Frame.cc:≈540): patch sample spacing and sweep step
    are the octave's scale factor, so a level-L keypoint is refined over a
    level-L-sized window with level-L disparity resolution, via bilinear
    sampling of the level-0 image.

    xl/yl/xr0: float32 positions; step: (N,) per-keypoint octave scale.
    Returns float32 refined right u.
    """
    offs = jnp.arange(-_PATCH, _PATCH + 1, dtype=jnp.float32)

    def one(xli, yli, xri, s):
        gy = yli + offs * s                       # (11,)
        pl = _bilinear(
            img_left, gy[:, None], (xli + offs * s)[None, :]
        )
        pl = pl - pl[_PATCH, _PATCH]  # center-normalized like the reference

        def sad(o):
            gx = xri + o * s + offs * s
            pr = _bilinear(img_right, gy[:, None], gx[None, :])
            pr = pr - pr[_PATCH, _PATCH]
            return jnp.sum(jnp.abs(pl - pr))

        sweeps = jnp.arange(-_SWEEP, _SWEEP + 1, dtype=jnp.float32)
        sads = jax.vmap(sad)(sweeps)
        best = jnp.argmin(sads)
        # Parabola fit around the minimum (clamped to the interior).
        bi = jnp.clip(best, 1, 2 * _SWEEP - 1)
        s0, s1, s2 = sads[bi - 1], sads[bi], sads[bi + 1]
        denom = s0 - 2.0 * s1 + s2
        delta = jnp.where(
            jnp.abs(denom) > 1e-6, 0.5 * (s0 - s2) / denom, 0.0
        )
        delta = jnp.clip(delta, -1.0, 1.0)
        return xri + (sweeps[bi] + delta) * s

    return jax.vmap(one)(xl, yl, xr0, step)


@jax.jit
def compute_stereo_matches(
    left: Features,
    right: Features,
    image_left: jnp.ndarray,
    image_right: jnp.ndarray,
    scale_factors: jnp.ndarray,
    bf: jnp.ndarray,
    min_disp: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (ur, depth): per-left-keypoint right-image u and depth,
    -1 where unmatched.

    Band: |v_l - v_r| <= 2 * scale(level_l); disparity in (min_disp, bf];
    candidate = best Hamming match in band; then sub-pixel SAD refine.
    """
    # Vertical band scaled by octave (reference: r = 2*scaleFactor^octave).
    r = 2.0 * scale_factors[jnp.clip(left.level, 0, scale_factors.shape[0] - 1)]
    dv = jnp.abs(left.xy[:, None, 1] - right.xy[None, :, 1])
    band = dv <= r[:, None]
    # Same-ish octave (reference checks levelR in [levelL-1, levelL+1]).
    level_ok = jnp.abs(left.level[:, None] - right.level[None, :]) <= 1
    disp = left.xy[:, None, 0] - right.xy[None, :, 0]
    disp_ok = (disp > min_disp) & (disp <= bf)

    m = match_descriptors(
        left.desc, left.valid, right.desc, right.valid,
        pair_mask=band & level_ok & disp_ok,
        max_dist=TH_HIGH, ratio=1.0,
    )
    xr0 = jnp.take_along_axis(
        right.xy[:, 0][None, :].repeat(left.xy.shape[0], 0), m.idx[:, None], 1
    )[:, 0]
    step = scale_factors[jnp.clip(left.level, 0, scale_factors.shape[0] - 1)]
    ur = _subpixel_refine(
        image_left.astype(jnp.float32),
        image_right.astype(jnp.float32),
        left.xy[:, 0],
        left.xy[:, 1],
        xr0,
        step,
    )
    matched_disp = left.xy[:, 0] - ur
    ok = m.ok & (matched_disp > min_disp) & (matched_disp <= bf)
    ur = jnp.where(ok, ur, -1.0)
    depth = jnp.where(ok, bf / jnp.maximum(matched_disp, 1e-6), -1.0)
    return ur, depth


@jax.jit
def depth_from_depthmap(
    feats: Features, depth_map: jnp.ndarray, bf: jnp.ndarray,
    depth_factor: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RGB-D: sample the (raw-coordinate) depth map at each keypoint
    (Frame::ComputeStereoFromRGBD, src/Frame.cc:≈590) and synthesize the
    virtual right-image coordinate ur = u - bf/z."""
    h, w = depth_map.shape
    xi = jnp.clip(jnp.round(feats.xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(feats.xy[:, 1]).astype(jnp.int32), 0, h - 1)
    d = depth_map[yi, xi] / jnp.maximum(depth_factor, 1e-9)
    ok = (d > 0.0) & feats.valid
    ur = jnp.where(ok, feats.xy[:, 0] - bf / jnp.maximum(d, 1e-9), -1.0)
    depth = jnp.where(ok, d, -1.0)
    return ur, depth
