"""The ORB extractor: pyramid -> FAST -> select -> orient -> describe.

JAX equivalent of ``ORBextractor::operator()``
(src/ORBextractor.cc:≈1000).  One jitted program per (image-shape, config):
all levels processed with static shapes, producing a fixed-capacity, masked
feature set (the SoA replacement for the reference's std::vector<KeyPoint>).

Stereo pairs batch the two images through the same program (the reference
spawns two std::threads per frame instead — SURVEY.md §2.5 P4).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import OrbSettings, TpuSettings
from . import fast as fast_ops
from . import orb as orb_ops
from . import pyramid as pyr_ops
from . import select as select_ops


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set (all arrays padded + masked).

    Mirrors the per-Frame feature state of the reference
    (Frame::mvKeysUn/mDescriptors/octaves, include/Frame.h):
      xy:       (N, 2) float32 — keypoint (x, y) in LEVEL-0 pixel coords
      level:    (N,)   int32   — pyramid octave
      angle:    (N,)   float32 — orientation (radians)
      response: (N,)   float32 — FAST corner score
      desc:     (N, 8) uint32  — packed 256-bit rBRIEF
      valid:    (N,)   bool
    """

    xy: jnp.ndarray
    level: jnp.ndarray
    angle: jnp.ndarray
    response: jnp.ndarray
    desc: jnp.ndarray
    valid: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.partial(
    jax.jit, static_argnums=(1, 2, 3, 4, 5, 6)
)
def _extract(
    image: jnp.ndarray,
    n_levels: int,
    scale_factor: float,
    min_th: float,
    capacity: int,
    per_level: tuple,
    cell: int,
) -> Features:
    levels = pyr_ops.build_pyramid(image.astype(jnp.float32), n_levels, scale_factor)
    scales = pyr_ops.scale_factors(n_levels, scale_factor)

    xs, lvls, resps, valids, patches = [], [], [], [], []
    for li, img in enumerate(levels):
        score = fast_ops.nms3x3(fast_ops.fast_score(img))
        score = jnp.where(score >= min_th, score, 0.0)
        xy, resp, valid = select_ops.select_keypoints(
            score, per_level[li], cell=cell
        )
        blur = pyr_ops.gaussian_blur(img)
        # One 31x31 patch gather per keypoint from the blurred image feeds
        # BOTH orientation and descriptors (reference computes IC_Angle on
        # the raw level image; blur stabilizes the intensity centroid on
        # weak-gradient patches at negligible cost).
        patches.append(orb_ops.extract_patches(blur, xy))

        xs.append(xy * scales[li])
        lvls.append(jnp.full(per_level[li], li, jnp.int32))
        resps.append(resp)
        valids.append(valid)

    xy = jnp.concatenate(xs)
    lvl = jnp.concatenate(lvls)
    resp = jnp.concatenate(resps)
    valid = jnp.concatenate(valids)
    # Orientation + rotated-BRIEF for ALL levels' keypoints in one
    # batch (patches are level-agnostic once gathered).
    pat = jnp.concatenate(patches)
    ang = orb_ops.orientations_from_patches(pat)
    desc = orb_ops.descriptors_from_patches(pat, ang)

    n = xy.shape[0]
    if n < capacity:
        pad = capacity - n
        xy = jnp.concatenate([xy, jnp.zeros((pad, 2), xy.dtype)])
        lvl = jnp.concatenate([lvl, jnp.zeros(pad, lvl.dtype)])
        ang = jnp.concatenate([ang, jnp.zeros(pad, ang.dtype)])
        resp = jnp.concatenate([resp, jnp.zeros(pad, resp.dtype)])
        desc = jnp.concatenate([desc, jnp.zeros((pad, 8), desc.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
    elif n > capacity:
        # Keep the strongest `capacity` features overall (still spatially
        # spread because selection already capped per cell/level).
        top_resp, idx = jax.lax.top_k(jnp.where(valid, resp, -1.0), capacity)
        xy, lvl, ang, desc = xy[idx], lvl[idx], ang[idx], desc[idx]
        resp, valid = top_resp, top_resp > 0.0

    return Features(xy=xy, level=lvl, angle=ang, response=resp, desc=desc, valid=valid)


class OrbExtractor:
    """Configured extractor: ``feats = extractor(image)``.

    ``image``: (H, W) uint8/float32 grayscale.  Output capacity is
    ``tpu.max_keypoints`` regardless of how many corners fire (masked).
    """

    def __init__(self, orb: OrbSettings, tpu: TpuSettings, cell: int = 32):
        self.orb = orb
        self.tpu = tpu
        self.cell = cell
        self.per_level = tuple(
            pyr_ops.features_per_level(
                orb.n_features, orb.n_levels, orb.scale_factor
            )
        )

    def __call__(self, image) -> Features:
        return _extract(
            jnp.asarray(image),
            self.orb.n_levels,
            self.orb.scale_factor,
            float(self.orb.min_th_fast),
            self.tpu.max_keypoints,
            self.per_level,
            self.cell,
        )
