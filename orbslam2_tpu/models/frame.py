"""Per-image working set: extraction + undistortion + depth association.

JAX equivalent of ``Frame`` (src/Frame.cc, SURVEY.md §2.1): the
mono/stereo/RGB-D constructors.  Deviations from the reference, by design:
* stereo L/R extraction is a batch of 2 through one jitted program instead
  of two std::threads (Frame.cc:≈110 — SURVEY.md §2.5 P4);
* no 64x48 feature grid (Frame::AssignFeaturesToGrid): our matchers are
  dense masked reductions, which is the batched equivalent of the grid's
  O(1) radius queries.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import stereo as stereo_ops
from ..ops.extractor import Features, OrbExtractor
from ..utils.camera import CameraModel, undistort_points


class Frame(NamedTuple):
    """Fixed-capacity frame: Features + stereo/depth channels.

    xy is UNDISTORTED level-0 coords (like Frame::mvKeysUn); ur/depth < 0
    where unavailable (mono or unmatched).
    """

    xy: jnp.ndarray        # (N, 2) undistorted
    level: jnp.ndarray     # (N,)
    angle: jnp.ndarray     # (N,)
    response: jnp.ndarray  # (N,)
    desc: jnp.ndarray      # (N, 8) uint32
    valid: jnp.ndarray     # (N,)
    ur: jnp.ndarray        # (N,) stereo right-u
    depth: jnp.ndarray     # (N,)

    @property
    def features(self) -> Features:
        return Features(
            xy=self.xy, level=self.level, angle=self.angle,
            response=self.response, desc=self.desc, valid=self.valid,
        )


def _undistorted(feats: Features, cam: CameraModel) -> jnp.ndarray:
    return undistort_points(cam, feats.xy)


def build_mono_frame(image, extractor: OrbExtractor, cam: CameraModel) -> Frame:
    f = extractor(image)
    n = f.xy.shape[0]
    return Frame(
        xy=_undistorted(f, cam), level=f.level, angle=f.angle,
        response=f.response, desc=f.desc, valid=f.valid,
        ur=jnp.full((n,), -1.0, jnp.float32),
        depth=jnp.full((n,), -1.0, jnp.float32),
    )


def build_stereo_frame(
    image_left, image_right, extractor: OrbExtractor, cam: CameraModel,
    scale_factors: jnp.ndarray,
) -> Frame:
    pair = jnp.stack([jnp.asarray(image_left), jnp.asarray(image_right)])
    # Two independent extractions in one program; XLA overlaps the two
    # subgraphs, as the reference runs 2 extraction threads
    # (Frame.cc:≈110).  A jax.vmap over the pair is untried on the GPU.
    left = extractor(pair[0])
    right = extractor(pair[1])
    ur, depth = stereo_ops.compute_stereo_matches(
        left, right, pair[0], pair[1], scale_factors, cam.bf
    )
    return Frame(
        xy=_undistorted(left, cam), level=left.level, angle=left.angle,
        response=left.response, desc=left.desc, valid=left.valid,
        ur=ur, depth=depth,
    )


def build_rgbd_frame(
    image, depth_map, extractor: OrbExtractor, cam: CameraModel,
    depth_factor: float = 1.0,
) -> Frame:
    f = extractor(image)
    ur, depth = stereo_ops.depth_from_depthmap(
        f, jnp.asarray(depth_map), cam.bf, jnp.float32(depth_factor)
    )
    return Frame(
        xy=_undistorted(f, cam), level=f.level, angle=f.angle,
        response=f.response, desc=f.desc, valid=f.valid,
        ur=ur, depth=depth,
    )
