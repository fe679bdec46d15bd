"""Pinhole camera model with radial-tangential distortion.

JAX replacement for the reference's scattered OpenCV camera math:
``Frame::UndistortKeyPoints`` (src/Frame.cc:≈420), ``Frame::UnprojectStereo``
(src/Frame.cc:≈630), projection inside ``ORBmatcher::SearchByProjection`` and
the g2o reprojection edges.  All functions are batched over leading dims and
jit-safe (fixed-iteration undistortion instead of OpenCV's iterative solver).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class CameraModel(NamedTuple):
    """Static per-sequence camera intrinsics (HOST-resident numpy scalars).

    Mirrors the YAML keys the reference's Tracking ctor parses
    (src/Tracking.cc:≈55-170): Camera.fx/fy/cx/cy, k1 k2 p1 p2 [k3],
    Camera.bf (stereo baseline x fx), width/height.

    The leaves are numpy (NOT jax device arrays) ON PURPOSE: the camera
    model is closure-captured as a constant by every fused tracking /
    mapping program; numpy leaves bake into the HLO as literal constants,
    while a captured device array is baked into the executable by value
    (utils/noconsts.py; tests/test_no_device_consts.py guards it).
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    # distortion [k1, k2, p1, p2, k3]
    dist: jnp.ndarray
    bf: jnp.ndarray  # stereo baseline * fx (0 for mono)
    width: int
    height: int
    # Undistorted image bounds (min_x, max_x, min_y, max_y), computed once like
    # Frame::ComputeImageBounds (src/Frame.cc:≈440).
    min_x: jnp.ndarray
    max_x: jnp.ndarray
    min_y: jnp.ndarray
    max_y: jnp.ndarray

    @property
    def K(self) -> jnp.ndarray:
        return jnp.array(
            [
                [self.fx, 0.0, self.cx],
                [0.0, self.fy, self.cy],
                [0.0, 0.0, 1.0],
            ],
            dtype=jnp.float32,
        )

    @property
    def baseline(self) -> jnp.ndarray:
        return self.bf / self.fx


def make_camera(fx, fy, cx, cy, dist=None, bf=0.0, width=640, height=480) -> CameraModel:
    # numpy-only on purpose — see the CameraModel docstring.
    dist = np.zeros(5, np.float32) if dist is None else np.asarray(dist, np.float32)
    if dist.shape[0] < 5:
        dist = np.concatenate([dist, np.zeros(5 - dist.shape[0], np.float32)])
    cam = CameraModel(
        fx=np.float32(fx), fy=np.float32(fy), cx=np.float32(cx), cy=np.float32(cy),
        dist=dist, bf=np.float32(bf), width=int(width), height=int(height),
        min_x=np.float32(0.0), max_x=np.float32(width),
        min_y=np.float32(0.0), max_y=np.float32(height),
    )
    # Undistorted bounds from the 4 image corners (Frame.cc:≈440).
    corners = np.array(
        [[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]], np.float32
    )
    und = np.asarray(undistort_points(cam, corners))
    cam = cam._replace(
        min_x=np.float32(min(und[0, 0], und[2, 0])),
        max_x=np.float32(max(und[1, 0], und[3, 0])),
        min_y=np.float32(min(und[0, 1], und[1, 1])),
        max_y=np.float32(max(und[2, 1], und[3, 1])),
    )
    return cam


def distort_normalized(cam: CameraModel, xn: jnp.ndarray) -> jnp.ndarray:
    """Apply radial-tangential distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return jnp.stack([xd, yd], axis=-1)


def project(cam: CameraModel, p_cam: jnp.ndarray, distort: bool = False) -> jnp.ndarray:
    """Project camera-frame 3-D points (..., 3) to pixels (..., 2).

    By default projects WITHOUT distortion — the reference operates on
    undistorted keypoints everywhere downstream of extraction.
    """
    z = p_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    xn = p_cam[..., :2] * inv_z[..., None]
    if distort:
        xn = distort_normalized(cam, xn)
    u = cam.fx * xn[..., 0] + cam.cx
    v = cam.fy * xn[..., 1] + cam.cy
    return jnp.stack([u, v], axis=-1)


def project_stereo(cam: CameraModel, p_cam: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3) [u, v, u_right] using bf (Camera.bf)."""
    uv = project(cam, p_cam)
    z = p_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    ur = uv[..., 0] - cam.bf * inv_z
    return jnp.concatenate([uv, ur[..., None]], axis=-1)


def backproject(cam: CameraModel, uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """Undistorted pixels (..., 2) + depth (...) -> camera-frame points (..., 3).

    Equivalent of Frame::UnprojectStereo (src/Frame.cc:≈630) minus the
    world-frame transform.
    """
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def undistort_points(cam: CameraModel, uv: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Undistort pixel coords (..., 2) -> undistorted pixel coords.

    Fixed-point iteration (the standard cv::undistortPoints scheme) with a
    static iteration count so it stays jit/XLA friendly.  Matches
    Frame::UndistortKeyPoints (src/Frame.cc:≈420).
    """
    xd = jnp.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], axis=-1
    )
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x = xd
    for _ in range(iters):
        r2 = jnp.sum(x * x, axis=-1)
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy = x[..., 0] * x[..., 1]
        dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x[..., 0] ** 2)
        dy = p1 * (r2 + 2.0 * x[..., 1] ** 2) + 2.0 * p2 * xy
        x = (xd - jnp.stack([dx, dy], axis=-1)) / radial[..., None]
    u = cam.fx * x[..., 0] + cam.cx
    v = cam.fy * x[..., 1] + cam.cy
    return jnp.stack([u, v], axis=-1)


def in_image(cam: CameraModel, uv: jnp.ndarray) -> jnp.ndarray:
    """Boolean mask: undistorted pixel inside the (undistorted) image bounds."""
    return (
        (uv[..., 0] >= cam.min_x)
        & (uv[..., 0] < cam.max_x)
        & (uv[..., 1] >= cam.min_y)
        & (uv[..., 1] < cam.max_y)
    )
