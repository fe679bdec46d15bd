"""Augmented-reality overlay — the AR demo node's capability
(Examples/ROS/ORB_SLAM2/src/AR/ros_mono_ar.cc + ViewerAR.{cc,h},
SURVEY.md §2.4): fit a dominant plane to the tracked map points and render
a virtual cube anchored to it using the live camera pose.

Batched pieces:
* ``fit_plane_ransac`` — the ViewerAR::DetectPlane equivalent as a batched
  fixed-iteration RANSAC (one hypothesis tensor, no loops) + SVD refine on
  the inlier set.
* ``cube_vertices`` / ``project_points`` — geometry for the overlay.
* ``draw_ar_overlay`` — headless PNG rendering (viewer-lite style; the
  reference draws through Pangolin/OpenCV windows).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class Plane(NamedTuple):
    normal: jnp.ndarray   # (3,) unit normal
    point: jnp.ndarray    # (3,) a point on the plane (inlier centroid)
    n_inliers: jnp.ndarray
    ok: jnp.ndarray


@jax.jit
def fit_plane_ransac(
    points: jnp.ndarray,      # (P, 3) world points
    valid: jnp.ndarray,       # (P,) mask
    key: jnp.ndarray,
    n_hyp: int = 256,
    inlier_th: float = 0.02,  # distance threshold (map units)
) -> Plane:
    """Dominant-plane RANSAC (ViewerAR::DetectPlane): sample 3 points per
    hypothesis, count inliers by point-plane distance, pick the best, then
    refine normal/centroid on the inlier set (principal-axis SVD)."""
    P = points.shape[0]
    w = valid.astype(jnp.float32)
    w = w / jnp.maximum(jnp.sum(w), 1.0)
    idx = jax.random.choice(key, P, shape=(n_hyp, 3), p=w)
    a = points[idx[:, 0]]
    b = points[idx[:, 1]]
    c = points[idx[:, 2]]
    n = jnp.cross(b - a, c - a)
    n_norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(n_norm, 1e-9)
    degenerate = n_norm[:, 0] < 1e-9

    # (H, P) point-plane distances.
    d = jnp.abs(jnp.einsum("hj,hpj->hp", n, points[None, :, :] - a[:, None, :]))
    inl = (d <= inlier_th) & valid[None, :]
    counts = jnp.where(degenerate, -1, jnp.sum(inl, axis=1))
    best = jnp.argmax(counts)

    inl_best = inl[best]
    wts = inl_best.astype(jnp.float32)
    centroid = jnp.sum(points * wts[:, None], axis=0) / jnp.maximum(
        jnp.sum(wts), 1.0
    )
    X = (points - centroid) * wts[:, None]
    # Smallest principal axis of the inlier scatter = refined normal.
    C = X.T @ X
    _, vecs = jnp.linalg.eigh(C)
    normal = vecs[:, 0]
    normal = normal / jnp.maximum(jnp.linalg.norm(normal), 1e-9)
    return Plane(
        normal=normal,
        point=centroid,
        n_inliers=counts[best],
        ok=counts[best] >= 20,
    )


def cube_vertices(plane: Plane, size: float = 0.3,
                  anchor: Optional[np.ndarray] = None) -> np.ndarray:
    """(8, 3) world-space cube corners sitting on the plane."""
    n = np.asarray(plane.normal, np.float64)
    p0 = np.asarray(anchor if anchor is not None else plane.point, np.float64)
    # Orthonormal in-plane basis.
    t = np.array([1.0, 0.0, 0.0])
    if abs(n @ t) > 0.9:
        t = np.array([0.0, 1.0, 0.0])
    u = np.cross(n, t); u /= np.linalg.norm(u)
    v = np.cross(n, u)
    s = size / 2.0
    base = [p0 + du * s * u + dv * s * v for du, dv in
            [(-1, -1), (1, -1), (1, 1), (-1, 1)]]
    top = [q + size * n for q in base]
    return np.stack(base + top)


CUBE_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def project_points(T_cw: np.ndarray, cam, pts_w: np.ndarray):
    """(N, 2) pixels + in-front mask for world points under pose T_cw."""
    T = np.asarray(T_cw, np.float64)
    pc = pts_w @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    uv = np.stack(
        [float(cam.fx) * pc[:, 0] / np.maximum(z, 1e-9) + float(cam.cx),
         float(cam.fy) * pc[:, 1] / np.maximum(z, 1e-9) + float(cam.cy)], -1
    )
    return uv, z > 0.05


def draw_ar_overlay(image, T_cw, cam, plane: Plane, path: str,
                    size: float = 0.3, anchor=None):
    """Render image + cube wireframe to ``path`` (headless PNG)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    verts = cube_vertices(plane, size=size, anchor=anchor)
    uv, front = project_points(T_cw, cam, verts)
    fig, ax = plt.subplots(figsize=(6.4, 4.8), dpi=100)
    ax.imshow(np.asarray(image), cmap="gray", vmin=0, vmax=255)
    for i, j in CUBE_EDGES:
        if front[i] and front[j]:
            ax.plot([uv[i, 0], uv[j, 0]], [uv[i, 1], uv[j, 1]],
                    color="lime", lw=2)
    ax.set_xlim(0, np.asarray(image).shape[1])
    ax.set_ylim(np.asarray(image).shape[0], 0)
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
