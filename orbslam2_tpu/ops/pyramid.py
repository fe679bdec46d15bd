"""Image pyramid + Gaussian blur.

JAX equivalent of ``ORBextractor::ComputePyramid``
(src/ORBextractor.cc:≈750: 8 levels, scale 1.2, bilinear resize) and the
7x7 sigma=2 GaussianBlur applied before descriptor extraction
(src/ORBextractor.cc:≈1060).  All shapes are static per level; XLA fuses the
separable convolutions.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(
    height: int, width: int, n_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    """Static (H, W) per pyramid level (level 0 = full resolution)."""
    return [
        (
            max(int(round(height / scale_factor**i)), 32),
            max(int(round(width / scale_factor**i)), 32),
        )
        for i in range(n_levels)
    ]


def build_pyramid(
    image: jnp.ndarray, n_levels: int, scale_factor: float
) -> List[jnp.ndarray]:
    """Grayscale image (H, W) float32 -> list of per-level images.

    Successive bilinear downsampling (resampling from the previous level like
    the reference, not from level 0, so aliasing behavior matches).
    """
    shapes = level_shapes(image.shape[0], image.shape[1], n_levels, scale_factor)
    levels = [image]
    for i in range(1, n_levels):
        prev = levels[-1]
        levels.append(
            jax.image.resize(prev, shapes[i], method="bilinear", antialias=True)
        )
    return levels


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(1, 2))
def gaussian_blur(image: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with edge replication (matches cv::GaussianBlur
    BORDER_REFLECT_101 closely enough for descriptor sampling)."""
    k = jnp.asarray(_gaussian_kernel(ksize, sigma))
    r = ksize // 2
    padded = jnp.pad(image, ((r, r), (0, 0)), mode="reflect")
    # Convolve rows then cols via depthwise 1-D convs (XLA fuses them;
    # image is (H, W) f32).
    out = jnp.zeros_like(image)
    for i in range(ksize):
        out = out + k[i] * jax.lax.dynamic_slice_in_dim(padded, i, image.shape[0], 0)
    padded = jnp.pad(out, ((0, 0), (r, r)), mode="reflect")
    out2 = jnp.zeros_like(image)
    for i in range(ksize):
        out2 = out2 + k[i] * jax.lax.dynamic_slice_in_dim(padded, i, image.shape[1], 1)
    return out2


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level scale (level-i coords * scale[i] = level-0 coords)."""
    return np.array([scale_factor**i for i in range(n_levels)], np.float32)


def level_sigma2(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level measurement variance sigma^2 = scale^2 (ORBextractor ctor,
    src/ORBextractor.cc:≈430: mvLevelSigma2[i] = mvScaleFactor[i]^2)."""
    return scale_factors(n_levels, scale_factor) ** 2


def features_per_level(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Reference's per-level feature budget (ORBextractor ctor,
    src/ORBextractor.cc:≈430): geometric series over 1/scaleFactor."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1.0 - factor) / (1.0 - factor**n_levels)
    out = []
    total = 0
    for i in range(n_levels - 1):
        n = int(round(n_first * factor**i))
        out.append(n)
        total += n
    out.append(max(n_features - total, 0))
    return out
