"""Device mesh + sharding helpers.

The reference has NO distributed story (single process, shared memory —
SURVEY.md §2.5); this package is the genuinely new capability: the map
(keyframes + their observations) sharded over a ``Mesh`` axis ``"map"``,
with XLA collectives reducing solver blocks across devices (BASELINE.json north
star; SURVEY.md §5 'map parallelism ≈ context parallelism').
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

MAP_AXIS = "map"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the ``map`` axis (keyframe-block sharding)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (MAP_AXIS,))


def kf_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (keyframe) axis."""
    return NamedSharding(mesh, P(MAP_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
