"""Multi-host runtime: jax.distributed init + live-map sharding.

SURVEY.md §2.5/§5's north star is map parallelism within and across hosts: the
reference is a single-process shared-memory system (no backend at all);
this module is the genuinely new capability layer on top of parallel/mesh:

  * ``initialize_distributed`` — the ``jax.distributed.initialize`` launch
    path for multi-host meshes (one process per host).  Single-process/
    virtual-device runs skip it.
  * ``shard_map_state`` — places the LIVE ``MapState`` on a mesh with
    keyframe-block sharding: every keyframe-major pool (poses, keypoints,
    descriptors, bindings) is sharded along the ``map`` axis; the landmark
    pools and counters are replicated.  Jitted map programs (local
    mapping, BA gathers, covisibility) then run under GSPMD, with XLA
    inserting the all-gathers/psums that the explicitly-collective solvers
    in dist_ba/dist_pose_graph spell out by hand.

Launch recipe (per host)::

    initialize_distributed(coordinator="host0:9999",
                           num_processes=N, process_id=i)
    mesh = make_mesh()            # all global devices
    m = shard_map_state(m, mesh)  # keyframe blocks on this host's shard

The keyframe axis is the natural shard axis (SURVEY §2.5 'map sharding:
keyframes + covisibility blocks per host'): appends touch one block,
local-BA windows gather a handful of rows, and the reduction-heavy point
axis stays replicated so landmark scatter-adds stay local.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import map_state as ms
from .mesh import MAP_AXIS


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Bring up the jax.distributed runtime for a multi-host mesh.

    No-op (returns False) when running single-process — virtual-device
    tests and the single-chip bench need no coordinator.  Mirrors
    ``jax.distributed.initialize``'s auto-detection when args are None
    (cluster environments populate them)."""
    if num_processes is not None and num_processes <= 1:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except (RuntimeError, ValueError) as e:
        # Already initialized, or single-process context without env hints.
        if "already" in str(e).lower():
            return True
        raise


def map_state_shardings(m: ms.MapState, mesh: Mesh):
    """Per-field NamedSharding for a MapState: keyframe-major pools are
    sharded along the keyframe axis, everything else replicated."""
    kf_fields = {
        "kf_pose_cw", "kf_xy", "kf_level", "kf_angle", "kf_desc", "kf_ur",
        "kf_kp_valid", "kf_point", "kf_valid", "kf_frame_id", "kf_parent",
    }
    shardings = {}
    for name in m._fields:
        if name in kf_fields and m.kf_capacity % mesh.devices.size == 0:
            shardings[name] = NamedSharding(mesh, P(MAP_AXIS))
        else:
            shardings[name] = NamedSharding(mesh, P())
    return type(m)(**shardings)


def shard_map_state(m: ms.MapState, mesh: Mesh) -> ms.MapState:
    """Place the live map on ``mesh`` with keyframe-block sharding.

    Requires kf_capacity to divide evenly by the mesh size (pools are
    powers of two; pad the capacity, not the mesh).  Returns the same
    values re-placed; subsequent jitted updates preserve the sharding
    through GSPMD."""
    sh = map_state_shardings(m, mesh)
    return type(m)(*(
        jax.device_put(leaf, s) for leaf, s in zip(m, sh)
    ))
