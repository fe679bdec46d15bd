"""Guard against device-array closure captures in jitted programs.

A jitted program that closes over a concrete ``jax.Array`` (instead of
numpy / a traced argument) gets that array baked into its executable as a
constant: the compiled program holds a private copy, and a program that
should take the array as an input silently ties its result to one value.

The rule this module enforces: jitted code may close over numpy arrays and
python scalars (baked into the HLO as literals), and may take jax.Arrays as
ARGUMENTS — but must never close over a concrete jax.Array.

``device_consts(fn, *args)`` traces ``fn`` and returns every captured
jax.Array, recursing through nested pjit/scan/cond/while jaxprs, so tests
can assert the production programs are capture-free
(tests/test_no_device_consts.py).
"""

from __future__ import annotations

from typing import Any, List

import jax
import numpy as np


def _walk_jaxpr(jaxpr, out: List[Any], seen: set):
    if id(jaxpr) in seen:
        return
    seen.add(id(jaxpr))
    # ClosedJaxpr: inspect its literal consts.
    consts = getattr(jaxpr, "consts", None) or []
    for c in consts:
        if isinstance(c, jax.Array) and not isinstance(c, jax.core.Tracer):
            out.append(c)
    inner = getattr(jaxpr, "jaxpr", jaxpr)
    for eqn in getattr(inner, "eqns", []):
        for v in eqn.params.values():
            _walk_param(v, out, seen)


def _walk_param(v, out, seen):
    if hasattr(v, "eqns") or hasattr(v, "jaxpr"):
        _walk_jaxpr(v, out, seen)
    elif isinstance(v, (tuple, list)):
        for x in v:
            _walk_param(x, out, seen)


def device_consts(fn, *args, **kwargs) -> List[jax.Array]:
    """Trace ``fn(*args, **kwargs)`` and return every closure-captured
    concrete jax.Array (device const), recursing into nested jaxprs."""
    closed = jax.make_jaxpr(fn)(*args, **kwargs)
    out: List[Any] = []
    _walk_jaxpr(closed, out, set())
    return out


def assert_no_device_consts(fn, *args, **kwargs):
    bad = device_consts(fn, *args, **kwargs)
    if bad:
        descr = ", ".join(f"{b.dtype}{list(b.shape)}" for b in bad[:8])
        raise AssertionError(
            f"jitted program closes over {len(bad)} device array(s) "
            f"[{descr}] — closure constants must be numpy (see "
            f"orbslam2_tpu/utils/noconsts.py)"
        )
