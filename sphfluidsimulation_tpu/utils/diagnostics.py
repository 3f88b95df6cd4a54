"""Debug-build state validation (SURVEY.md §5: failure detection).

The reference's only runtime guard is the in-kernel NaN trap
(VelPos.compute:143-147). Beyond the always-on per-particle ``nan_count``
and the sites exactness certificates, this module adds:

* ``validate_state`` — host-side invariant checks (finite, in-cube, shapes)
  raising ``StateError`` with a diagnosis;
* ``checkify_step`` — wraps a step function with ``jax.experimental
  .checkify`` so invariant violations are detected *inside* jit without
  host round-trips per frame (debug builds; ~free when checks pass).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify

from ..state import ParticleState


class StateError(RuntimeError):
    pass


def validate_state(state: ParticleState, *, n_particles: int | None = None
                   ) -> dict:
    """Host-side invariant check; returns a small diagnostics dict."""
    pos = np.asarray(jax.device_get(state.pos))
    vel = np.asarray(jax.device_get(state.vel))
    if n_particles is not None and pos.shape != (n_particles, 3):
        raise StateError(f"position shape {pos.shape} != ({n_particles}, 3)")
    bad_pos = ~np.isfinite(pos)
    bad_vel = ~np.isfinite(vel)
    out_of_cube = (pos < 0.0) | (pos > 1.0)
    diag = {
        "nonfinite_pos": int(bad_pos.any(axis=-1).sum()),
        "nonfinite_vel": int(bad_vel.any(axis=-1).sum()),
        "out_of_cube": int(out_of_cube.any(axis=-1).sum()),
        "nan_trapped": int(np.asarray(state.nan_count).sum()),
        "max_speed": float(np.sqrt((vel * vel).sum(-1).max())),
    }
    if diag["nonfinite_pos"]:
        raise StateError(f"non-finite positions: {diag}")
    return diag


def checkify_step(step: Callable) -> Callable:
    """Wrap ``step(state, ...)`` with in-jit invariant checks.

    Returns ``checked(state, ...) -> (state', metrics)`` that raises on the
    first frame whose positions leave [0,1]³ or go non-finite (which the
    clamp should make impossible — catching a framework bug, not a physics
    event).
    """

    def with_checks(state, *args):
        out_state, metrics = step(state, *args)
        checkify.check(jnp.all(jnp.isfinite(out_state.pos)),
                       "non-finite positions after step")
        checkify.check(jnp.all((out_state.pos >= 0.0)
                               & (out_state.pos <= 1.0)),
                       "positions escaped the unit cube (clamp broken)")
        return out_state, metrics

    checked = checkify.checkify(with_checks)

    def run(state, *args):
        err, out = checked(state, *args)
        err.throw()
        return out

    return run
