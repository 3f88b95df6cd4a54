"""Particle state pytrees.

The reference stores particle state in ping-ponged square float4 textures
(SphFluidSimulation.cs:138-155); here the layout is a struct-of-arrays
pytree of flat ``[N, 3]`` float32 arrays advanced functionally (no ping-pong —
XLA double-buffers for us). Particle index ``i`` corresponds to reference
texel ``(i % res, i / res)`` (Density.compute:53, VelPos.compute:84).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ParticleState(NamedTuple):
    """Positions in the unit cube [0,1]³ and velocities (unit-cube units/s).

    ``nan_count`` replaces the reference's per-particle NaN alpha marker
    (VelPos.compute:143-147): instead of tagging velocity.w = 0.003 we count
    trapped-NaN events per particle, which is strictly more informative.
    """

    pos: jax.Array        # f32[N, 3]
    vel: jax.Array        # f32[N, 3]
    nan_count: jax.Array  # i32[N]

    @property
    def n(self) -> int:
        return self.pos.shape[-2]


def make_state(pos: jax.Array, vel: jax.Array | None = None) -> ParticleState:
    pos = jnp.asarray(pos, jnp.float32)
    if vel is None:
        # Velocities are zero-initialized (SphFluidSimulation.cs:189).
        vel = jnp.zeros_like(pos)
    nan_count = jnp.zeros(pos.shape[:-1], jnp.int32)
    return ParticleState(pos=pos, vel=jnp.asarray(vel, jnp.float32), nan_count=nan_count)


class FrameAux(NamedTuple):
    """Per-frame cached quantities reused across the 5 substeps.

    The reference builds the bucket once per frame and computes density once
    per frame, then reuses both for all five integration substeps
    (SphFluidSimulation.cs:98-102). ``cell`` is each particle's voxel at
    frame start (the "stale" cell used for neighbor candidate lookup), and
    ``rho`` the frame-start density.
    """

    rho: jax.Array   # f32[N]
    cell: jax.Array  # i32[N, 3] — frame-start voxel coordinates


class StepMetrics(NamedTuple):
    """Structured observability per frame (no reference equivalent; the
    reference's only observability is speed-based coloring and the NaN alpha
    marker — SURVEY.md §5)."""

    max_speed: jax.Array      # f32[]
    mean_density: jax.Array   # f32[]
    kinetic_energy: jax.Array # f32[]
    nan_events: jax.Array     # i32[] — total NaN traps this frame
    overflow: jax.Array       # i32[] — particles dropped by voxel capacity
    exact_cert: jax.Array     # i32[] — sites exactness certificate: count of
                              # candidates/particles beyond the site capacity
                              # or the slab halo this frame (0 == the
                              # reference candidate set; always 0 on the
                              # brute/gather/slotted backends)
