"""Traced physics parameters.

The reference uploads its physics constants as shader uniforms each dispatch
(SphFluidSimulation.cs:229-265 via ShaderIDs.cs:5-32); the JAX
equivalent is a pytree of f32 scalars passed through the jitted step, so one
compiled executable serves every parameter setting — and `vmap` over the
pytree gives batched multi-scene sweeps (BASELINE config 5) for free.

Structural quantities that determine array shapes (particle count, bucket
resolution, voxel capacity, substep count) stay static in `SimConfig`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import GRAVITY_Y, SimConfig


class PhysParams(NamedTuple):
    """Per-scene physics scalars (all f32, all traced; leading batch dims
    broadcast through the whole step for vmapped sweeps)."""

    h: jax.Array               # smoothing length = 1/(R-1) (cs:159)
    mass: jax.Array            # damFillRate / N (cs:176)
    gas_constant: jax.Array    # EOS k (VelPos.compute:61)
    rest_density: jax.Array    # rho_0
    viscosity: jax.Array       # mu
    stiffness: jax.Array       # wall spring (VelPos.compute:135)
    damping: jax.Array         # wall damping coefficient
    dt: jax.Array              # substep timestep = frame_dt/25 (cs:102)
    gravity_y: jax.Array       # hardcoded -9.8 in the reference (VelPos:7)

    @classmethod
    def from_config(cls, cfg: SimConfig) -> "PhysParams":
        f = lambda x: jnp.float32(x)  # noqa: E731
        return cls(
            h=f(cfg.effective_radius),
            mass=f(cfg.particle_mass),
            gas_constant=f(cfg.gas_constant),
            rest_density=f(cfg.rest_density),
            viscosity=f(cfg.viscosity),
            stiffness=f(cfg.stiffness_coefficient),
            damping=f(cfg.damping_coefficient),
            dt=f(cfg.substep_dt),
            gravity_y=f(GRAVITY_Y),
        )


def stack_params(params: list[PhysParams]) -> PhysParams:
    """Stack per-scene params along a leading batch axis for vmap."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *params)
