"""Per-instance render properties (device-side, jittable).

Transcribes ``Assets/Resources/UpdateMeshProperties.compute``:

* world position = unit-cube position · simScale − simScale/2
  (UpdateMeshProperties.compute:34-40 — the SimTRS translation is extracted
  at :37 but never applied, so only the diagonal scale matters; the host
  passes transform.localToWorldMatrix with the scene's uniform scale 5,
  SphFluidSimulation.cs:284, SampleScene.unity:461)
* per-instance matrix = translation(worldPos) · scale(particleRadius)
  (:43-59; the host passes particleRadius on all three axes,
  SphFluidSimulation.cs:280)
* color = lerp(blue → red, saturate((|v| − low)/(high − low))) (:62-63)

The MeshProperties struct (float4x4 + float4, :3-6) becomes a pair of
arrays (mat f32[N,4,4], color f32[N,4]) — struct-of-arrays layout.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SimConfig


class RenderParams(NamedTuple):
    low_speed: jax.Array      # _LowSpeed
    high_speed: jax.Array     # _HighSpeed
    particle_scale: jax.Array # _ParticleScale (= particleRadius, cs:280)
    sim_scale: jax.Array      # diagonal of _SimTRS (scene scale 5)

    @classmethod
    def from_config(cls, cfg: SimConfig) -> "RenderParams":
        return cls(low_speed=jnp.float32(cfg.low_speed),
                   high_speed=jnp.float32(cfg.high_speed),
                   particle_scale=jnp.float32(cfg.particle_radius),
                   sim_scale=jnp.float32(cfg.sim_scale))


def world_positions(pos: jax.Array, rp: RenderParams) -> jax.Array:
    """unit cube → world: pos·simScale − simScale/2
    (UpdateMeshProperties.compute:40)."""
    return pos * rp.sim_scale - rp.sim_scale * 0.5


# Alpha written to a NaN-trapped particle's velocity w channel
# (VelPos.compute:146: vel = float4(0, 0, 0, 0.003)).
NAN_MARKER_ALPHA = 0.003


def speed_colors(vel: jax.Array, rp: RenderParams,
                 nan_mask: jax.Array | None = None) -> jax.Array:
    """Blue→red speed ramp, RGBA f32[..., 4]
    (UpdateMeshProperties.compute:62-63).

    ``nan_mask`` (optional bool[...]) marks NaN-trapped particles with
    alpha 0.003 — the reference's only visual failure signal. The reference
    stores the marker in the velocity texture's w channel
    (VelPos.compute:146) where it survives one substep; its
    UpdateMeshProperties pass emits constant color alpha 1
    (UpdateMeshProperties.compute:63), so the marker never reaches the
    shader there — here it is surfaced on the instance color so trapped
    particles are render-visible (near-transparent). Callers typically pass
    ``state.nan_count > 0`` (ever-trapped) rather than the reference's
    transient last-substep population.
    """
    speed = jnp.linalg.norm(vel, axis=-1)
    t = jnp.clip((speed - rp.low_speed) / (rp.high_speed - rp.low_speed),
                 0.0, 1.0)
    blue = jnp.array([0.0, 0.0, 1.0, 1.0], jnp.float32)
    red = jnp.array([1.0, 0.0, 0.0, 1.0], jnp.float32)
    rgba = blue + (red - blue) * t[..., None]
    if nan_mask is not None:
        alpha = jnp.where(nan_mask, jnp.float32(NAN_MARKER_ALPHA),
                          rgba[..., 3])
        rgba = rgba.at[..., 3].set(alpha)
    return rgba


def mesh_properties(pos: jax.Array, vel: jax.Array, rp: RenderParams,
                    nan_mask: jax.Array | None = None
                    ) -> tuple[jax.Array, jax.Array]:
    """(mat f32[N,4,4], color f32[N,4]) — the MeshProperties buffer."""
    wp = world_positions(pos, rp)
    n = pos.shape[0]
    eye = jnp.eye(4, dtype=jnp.float32)
    mat = jnp.tile(eye, (n, 1, 1))
    s = jnp.broadcast_to(rp.particle_scale, (n,))
    mat = mat.at[:, 0, 0].set(s).at[:, 1, 1].set(s).at[:, 2, 2].set(s)
    mat = mat.at[:, 0, 3].set(wp[:, 0]).at[:, 1, 3].set(wp[:, 1]) \
             .at[:, 2, 3].set(wp[:, 2])
    return mat, speed_colors(vel, rp, nan_mask)
