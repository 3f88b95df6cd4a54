"""SPH kernel functions, equation of state, and wall forces.

These are exact functional transcriptions of the reference's HLSL formulas
(not the Müller-03 textbook forms — see notes):

* poly6 density kernel          — Density.compute:22-27
* pressure gradient kernel      — VelPos.compute:33-38  (profile (h−r)³, NOT
  the textbook spiky gradient (h−r)²; reproduced verbatim for parity)
* viscosity Laplacian kernel    — VelPos.compute:40-44
* equation of state             — VelPos.compute:61,87  (p can be negative)
* wall penalty force            — VelPos.compute:107-137 (including the quirk
  that the damping term is the SCALAR dot(damp, v) subtracted from all three
  force components)

All functions are elementwise over leading batch dimensions and f32.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from ..config import EPSILON

_PI = math.pi


def w_poly6(r2, h2, h9):
    """Density kernel W(r) = 315/(64π) · (h²−|r|²)³ / h⁹ for |r|² < h².

    Density.compute:22-27. Takes squared distance ``r2`` (f32[...]).
    """
    c = 315.0 / (64.0 * _PI)
    diff = h2 - r2
    w = c * (diff * diff * diff) / h9
    return jnp.where(diff > 0, w, 0.0)


def grad_w_press_over_r(abs_r, h, h6):
    """Scalar radial factor of the pressure kernel gradient: multiply by the
    displacement components (pos_i − pos_j) to get the vector gradient.

    grad_W_press(r) = 45/π / h⁶ · (h−|r|)³ · r/|r|, valid only when both
    |r| > ε and (h−|r|) > ε (VelPos.compute:33-38). Note the cubic (h−r)³
    radial profile — the reference's deviation from Müller-03's (h−r)².

    Kept component-wise (caller multiplies dx, dy, dz separately) so big
    pairwise intermediates never materialize trailing-dim-3 arrays.
    """
    c = 45.0 / _PI
    diff_r = h - abs_r
    valid = (diff_r > EPSILON) & (abs_r > EPSILON)
    safe_abs = jnp.where(valid, abs_r, 1.0)
    mag = (c / h6) * (diff_r * diff_r * diff_r) / safe_abs
    return jnp.where(valid, mag, 0.0)


def grad_w_press(r_vec, h, h6):
    """Vector form of the pressure gradient (reference tests / small shapes)."""
    abs_r = jnp.linalg.norm(r_vec, axis=-1)
    return grad_w_press_over_r(abs_r, h, h6)[..., None] * r_vec


def grad_w_vis_r(abs_r, h, h6):
    """Viscosity Laplacian kernel: 45/π / h⁶ · (h−|r|) for |r| < h.

    VelPos.compute:40-44 (standard Müller viscosity Laplacian). Scalar.
    """
    c = 45.0 / _PI
    return jnp.where(abs_r < h, (c / h6) * (h - abs_r), 0.0)


def grad_w_vis(r_vec, h, h6):
    """Vector-displacement wrapper of :func:`grad_w_vis_r`."""
    return grad_w_vis_r(jnp.linalg.norm(r_vec, axis=-1), h, h6)


def eos_pressure(rho, gas_constant, rest_density):
    """p = k·(ρ − ρ₀) (VelPos.compute:61,87). May be negative."""
    return gas_constant * (rho - rest_density)


def wall_force(pos, vel, h, stiffness, damping, mass):
    """Box-boundary penalty force (VelPos.compute:107-137).

    Per axis: penetration depth r = h−p if p < h, r = 1−p−h if p > 1−h
    (note the second is negative), else 0. Then

        f_wall = r·stiffness − dot(damp, v)        (VelPos.compute:135)

    where damp.axis = damping iff r.axis ≠ 0 and the dot product is a SCALAR
    subtracted from ALL components — a reference quirk reproduced exactly.
    The force is scaled by mass (:136) and applied only if max|r| > 0 (:133).

    pos, vel: f32[..., 3]. Returns f32[..., 3].
    """
    low = h - pos                 # r when pos < h
    high = 1.0 - pos - h          # r when pos > 1 − h (negative)
    r = jnp.where(pos < h, low, jnp.where(pos > 1.0 - h, high, 0.0))
    damp = jnp.where(r != 0.0, damping, 0.0)
    damp_dot = jnp.sum(damp * vel, axis=-1, keepdims=True)  # scalar per particle
    f = (r * stiffness - damp_dot) * mass
    active = jnp.max(jnp.abs(r), axis=-1, keepdims=True) > 0.0
    return jnp.where(active, f, 0.0)


def cell_index(pos, bucket_resolution):
    """Voxel coordinates int3(pos · (R−1)) (Bucket.compute:27).

    The HLSL int cast truncates toward zero, which `astype(int32)` matches;
    slightly-out-of-range positions (jittered init before the first clamp)
    land in edge cells exactly as in the reference.
    """
    return (pos * (bucket_resolution - 1)).astype(jnp.int32)
