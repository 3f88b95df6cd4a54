"""Grid-gathered density and force passes (XLA gather formulation).

Replaces the reference's per-thread 27-voxel × 32-slot walk
(Density.compute:42-57, VelPos.compute:67-98) with a static-shaped
fixed-fanout gather: a `lax.scan` over the 27 cell offsets, each step
gathering one voxel's C candidate slots for every particle. Shapes are fully
static, as XLA requires, and out-of-range cells / empty slots are
masked, reproducing the reference's bounds check (Density.compute:46) and
sentinel break (:52).

The ``*_rows`` variants compute results for a contiguous row block of
particles against the full candidate arrays — the building block for
spatial domain decomposition (each device computes its own rows after an
all_gather of the candidate source arrays).

Two layouts of the same walk: ``gather`` (per-candidate gathers, below) and
``slotted`` (packed 128-float slot rows, further down).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import EPSILON
from . import sph_math
from ..params import PhysParams
from .grid import Bucket, flat_cell_id, neighborhood_offsets


def _offset_candidates(table: jax.Array, cell_rows: jax.Array, off: jax.Array,
                       r: int, capacity: int, n: int) -> jax.Array:
    """Candidate particle ids in voxel (cell_rows + off) — i32[rows, C],
    sentinel n for empty/out-of-range (bounds check Density.compute:46)."""
    ncell = cell_rows + off[None, :]
    valid = jnp.all((ncell >= 0) & (ncell < r), axis=-1)
    ncid = jnp.where(valid, flat_cell_id(ncell, r), 0)
    slots = ncid[:, None] * capacity + jnp.arange(capacity, dtype=jnp.int32)[None, :]
    cand = table[slots]
    return jnp.where(valid[:, None], cand, n)


def density_grid_rows(pos_rows: jax.Array, cell_rows: jax.Array,
                      pos_all: jax.Array, table: jax.Array, capacity: int,
                      p: PhysParams, bucket_resolution: int) -> jax.Array:
    """ρ for a row block via the voxel table (Density.compute:32-60; the
    self term is included — no j==i skip)."""
    n = pos_all.shape[0]
    h2, h9 = p.h * p.h, p.h ** 9
    offs = neighborhood_offsets()

    def body(rho, off):
        cand = _offset_candidates(table, cell_rows, off, bucket_resolution,
                                  capacity, n)
        ok = cand < n
        j = jnp.minimum(cand, n - 1)
        diff = pos_rows[:, None, :] - pos_all[j]
        r2 = jnp.sum(diff * diff, axis=-1)
        w = sph_math.w_poly6(r2, h2, h9)
        return rho + jnp.sum(jnp.where(ok, p.mass * w, 0.0), axis=-1), None

    rho, _ = jax.lax.scan(body, jnp.zeros(pos_rows.shape[0], jnp.float32), offs)
    return rho


def fluid_forces_grid_rows(pos_rows: jax.Array, vel_rows: jax.Array,
                           ids_rows: jax.Array, rho_rows: jax.Array,
                           pos_all: jax.Array, vel_all: jax.Array,
                           rho_all: jax.Array, table: jax.Array,
                           capacity: int, p: PhysParams,
                           bucket_resolution: int) -> jax.Array:
    """Pressure + viscosity for a row block (VelPos.compute:49-105).

    ``pos/vel`` are fresh (current substep); ``rho`` and the table are
    frame-start stale. The candidate window is centered on the *fresh* cell
    of each row (VelPos.compute:57-58 recomputes idx_3d each substep).
    ``ids_rows`` are global particle ids for the j==i skip (VelPos:82).
    """
    n = pos_all.shape[0]
    h6 = p.h ** 6
    cell_fresh = sph_math.cell_index(pos_rows, bucket_resolution)
    press_rows = sph_math.eos_pressure(rho_rows, p.gas_constant, p.rest_density)
    press_all = sph_math.eos_pressure(rho_all, p.gas_constant, p.rest_density)
    offs = neighborhood_offsets()

    def body(carry, off):
        f_press, f_vis = carry
        cand = _offset_candidates(table, cell_fresh, off, bucket_resolution,
                                  capacity, n)
        ok = (cand < n) & (cand != ids_rows[:, None])  # skip j==i (VelPos:82)
        j = jnp.minimum(cand, n - 1)
        rho_j = rho_all[j]
        ok = ok & (rho_j > EPSILON)                    # VelPos.compute:91
        safe_rho = jnp.where(rho_j > EPSILON, rho_j, 1.0)
        diff = pos_rows[:, None, :] - pos_all[j]
        gwp = sph_math.grad_w_press(diff, p.h, h6)
        gwv = sph_math.grad_w_vis(diff, p.h, h6)
        press_coef = (press_rows[:, None] + press_all[j]) / (2.0 * safe_rho)
        dfp = jnp.sum(jnp.where(ok[..., None], press_coef[..., None] * gwp, 0.0), 1)
        dvel = vel_all[j] - vel_rows[:, None, :]
        vis_coef = gwv / safe_rho
        dfv = jnp.sum(jnp.where(ok[..., None], vis_coef[..., None] * dvel, 0.0), 1)
        return (f_press + dfp, f_vis + dfv), None

    zero = jnp.zeros_like(pos_rows)
    (f_press, f_vis), _ = jax.lax.scan(body, (zero, zero), offs)

    # Final scaling, guarded by ρ_i > ε (VelPos.compute:101-105).
    i_ok = (rho_rows > EPSILON)[:, None]
    safe_rho_i = jnp.where(rho_rows > EPSILON, rho_rows, 1.0)[:, None]
    f_press = jnp.where(i_ok, f_press * (p.mass * p.mass / safe_rho_i), f_press)
    f_vis = jnp.where(i_ok, f_vis * (p.viscosity * p.mass * p.mass / safe_rho_i),
                      f_vis)
    return f_press + f_vis


def density_grid(pos: jax.Array, bucket: Bucket, capacity: int,
                 p: PhysParams, bucket_resolution: int) -> jax.Array:
    """Full-array wrapper of :func:`density_grid_rows`."""
    return density_grid_rows(pos, bucket.cell, pos, bucket.table, capacity,
                             p, bucket_resolution)


def fluid_forces_grid(pos: jax.Array, vel: jax.Array, rho: jax.Array,
                      bucket: Bucket, capacity: int, p: PhysParams,
                      bucket_resolution: int) -> jax.Array:
    """Full-array wrapper of :func:`fluid_forces_grid_rows`."""
    ids = jnp.arange(pos.shape[0], dtype=jnp.int32)
    return fluid_forces_grid_rows(pos, vel, ids, rho, pos, vel, rho,
                                  bucket.table, capacity, p,
                                  bucket_resolution)


# ---------------------------------------------------------------------------
# Slotted formulation: identical results, one row gather per window cell.
#
# The formulation above gathers every candidate's pos/vel/rho per
# (particle x offset x slot), through arrays with tiny minor dimensions
# (3, or C=32). Here candidate data is pre-packed into cell-major rows of
# 4C = 128 floats:
#
#     posocc[c]  = [ x·C | y·C | z·C | occ·C ]      (C = 32 slots)
#     velrho[c]  = [ vx·C | vy·C | vz·C | rho·C ]
#
# so each window-cell lookup is ONE contiguous row gather per array.
# Two semantic notes, both exactness-preserving:
#
# * The reference's j==i skip (VelPos.compute:82) is reproduced EXACTLY: the
#   occupancy lane carries the candidate's particle id + 1 (0 = empty slot;
#   ids ≤ 2^22 are exact in f32), and the force gate drops the lane whose id
#   matches the row's. The skip is NOT merely an HLSL optimization: for
#   finite values the self pair contributes exactly zero (grad_W_press(0) =
#   0 via the epsilon guard (:37), viscosity carries v_i − v_i = 0), but a
#   particle with ±inf velocity or density computes inf − inf = NaN /
#   inf · 0 = NaN on its OWN lane — a NaN the reference never evaluates,
#   systematically perturbing trap populations on violent configs.
# * Empty slots carry id+1 = 0 and are select-gated out (the reference
#   breaks at the sentinel, Bucket.compute:33; our build packs occupied
#   slots first, so the candidate SET is identical).
# ---------------------------------------------------------------------------


class PackedSlots(NamedTuple):
    """Per-frame packed slot arrays (pytree).

    posocc: f32[R³, 4C] — fresh positions + occupancy lane (rebuilt per
            substep in faithful mode from fresh positions over the STALE
            table, matching VelPos reading fresh textures via stale ids).
            The occupancy lane holds the slot's particle id + 1 (0 for
            empty slots; exact in f32 for ids < 2^24), so a `> 0` test is
            the occupancy gate and an equality test against the row's
            id + 1 is the reference's j==i skip (VelPos.compute:82).
    velrho: f32[R³, 4C] — fresh velocities + STALE density.
    """

    posocc: jax.Array
    velrho: jax.Array


def _window_cells(cell_rows: jax.Array, off: jax.Array, r: int
                  ) -> tuple[jax.Array, jax.Array]:
    """(clipped flat cell id, validity) of the window cell at ``off``."""
    ncell = cell_rows + off[None, :]
    valid = jnp.all((ncell >= 0) & (ncell < r), axis=-1)
    ncid = jnp.where(valid, flat_cell_id(ncell, r), 0)
    return ncid, valid


def pack_slots(table: jax.Array, capacity: int, n: int, pos: jax.Array,
               vel: jax.Array | None, rho: jax.Array | None) -> PackedSlots:
    """Scatter per-particle values into the packed slot-row layout."""
    ids = table.reshape(-1, capacity)
    occ_b = ids < n
    # occupancy lane = particle id + 1 (0 empty) — carries the candidate's
    # identity for the j==i skip at zero extra gather traffic
    occ = jnp.where(occ_b, (ids + 1).astype(jnp.float32), 0.0)
    j = jnp.minimum(ids, n - 1)
    # select, don't multiply: on exploding scenes real particles can hold
    # inf pos/vel, and 0 * inf = NaN would poison EMPTY slots (the
    # reference walks only occupied slots, Bucket.compute:30-35)
    px, py, pz = (jnp.where(occ_b, pos[..., k][j], 0.0) for k in range(3))
    posocc = jnp.concatenate([px, py, pz, occ], axis=-1)
    if vel is None:
        velrho = jnp.zeros_like(posocc)
    else:
        vx, vy, vz = (jnp.where(occ_b, vel[..., k][j], 0.0)
                      for k in range(3))
        rr = jnp.where(occ_b, rho[j], 0.0)
        velrho = jnp.concatenate([vx, vy, vz, rr], axis=-1)
    return PackedSlots(posocc=posocc, velrho=velrho)


def repack_fresh(slots: PackedSlots, table: jax.Array, capacity: int, n: int,
                 pos: jax.Array, vel: jax.Array) -> PackedSlots:
    """Refresh pos/vel lanes for a new substep; keep stale rho lanes."""
    ids = table.reshape(-1, capacity)
    occ_b = ids < n
    occ = jnp.where(occ_b, (ids + 1).astype(jnp.float32), 0.0)
    j = jnp.minimum(ids, n - 1)
    # select, not multiply (0 * inf = NaN — see pack_slots)
    px, py, pz = (jnp.where(occ_b, pos[..., k][j], 0.0) for k in range(3))
    posocc = jnp.concatenate([px, py, pz, occ], axis=-1)
    vx, vy, vz = (jnp.where(occ_b, vel[..., k][j], 0.0) for k in range(3))
    velrho = jnp.concatenate(
        [vx, vy, vz, slots.velrho[:, 3 * capacity:]], axis=-1)
    return PackedSlots(posocc=posocc, velrho=velrho)


def density_slotted_rows(pos_rows: jax.Array, cell_rows: jax.Array,
                         slots: PackedSlots, capacity: int, p: PhysParams,
                         bucket_resolution: int) -> jax.Array:
    """ρ for a row block via packed-row gathers (Density.compute:32-60
    semantics: self term included, bounds check per window cell)."""
    c = capacity
    h2, h9 = p.h * p.h, p.h ** 9
    offs = neighborhood_offsets()

    def body(rho, off):
        ncid, valid = _window_cells(cell_rows, off, bucket_resolution)
        row = jnp.take(slots.posocc, ncid, axis=0)          # [rows, 4C]
        cx, cy, cz, occ = (row[:, k * c:(k + 1) * c] for k in range(4))
        dx = pos_rows[:, 0:1] - cx
        dy = pos_rows[:, 1:2] - cy
        dz = pos_rows[:, 2:3] - cz
        r2 = dx * dx + dy * dy + dz * dz
        w = sph_math.w_poly6(r2, h2, h9)
        gate = (occ > 0.0) & valid[:, None]
        return rho + p.mass * jnp.sum(jnp.where(gate, w, 0.0), axis=-1), None

    rho, _ = jax.lax.scan(body, jnp.zeros(pos_rows.shape[0], jnp.float32),
                          offs)
    return rho


def fluid_forces_slotted_rows(pos_rows: jax.Array, vel_rows: jax.Array,
                              ids_rows: jax.Array, rho_rows: jax.Array,
                              slots: PackedSlots,
                              capacity: int, p: PhysParams,
                              bucket_resolution: int) -> jax.Array:
    """Pressure + viscosity for a row block via packed-row gathers
    (VelPos.compute:49-105 semantics: fresh window center, stale table/ρ,
    ρ guards, final m²/ρ_i scaling). ``ids_rows`` are the rows' global
    particle ids for the reference's j==i skip (VelPos.compute:82) —
    required so a particle with ±inf velocity does not evaluate its own
    inf − inf = NaN self pair (the reference never does)."""
    c = capacity
    h6 = p.h ** 6
    cell_fresh = sph_math.cell_index(pos_rows, bucket_resolution)
    press_rows = sph_math.eos_pressure(rho_rows, p.gas_constant,
                                       p.rest_density)
    offs = neighborhood_offsets()

    def body(carry, off):
        fpx, fpy, fpz, fvx, fvy, fvz = carry
        ncid, valid = _window_cells(cell_fresh, off, bucket_resolution)
        prow = jnp.take(slots.posocc, ncid, axis=0)         # [rows, 4C]
        vrow = jnp.take(slots.velrho, ncid, axis=0)         # [rows, 4C]
        cx, cy, cz, occ = (prow[:, k * c:(k + 1) * c] for k in range(4))
        vx, vy, vz, rho_j = (vrow[:, k * c:(k + 1) * c] for k in range(4))

        # select-gating, not multiplicative: 0 * inf = NaN would inject
        # NaN into the sums from empty slots / out-of-bounds cells the
        # reference never evaluates (Bucket.compute:30-35, VelPos:73).
        # occ carries id+1, so occ != id_i+1 is exactly VelPos:82's
        # `if (j == id_1d) continue` — the whole self iteration is skipped
        gate = ((occ > 0.0) & valid[:, None]
                & (occ != (ids_rows.astype(jnp.float32) + 1.0)[:, None])
                & (rho_j > EPSILON))                         # VelPos:91
        safe_rho = jnp.where(rho_j > EPSILON, rho_j, 1.0)

        dx = pos_rows[:, 0:1] - cx
        dy = pos_rows[:, 1:2] - cy
        dz = pos_rows[:, 2:3] - cz
        abs_r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        gwp = sph_math.grad_w_press_over_r(abs_r, p.h, h6)
        gwv = sph_math.grad_w_vis_r(abs_r, p.h, h6)

        press_j = sph_math.eos_pressure(rho_j, p.gas_constant, p.rest_density)
        # whole-term selects: candidate positions can faithfully be NaN
        # (inf velocities pass the acceleration-only NaN trap), so a
        # selected coefficient times a NaN dx would re-leak NaN
        pc = (press_rows[:, None] + press_j) / (2.0 * safe_rho) * gwp
        fpx = fpx + jnp.sum(jnp.where(gate, pc * dx, 0.0), axis=-1)
        fpy = fpy + jnp.sum(jnp.where(gate, pc * dy, 0.0), axis=-1)
        fpz = fpz + jnp.sum(jnp.where(gate, pc * dz, 0.0), axis=-1)

        vc = gwv / safe_rho
        fvx = fvx + jnp.sum(
            jnp.where(gate, vc * (vx - vel_rows[:, 0:1]), 0.0), axis=-1)
        fvy = fvy + jnp.sum(
            jnp.where(gate, vc * (vy - vel_rows[:, 1:2]), 0.0), axis=-1)
        fvz = fvz + jnp.sum(
            jnp.where(gate, vc * (vz - vel_rows[:, 2:3]), 0.0), axis=-1)
        return (fpx, fpy, fpz, fvx, fvy, fvz), None

    zeros = jnp.zeros(pos_rows.shape[0], jnp.float32)
    (fpx, fpy, fpz, fvx, fvy, fvz), _ = jax.lax.scan(
        body, (zeros,) * 6, offs)
    f_press = jnp.stack([fpx, fpy, fpz], -1)
    f_vis = jnp.stack([fvx, fvy, fvz], -1)

    i_ok = (rho_rows > EPSILON)[:, None]
    safe_rho_i = jnp.where(rho_rows > EPSILON, rho_rows, 1.0)[:, None]
    f_press = jnp.where(i_ok, f_press * (p.mass * p.mass / safe_rho_i),
                        f_press)
    f_vis = jnp.where(i_ok, f_vis * (p.viscosity * p.mass * p.mass
                                     / safe_rho_i), f_vis)
    return f_press + f_vis
