"""Uniform-grid neighbor structure.

The reference builds a dense voxel table of ``R³ × 32`` particle-id slots
with atomic compare-exchange insertion (Bucket.compute:18-36) — insertion
order is a GPU race and overflow beyond 32 slots per voxel is silently
dropped. This rebuild is *sort-based and deterministic*: particles
are ranked within their voxel by a stable sort on cell id (ties broken by
particle index), which is strictly better (run-to-run reproducible) while
preserving the reference's capacity/drop semantics when ``capacity`` is set.

Everything is static-shaped for XLA: the slot table is ``[R³ · C]`` int32
with the particle count ``n`` as the empty sentinel (matching the reference's
``_NumParticles`` sentinel, Bucket.compute:33,51).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import sph_math


class Bucket(NamedTuple):
    """Sorted uniform-grid structure for one frame.

    table:    i32[R³·C] particle ids, sentinel == n for empty slots.
    cell:     i32[N, 3] frame-start voxel coordinates per particle.
    in_table: bool[N] — False for particles dropped by voxel overflow.
    rank:     i32[N] — deterministic slot index within the particle's voxel.
    order:    i32[N] — particle ids sorted by (cell id, particle id); the
              cell-contiguous permutation reused by the blocked kernels.
    cell_id:  i32[N] flat voxel index per particle (unsorted order).
    """

    table: jax.Array
    cell: jax.Array
    in_table: jax.Array
    rank: jax.Array
    order: jax.Array
    cell_id: jax.Array


def flat_cell_id(cell: jax.Array, r: int) -> jax.Array:
    """x + y·R + z·R² (Bucket.compute:28)."""
    return cell[..., 0] + cell[..., 1] * r + cell[..., 2] * (r * r)


def run_starts(sorted_vals: jax.Array) -> jax.Array:
    """First index of each equal-value run in an ascending-sorted array.

    Value-identical to ``jnp.searchsorted(a, a, side='left')``, which is a
    binary search per element; the run-boundary compare + cummax form is one
    elementwise pass. Used by every capacity-rank pass (this module, sites,
    slab) — the rank of a particle within its voxel is
    ``i - run_starts(cid_s)[i]`` in sorted order.
    """
    n = sorted_vals.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    new = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                           sorted_vals[1:] != sorted_vals[:-1]])
    return jax.lax.cummax(jnp.where(new, idx, 0))


def build_bucket(pos: jax.Array, r: int, capacity: int | None) -> tuple[Bucket, int]:
    """Build the frame's neighbor structure from positions.

    Returns (bucket, capacity_used). When ``capacity`` is None a capacity
    large enough to hold the worst-case voxel occupancy is NOT computed
    (dynamic shapes are not XLA-friendly); instead the caller should pass an
    explicit bound — None here simply means "no reference-style drop", which
    we realize by capping at N (table omitted, in_table all-True) for the
    brute-force path.
    """
    n = pos.shape[0]
    cell = sph_math.cell_index(pos, r)
    cid = flat_cell_id(cell, r)

    # Stable sort by cell id; ties resolve by particle index, making slot
    # order deterministic (the reference's atomic insertion is not —
    # Bucket.compute:33; SURVEY.md §5 "race detection").
    order = jnp.argsort(cid, stable=True).astype(jnp.int32)
    sorted_cid = cid[order]

    # Rank within each equal-cell run.
    idx = jnp.arange(n, dtype=jnp.int32)
    run_start = run_starts(sorted_cid)
    rank_sorted = idx - run_start
    rank = jnp.zeros(n, jnp.int32).at[order].set(rank_sorted)

    # A particle whose flat cell id falls outside the table is never inserted:
    # the reference's out-of-bounds UAV write is silently dropped by D3D11
    # (Bucket.compute:28-33 has no bounds check on the insert path; jittered
    # spawns can land slightly outside the unit cube). Ids that alias INTO
    # range (an out-of-range x wrapping into the next y row via x + y·R + z·R²)
    # are kept, faithfully reproducing the reference's index arithmetic.
    in_range = (cid >= 0) & (cid < r * r * r)

    if capacity is None:
        bucket = Bucket(table=jnp.zeros((0,), jnp.int32), cell=cell,
                        in_table=in_range, rank=rank, order=order,
                        cell_id=cid)
        return bucket, 0

    in_table = (rank < capacity) & in_range
    slot = jnp.where(in_table, cid * capacity + rank, r * r * r * capacity)
    table = jnp.full((r * r * r * capacity,), n, jnp.int32)
    table = table.at[slot].set(idx, mode="drop")
    bucket = Bucket(table=table, cell=cell, in_table=in_table, rank=rank,
                    order=order, cell_id=cid)
    return bucket, capacity


def overflow_count(bucket: Bucket) -> jax.Array:
    """Number of particles silently dropped by voxel capacity — surfaced as a
    metric instead of the reference's silent drop (Bucket.compute:30-35)."""
    return jnp.sum(~bucket.in_table).astype(jnp.int32)


# Static 27-cell neighborhood offsets in the reference's loop order
# (x outer, y middle, z inner — Density.compute:42-44) — the order matters
# only for float-summation bit-parity between our own passes.
def neighborhood_offsets() -> jnp.ndarray:
    import numpy as np
    offs = [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    return jnp.asarray(np.array(offs, np.int32))
