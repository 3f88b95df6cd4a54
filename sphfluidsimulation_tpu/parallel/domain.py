"""Spatial domain decomposition over a device mesh (shard_map).

The reference has no multi-device story (single GPU, SURVEY.md §2). The
scaling axis for SPH is particle count, and the decomposition here shards
the *particle rows*: each device owns N/D particles, computes their
density/forces/integration locally, and sees candidate neighbors via
`all_gather` of the source arrays.

Communication per frame (faithful semantics, SphFluidSimulation.cs:96-102):

* 1 × all_gather(pos)  — bucket build + density pass (frame start)
* 1 × all_gather(rho)  — the stale density reused by all substeps
* substeps × all_gather(pos, vel) — fresh state for force gathers

The bucket build (sort by cell id) is computed redundantly per device from
the gathered positions — O(N log N) replicated work that is negligible next
to the O(N·864) force gathers it enables, and it avoids any sharded-sort
collective choreography. Metrics are reduced with psum/pmax.

Row ownership is by particle index (round-robin-free contiguous blocks);
because candidates are fully gathered, correctness does not depend on any
spatial assignment — sorting rows by position would only improve locality,
which the gather formulation doesn't exploit anyway. parallel/slab.py is
the true slab decomposition with halo exchange.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..params import PhysParams
from ..ops import cellops
from ..ops.grid import build_bucket
from ..sim.stepper import integrate_substep
from ..state import ParticleState, StepMetrics


def shard_state(state: ParticleState, mesh: Mesh, axis: str = "sp"
                ) -> ParticleState:
    """Place a particle state sharded over its N axis."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sh), state)


def _make_local_step(cfg: SimConfig, axis: str):
    """Per-device frame step over a row shard; runs inside shard_map.

    Candidate neighbor data is exchanged with `all_gather` over ``axis``;
    the returned metrics are replicated scalars (psum/pmax/pmean).
    """
    r = cfg.bucket_resolution
    cap = cfg.voxel_capacity if cfg.voxel_capacity is not None else 32

    def local_step(pos_sh, vel_sh, nan_sh, phys):
        rows = pos_sh.shape[0]
        # Global row ids of this device's block.
        d = jax.lax.axis_index(axis)
        ids = d * rows + jnp.arange(rows, dtype=jnp.int32)

        # -- frame start: bucket + stale density (SphFluidSimulation.cs:98-99)
        pos_all = jax.lax.all_gather(pos_sh, axis, tiled=True)
        bucket, _ = build_bucket(pos_all, r, cap)
        cell_rows = jnp.take(bucket.cell, ids, axis=0)
        rho_sh = cellops.density_grid_rows(pos_sh, cell_rows, pos_all,
                                           bucket.table, cap, phys, r)
        rho_all = jax.lax.all_gather(rho_sh, axis, tiled=True)
        ovf = jnp.sum(~bucket.in_table).astype(jnp.int32)  # replicated

        def substep(carry, _):
            pos_sh, vel_sh, nan_hits = carry
            pos_all = jax.lax.all_gather(pos_sh, axis, tiled=True)
            vel_all = jax.lax.all_gather(vel_sh, axis, tiled=True)
            f = cellops.fluid_forces_grid_rows(
                pos_sh, vel_sh, ids, rho_sh, pos_all, vel_all, rho_all,
                bucket.table, cap, phys, r)
            pos_sh2, vel_sh2, nan_mask = integrate_substep(pos_sh, vel_sh, f,
                                                           phys)
            return (pos_sh2, vel_sh2, nan_hits + nan_mask.astype(jnp.int32)), None

        nan0 = jnp.zeros(rows, jnp.int32)
        (pos_sh, vel_sh, nan_hits), _ = jax.lax.scan(
            substep, (pos_sh, vel_sh, nan0), None, length=cfg.substeps)

        # -- metrics (replicated scalars via collectives)
        speed2 = jnp.sum(vel_sh * vel_sh, axis=-1)
        max_speed = jnp.sqrt(jax.lax.pmax(jnp.max(speed2), axis))
        mean_rho = jax.lax.pmean(jnp.mean(rho_sh), axis)
        ke = 0.5 * phys.mass * jax.lax.psum(jnp.sum(speed2), axis)
        nan_events = jax.lax.psum(jnp.sum(nan_hits), axis)
        m = StepMetrics(max_speed=max_speed, mean_density=mean_rho,
                        kinetic_energy=ke, nan_events=nan_events,
                        overflow=ovf, exact_cert=jnp.int32(0))
        return pos_sh, vel_sh, nan_sh + nan_hits, m

    return local_step


def make_sharded_frame_step(cfg: SimConfig, mesh: Mesh, *, axis: str = "sp"):
    """Frame step over row-sharded state: ``(state, phys) → (state, metrics)``.

    ``state`` arrays are sharded over ``axis`` on their leading N dimension
    (n_particles must divide the axis size). Metrics are replicated scalars.
    Semantics are always "faithful" (frame-start bucket + density reused
    across substeps, SphFluidSimulation.cs:98-102).
    """
    cfg = cfg.validate()
    n_dev = mesh.shape[axis]
    if cfg.n_particles % n_dev:
        raise ValueError(
            f"n_particles {cfg.n_particles} not divisible by mesh axis {n_dev}")
    local_step = _make_local_step(cfg, axis)

    # check_vma=False: the step reuses the single-device cellops kernels,
    # whose internal scan carries are created unvarying (jnp.zeros) — the
    # varying-manual-axes type check would demand pcast noise throughout.
    shmapped = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis), P()),
        check_vma=False,
    )

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        pos, vel, nan_count, m = shmapped(state.pos, state.vel,
                                          state.nan_count, phys)
        return ParticleState(pos=pos, vel=vel, nan_count=nan_count), m

    return step


def make_batched_sharded_step(cfg: SimConfig, mesh: Mesh, *,
                              scene_axis: str = "dp",
                              domain_axis: str = "sp"):
    """2D-parallel frame step: scenes sharded over ``scene_axis`` (pure data
    parallelism) × particle rows sharded over ``domain_axis`` (spatial
    decomposition with all_gather neighbor exchange).

    state arrays are [B, N, ...] sharded P(scene_axis, domain_axis); phys
    leaves are [B] sharded P(scene_axis). This is the "full training step"
    shape of the framework: both parallelism axes of SURVEY.md §5 in one
    program.
    """
    cfg = cfg.validate()
    n_dev = mesh.shape[domain_axis]
    if cfg.n_particles % n_dev:
        raise ValueError("n_particles must divide the domain axis size")
    local_step = _make_local_step(cfg, domain_axis)
    vstep = jax.vmap(local_step, in_axes=(0, 0, 0, 0))

    shmapped = jax.shard_map(
        vstep, mesh=mesh,
        in_specs=(P(scene_axis, domain_axis), P(scene_axis, domain_axis),
                  P(scene_axis, domain_axis), P(scene_axis)),
        out_specs=(P(scene_axis, domain_axis), P(scene_axis, domain_axis),
                   P(scene_axis, domain_axis), P(scene_axis)),
        check_vma=False,
    )

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        pos, vel, nan_count, m = shmapped(state.pos, state.vel,
                                          state.nan_count, phys)
        return ParticleState(pos=pos, vel=vel, nan_count=nan_count), m

    return step
