"""Frame stepper and rollout engine.

Reproduces the reference's per-frame pipeline (SphFluidSimulation.cs:96-108):

    bucket build → density → 5 × (force + semi-implicit Euler) → render prep

with its critical semantic quirk kept as the default ("faithful" mode): the
neighbor bucket and the density field are computed ONCE per frame from
pre-substep positions and reused across all five substeps
(SphFluidSimulation.cs:98-102), while each substep re-reads fresh
positions/velocities. ``faithful=False`` switches to the physically-corrected
mode that rebuilds both every substep.

The texture ping-pong of the reference (SphFluidSimulation.cs:267-268,
290-293) disappears: the stepper is a pure function ``state → state`` and
rollouts ride ``jax.lax.scan``. Physics scalars ride a :class:`PhysParams`
pytree (the analogue of the reference's shader uniforms) so one compiled
executable serves any parameter setting and `vmap` gives multi-scene sweeps.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..params import PhysParams
from ..ops import brute, cellops, sph_math
from ..ops.grid import build_bucket, overflow_count
from ..state import ParticleState, StepMetrics, make_state

StepFn = Callable[[ParticleState], tuple[ParticleState, StepMetrics]]
ParamStepFn = Callable[[ParticleState, PhysParams],
                       tuple[ParticleState, StepMetrics]]

# Neighbor backends. Every one runs the same candidate semantics; 'brute' is
# the O(N²) oracle and the others are the cell-walk formulations.
BACKENDS = ("slotted", "gather", "sites", "brute")

# Named scopes of the per-frame phases (the profiler trace attributes device
# time to them; see utils/profiling.phase_breakdown).
PHASES = ("grid_build", "density", "force_integrate")


def integrate_substep(pos: jax.Array, vel: jax.Array, f_fluid: jax.Array,
                      p: PhysParams, xsph_dv: jax.Array | None = None
                      ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Wall penalty + gravity + NaN guard + semi-implicit Euler + clamp.

    Transcribes VelPos.compute:107-157. ``xsph_dv`` (optional) is the XSPH
    advection-velocity correction, applied to the position update only.
    Returns (pos', vel', nan_mask).
    """
    f_wall = sph_math.wall_force(pos, vel, p.h, p.stiffness, p.damping, p.mass)
    gravity = jnp.stack([jnp.zeros_like(p.gravity_y), p.gravity_y,
                         jnp.zeros_like(p.gravity_y)], -1)
    a = gravity + (f_fluid + f_wall) / p.mass

    # NaN trap (VelPos.compute:143-147): zero the acceleration AND the
    # velocity of any particle whose acceleration went NaN.
    nan_mask = jnp.any(jnp.isnan(a), axis=-1)
    vel_new = jnp.where(nan_mask[..., None], 0.0, vel + a * p.dt)
    adv = vel_new if xsph_dv is None else vel_new + xsph_dv
    pos_new = jnp.clip(pos + p.dt * adv, 0.0, 1.0)  # VelPos.compute:153-154
    return pos_new, vel_new, nan_mask


def _metrics(state: ParticleState, rho: jax.Array, nan_events: jax.Array,
             overflow: jax.Array, p: PhysParams,
             exact_cert: jax.Array | None = None) -> StepMetrics:
    speed2 = jnp.sum(state.vel * state.vel, axis=-1)
    return StepMetrics(
        max_speed=jnp.sqrt(jnp.max(speed2)),
        mean_density=jnp.mean(rho),
        kinetic_energy=0.5 * p.mass * jnp.sum(speed2),
        nan_events=nan_events,
        overflow=overflow,
        exact_cert=(jnp.int32(0) if exact_cert is None
                    else exact_cert.astype(jnp.int32)),
    )


def _brute_pair_mask(pos, bucket, r: int):
    """[N, N] candidate mask for the all-pairs extension oracles (same
    window semantics as the force pass: fresh cell center, stale bucket)."""
    cell_i = sph_math.cell_index(pos, r)
    return brute._window_mask(cell_i, bucket.cell_id, bucket.in_table, r)




def make_param_step(cfg: SimConfig, *, neighbor: str = "slotted",
                    faithful: bool = True, fields: bool = False
                    ) -> ParamStepFn:
    """Build the per-frame step ``(state, phys) → (state, metrics)``.

    ``cfg`` contributes only structure (shapes): particle count, bucket
    resolution, voxel capacity, substep count, neighbor backend. All physics
    scalars come from the traced ``phys`` pytree.

    neighbor: 'slotted' (packed slot-row gathers), 'gather' (per-candidate
              gathers), 'sites' (dense site grids, ops/sites.py) or
              'brute' (O(N²) oracle).
    faithful: reuse frame-start bucket + density across all substeps
              (reference semantics); False rebuilds per substep.
    fields:   the step also returns ``(rho, f)``: the frame-start density
              and every substep's fluid force, ``f32[substeps, N, 3]`` —
              what the oracle comparisons check, taken from this step.
    """
    cfg = cfg.validate()
    if neighbor not in BACKENDS:
        raise ValueError(f"unknown neighbor backend {neighbor!r}; "
                         f"choose one of {BACKENDS}")
    if neighbor == "sites":
        return _make_sites_step(cfg, faithful=faithful, fields=fields)
    r = cfg.bucket_resolution
    n = cfg.n_particles
    cap = cfg.voxel_capacity
    if cap is None and neighbor != "brute":
        # The slotted/gather backends allocate static [n_cells, capacity]
        # slot arrays — an uncapped variant would need capacity == N. Loud
        # failure beats the silent 4x-mean substitute it used to be.
        raise ValueError(
            "voxel_capacity=None (no reference drop) is supported by the "
            "'brute' and 'sites' backends only; pick a finite capacity "
            f"for neighbor={neighbor!r}")
    grid_capacity = cap
    ids = jnp.arange(n, dtype=jnp.int32)

    def frame_aux(pos, phys):
        """Bucket + density from current positions (frame start)."""
        with jax.named_scope("grid_build"):
            bucket, capacity = build_bucket(pos, r, cap)
        with jax.named_scope("density"):
            if neighbor == "brute":
                rho = brute.density_bruteforce(pos, bucket.cell_id,
                                               bucket.in_table, phys, r)
                return bucket, None, rho
            if neighbor == "slotted":
                slots = cellops.pack_slots(bucket.table, capacity, n, pos,
                                           None, None)
                rho = cellops.density_slotted_rows(pos, bucket.cell, slots,
                                                   capacity, phys, r)
                frame = cellops.pack_slots(bucket.table, capacity, n, pos,
                                           jnp.zeros_like(pos), rho)
                return bucket, frame, rho
            rho = cellops.density_grid(pos, bucket, capacity, phys, r)
            return bucket, None, rho

    use_xsph = cfg.xsph != 0.0
    use_avisc = cfg.artificial_viscosity != 0.0
    if (use_xsph or use_avisc) and neighbor == "gather":
        raise NotImplementedError(
            "xsph/artificial viscosity are implemented for the 'slotted', "
            "'sites' and 'brute' backends")

    def forces(pos, vel, rho, bucket, frame, phys):
        if neighbor == "brute":
            from ..ops import extensions
            pair_mask = (_brute_pair_mask(pos, bucket, r)
                         if (use_xsph or use_avisc) else None)
            f = brute.fluid_forces_bruteforce(pos, vel, rho, bucket.cell_id,
                                              bucket.in_table, phys, r)
            if use_avisc:
                f = f + extensions.artificial_viscosity_bruteforce(
                    pos, vel, rho, pair_mask, phys,
                    cfg.artificial_viscosity)
            dv = (extensions.xsph_bruteforce(pos, vel, rho, pair_mask, phys,
                                             cfg.xsph)
                  if use_xsph else None)
            return f, dv
        if neighbor == "slotted":
            from ..ops import extensions
            slots = cellops.repack_fresh(frame, bucket.table, grid_capacity,
                                         n, pos, vel)
            f = cellops.fluid_forces_slotted_rows(
                pos, vel, ids, rho, slots, grid_capacity, phys, r)
            if use_avisc:
                f = f + extensions.artificial_viscosity_slotted(
                    pos, vel, rho, slots, grid_capacity, phys, r,
                    cfg.artificial_viscosity)
            dv = (extensions.xsph_slotted(pos, vel, rho, slots,
                                          grid_capacity, phys, r, cfg.xsph)
                  if use_xsph else None)
            return f, dv
        return cellops.fluid_forces_grid(pos, vel, rho, bucket,
                                         grid_capacity, phys, r), None

    def substep(carry, _):
        pos, vel, nan_hits, bucket, frame, rho, phys = carry
        if not faithful:
            bucket, frame, rho = frame_aux(pos, phys)
        with jax.named_scope("force_integrate"):
            f_fluid, xsph_dv = forces(pos, vel, rho, bucket, frame, phys)
            pos, vel, nan_mask = integrate_substep(pos, vel, f_fluid, phys,
                                                   xsph_dv)
        nan_hits = nan_hits + nan_mask.astype(jnp.int32)
        return ((pos, vel, nan_hits, bucket, frame, rho, phys),
                f_fluid if fields else None)

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        pos, vel = state.pos, state.vel
        bucket, frame, rho = frame_aux(pos, phys)
        ovf = overflow_count(bucket)
        nan_hits = jnp.zeros(pos.shape[0], jnp.int32)
        # The five substeps ride lax.scan; in faithful mode bucket and rho
        # are loop-invariant carries, matching the reference's reuse of both
        # across substeps (SphFluidSimulation.cs:98-102).
        (pos, vel, nan_hits, _, _, _, _), f_sub = jax.lax.scan(
            substep, (pos, vel, nan_hits, bucket, frame, rho, phys), None,
            length=cfg.substeps)
        new_state = ParticleState(pos=pos, vel=vel,
                                  nan_count=state.nan_count + nan_hits)
        m = _metrics(new_state, rho, jnp.sum(nan_hits), ovf, phys)
        return (new_state, m, (rho, f_sub)) if fields else (new_state, m)

    return step


def _make_sites_step(cfg: SimConfig, *, faithful: bool = True,
                     fields: bool = False) -> ParamStepFn:
    """Frame step on the site-grid backend.

    Pipeline per frame (ops/sites.py): frame binding (stale bucket
    membership) → site-grid density (once) → 5 × (site-grid forces +
    integrate), all per-particle state staying in particle order — the
    grids are rebuilt per substep from fresh values, which is exactly the
    reference's fresh-reads-through-stale-lists semantics
    (VelPos.compute:57-58, 86-94). ``faithful=False`` rebuilds binding and
    density every substep. StepMetrics.exact_cert counts candidates/sites
    dropped by the site capacity (SimConfig.site_capacity).
    """
    from ..ops import sites

    r = cfg.bucket_resolution
    cap = cfg.voxel_capacity  # None → truly uncapped bucket membership
    kj = cfg.site_capacity
    ki = cfg.site_capacity_i or kj
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity
    # z-banded grids past the auto budget (bit-identical — see
    # sites._banded_pass and sites.SITE_BAND_AUTO_CELLS)
    nb = cfg.site_bands or sites.auto_bands(r)

    def frame_aux(pos, phys):
        with jax.named_scope("grid_build"):
            stale_cid, in_cap, ovf = sites.frame_binding(pos, r, cap)
        with jax.named_scope("density"):
            rho, cert = sites.density_sites(pos, stale_cid, in_cap, phys, r,
                                            ki, kj, z_bands=nb)
        return stale_cid, in_cap, ovf, rho, cert

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        pos, vel = state.pos, state.vel
        stale_cid, in_cap, ovf, rho0, cert0 = frame_aux(pos, phys)

        def substep(carry, _):
            pos, vel, nan_hits, cert, stale_cid, in_cap, rho = carry
            if not faithful:
                stale_cid, in_cap, _, rho, cd = frame_aux(pos, phys)
                cert = cert + cd
            with jax.named_scope("force_integrate"):
                f, dv, c = sites.fluid_forces_sites(
                    pos, vel, rho, stale_cid, in_cap, phys, r, ki, kj,
                    xsph=xsph, alpha_visc=alpha, z_bands=nb)
                pos, vel, nan_mask = integrate_substep(pos, vel, f, phys,
                                                       dv)
            return ((pos, vel, nan_hits + nan_mask.astype(jnp.int32),
                     cert + c, stale_cid, in_cap, rho),
                    f if fields else None)

        nan0 = jnp.zeros(pos.shape[0], jnp.int32)
        (pos, vel, nan_hits, cert, _, _, _), f_sub = jax.lax.scan(
            substep, (pos, vel, nan0, cert0, stale_cid, in_cap, rho0),
            None, length=cfg.substeps)
        new_state = ParticleState(pos=pos, vel=vel,
                                  nan_count=state.nan_count + nan_hits)
        m = _metrics(new_state, rho0, jnp.sum(nan_hits), ovf, phys,
                     exact_cert=cert)
        return (new_state, m, (rho0, f_sub)) if fields else (new_state, m)

    return step


def make_frame_step(cfg: SimConfig, *, neighbor: str = "slotted",
                    faithful: bool = True, fields: bool = False) -> StepFn:
    """Single-scene step with the config's own physics baked as constants
    (``fields``: see :func:`make_param_step`)."""
    param_step = make_param_step(cfg, neighbor=neighbor, faithful=faithful,
                                 fields=fields)
    phys = PhysParams.from_config(cfg)
    return lambda state: param_step(state, phys)


def make_dt_rollout(cfg: SimConfig, n_frames: int, *,
                    neighbor: str = "slotted", faithful: bool = True,
                    snapshot_every: int = 0):
    """Variable frame-dt rollout: ``(state, dt_schedule) → (state, metrics)``.

    The reference's timestep is frame-rate-dependent — each substep advances
    ``Time.deltaTime / 25`` (SphFluidSimulation.cs:101-102) — so a faithful
    replay of a recorded session needs a PER-FRAME dt sequence, not the fixed
    ``frame_dt`` that `make_rollout` bakes for determinism (config.py:76-81).
    ``dt_schedule`` is ``f32[n_frames]`` of FRAME deltas (Unity's
    ``Time.deltaTime``); each frame's substep dt is
    ``dt_schedule[f] / substep_divisor``. All other physics ride the config.

    Bit-equal to stepping frame-by-frame through ``make_param_step`` with
    ``phys._replace(dt=dt_f / divisor)`` per call (pinned in
    tests/test_rollout.py).
    """
    if snapshot_every < 0 or (snapshot_every and n_frames % snapshot_every):
        raise ValueError("snapshot_every must be 0 or divide n_frames")
    cfg = cfg.validate()
    param_step = make_param_step(cfg, neighbor=neighbor, faithful=faithful)
    base = PhysParams.from_config(cfg)
    div = jnp.float32(cfg.substep_divisor)

    def body(state, dt):
        st, m = param_step(state, base._replace(dt=dt / div))
        out = (m, st.pos) if snapshot_every == 1 else (m,)
        return st, out

    def chunk_body(state, dts):
        state, (m,) = jax.lax.scan(body, state, dts)
        return state, (m, state.pos)

    @jax.jit
    def rollout(state: ParticleState, dt_schedule: jax.Array):
        dts = jnp.asarray(dt_schedule, jnp.float32).reshape(n_frames)
        if snapshot_every > 1:
            final, (m, snaps) = jax.lax.scan(
                chunk_body, state,
                dts.reshape(n_frames // snapshot_every, snapshot_every))
            m = jax.tree.map(lambda x: x.reshape((n_frames,) + x.shape[2:]),
                             m)
            return final, m, snaps
        final, outs = jax.lax.scan(body, state, dts)
        return (final,) + tuple(outs)

    return rollout


def make_rollout(cfg: SimConfig, n_frames: int, *, neighbor: str = "slotted",
                 faithful: bool = True, snapshot_every: int = 0):
    """Build a jitted ``state → (state, metrics[, snapshots])`` rollout over
    ``n_frames`` frames via lax.scan (one device dispatch per rollout).

    ``snapshot_every=k`` (k > 0) additionally returns the position array of
    every k-th frame (frames k-1, 2k-1, ... in 0-based frame order), stacked
    as ``f32[n_frames // k, N, 3]``; 0 disables snapshots.

    For the reference's frame-rate-dependent timestep (a recorded
    ``Time.deltaTime`` trace), see :func:`make_dt_rollout`.
    """
    if snapshot_every < 0 or (snapshot_every and n_frames % snapshot_every):
        raise ValueError("snapshot_every must be 0 or divide n_frames")
    step = make_frame_step(cfg, neighbor=neighbor, faithful=faithful)

    def body(state, _):
        new_state, m = step(state)
        out = (m, new_state.pos) if snapshot_every == 1 else (m,)
        return new_state, out

    def chunk_body(state, _):
        # inner scan of k frames; only the chunk-final positions are kept,
        # so device memory holds n_frames // k snapshots, not n_frames
        state, (m,) = jax.lax.scan(body, state, None, length=snapshot_every)
        return state, (m, state.pos)

    @jax.jit
    def rollout(state: ParticleState):
        if snapshot_every > 1:
            final, (m, snaps) = jax.lax.scan(
                chunk_body, state, None, length=n_frames // snapshot_every)
            m = jax.tree.map(lambda x: x.reshape((n_frames,) + x.shape[2:]), m)
            return final, m, snaps
        final, outs = jax.lax.scan(body, state, None, length=n_frames)
        return (final,) + tuple(outs)

    return rollout


def initial_state(cfg: SimConfig) -> ParticleState:
    """Spawn per the config preset with zero velocities
    (SphFluidSimulation.cs:157-190)."""
    from ..models.presets import init_positions
    return make_state(init_positions(cfg))
