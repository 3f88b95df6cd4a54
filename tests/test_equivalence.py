"""Neighbor-structure equivalence: grid-gathered density/forces must match
the brute-force O(N^2) oracle (SURVEY.md section 4 item 2). The 27-cell
window is exact cover because cell edge == smoothing length h
(SphFluidSimulation.cs:159 + Bucket.compute:27)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphfluidsimulation_tpu.config import SimConfig
from sphfluidsimulation_tpu.models.presets import init_positions
from sphfluidsimulation_tpu.ops import brute, cellops
from sphfluidsimulation_tpu.ops.grid import build_bucket
from sphfluidsimulation_tpu.params import PhysParams


def _random_cloud(n, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.uniform(lo, hi, (n, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(0, 0.3, (n, 3)), jnp.float32)
    return pos, vel


@pytest.mark.parametrize("n,r,cap", [(512, 9, 32), (1024, 13, 8), (2048, 17, 32)])
def test_density_grid_matches_brute(n, r, cap):
    cfg = SimConfig(particle_number=n, bucket_resolution=r, voxel_capacity=cap)
    p = PhysParams.from_config(cfg)
    pos, _ = _random_cloud(cfg.n_particles, seed=n)
    bucket, capacity = build_bucket(pos, r, cap)
    rho_g = cellops.density_grid(pos, bucket, capacity, p, r)
    rho_b = brute.density_bruteforce(pos, bucket.cell_id, bucket.in_table, p, r)
    np.testing.assert_allclose(np.asarray(rho_g), np.asarray(rho_b),
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n,r,cap", [(512, 9, 32), (1024, 13, 8)])
def test_forces_grid_matches_brute(n, r, cap):
    cfg = SimConfig(particle_number=n, bucket_resolution=r, voxel_capacity=cap)
    p = PhysParams.from_config(cfg)
    pos, vel = _random_cloud(cfg.n_particles, seed=n + 7)
    bucket, capacity = build_bucket(pos, r, cap)
    rho = brute.density_bruteforce(pos, bucket.cell_id, bucket.in_table, p, r)
    f_g = cellops.fluid_forces_grid(pos, vel, rho, bucket, capacity, p, r)
    f_b = brute.fluid_forces_bruteforce(pos, vel, rho, bucket.cell_id,
                                        bucket.in_table, p, r)
    scale = np.maximum(np.abs(np.asarray(f_b)).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(f_g) / scale,
                               np.asarray(f_b) / scale, atol=3e-6)


@pytest.mark.slow
def test_preset_spawn_equivalence():
    # real spawn geometry incl. out-of-cube positions (preset2 overshoot)
    cfg = SimConfig(particle_number=1024, bucket_resolution=11, preset=1)
    p = PhysParams.from_config(cfg)
    pos = init_positions(cfg)
    vel = jnp.zeros_like(pos)
    r = cfg.bucket_resolution
    bucket, capacity = build_bucket(pos, r, cfg.voxel_capacity)
    rho_g = cellops.density_grid(pos, bucket, capacity, p, r)
    rho_b = brute.density_bruteforce(pos, bucket.cell_id, bucket.in_table, p, r)
    np.testing.assert_allclose(np.asarray(rho_g), np.asarray(rho_b),
                               rtol=2e-5, atol=1e-6)
    f_g = cellops.fluid_forces_grid(pos, vel, rho_b, bucket, capacity, p, r)
    f_b = brute.fluid_forces_bruteforce(pos, vel, rho_b, bucket.cell_id,
                                        bucket.in_table, p, r)
    scale = np.maximum(np.abs(np.asarray(f_b)).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(f_g) / scale,
                               np.asarray(f_b) / scale, atol=3e-6)


def test_capacity_truncation_changes_density():
    # the 32-per-voxel drop is semantic: a tighter cap must change results
    # in a dense cloud (reference Bucket.compute:30-35 drops silently)
    cfg = SimConfig(particle_number=1024, bucket_resolution=5)
    p = PhysParams.from_config(cfg)
    pos, _ = _random_cloud(cfg.n_particles, seed=3, lo=0.4, hi=0.6)
    b_full, cap_full = build_bucket(pos, 5, 1024)
    b_cut, cap_cut = build_bucket(pos, 5, 4)
    rho_full = cellops.density_grid(pos, b_full, cap_full, p, 5)
    rho_cut = cellops.density_grid(pos, b_cut, cap_cut, p, 5)
    assert float(jnp.max(jnp.abs(rho_full - rho_cut))) > 1e-3


def test_window_uses_fresh_cell_stale_bucket():
    # VelPos recomputes idx_3d from the CURRENT position each substep
    # (VelPos.compute:57-58) while walking the frame-start bucket. Moving a
    # particle across a cell boundary must change its candidate window.
    cfg = SimConfig(particle_number=1024, bucket_resolution=9)
    p = PhysParams.from_config(cfg)
    pos, vel = _random_cloud(cfg.n_particles, seed=11)
    r = 9
    bucket, capacity = build_bucket(pos, r, 32)
    rho = brute.density_bruteforce(pos, bucket.cell_id, bucket.in_table, p, r)
    # shift everyone by 2 cells: windows change, forces must differ from
    # recomputing with the original positions
    pos2 = jnp.clip(pos + 2.0 / 8.0, 0.0, 1.0)
    f_moved_g = cellops.fluid_forces_grid(pos2, vel, rho, bucket, capacity, p, r)
    f_moved_b = brute.fluid_forces_bruteforce(pos2, vel, rho, bucket.cell_id,
                                              bucket.in_table, p, r)
    scale = np.maximum(np.abs(np.asarray(f_moved_b)).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(f_moved_g) / scale,
                               np.asarray(f_moved_b) / scale, atol=3e-6)


def test_slotted_step_matches_gather_and_brute():
    # full frame through all three backends (slotted is the default)
    from sphfluidsimulation_tpu.sim.stepper import initial_state, make_frame_step
    cfg = SimConfig(particle_number=1024, bucket_resolution=11)
    st = initial_state(cfg)
    outs = {}
    for nb in ("slotted", "gather", "brute"):
        s, m = jax.jit(make_frame_step(cfg, neighbor=nb))(st)
        outs[nb] = (np.asarray(s.pos), float(m.mean_density), int(m.overflow))
    np.testing.assert_allclose(outs["slotted"][0], outs["gather"][0], atol=1e-6)
    np.testing.assert_allclose(outs["slotted"][0], outs["brute"][0], atol=1e-5)
    assert outs["slotted"][1] == pytest.approx(outs["gather"][1], rel=1e-6)
    assert outs["slotted"][2] == outs["gather"][2] == outs["brute"][2]


def test_voxel_capacity_none_raises_on_slot_backends():
    # the slot backends allocate static [n_cells, capacity] arrays, so the
    # uncapped bucket fails loudly there instead of being substituted
    from sphfluidsimulation_tpu.sim.stepper import make_frame_step
    cfg = SimConfig(particle_number=1024, bucket_resolution=11, preset=0,
                    gas_constant=20.0, rest_density=1.7, viscosity=0.05,
                    stiffness_coefficient=1000.0, frame_dt=1 / 240,
                    voxel_capacity=None)
    for nb in ("slotted", "gather"):
        with pytest.raises(ValueError):
            make_frame_step(cfg, neighbor=nb)


@pytest.mark.slow
def test_self_pair_skip_matches_brute_on_inf_velocities():
    """VelPos.compute:82 `if (j == id_1d) continue`: a particle carrying
    ±inf velocity must NOT evaluate its own inf − inf = NaN self pair —
    the reference never does. Brute (which skips self, ops/brute.py) is
    the oracle; the SLOTTED rollout must reproduce its NaN-trap
    population and trajectories exactly on a violent state with injected
    inf velocities."""
    from sphfluidsimulation_tpu.sim.stepper import (initial_state,
                                                    make_frame_step)

    cfg = SimConfig(particle_number=1024, bucket_resolution=11)
    st0 = initial_state(cfg)
    # scatter ±inf velocities across the dam (single-sign per particle so
    # neighbor sums stay inf, not order-dependent NaN)
    vel = st0.vel
    vel = vel.at[::37, 0].set(jnp.inf)
    vel = vel.at[5::53, 1].set(-jnp.inf)
    st0 = st0._replace(vel=vel)

    out = {}
    for nb in ("brute", "slotted"):
        state = st0
        metrics = None
        step = jax.jit(make_frame_step(cfg, neighbor=nb))
        for _ in range(3):  # 15 substeps: traps fire from substep 2 on
            state, metrics = step(state)
        out[nb] = (state, metrics)

    b_state, b_m = out["brute"]
    assert int(jnp.sum(b_state.nan_count)) > 0  # the scenario does trap
    s, m = out["slotted"]
    np.testing.assert_array_equal(np.asarray(s.nan_count),
                                  np.asarray(b_state.nan_count),
                                  err_msg="slotted trap population")
    assert int(m.nan_events) == int(b_m.nan_events)
    np.testing.assert_allclose(np.asarray(s.pos), np.asarray(b_state.pos),
                               atol=5e-5, err_msg="slotted positions")
