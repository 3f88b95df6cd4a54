"""Site-grid backend equivalence vs the brute-force oracle and the slotted
backend (SURVEY.md section 4 item 2), plus the site-specific semantics:
coincident-particle deduplication, capacity certificates, stale-bucket /
fresh-window reproduction, and the spawn-jitter window escalation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphfluidsimulation_tpu.config import SimConfig
from sphfluidsimulation_tpu.models.presets import init_positions
from sphfluidsimulation_tpu.ops import brute, sites
from sphfluidsimulation_tpu.ops.grid import build_bucket
from sphfluidsimulation_tpu.params import PhysParams
from sphfluidsimulation_tpu.sim.stepper import initial_state, make_frame_step


def _random_cloud(n, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.uniform(lo, hi, (n, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(0, 0.3, (n, 3)), jnp.float32)
    return pos, vel


def _oracle_rho(pos, r, cap, p):
    bucket, _ = build_bucket(pos, r, cap)
    return brute.density_bruteforce(pos, bucket.cell_id, bucket.in_table,
                                    p, r), bucket


@pytest.mark.parametrize("n,r,cap", [(512, 9, 32), (1024, 13, 8)])
def test_density_sites_matches_brute(n, r, cap):
    cfg = SimConfig(particle_number=n, bucket_resolution=r,
                    voxel_capacity=cap)
    p = PhysParams.from_config(cfg)
    pos, _ = _random_cloud(cfg.n_particles, seed=n)
    rho_b, _ = _oracle_rho(pos, r, cap, p)
    cid, in_cap, _ = sites.frame_binding(pos, r, cap)
    rho_s, cert = sites.density_sites(pos, cid, in_cap, p, r, 16, 16)
    assert int(cert) == 0
    np.testing.assert_allclose(np.asarray(rho_s), np.asarray(rho_b),
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n,r,cap", [(512, 9, 32), (1024, 13, 8)])
def test_forces_sites_match_brute(n, r, cap):
    cfg = SimConfig(particle_number=n, bucket_resolution=r,
                    voxel_capacity=cap)
    p = PhysParams.from_config(cfg)
    pos, vel = _random_cloud(cfg.n_particles, seed=n + 7)
    rho, bucket = _oracle_rho(pos, r, cap, p)
    f_b = brute.fluid_forces_bruteforce(pos, vel, rho, bucket.cell_id,
                                        bucket.in_table, p, r)
    cid, in_cap, _ = sites.frame_binding(pos, r, cap)
    f_s, dv, cert = sites.fluid_forces_sites(pos, vel, rho, cid, in_cap,
                                             p, r, 16, 16)
    assert dv is None and int(cert) == 0
    scale = np.maximum(np.abs(np.asarray(f_b)).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(f_s) / scale,
                               np.asarray(f_b) / scale, atol=3e-6)


def test_forces_sites_stale_bucket_fresh_window():
    # the reference walks the FRAME-START bucket from the CURRENT cell
    # (VelPos.compute:57-58): move everyone 2 cells, keep the stale binding
    cfg = SimConfig(particle_number=1024, bucket_resolution=9)
    p = PhysParams.from_config(cfg)
    pos, vel = _random_cloud(cfg.n_particles, seed=11)
    r = 9
    rho, bucket = _oracle_rho(pos, r, 32, p)
    pos2 = jnp.clip(pos + 2.0 / 8.0, 0.0, 1.0)
    f_b = brute.fluid_forces_bruteforce(pos2, vel, rho, bucket.cell_id,
                                        bucket.in_table, p, r)
    cid, in_cap, _ = sites.frame_binding(pos, r, 32)
    f_s, _, cert = sites.fluid_forces_sites(pos2, vel, rho, cid, in_cap,
                                            p, r, 16, 16)
    assert int(cert) == 0
    scale = np.maximum(np.abs(np.asarray(f_b)).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(f_s) / scale,
                               np.asarray(f_b) / scale, atol=3e-6)


def test_spawn_jitter_escalation():
    # preset spawns overshoot the unit cube before the first clamp; the
    # i-grid clamps the cell and widens the window (δ path) — results must
    # still match the oracle exactly, with a zero certificate
    cfg = SimConfig(particle_number=1024, bucket_resolution=11, preset=1)
    p = PhysParams.from_config(cfg)
    pos = init_positions(cfg)
    assert float(jnp.min(pos)) < 0.0 or float(jnp.max(pos)) > 1.0
    vel = jnp.zeros_like(pos)
    r = cfg.bucket_resolution
    rho, bucket = _oracle_rho(pos, r, 32, p)
    cid, in_cap, _ = sites.frame_binding(pos, r, 32)
    rho_s, cert_d = sites.density_sites(pos, cid, in_cap, p, r, 16, 16)
    np.testing.assert_allclose(np.asarray(rho_s), np.asarray(rho),
                               rtol=2e-5, atol=1e-6)
    f_b = brute.fluid_forces_bruteforce(pos, vel, rho, bucket.cell_id,
                                        bucket.in_table, p, r)
    f_s, _, cert = sites.fluid_forces_sites(pos, vel, rho, cid, in_cap,
                                            p, r, 16, 16)
    assert int(cert_d) == 0 and int(cert) == 0
    scale = np.maximum(np.abs(np.asarray(f_b)).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(f_s) / scale,
                               np.asarray(f_b) / scale, atol=3e-6)


def test_coincident_pile_dedup():
    # thousands of particles parked on one point (the clamp's wall pile,
    # VelPos.compute:154) collapse to ONE site: a tiny site capacity still
    # certifies exact, and results match the brute oracle which sees every
    # particle individually (capacity-uncapped so nothing is dropped)
    n = 1024
    rng = np.random.default_rng(0)
    pile = np.repeat([[0.5, 0.125, 0.5]], 900, axis=0)
    rest = rng.uniform(0, 1, (n - 900, 3))
    pos = jnp.asarray(np.concatenate([pile, rest]), jnp.float32)
    vel = jnp.asarray(rng.normal(0, 0.2, (n, 3)), jnp.float32)
    r = 9
    cfg = SimConfig(particle_number=n, bucket_resolution=r,
                    voxel_capacity=None)
    p = PhysParams.from_config(cfg)
    bucket, _ = build_bucket(pos, r, None)
    rho = brute.density_bruteforce(pos, bucket.cell_id, bucket.in_table,
                                   p, r)
    f_b = brute.fluid_forces_bruteforce(pos, vel, rho, bucket.cell_id,
                                        bucket.in_table, p, r)
    cid, in_cap, ovf = sites.frame_binding(pos, r, None)
    assert int(ovf) == 0
    rho_s, cert_d = sites.density_sites(pos, cid, in_cap, p, r, 8, 8)
    f_s, _, cert = sites.fluid_forces_sites(pos, vel, rho, cid, in_cap,
                                            p, r, 8, 8)
    assert int(cert_d) == 0 and int(cert) == 0
    np.testing.assert_allclose(np.asarray(rho_s), np.asarray(rho),
                               rtol=2e-4, atol=1e-5)
    scale = np.maximum(np.abs(np.asarray(f_b)).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(f_s) / scale,
                               np.asarray(f_b) / scale, atol=1e-5)


def test_site_capacity_certificate_fires():
    # more distinct positions per voxel than site slots → loud certificate
    n = 256
    rng = np.random.default_rng(5)
    pos = jnp.asarray(rng.uniform(0.45, 0.55, (n, 3)), jnp.float32)
    r = 5
    cfg = SimConfig(particle_number=n, bucket_resolution=r)
    p = PhysParams.from_config(cfg)
    cid, in_cap, _ = sites.frame_binding(pos, r, 32)
    _, cert = sites.density_sites(pos, cid, in_cap, p, r, 2, 2)
    assert int(cert) > 0


def test_sites_step_matches_brute_and_slotted():
    cfg = SimConfig(particle_number=1024, bucket_resolution=11,
                    site_capacity=16)
    st = initial_state(cfg)
    outs = {}
    for nb in ("sites", "slotted", "brute"):
        s, m = jax.jit(make_frame_step(cfg, neighbor=nb))(st)
        outs[nb] = (np.asarray(s.pos), float(m.mean_density),
                    int(m.overflow), int(m.exact_cert))
    assert outs["sites"][3] == 0
    np.testing.assert_allclose(outs["sites"][0], outs["brute"][0], atol=1e-5)
    np.testing.assert_allclose(outs["sites"][0], outs["slotted"][0],
                               atol=1e-5)
    assert outs["sites"][1] == pytest.approx(outs["brute"][1], rel=1e-5)
    assert outs["sites"][2] == outs["brute"][2]


@pytest.mark.slow
def test_sites_rollout_tracks_slotted():
    from sphfluidsimulation_tpu.sim.stepper import make_rollout
    # gentler EOS and timestep so float divergence stays visible; corner
    # cells still reach ~22 distinct positions, inside the default
    # site_capacity=32 → certificate must stay zero
    cfg = SimConfig(particle_number=1024, bucket_resolution=9,
                    gas_constant=5.0, frame_dt=1.0 / 600.0,
                    site_capacity=24)
    st = initial_state(cfg)
    f_a, m_a = make_rollout(cfg, 5, neighbor="sites")(st)
    f_b, m_b = make_rollout(cfg, 5, neighbor="slotted")(st)
    assert int(jnp.sum(m_a.exact_cert)) == 0
    np.testing.assert_allclose(np.asarray(f_a.pos), np.asarray(f_b.pos),
                               atol=5e-4)


@pytest.mark.slow
def test_sites_corrected_mode_matches_brute():
    # 1024 particles at R=9 exceed 16 distinct sites in dense voxels
    # (cert 192); 32 — the reference bucket bound — is exact here
    cfg = SimConfig(particle_number=1024, bucket_resolution=9,
                    site_capacity=32)
    st = initial_state(cfg)
    s_a, _ = jax.jit(make_frame_step(cfg, neighbor="sites",
                                     faithful=False))(st)
    s_b, _ = jax.jit(make_frame_step(cfg, neighbor="brute",
                                     faithful=False))(st)
    np.testing.assert_allclose(np.asarray(s_a.pos), np.asarray(s_b.pos),
                               atol=1e-5)


@pytest.mark.slow
def test_sites_extensions_match_slotted():
    # avisc extends the site key with velocity → more distinct sites/voxel
    cfg = SimConfig(particle_number=1024, bucket_resolution=11,
                    xsph=0.05, artificial_viscosity=0.2, site_capacity=32)
    st = initial_state(cfg)
    s_a, m_a = jax.jit(make_frame_step(cfg, neighbor="sites"))(st)
    s_b, _ = jax.jit(make_frame_step(cfg, neighbor="slotted"))(st)
    assert int(m_a.exact_cert) == 0
    np.testing.assert_allclose(np.asarray(s_a.pos), np.asarray(s_b.pos),
                               atol=1e-5)


def test_uncapped_binding():
    # voxel_capacity=None: nothing dropped from the bucket, in-range only
    pos, _ = _random_cloud(2048, seed=1, lo=0.48, hi=0.52)  # ultra dense
    cid, in_cap, ovf = sites.frame_binding(pos, 9, None)
    assert int(ovf) == 0 and bool(jnp.all(in_cap))


@pytest.mark.slow
def test_independent_i_capacity():
    """site_capacity_i raises only the evaluation-grid capacity: a config
    whose fresh voxels exceed site_capacity distinct tuples certifies at
    ki == kj but not with a raised ki."""
    rng = np.random.default_rng(3)
    # many distinct positions packed into few voxels; the reference 32-cap
    # bounds the j-side at 32 distinct candidates per voxel, but EVERY
    # particle still needs an evaluation site (the i-side is uncapped)
    pos = jnp.asarray(0.05 + 0.2 * rng.random((512, 3)), jnp.float32)
    cfg = SimConfig(particle_number=512, bucket_resolution=9)
    p = PhysParams.from_config(cfg)
    cid, in_cap, _ = sites.frame_binding(pos, 9, 32)
    # tight i-capacity: certificate fires
    _, cert_small = sites.density_sites(pos, cid, in_cap, p, 9, 8, 32)
    assert int(cert_small) > 0
    # raised i-capacity: exact (512 covers any voxel's distinct tuples)
    _, cert_big = sites.density_sites(pos, cid, in_cap, p, 9, 512, 32)
    assert int(cert_big) == 0


def test_kj_scanned_matches_broadcast(monkeypatch):
    """The large-grid j-slot scan (temp-bloat fix: [Ki,1,S] instead of
    [Ki,Kj,S] temporaries) must reproduce the dense broadcast path to
    float-summation tolerance — same candidate set, different add order."""
    from sphfluidsimulation_tpu.models.presets import init_positions
    from sphfluidsimulation_tpu.ops import sites
    from sphfluidsimulation_tpu.params import PhysParams

    cfg = SimConfig(particle_number=1024, bucket_resolution=11, preset=0,
                    gas_constant=20.0)
    p = PhysParams.from_config(cfg)
    pos = init_positions(cfg)
    vel = 0.05 * jnp.sin(37.0 * pos)
    cid, in_cap, _ = sites.frame_binding(pos, cfg.bucket_resolution,
                                         cfg.voxel_capacity)
    r = cfg.bucket_resolution

    rho_b, cert_b = jax.jit(lambda: sites.density_sites(
        pos, cid, in_cap, p, r, 16, 16))()
    f_b, _, cf_b = jax.jit(lambda: sites.fluid_forces_sites(
        pos, vel, rho_b, cid, in_cap, p, r, 16, 16))()

    monkeypatch.setattr(sites, "KJ_SCAN_CELLS", 0)
    rho_s, cert_s = jax.jit(lambda: sites.density_sites(
        pos, cid, in_cap, p, r, 16, 16))()
    f_s, _, cf_s = jax.jit(lambda: sites.fluid_forces_sites(
        pos, vel, rho_b, cid, in_cap, p, r, 16, 16))()

    assert int(cert_b) == int(cert_s)
    assert int(cf_b) == int(cf_s)
    np.testing.assert_allclose(np.asarray(rho_s), np.asarray(rho_b),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_b),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# z-banded grids (flagship-scale variant, sites._banded_pass)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb", [2, 3, 5])
def test_banded_density_bit_identical(nb):
    """z-banded density == one-piece density BIT-identical: each band's
    grid holds exactly the full grid's sites for its planes and the
    window walk visits offsets in the same order."""
    cfg = SimConfig(particle_number=2048, bucket_resolution=11)
    p = PhysParams.from_config(cfg)
    pos, _ = _random_cloud(cfg.n_particles, seed=42)
    r = cfg.bucket_resolution
    cid, in_cap, _ = sites.frame_binding(pos, r, 32)
    rho_full, cert_full = jax.jit(lambda: sites.density_sites(
        pos, cid, in_cap, p, r, 16, 16))()
    rho_band, cert_band = jax.jit(lambda: sites.density_sites(
        pos, cid, in_cap, p, r, 16, 16, z_bands=nb))()
    assert int(cert_full) == 0 and int(cert_band) == 0
    np.testing.assert_array_equal(np.asarray(rho_band),
                                  np.asarray(rho_full))


@pytest.mark.parametrize("nb", [2, 4])
def test_banded_forces_match(nb):
    # the banded force pass evaluates the identical candidate set in the
    # identical order; XLA's fusion/FMA choices vary with the grid extent
    # → ULP-level differences only
    cfg = SimConfig(particle_number=2048, bucket_resolution=11)
    p = PhysParams.from_config(cfg)
    pos, vel = _random_cloud(cfg.n_particles, seed=43)
    r = cfg.bucket_resolution
    cid, in_cap, _ = sites.frame_binding(pos, r, 32)
    rho, _ = sites.density_sites(pos, cid, in_cap, p, r, 16, 16)
    f_full, dv_f, c_full = jax.jit(lambda: sites.fluid_forces_sites(
        pos, vel, rho, cid, in_cap, p, r, 16, 16))()
    f_band, dv_b, c_band = jax.jit(lambda: sites.fluid_forces_sites(
        pos, vel, rho, cid, in_cap, p, r, 16, 16, z_bands=nb))()
    assert dv_f is None and dv_b is None
    assert int(c_full) == 0 and int(c_band) == 0
    np.testing.assert_allclose(np.asarray(f_band), np.asarray(f_full),
                               atol=1e-7)


def test_banded_extensions_match():
    # xsph + avisc widen the site key and add field arrays — the banded
    # walk must carry all of them (ULP tolerance: see banded_forces_match)
    cfg = SimConfig(particle_number=1024, bucket_resolution=9,
                    xsph=0.05, artificial_viscosity=0.2)
    p = PhysParams.from_config(cfg)
    pos, vel = _random_cloud(cfg.n_particles, seed=44)
    r = cfg.bucket_resolution
    cid, in_cap, _ = sites.frame_binding(pos, r, 32)
    rho, _ = sites.density_sites(pos, cid, in_cap, p, r, 16, 16)
    args = dict(xsph=cfg.xsph, alpha_visc=cfg.artificial_viscosity)
    f_full, dv_f, c_f = jax.jit(lambda: sites.fluid_forces_sites(
        pos, vel, rho, cid, in_cap, p, r, 32, 32, **args))()
    f_band, dv_b, c_b = jax.jit(lambda: sites.fluid_forces_sites(
        pos, vel, rho, cid, in_cap, p, r, 32, 32, z_bands=3, **args))()
    assert int(c_f) == 0 and int(c_b) == 0
    np.testing.assert_allclose(np.asarray(f_band), np.asarray(f_full),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(dv_b), np.asarray(dv_f),
                               atol=1e-7)


def test_banded_cert_counts_once():
    # capacity overflow: each voxel's dropped candidates counted by its
    # interior owner band exactly once → banded cert == full cert (> 0)
    n = 512
    rng = np.random.default_rng(7)
    # dense pile spanning several z planes so bands share halo voxels
    pos = jnp.asarray(rng.uniform(0.3, 0.7, (n, 3)), jnp.float32)
    r = 7
    cfg = SimConfig(particle_number=n, bucket_resolution=r)
    p = PhysParams.from_config(cfg)
    cid, in_cap, _ = sites.frame_binding(pos, r, 32)
    rho_f, cert_f = sites.density_sites(pos, cid, in_cap, p, r, 2, 2)
    rho_b, cert_b = sites.density_sites(pos, cid, in_cap, p, r, 2, 2,
                                        z_bands=3)
    assert int(cert_f) > 0
    assert int(cert_b) == int(cert_f)


def test_banded_spawn_jitter_escalation():
    # preset spawns overshoot the unit cube (jitter) → the widened windows
    # (w=2,3) must read real halo candidates in banded mode too
    cfg = SimConfig(particle_number=4096, bucket_resolution=13, preset=2)
    p = PhysParams.from_config(cfg)
    pos = init_positions(cfg)
    r = cfg.bucket_resolution
    cid, in_cap, _ = sites.frame_binding(pos, r, 32)
    rho_f, cert_f = jax.jit(lambda: sites.density_sites(
        pos, cid, in_cap, p, r, 32, 32))()
    rho_b, cert_b = jax.jit(lambda: sites.density_sites(
        pos, cid, in_cap, p, r, 32, 32, z_bands=4))()
    assert int(cert_b) == int(cert_f)
    np.testing.assert_array_equal(np.asarray(rho_b), np.asarray(rho_f))


def test_banded_step_matches_full():
    # whole frame step through the stepper with cfg.site_bands forced
    cfg_full = SimConfig(particle_number=1024, bucket_resolution=11,
                         site_capacity=16, site_bands=1)
    cfg_band = SimConfig(particle_number=1024, bucket_resolution=11,
                         site_capacity=16, site_bands=3)
    st = initial_state(cfg_full)
    s_f, m_f = jax.jit(make_frame_step(cfg_full, neighbor="sites"))(st)
    s_b, m_b = jax.jit(make_frame_step(cfg_band, neighbor="sites"))(st)
    assert int(m_f.exact_cert) == 0 and int(m_b.exact_cert) == 0
    np.testing.assert_allclose(np.asarray(s_b.pos), np.asarray(s_f.pos),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(s_b.vel), np.asarray(s_f.vel),
                               rtol=2e-5, atol=1e-6)


def test_auto_bands_rule():
    # every scaled scene up to the reference's 4,194,304-particle cap
    # (R=118) runs as one piece; larger grids are banded so a band's grid
    # stays under the budget while covering the halo
    for r in (47, 75, 118):
        assert sites.auto_bands(r) == 1
    for r in (129, 160, 256):
        nb = sites.auto_bands(r)
        assert nb > 1
        zspan = -(-r // nb)
        assert (zspan + 2 * sites._BAND_HALO) * r * r \
            <= sites.SITE_BAND_AUTO_CELLS


def test_banded_scan_rollout_matches_host_chained_steps():
    """A multi-frame lax.scan rollout of the banded sites step equals the
    same jitted frame step chained from the host, frame by frame."""
    from sphfluidsimulation_tpu.sim.stepper import (initial_state,
                                                    make_frame_step,
                                                    make_rollout)
    cfg = SimConfig(particle_number=1024, bucket_resolution=11,
                    site_capacity=24, site_bands=3, gas_constant=1.0,
                    viscosity=0.05)
    st = initial_state(cfg)
    final, m = make_rollout(cfg, 3, neighbor="sites")(st)
    step = jax.jit(make_frame_step(cfg, neighbor="sites"))
    s = st
    for f in range(3):
        s, mf = step(s)
        assert int(mf.exact_cert) == int(m.exact_cert[f])
        assert int(mf.overflow) == int(m.overflow[f])
    np.testing.assert_allclose(np.asarray(final.pos), np.asarray(s.pos),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(final.vel), np.asarray(s.vel),
                               rtol=1e-5, atol=1e-5)
