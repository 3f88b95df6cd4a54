"""Slab decomposition (parallel/slab.py) on the 8-device virtual CPU mesh:
the sharded sites step matches the single-device sites step, per-device
memory is O(N/D + halo) by construction of the array shapes, particles
migrate between slabs without loss, and over-halo drift is certified."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sphfluidsimulation_tpu.config import SimConfig
from sphfluidsimulation_tpu.params import PhysParams, stack_params
from sphfluidsimulation_tpu.parallel import slab
from sphfluidsimulation_tpu.sim.stepper import make_frame_step
from sphfluidsimulation_tpu.state import make_state

CFG = SimConfig(particle_number=1024, bucket_resolution=11,
                site_capacity=24)


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names)


def _calm_state(cfg, seed=0, vscale=0.02):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (cfg.n_particles, 3)).astype(np.float32)
    vel = rng.normal(0.0, vscale, (cfg.n_particles, 3)).astype(np.float32)
    return make_state(jnp.asarray(pos), jnp.asarray(vel))


def _calm_cfg(**kw):
    # gentle physics so per-frame cell drift stays within the halo band
    return CFG.replace(gas_constant=1.0, viscosity=0.05, **kw)


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.slow
def test_slab_matches_single_device(n_dev):
    cfg = _calm_cfg()
    mesh = _mesh((n_dev,), ("sp",))
    phys = PhysParams.from_config(cfg)
    st = _calm_state(cfg)

    ref_step = jax.jit(make_frame_step(cfg, neighbor="sites"))
    step, spec = slab.make_slab_step(cfg, mesh)
    step = jax.jit(step)

    s_ref, m_ref = ref_step(st)
    sst = slab.distribute(st, cfg, spec, mesh)
    sst, m_sh = step(sst, phys)
    out, lost = slab.collect(sst, cfg.n_particles)

    assert lost == 0
    assert int(m_sh.exact_cert) == 0
    assert int(m_sh.overflow) == int(m_ref.overflow)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(s_ref.pos),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(s_ref.vel),
                               atol=2e-4)
    assert float(m_sh.mean_density) == pytest.approx(
        float(m_ref.mean_density), rel=1e-5)


@pytest.mark.slow
def test_slab_multi_frame_migration():
    """Three frames: particles cross slab boundaries; ids are conserved,
    nothing is lost, and positions keep tracking the single-device step."""
    cfg = _calm_cfg()
    mesh = _mesh((8,), ("sp",))
    phys = PhysParams.from_config(cfg)
    st = _calm_state(cfg, seed=3, vscale=0.05)

    ref_step = jax.jit(make_frame_step(cfg, neighbor="sites"))
    step, spec = slab.make_slab_step(cfg, mesh)
    step = jax.jit(step)

    sst = slab.distribute(st, cfg, spec, mesh)
    s_ref = st
    for _ in range(3):
        s_ref, _ = ref_step(s_ref)
        sst, m = step(sst, phys)
        assert int(m.exact_cert) == 0
    out, lost = slab.collect(sst, cfg.n_particles)
    assert lost == 0
    pid = np.sort(np.asarray(sst.pid)[np.asarray(sst.valid)])
    assert np.array_equal(pid, np.arange(cfg.n_particles))
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(s_ref.pos),
                               atol=1e-5)


def test_distribute_places_one_shard_per_device():
    # a 4-device slab mesh holds one row-buffer shard on each device, in
    # slab order — not everything on the first device
    cfg = _calm_cfg()
    mesh = _mesh((4,), ("sp",))
    spec = slab.make_spec(cfg, 4)
    sst = slab.distribute(_calm_state(cfg), cfg, spec, mesh)
    for leaf in sst:
        shards = sorted(leaf.addressable_shards,
                        key=lambda sh: sh.index[0].start or 0)
        assert [sh.device for sh in shards] == list(mesh.devices)
        assert all(sh.data.shape[0] == spec.cap_rows for sh in shards)


def _top_heavy_state(cfg, frac=0.75):
    """A calm state with ``frac`` of the particles in the top z-slab of 4."""
    st = _calm_state(cfg)
    n_top = int(frac * cfg.n_particles)
    z = np.asarray(st.pos)[:, 2].copy()
    z[:n_top] = np.linspace(0.9, 0.95, n_top)
    return st._replace(pos=st.pos.at[:, 2].set(jnp.asarray(z)))


def test_spec_rows_follow_busiest_slab():
    # an unbalanced spawn overflows the even-split rows; sized from its
    # slab populations it fits, and an even split keeps N/D·slack rows
    cfg = _calm_cfg()
    n = cfg.n_particles
    st = _top_heavy_state(cfg)
    pops = slab.slab_populations(st, cfg, 4)
    assert pops.sum() == n and pops[3] > 2 * n // 4
    with pytest.raises(ValueError, match="slab 3 holds"):
        slab.distribute(st, cfg, slab.make_spec(cfg, 4))
    spec = slab.make_spec(cfg, 4, busiest=int(pops.max()))
    assert spec.cap_rows == min(n, int(pops.max()) + n // 4)
    sst = slab.distribute(st, cfg, spec)
    assert int(np.asarray(sst.valid).sum()) == n
    assert slab.make_spec(cfg, 4, busiest=n // 8).cap_rows == 2 * n // 4
    assert slab.make_spec(cfg, 4, row_slack=8.0).cap_rows == n


def test_cli_shards_default_rows_take_unbalanced_state(tmp_path, capsys):
    # `run --shards` with the default row slack on a state whose top slab
    # holds 3/4 of the particles: no overflow at distribution, none lost
    import json

    from sphfluidsimulation_tpu.cli import main
    from sphfluidsimulation_tpu.utils.checkpoint import save_checkpoint

    cfg = _calm_cfg(particle_number=256, bucket_resolution=7)
    ck = str(tmp_path / "top.npz")
    save_checkpoint(ck, _top_heavy_state(cfg), cfg, frame=0)
    assert main(["run", "--resume", ck, "--shards", "4", "--frames",
                 "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["lost"] == 0 and rec["rows_per_device"] == 256


def test_slab_memory_is_decomposed():
    """The spec's shapes prove O(N/D + halo): rows ≈ N/D·slack and the
    local grid spans slab_z + 2·halo z-planes, not R."""
    cfg = _calm_cfg()
    mesh = _mesh((8,), ("sp",))
    _, spec = slab.make_slab_step(cfg, mesh)
    r = cfg.bucket_resolution
    assert spec.cap_rows == -(-2 * cfg.n_particles // 8)
    assert spec.slab_z == -(-r // 8)
    assert spec.slab_z + 2 * spec.halo < r  # local grid < global grid


@pytest.mark.slow
def test_slab_cert_fires_on_overdrift():
    """Velocities large enough to jump past the halo band within one frame
    must be certified, not silently wrong."""
    cfg = _calm_cfg()
    mesh = _mesh((8,), ("sp",))
    phys = PhysParams.from_config(cfg)
    rng = np.random.default_rng(7)
    pos = rng.uniform(0.05, 0.95, (cfg.n_particles, 3)).astype(np.float32)
    vel = np.zeros((cfg.n_particles, 3), np.float32)
    vel[:, 2] = 60.0  # ~ many cells per substep in z
    st = make_state(jnp.asarray(pos), jnp.asarray(vel))

    step, spec = slab.make_slab_step(cfg, mesh)
    sst = slab.distribute(st, cfg, spec, mesh)
    _, m = jax.jit(step)(sst, phys)
    assert int(m.exact_cert) > 0


@pytest.mark.slow
def test_slab_preset_spawn_jitter_certifies_frame_1():
    """Pins the documented slab jitter contract (slab._build_i_local
    docstring): preset spawns overshoot the unit cube (InitParticles'
    simplex jitter), single-device sites handles the out-of-cube cells
    exactly via its delta-widened window, while a slab run clamps those
    evaluation cells into the band and CERTIFIES frame 1 as non-exact —
    one certificate count per jittered particle, never silent."""
    from sphfluidsimulation_tpu.sim.stepper import initial_state

    cfg = SimConfig(particle_number=1024, bucket_resolution=11,
                    site_capacity=24, preset=1).replace(
                        gas_constant=1.0, viscosity=0.05)
    st = initial_state(cfg)
    r = cfg.bucket_resolution
    cell = (np.asarray(st.pos) * (r - 1)).astype(np.int32)
    n_jitter = int((cell != np.clip(cell, 0, r - 1)).any(-1).sum())
    assert n_jitter > 0  # preset 1 @1024 spawns outside the cube

    mesh = _mesh((2,), ("sp",))
    phys = PhysParams.from_config(cfg)
    step, spec = slab.make_slab_step(cfg, mesh)
    sst = slab.distribute(st, cfg, spec, mesh)
    sst, m = jax.jit(step)(sst, phys)
    out, lost = slab.collect(sst, cfg.n_particles)

    assert lost == 0
    # every jittered particle is certified (plus any drift/capacity certs)
    assert int(m.exact_cert) >= n_jitter
    assert np.isfinite(np.asarray(out.pos)).all()


@pytest.mark.slow
def test_batched_slab_dp_sp():
    """2 scenes × 4 slabs: each scene matches its own single-device run."""
    cfg = _calm_cfg()
    mesh = _mesh((2, 4), ("dp", "sp"))
    cfgs = [cfg.replace(rest_density=1.2), cfg.replace(rest_density=1.6)]
    phys = stack_params([PhysParams.from_config(c) for c in cfgs])
    states = [_calm_state(c, seed=10 + i) for i, c in enumerate(cfgs)]

    step, spec = slab.make_batched_slab_step(cfg, mesh)
    ssts = [slab.distribute(s, cfg, spec) for s in states]
    sst = jax.tree.map(lambda *xs: jnp.stack(xs), *ssts)
    sst, m = jax.jit(step)(sst, phys)

    for i, (c, st) in enumerate(zip(cfgs, states)):
        ref_step = jax.jit(make_frame_step(c, neighbor="sites"))
        s_ref, m_ref = ref_step(st)
        part = jax.tree.map(lambda x: x[i], sst)
        out, lost = slab.collect(part, c.n_particles)
        assert lost == 0
        np.testing.assert_allclose(np.asarray(out.pos),
                                   np.asarray(s_ref.pos), atol=2e-6)
        assert float(m.mean_density[i]) == pytest.approx(
            float(m_ref.mean_density), rel=1e-5)


@pytest.mark.slow
def test_slab_extensions_match_single_device():
    """XSPH + artificial viscosity ride the same j-field stack through the
    halo exchange; the sharded step must match single-device sites."""
    cfg = _calm_cfg(xsph=0.1, artificial_viscosity=0.2)
    mesh = _mesh((4,), ("sp",))
    phys = PhysParams.from_config(cfg)
    st = _calm_state(cfg, seed=11)

    ref_step = jax.jit(make_frame_step(cfg, neighbor="sites"))
    step, spec = slab.make_slab_step(cfg, mesh)
    s_ref, _ = ref_step(st)
    sst = slab.distribute(st, cfg, spec, mesh)
    sst, m = jax.jit(step)(sst, phys)
    out, lost = slab.collect(sst, cfg.n_particles)
    assert lost == 0 and int(m.exact_cert) == 0
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(s_ref.pos),
                               atol=2e-6)
