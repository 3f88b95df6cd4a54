"""XSPH + Monaghan artificial viscosity (framework extensions, BASELINE
config 3): slotted and sites implementations vs all-pairs oracle,
physical effect."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphfluidsimulation_tpu.config import SimConfig
from sphfluidsimulation_tpu.sim.stepper import initial_state, make_frame_step

BASE = SimConfig(particle_number=1024, bucket_resolution=11, preset=0,
                 gas_constant=20.0, rest_density=1.7, viscosity=0.05,
                 stiffness_coefficient=1000.0, frame_dt=1 / 240)


def test_disabled_extensions_bit_identical():
    st = initial_state(BASE)
    a, _ = jax.jit(make_frame_step(BASE, neighbor="slotted"))(st)
    b, _ = jax.jit(make_frame_step(
        BASE.replace(xsph=0.0, artificial_viscosity=0.0),
        neighbor="slotted"))(st)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))


@pytest.mark.parametrize("overrides", [
    {"xsph": 0.5},
    {"artificial_viscosity": 0.3},
    {"xsph": 0.3, "artificial_viscosity": 0.2},
])
def test_slotted_matches_brute_oracle(overrides):
    cfg = BASE.replace(**overrides)
    st = initial_state(cfg)
    ss, ms = jax.jit(make_frame_step(cfg, neighbor="slotted"))(st)
    sb, mb = jax.jit(make_frame_step(cfg, neighbor="brute"))(st)
    np.testing.assert_allclose(np.asarray(ss.pos), np.asarray(sb.pos),
                               atol=1e-5)
    assert float(ms.mean_density) == pytest.approx(float(mb.mean_density),
                                                   rel=1e-5)


def test_xsph_changes_trajectory():
    st = initial_state(BASE)
    plain = jax.jit(make_frame_step(BASE, neighbor="slotted"))
    xs = jax.jit(make_frame_step(BASE.replace(xsph=0.5),
                                 neighbor="slotted"))
    sa, sb = st, st
    for _ in range(3):
        sa, _ = plain(sa)
        sb, _ = xs(sb)
    assert float(jnp.max(jnp.abs(sa.pos - sb.pos))) > 1e-6


def test_artificial_viscosity_opposes_approach():
    # Monaghan PI is active only for approaching pairs (v.r < 0) and the
    # resulting force is repulsive along r
    from sphfluidsimulation_tpu.ops.extensions import (
        artificial_viscosity_bruteforce)
    from sphfluidsimulation_tpu.params import PhysParams

    p = PhysParams.from_config(BASE)
    h = float(p.h)
    pos = jnp.array([[0.50, 0.5, 0.5], [0.50 + 0.5 * h, 0.5, 0.5]],
                    jnp.float32)
    rho = jnp.array([1.7, 1.7], jnp.float32)
    mask = jnp.ones((2, 2), bool)

    approaching = jnp.array([[0.1, 0.0, 0.0], [-0.1, 0.0, 0.0]], jnp.float32)
    f = np.asarray(artificial_viscosity_bruteforce(
        pos, approaching, rho, mask, p, alpha=1.0))
    assert f[0, 0] < 0 and f[1, 0] > 0        # pushed apart
    np.testing.assert_allclose(f[0], -f[1], rtol=1e-5)  # Newton's third law

    separating = -approaching
    f2 = np.asarray(artificial_viscosity_bruteforce(
        pos, separating, rho, mask, p, alpha=1.0))
    assert np.all(f2 == 0.0)                  # inactive when receding


def test_unsupported_backend_raises():
    with pytest.raises(NotImplementedError):
        make_frame_step(BASE.replace(xsph=0.5), neighbor="gather")


@pytest.mark.slow
def test_sites_extensions_match_brute_oracle():
    cfg = BASE.replace(xsph=0.3, artificial_viscosity=0.4)
    st = initial_state(cfg)
    sp, mp = jax.jit(make_frame_step(cfg, neighbor="sites"))(st)
    sb, mb = jax.jit(make_frame_step(cfg, neighbor="brute"))(st)
    assert int(mp.exact_cert) == 0  # calm config: certificate holds
    np.testing.assert_allclose(np.asarray(sp.pos), np.asarray(sb.pos),
                               atol=1e-5)
