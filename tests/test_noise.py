"""Simplex-noise properties + pinned regression values.

The init jitter must be deterministic (the rollout-parity oracle depends on
it), bounded, and non-degenerate. Golden values pin the implementation so a
refactor can't silently change every spawn position.
"""

import jax.numpy as jnp
import numpy as np

from sphfluidsimulation_tpu.ops.noise import snoise4


def _grid(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(-10, 10, size=(n, 4)), jnp.float32)


def test_deterministic():
    v = _grid()
    a = np.asarray(snoise4(v))
    b = np.asarray(snoise4(v))
    np.testing.assert_array_equal(a, b)


def test_bounded_and_nondegenerate():
    x = np.asarray(snoise4(_grid(16384)))
    assert np.all(np.isfinite(x))
    # the Ashima 49.0 scaling slightly overshoots [-1, 1] (observed max 1.01)
    assert np.max(np.abs(x)) <= 1.05
    assert np.std(x) > 0.05                  # actually varies
    assert abs(np.mean(x)) < 0.05            # roughly zero-mean


def test_continuity():
    # noise is continuous: tiny input perturbations -> tiny output changes
    v = _grid(512)
    dv = v + 1e-4
    a = np.asarray(snoise4(v))
    b = np.asarray(snoise4(dv))
    assert np.max(np.abs(a - b)) < 0.05


def test_batch_shapes():
    v = _grid(64).reshape(4, 16, 4)
    out = snoise4(v)
    assert out.shape == (4, 16)


def test_pinned_golden_values():
    # Regression pins (computed once on CPU float32; platform-stable to 1e-5).
    pts = jnp.array(
        [
            [0.0, 0.0, 0.0, 0.0],
            [0.1, 0.2, 0.3, 0.4],
            [1.5, -2.25, 3.75, 100.0],
            [12.34, 56.78, -9.01, 2345.0],
        ],
        jnp.float32,
    )
    got = np.asarray(snoise4(pts))
    expected = np.array(
        [0.0, -0.30039418, 0.18072851, -0.47077897], np.float32)
    # loose atol: float32 rounding differs in the last ulps across backends
    np.testing.assert_allclose(got, expected, atol=1e-4)
