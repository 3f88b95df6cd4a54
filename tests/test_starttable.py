"""run_starts is value-identical to searchsorted.

``run_starts`` (ops/grid.py) gives the first index of each equal-value run
of a sorted array; every capacity-rank pass (grid, sites, slab) uses it.
The physics contract is bit-identity: these ranks feed candidate walks
whose pinned trajectories must not move.
"""

import numpy as np
import jax.numpy as jnp

from sphfluidsimulation_tpu.ops.grid import run_starts


def _cases(rng):
    yield np.sort(rng.integers(0, 50, size=1000)).astype(np.int32), 51
    # heavy duplication + empty cells
    yield np.sort(rng.integers(0, 7, size=513)).astype(np.int32), 40
    # all one value
    yield np.full(128, 3, np.int32), 10
    # sentinel rows at the top of the query range (dead-slot pattern)
    a = np.sort(np.concatenate([rng.integers(0, 63, size=400),
                                np.full(29, 63)])).astype(np.int32)
    yield a, 64
    # single element / queries beyond every element
    yield np.array([2], np.int32), 9


def test_run_starts_matches_searchsorted_self_join():
    rng = np.random.default_rng(11)
    for a, _ in _cases(rng):
        want = np.searchsorted(a, a, side="left")
        got = np.asarray(run_starts(jnp.asarray(a)))
        np.testing.assert_array_equal(got, want)
