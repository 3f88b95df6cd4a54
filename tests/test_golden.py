"""Pinned golden-trajectory regression (SURVEY.md §4 item 3).

The reference ships no test oracle, so the stage-1 brute-force CPU rollout
IS the behavioral oracle (SURVEY.md §7): a dam-break trajectory generated
by tests/data's pinned run must be reproduced bit-exactly by the brute
backend on CPU, and tracked by the fast backends. The dam-break is chaotic
(velocities explode under the scene EOS at this size — faithful reference
behavior), so cross-backend comparisons use early frames where float
summation-order differences have not yet amplified.
"""

import os

import jax
import numpy as np
import pytest

from sphfluidsimulation_tpu.config import SimConfig
from sphfluidsimulation_tpu.sim.stepper import initial_state, make_frame_step

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "golden_dambreak_1k.npz")
CFG = SimConfig(particle_number=1024, bucket_resolution=11, preset=1)


@pytest.fixture(scope="module")
def golden():
    with np.load(DATA) as z:
        return {k: z[k] for k in ("pos_1", "pos_5", "pos_20")}


def _rollout(neighbor, frames):
    step = jax.jit(make_frame_step(CFG, neighbor=neighbor))
    s = initial_state(CFG)
    out = {}
    for f in range(1, frames + 1):
        s, _ = step(s)
        if f in (1, 5, 20):
            out[f"pos_{f}"] = np.asarray(s.pos)
    return out

def test_brute_reproduces_golden_exactly(golden):
    got = _rollout("brute", 20)
    for k, v in golden.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_slotted_tracks_golden_early_frames(golden):
    got = _rollout("slotted", 5)
    rmse1 = np.sqrt(np.mean((got["pos_1"] - golden["pos_1"]) ** 2))
    rmse5 = np.sqrt(np.mean((got["pos_5"] - golden["pos_5"]) ** 2))
    assert rmse1 < 1e-6
    assert rmse5 < 1e-3   # chaotic amplification bound

@pytest.mark.slow
def test_sites_tracks_golden_full_tolerance():
    """The sites backend centers every evaluation window on the FRESH
    cell by construction, so there is no drift degradation on the
    explosive golden config — every particle must track, certificate
    must stay 0."""
    step = jax.jit(make_frame_step(CFG, neighbor="sites"))
    s = initial_state(CFG)
    certs = 0
    out = {}
    for f in range(1, 6):
        s, m = step(s)
        certs += int(m.exact_cert)
        if f in (1, 5):
            out[f"pos_{f}"] = np.asarray(s.pos)
    with np.load(DATA) as z:
        golden = {k: z[k] for k in ("pos_1", "pos_5")}
    assert certs == 0
    err1 = np.abs(out["pos_1"] - golden["pos_1"]).max()
    assert err1 < 1e-5            # every particle, not 99%
    rmse5 = np.sqrt(np.mean((out["pos_5"] - golden["pos_5"]) ** 2))
    assert rmse5 < 1e-3           # chaotic amplification bound
