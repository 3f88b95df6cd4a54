"""Checkpoint (npz + orbax), diagnostics, metrics logger."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphfluidsimulation_tpu.config import SimConfig
from sphfluidsimulation_tpu.sim.stepper import initial_state, make_frame_step
from sphfluidsimulation_tpu.state import ParticleState
from sphfluidsimulation_tpu.utils import (
    MetricsLogger,
    StateError,
    checkify_step,
    load_checkpoint,
    save_checkpoint,
    validate_state,
)

CFG = SimConfig(particle_number=1024, bucket_resolution=11)


def _roundtrip(path):
    st = initial_state(CFG)
    save_checkpoint(path, st, CFG, frame=7, extra={"note": "x"})
    state, cfg, meta = load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(state.pos), np.asarray(st.pos))
    assert cfg == CFG
    assert meta["frame"] == 7
    assert meta["extra"]["note"] == "x"


def test_npz_checkpoint_roundtrip(tmp_path):
    _roundtrip(os.path.join(tmp_path, "ck.npz"))


def test_orbax_checkpoint_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    _roundtrip(os.path.join(tmp_path, "ckdir"))


def test_orbax_missing_names_npz(tmp_path, monkeypatch):
    # a directory-style path needs orbax; without it the error says so and
    # points at the built-in .npz writer
    import sys
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    st = initial_state(CFG)
    with pytest.raises(ImportError, match=r"\.npz"):
        save_checkpoint(os.path.join(tmp_path, "ckdir"), st, CFG)
    with pytest.raises(ImportError, match=r"\.npz"):
        load_checkpoint(os.path.join(tmp_path, "ckdir"))


def test_checkpoint_shape_validation(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    st = initial_state(CFG)
    save_checkpoint(path, st, CFG)
    # corrupt: claim a different particle count in the embedded config
    with np.load(path) as z:
        data = dict(z)
    meta = json.loads(bytes(data["meta"].tobytes()).decode())
    meta["config"]["particle_number"] = 4096
    data["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **data)
    with pytest.raises(ValueError):
        load_checkpoint(path)


def test_validate_state_passes_and_fails():
    st = initial_state(CFG)
    step = jax.jit(make_frame_step(CFG))
    st, _ = step(st)
    diag = validate_state(st, n_particles=CFG.n_particles)
    assert diag["nonfinite_pos"] == 0
    bad = ParticleState(pos=st.pos.at[0, 0].set(jnp.nan), vel=st.vel,
                        nan_count=st.nan_count)
    with pytest.raises(StateError):
        validate_state(bad)


def test_checkify_step_passes_on_valid_step():
    step = checkify_step(make_frame_step(CFG))
    st = initial_state(CFG)
    out, m = step(st)
    assert out.pos.shape == st.pos.shape


def test_metrics_logger(tmp_path):
    path = os.path.join(tmp_path, "m.jsonl")
    log = MetricsLogger(path, n_particles=CFG.n_particles)
    scene_step = jax.jit(make_frame_step(CFG))
    st = initial_state(CFG)
    st, m = scene_step(st)
    rec = log.log(1, m, tag="t")
    assert rec["frame"] == 1 and rec["tag"] == "t"
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["mean_density"] > 0
