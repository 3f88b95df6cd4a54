"""Checkpoint / resume.

The reference has no persistence: simulation state lives only in GPU
textures and dies with the scene (SphFluidSimulation.cs:110-120). Here the
state is a plain pytree, so checkpointing is a host transfer + npz file,
with the config embedded so a resume can validate structural compatibility.
Orbax is used for directory-style paths where it is installed; the npz
path has zero extra dependencies and is the default.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np

from ..config import SimConfig
from ..state import ParticleState

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state: ParticleState, cfg: SimConfig, *,
                    frame: int = 0, extra: dict | None = None) -> None:
    """Write state + config (+ metadata) to ``path``.

    A ``.npz`` path uses the zero-dependency writer; a directory-style path
    (no extension) uses orbax (sharded-array aware), and raises a clear
    ImportError where orbax is not installed.
    """
    meta = {"format_version": _FORMAT_VERSION, "frame": int(frame),
            "config": cfg.as_dict(), "extra": extra or {}}
    if not path.endswith(".npz"):
        _save_orbax(path, state, meta)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        pos=np.asarray(jax.device_get(state.pos)),
        vel=np.asarray(jax.device_get(state.vel)),
        nan_count=np.asarray(jax.device_get(state.nan_count)),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "orbax is not installed, and a checkpoint path without the "
            ".npz suffix needs it; give a path ending in .npz to use the "
            "built-in writer") from e
    return ocp


def _save_orbax(path: str, state: ParticleState, meta: dict) -> None:
    ocp = _orbax()

    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path),
                   {"state": state._asdict(),
                    "meta_json": np.frombuffer(json.dumps(meta).encode(),
                                               dtype=np.uint8)},
                   force=True)


def _load_orbax(path: str) -> tuple[ParticleState, SimConfig, dict]:
    ocp = _orbax()

    with ocp.PyTreeCheckpointer() as ckptr:
        tree = ckptr.restore(os.path.abspath(path))
    meta = json.loads(bytes(np.asarray(tree["meta_json"]).tobytes()).decode())
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version in {path}")
    cfg = SimConfig.from_dict(meta["config"])
    s = tree["state"]
    state = ParticleState(pos=jax.numpy.asarray(s["pos"]),
                          vel=jax.numpy.asarray(s["vel"]),
                          nan_count=jax.numpy.asarray(s["nan_count"]))
    return state, cfg, meta


def load_checkpoint(path: str) -> tuple[ParticleState, SimConfig, dict]:
    """Read (state, config, meta) from ``path``; validates shape vs config."""
    if not path.endswith(".npz"):
        return _load_orbax(path)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version in {path}")
        cfg = SimConfig.from_dict(meta["config"])
        pos, vel = z["pos"], z["vel"]
        nan_count = z["nan_count"]
    if pos.shape != (cfg.n_particles, 3):
        raise ValueError(
            f"checkpoint state {pos.shape} does not match config "
            f"({cfg.n_particles} particles)")
    state = ParticleState(pos=jax.numpy.asarray(pos),
                          vel=jax.numpy.asarray(vel),
                          nan_count=jax.numpy.asarray(nan_count))
    return state, cfg, meta
