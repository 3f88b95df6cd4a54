"""Throughput benchmark: particle-substeps/s on the dam-break.

Workload: the reference's canonical dam-break scene (preset 2 spawn, golden
physics constants, SampleScene.unity:362-376) scaled to the requested
particle count with the bucket resolution scaled like the golden config
(occupancy-preserving: R ∝ N^(1/3), golden 262144 → 47).

Methodology: one jitted ``lax.scan`` rollout of ``frames`` frames, compiled
ahead of time (compilation is set-up, reported apart), timed with the host
clock around a call that ends in ``jax.block_until_ready``. The spawn window
is frames ``[0, frames)``, timed after one discarded run of the same window
so that it pays no first-run cost the late window does not; the late window
starts at the first multiple of ``frames`` at or past ``late_after``,
reached by the timed backend's own rollout.
Every result names the device it ran on, so a CPU number never passes for
a GPU one.
"""

from __future__ import annotations

import subprocess
import time

import jax

from .config import SimConfig
from .sim.stepper import PHASES, initial_state, make_rollout

# The backend `run_bench`, `cli bench` and the root `bench.py` time by
# default: the fastest at 1,048,576 particles on the H100 (PERF.md).
DEFAULT_NEIGHBOR = "slotted"

# Backends the benchmark times (brute is the O(N²) oracle).
BENCH_BACKENDS = ("gather", "slotted", "sites")


def scaled_config(n_particles: int, site_capacity: int | None = None,
                  site_bands: int = 0) -> SimConfig:
    """Golden physics at a given N; R scales to preserve voxel occupancy."""
    base_r = 47
    r = max(3, round(base_r * (n_particles / 262144.0) ** (1.0 / 3.0)))
    kw = {} if site_capacity is None else {"site_capacity": site_capacity}
    return SimConfig(particle_number=n_particles, bucket_resolution=r,
                     site_bands=site_bands, **kw)


def gpu_name_and_power_limit() -> str | None:
    """``name, power.limit`` of every card as nvidia-smi reports them (one
    line per card, joined by '; '), or None where nvidia-smi is absent."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if r.returncode == 0 and lines else None


def device_record() -> dict:
    """The device a measurement ran on, as JAX reports it; on a GPU also
    the card's name and power limit."""
    devs = jax.devices()
    rec = {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
           "device_count": len(devs)}
    if rec["platform"] == "gpu":
        rec["gpu_name_power_limit"] = gpu_name_and_power_limit()
    return rec


def force_candidate_bytes(cfg: SimConfig) -> int:
    """Candidate bytes one force substep of the cell walks reads: every
    particle visits 27 voxels × capacity slots and reads a candidate's
    position, velocity, density and id (32 B, the same for the 'gather'
    and 'slotted' layouts)."""
    return cfg.n_particles * 27 * (cfg.voxel_capacity or 0) * 32


def _window(compiled, state, cfg: SimConfig, frames: int):
    jax.block_until_ready(state)   # no earlier dispatch runs into the timing
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(state))
    elapsed = time.perf_counter() - t0
    m = out[1]
    return out[0], {
        "value": cfg.n_particles * cfg.substeps * frames / elapsed,
        "elapsed_s": elapsed,
        "exact_cert_total": int(jax.numpy.sum(m.exact_cert)),
        "overflow_max": int(jax.numpy.max(m.overflow)),
        "nan_events": int(jax.numpy.sum(m.nan_events)),
    }


def run_bench(n_particles: int = 1 << 20, frames: int = 20,
              neighbor: str = DEFAULT_NEIGHBOR,
              site_capacity: int | None = None, site_bands: int = 0,
              late_after: int = 0, trace_dir: str | None = None) -> dict:
    """Time one backend at one size; see the module docstring.

    ``late_after`` > 0 adds a late window. ``trace_dir`` traces one more
    window with the profiler and reduces it to per-phase device time
    (utils/profiling.phase_breakdown).
    """
    cfg = scaled_config(n_particles, site_capacity, site_bands)
    state = initial_state(cfg)
    roll = make_rollout(cfg, frames, neighbor=neighbor)
    t0 = time.perf_counter()
    compiled = roll.lower(state).compile()
    compile_s = time.perf_counter() - t0

    jax.block_until_ready(compiled(state))   # warm-up; the rollout is pure
    state, spawn = _window(compiled, state, cfg, frames)
    result = {
        "metric": "particle-substeps/s (dam-break, faithful mode)",
        "unit": "particle-substeps/s",
        "neighbor": neighbor,
        "n_particles": cfg.n_particles,
        "bucket_resolution": cfg.bucket_resolution,
        "frames_window": [0, frames],
        **spawn,
        "compile_s": compile_s,
        **device_record(),
    }
    if neighbor == "sites":
        from .ops import sites
        result["site_capacity"] = cfg.site_capacity
        result["site_bands"] = (cfg.site_bands
                                or sites.auto_bands(cfg.bucket_resolution))
    done = frames
    if late_after:
        while done < late_after:
            state = compiled(state)[0]
            done += frames
        state, late = _window(compiled, state, cfg, frames)
        result["late"] = {"frames_window": [done, done + frames], **late}
        done += frames
    if trace_dir:
        from .utils.profiling import latest_xplane, phase_breakdown
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(compiled(state))
        bd = phase_breakdown(latest_xplane(trace_dir), [compiled.as_text()],
                             PHASES)
        bd["frames_window"] = [done, done + frames]
        if neighbor in ("gather", "slotted"):
            ns = bd["phase_ns"]["force_integrate"]
            bd["force_candidate_bytes_per_s"] = (
                force_candidate_bytes(cfg) * cfg.substeps * frames
                / max(ns, 1) * 1e9)
        result["trace"] = bd
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        result["peak_bytes_in_use"] = stats["peak_bytes_in_use"]
    return result
