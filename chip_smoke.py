#!/usr/bin/env python
"""Smoke test of the simulator's main path on the GPU.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: the z-slab phase only

Phases (one card):
  1. device      refuse any platform but ``gpu``; print the card's name and
                 power limit as nvidia-smi gives them
  2. golden      ``Scene(SimConfig())``: 262,144 particles, 10 frames; then
                 ``cli run`` of the same scene for 3 frames
  3. throughput  ``cli bench`` (``run_bench``) at 1,048,576 particles,
                 20 frames
  4. oracle      frame-1 density, forces and positions of the cell walks
                 against the O(N²) ``brute`` oracle (16,384 particles), and
                 of the bench default against an independent backend
                 (262,144 particles), float32 at "highest" matmul precision
  5. sweep       ``cli sweep``: 8 vmapped scenes of 131,072 particles
With ``--four-cards``: the z-slab step through ``cli run --shards 4`` at
1,048,576 particles (calm state) against the single-card ``sites`` step,
then a few golden frames at 4,194,304.

Any failed check raises, so the script exits non-zero. The last line of
standard output is one JSON object naming the device; it is printed only
when every phase passed.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Frame-1 tolerances against the brute oracle and between backends, from
# the CPU pins (tests/test_golden.py: 1e-6 position RMSE, 1e-5 worst
# particle at frame 1). Sums run in another order on the GPU (tree
# reductions against the oracle's all-pairs rows), which moves a field by a
# few ulp of its largest term: density and force are held to that,
# relative to the field's scale. Positions keep the 1e-6 RMSE pin. The
# spawn frame throws a few particles across the box (frame-1 displacement
# up to 1.2 box widths at 16,384-262,144 particles), and five substeps
# amplify order noise along those paths (up to 2.6e-4 between two XLA
# backends on the CPU at 262,144), so the 1e-5 pin holds for 99.9% of the
# particles and the worst one is held to 1e-3.
TOL = {
    "rho_max_rel": 1e-5,     # max |Δρ| / max ρ
    "force_rms_rel": 1e-5,   # ‖Δf‖₂ / ‖f‖₂
    "force_max_rel": 1e-4,   # max |Δf| / max |f|
    "pos_rmse": 1e-6,        # tests/test_golden.py:52
    "pos_q999": 1e-5,        # tests/test_golden.py:64, 88
    "pos_max": 1e-3,
}


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 -----------------------------------------------------------------

def phase_device(expect_count: int = 1) -> dict:
    import jax

    from sphfluidsimulation_tpu.bench import gpu_name_and_power_limit

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is {devs[0].platform!r}")
    check(len(devs) >= expect_count,
          f"need {expect_count} GPUs, JAX sees {len(devs)}")
    log(f"[device] {len(devs)} x {devs[0].device_kind}")
    log(gpu_name_and_power_limit() or "nvidia-smi: not available")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# -- phase 2 -----------------------------------------------------------------

def check_positions(pos, n: int, label: str,
                    allow_nonfinite: bool = False) -> int:
    """Shape ``(n, 3)``, every finite position inside [0,1]^3 and, unless
    ``allow_nonfinite``, every position finite. Returns the number of
    particles with a non-finite coordinate."""
    import numpy as np

    pos = np.asarray(pos)
    check(pos.shape == (n, 3), f"{label}: shape {pos.shape}")
    bad = ~np.isfinite(pos).all(axis=1)
    check(allow_nonfinite or not bad.any(), f"{label}: non-finite positions")
    fin = pos[~bad]
    check(bool(((fin >= 0.0) & (fin <= 1.0)).all()),
          f"{label}: positions outside [0,1]^3")
    return int(bad.sum())


def phase_golden(cfg=None, frames: int = 10, cli_frames: int = 3) -> None:
    """``Scene`` for ``frames`` frames, then ``cli run`` of the same scene
    for ``cli_frames`` frames into a checkpoint."""
    from sphfluidsimulation_tpu import Scene, SimConfig
    from sphfluidsimulation_tpu.utils.checkpoint import load_checkpoint

    scene = Scene(cfg or SimConfig())
    n = scene.cfg.n_particles
    t0 = time.perf_counter()
    scene.step(frames)
    m = scene.last_metrics
    log(f"[golden] Scene: {n} particles, {frames} frames, "
        f"neighbor={scene.neighbor}, {time.perf_counter() - t0:.1f} s "
        f"(compile included): overflow={int(m.overflow)} "
        f"nan_events={int(m.nan_events)} exact_cert={int(m.exact_cert)}")
    check_positions(scene.state.pos, n, "Scene")

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "golden.npz")
        t0 = time.perf_counter()
        rec = cli_json(["run", "--particles", str(scene.cfg.particle_number),
                        "--bucket-resolution",
                        str(scene.cfg.bucket_resolution),
                        "--frames", str(cli_frames), "--checkpoint", ck])
        state, _, meta = load_checkpoint(ck)
    log(f"[golden] cli run: {cli_frames} frames, "
        f"{time.perf_counter() - t0:.1f} s (compile included): "
        f"overflow={rec['overflow']} nan_events={rec['nan_events']}")
    check(rec["frames"] == meta["frame"] == cli_frames, "cli run frames")
    check_positions(state.pos, n, "cli run")


# -- phase 3 -----------------------------------------------------------------

def phase_throughput(n: int = 1 << 20, frames: int = 20) -> dict:
    """``cli bench`` (``run_bench`` on the default backend)."""
    import math

    res = cli_json(["bench", "--particles", str(n), "--frames", str(frames)])
    log(f"[throughput] cli bench, {res['neighbor']} at "
        f"{res['n_particles']}: {res['value']} particle-substeps/s over "
        f"frames {res['frames_window']} ({res['elapsed_s']} s, compile "
        f"{res['compile_s']} s) on "
        f"{res.get('gpu_name_power_limit') or res['device_kind']}")
    check(math.isfinite(res["value"]) and res["value"] > 0, "no rate")
    return res


# -- phase 4 -----------------------------------------------------------------

def frame1(cfg, neighbor: str, state):
    """Frame 1 of one backend's frame step — the step the rollouts time —
    as numpy arrays: (frame-start ρ, first substep's fluid force, positions
    after the frame, exactness certificate)."""
    import jax
    import numpy as np

    from sphfluidsimulation_tpu.sim.stepper import make_frame_step

    st, m, (rho, f) = jax.jit(
        make_frame_step(cfg, neighbor=neighbor, fields=True))(state)
    return (np.asarray(rho), np.asarray(f[0]), np.asarray(st.pos),
            int(m.exact_cert))


def compare(a, b, label: str) -> dict:
    """Frame-1 differences of ``a`` against the reference ``b`` (both as
    returned by :func:`frame1`), checked against TOL."""
    import numpy as np

    rho_a, f_a, p_a, cert = a
    rho_b, f_b, p_b, _ = b
    dp = np.abs(p_a - p_b).max(axis=1)
    d = {
        "rho_max_rel": float(np.abs(rho_a - rho_b).max()
                             / max(np.abs(rho_b).max(), 1e-30)),
        "force_rms_rel": float(np.linalg.norm(f_a - f_b)
                               / max(np.linalg.norm(f_b), 1e-30)),
        "force_max_rel": float(np.abs(f_a - f_b).max()
                               / max(np.abs(f_b).max(), 1e-30)),
        "pos_rmse": float(np.sqrt(np.mean((p_a - p_b) ** 2))),
        "pos_q999": float(np.quantile(dp, 0.999)),
        "pos_max": float(dp.max()),
    }
    log(f"[oracle] {label}: " + " ".join(
        f"{k}={v:.3e} (tol {TOL[k]:g})" for k, v in d.items())
        + f" exact_cert={cert}")
    for k, v in d.items():
        check(v <= TOL[k], f"{label}: {k}={v:.3e} > {TOL[k]:g}")
    check(cert == 0, f"{label}: exact_cert={cert}")
    return d


def phase_oracle(n_oracle: int = 16384, n_pair: int = 262144) -> None:
    import jax

    from sphfluidsimulation_tpu.bench import DEFAULT_NEIGHBOR, scaled_config
    from sphfluidsimulation_tpu.sim.stepper import initial_state

    other = "gather" if DEFAULT_NEIGHBOR == "slotted" else "slotted"
    with jax.default_matmul_precision("highest"):
        cfg = scaled_config(n_oracle)
        st = initial_state(cfg)
        ref = frame1(cfg, "brute", st)
        for nb in ("gather", "slotted"):
            compare(frame1(cfg, nb, st), ref,
                    f"{nb} vs brute at {cfg.n_particles} "
                    f"(R={cfg.bucket_resolution})")
        cfg = scaled_config(n_pair)
        st = initial_state(cfg)
        compare(frame1(cfg, DEFAULT_NEIGHBOR, st), frame1(cfg, other, st),
                f"{DEFAULT_NEIGHBOR} vs {other} at {cfg.n_particles} "
                f"(R={cfg.bucket_resolution})")


# -- phase 5 -----------------------------------------------------------------

def cli_json(argv) -> dict:
    """Run the CLI in this process; its last stdout line parsed as JSON."""
    from sphfluidsimulation_tpu.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    out = buf.getvalue()
    check(rc == 0, f"cli {argv[0]} exited {rc}: {out[-400:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_sweep(scenes: int = 8, particles: int = 131072,
                frames: int = 3) -> dict:
    import math

    t0 = time.perf_counter()
    rec = cli_json(["sweep", "--scenes", str(scenes), "--particles",
                    str(particles), "--frames", str(frames)])
    log(f"[sweep] {scenes} x {particles}, {frames} frames, "
        f"{time.perf_counter() - t0:.1f} s (compile included): "
        f"mean_density={rec['mean_density']} overflow={rec['overflow']}")
    check(rec["scenes"] == scenes and rec["frames"] == frames, "sweep shape")
    check(all(math.isfinite(x) and x > 0 for x in rec["mean_density"]),
          "sweep density")
    return rec


# -- four cards --------------------------------------------------------------

def phase_slab(n: int = 1 << 20, n_big: int = 1 << 22, big_frames: int = 3,
               shards: int = 4) -> None:
    """The z-slab step over ``shards`` cards through ``cli run --shards``.

    Exactness at ``n`` (R scaled as in the benchmark): one sharded frame
    from a calm state (tests/test_slab.py's: uniform positions, slow
    velocities, gas constant 1, viscosity 0.05) against the single-card
    ``sites`` frame — no particle lost, the same overflow and certificate,
    positions within the oracle phase's tolerances and velocities within
    tests/test_slab.py's 2e-4. The golden spawn cannot serve here: its
    frame-1 speeds reach ~1e17, particles cross more than the halo in one
    frame, and the slab step certifies those windows rather than follows
    them. Then ``big_frames`` golden frames from the real spawn at
    ``n_big``: every particle kept, every finite position in the box. The
    count of non-finite positions is printed, not bounded: at golden
    physics ``vel = inf`` then ``a = -inf`` gives a NaN velocity past the
    NaN trap (FIDELITY.md), and the clamp keeps a NaN position NaN. The
    single-device ``sites`` step does the same (1,103 of 262,144 particles
    by frame 3 on the CPU; the four-slab step 953). Both runs take the
    CLI's default row capacity, which the golden spawn's unbalanced
    z-slabs exercise (parallel/slab.make_spec).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sphfluidsimulation_tpu.bench import scaled_config
    from sphfluidsimulation_tpu.sim.stepper import make_frame_step
    from sphfluidsimulation_tpu.state import make_state
    from sphfluidsimulation_tpu.utils.checkpoint import (load_checkpoint,
                                                         save_checkpoint)

    cfg = scaled_config(n).replace(gas_constant=1.0, viscosity=0.05)
    rng = np.random.default_rng(0)
    st = make_state(
        jnp.asarray(rng.uniform(0.05, 0.95, (cfg.n_particles, 3)),
                    jnp.float32),
        jnp.asarray(rng.normal(0.0, 0.02, (cfg.n_particles, 3)),
                    jnp.float32))
    ref, m_ref = jax.jit(make_frame_step(cfg, neighbor="sites"))(st)
    with tempfile.TemporaryDirectory() as tmp:
        ck0 = os.path.join(tmp, "calm.npz")
        ck1 = os.path.join(tmp, "frame1.npz")
        save_checkpoint(ck0, st, cfg, frame=0)
        t0 = time.perf_counter()
        rec = cli_json(["run", "--resume", ck0, "--shards", str(shards),
                        "--frames", "1", "--checkpoint", ck1])
        dt = time.perf_counter() - t0
        out, _, _ = load_checkpoint(ck1)
    devs = rec["shard_devices"]
    log(f"[slab] {cfg.n_particles} particles (calm) on {shards} cards "
        f"(shard devices {devs}, {rec['rows_per_device']} rows each), "
        f"1 frame, {dt:.1f} s (compile included): "
        f"lost={rec['lost']} exact_cert={rec['exact_cert']} (single card "
        f"{int(m_ref.exact_cert)}) overflow={rec['overflow']} (single card "
        f"{int(m_ref.overflow)})")
    dp = np.abs(np.asarray(out.pos) - np.asarray(ref.pos)).max(axis=1)
    d = {"pos_rmse": float(np.sqrt(np.mean(dp ** 2))),
         "pos_q999": float(np.quantile(dp, 0.999)),
         "pos_max": float(dp.max()),
         "vel_max": float(np.abs(np.asarray(out.vel)
                                 - np.asarray(ref.vel)).max())}
    tol = {**TOL, "vel_max": 2e-4}
    log("[slab] vs single-card sites: " + " ".join(
        f"{k}={v:.3e} (tol {tol[k]:g})" for k, v in d.items()))
    check(sorted(devs) == list(range(shards)), f"shards on {devs}")
    check(rec["lost"] == 0, "slab lost particles")
    check_positions(out.pos, cfg.n_particles, "slab 1M")
    check(rec["overflow"] == int(m_ref.overflow), "overflow differs")
    check(rec["exact_cert"] == int(m_ref.exact_cert), "certificate differs")
    for k, v in d.items():
        check(v <= tol[k], f"slab vs single card: {k}={v:.3e} > {tol[k]:g}")

    big = scaled_config(n_big)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "big.npz")
        t0 = time.perf_counter()
        rec = cli_json(["run", "--particles", str(big.particle_number),
                        "--bucket-resolution", str(big.bucket_resolution),
                        "--shards", str(shards), "--frames", str(big_frames),
                        "--checkpoint", ck])
        dt = time.perf_counter() - t0
        out, _, _ = load_checkpoint(ck)
    nonfinite = check_positions(out.pos, big.n_particles, "slab 4M",
                                allow_nonfinite=True)
    log(f"[slab] {big.n_particles} particles on {shards} cards "
        f"({rec['rows_per_device']} rows each), {big_frames} frames, "
        f"{dt:.1f} s (compile included): lost={rec['lost']} "
        f"exact_cert={rec['exact_cert']} overflow={rec['overflow']} "
        f"max_speed={rec['max_speed']} nonfinite_positions={nonfinite}")
    check(rec["lost"] == 0, "slab lost particles at 4M")
    check(sorted(rec["shard_devices"]) == list(range(shards)),
          "4M shards misplaced")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the z-slab phase on four cards")
    a = ap.parse_args(argv)

    from sphfluidsimulation_tpu.utils.compcache import (
        enable_compilation_cache)

    device = phase_device(4 if a.four_cards else 1)
    enable_compilation_cache()
    t0 = time.perf_counter()
    if a.four_cards:
        phase_slab()
    else:
        phase_golden()
        phase_throughput()
        phase_oracle()
        phase_sweep()
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
