"""Golden-scene dam-break demo: simulate on the accelerator and export
speed-colored frames + a checkpoint.

The canonical workload of the reference (SampleScene.unity:362-376) end to
end: spawn preset 2, faithful frame semantics, the benchmark's default
neighbor backend, host-side point-sprite rendering. Usage:

    python examples/dam_break_demo.py [--particles 262144] [--frames 120]
                                      [--out examples/out]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=262144)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=20,
                    help="frames per scan dispatch")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "out"))
    ap.add_argument("--neighbor", default=None,
                    help="neighbor backend (default: the benchmark's)")
    ap.add_argument("--xsph", type=float, default=0.0)
    ap.add_argument("--alpha-visc", type=float, default=0.0)
    a = ap.parse_args()

    import jax
    import numpy as np

    from sphfluidsimulation_tpu.bench import DEFAULT_NEIGHBOR, scaled_config
    from sphfluidsimulation_tpu.render.camera import OrbitCamera
    from sphfluidsimulation_tpu.render.export import render_frame_png, save_png
    from sphfluidsimulation_tpu.render.meshprops import (RenderParams,
                                                         speed_colors)
    from sphfluidsimulation_tpu.sim.stepper import initial_state, make_rollout
    from sphfluidsimulation_tpu.utils.checkpoint import save_checkpoint
    from sphfluidsimulation_tpu.utils.metrics import MetricsLogger

    neighbor = a.neighbor or DEFAULT_NEIGHBOR
    cfg = scaled_config(a.particles).replace(
        xsph=a.xsph, artificial_viscosity=a.alpha_visc)
    os.makedirs(a.out, exist_ok=True)
    print(f"scene: {cfg.n_particles} particles, R={cfg.bucket_resolution}, "
          f"backend={neighbor}, device={jax.devices()[0]}", flush=True)

    rollout = make_rollout(cfg, a.chunk, neighbor=neighbor)
    state = initial_state(cfg)
    rp = RenderParams.from_config(cfg)
    cam = OrbitCamera(distance=8.0, yaw=35.0, pitch=18.0)
    log = MetricsLogger(os.path.join(a.out, "metrics.jsonl"),
                        n_particles=cfg.n_particles, substeps=cfg.substeps)

    def export(frame, st):
        colors = np.asarray(speed_colors(st.vel, rp))
        img = render_frame_png(np.asarray(st.pos), colors,
                               sim_scale=cfg.sim_scale,
                               particle_radius=cfg.particle_radius,
                               camera=cam)
        save_png(os.path.join(a.out, f"frame_{frame:04d}.png"), img)

    export(0, state)
    frame = 0
    t0 = time.time()
    while frame < a.frames:
        out = jax.block_until_ready(rollout(state))
        state, metrics = out[0], out[1]
        frame += a.chunk
        last = jax.tree.map(lambda x: x[-1], metrics)
        rec = log.log(frame, last)
        print(json.dumps(rec), flush=True)
        export(frame, state)

    save_checkpoint(os.path.join(a.out, "final.npz"), state, cfg, frame=frame)
    rate = cfg.n_particles * cfg.substeps * frame / (time.time() - t0)
    print(f"done: {frame} frames, {rate/1e6:.2f}M particle-substeps/s, "
          f"artifacts in {a.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
