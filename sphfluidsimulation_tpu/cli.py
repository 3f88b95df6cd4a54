"""Command-line runner.

The reference's "user interface" is the Unity inspector (15 serialized
fields, SphFluidSimulation.cs:34-53) plus play mode. The equivalent here:
``python -m sphfluidsimulation_tpu run`` with one flag per inspector field,
plus the framework services the reference lacks (checkpoint/resume, metrics
JSONL, frame export, throughput bench).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .bench import BENCH_BACKENDS, DEFAULT_NEIGHBOR
from .sim.stepper import BACKENDS


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    # one flag per reference inspector field (SphFluidSimulation.cs:34-53)
    p.add_argument("--preset", type=int, default=1,
                   help="spawn kernel index: 0 dam, 1 centered column, "
                        "2 corner column (scene default 1)")
    p.add_argument("--particles", type=int, default=262144)
    p.add_argument("--bucket-resolution", type=int, default=47)
    p.add_argument("--dam-fill-rate", type=float, default=0.8)
    p.add_argument("--viscosity", type=float, default=0.01)
    p.add_argument("--rest-density", type=float, default=1.5)
    p.add_argument("--gas-constant", type=float, default=150.0)
    p.add_argument("--stiffness", type=float, default=5000.0)
    p.add_argument("--damping", type=float, default=10.0)
    p.add_argument("--particle-radius", type=float, default=0.01)
    p.add_argument("--low-speed", type=float, default=0.0)
    p.add_argument("--high-speed", type=float, default=0.5)
    p.add_argument("--frame-dt", type=float, default=1.0 / 60.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--neighbor", choices=list(BACKENDS), default="slotted")
    p.add_argument("--corrected", action="store_true",
                   help="rebuild bucket+density every substep instead of "
                        "the reference's once-per-frame reuse")
    p.add_argument("--xsph", type=float, default=0.0,
                   help="XSPH advection-smoothing epsilon (0 disables)")
    p.add_argument("--alpha-visc", type=float, default=0.0,
                   help="Monaghan artificial-viscosity alpha (0 disables)")
    p.add_argument("--site-capacity", type=int, default=32,
                   help="distinct (position[,rho,v]) sites per voxel for "
                        "the 'sites' backend (overflow is certified)")


def _config_from_args(a) -> "SimConfig":
    from .config import SimConfig
    return SimConfig(
        preset=a.preset, particle_number=a.particles,
        bucket_resolution=a.bucket_resolution, dam_fill_rate=a.dam_fill_rate,
        viscosity=a.viscosity, rest_density=a.rest_density,
        gas_constant=a.gas_constant, stiffness_coefficient=a.stiffness,
        damping_coefficient=a.damping, particle_radius=a.particle_radius,
        low_speed=a.low_speed, high_speed=a.high_speed, frame_dt=a.frame_dt,
        seed=a.seed, xsph=a.xsph, artificial_viscosity=a.alpha_visc,
        site_capacity=a.site_capacity,
    ).validate()


def cmd_run(a) -> int:
    from .models.scene import Scene
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import MetricsLogger

    if getattr(a, "shards", 1) > 1:
        return _run_slab(a)
    if a.resume:
        state, cfg, meta = load_checkpoint(a.resume)
        scene = Scene(cfg, neighbor=a.neighbor, faithful=not a.corrected)
        scene.state = state
        scene.frame = meta.get("frame", 0)
        print(f"resumed frame {scene.frame} from {a.resume}")
    else:
        cfg = _config_from_args(a)
        scene = Scene(cfg, neighbor=a.neighbor, faithful=not a.corrected)

    log = MetricsLogger(a.metrics, n_particles=scene.cfg.n_particles,
                        substeps=scene.cfg.substeps)
    export_every = a.export_every if a.export_dir else 0
    if a.export_dir:
        os.makedirs(a.export_dir, exist_ok=True)

    exported: list[str] = []
    viewer_frames: list = []
    viewer_speeds: list = []
    for _ in range(a.frames):
        scene.step()
        if a.viewer and scene.frame % max(a.viewer_every, 1) == 0:
            import numpy as np
            viewer_frames.append(np.asarray(scene.state.pos))
            viewer_speeds.append(
                np.linalg.norm(np.asarray(scene.state.vel), axis=-1))
            # live mode: rewrite the self-contained viewer every k
            # recorded frames with an auto-refresh tag, so a browser on
            # the file follows the RUNNING sim — the headless equivalent
            # of the reference's per-frame draw (SphFluidSimulation.cs:
            # 106-107); the final write below drops the refresh
            if a.viewer_live and len(viewer_frames) % a.viewer_live == 0:
                from .render.viewer import export_html_viewer
                export_html_viewer(
                    a.viewer, np.stack(viewer_frames),
                    np.stack(viewer_speeds),
                    sim_scale=scene.cfg.sim_scale,
                    low_speed=scene.cfg.low_speed,
                    high_speed=scene.cfg.high_speed,
                    refresh_s=2.0)
        rec = log.log(scene.frame, scene.last_metrics)
        if a.verbose:
            print(json.dumps(rec))
        if a.checkpoint and a.checkpoint_every and \
                scene.frame % a.checkpoint_every == 0:
            save_checkpoint(a.checkpoint, scene.state, scene.cfg,
                            frame=scene.frame)
        if export_every and scene.frame % export_every == 0:
            exported.append(_export_frame(scene, a.export_dir))

    if a.checkpoint:
        save_checkpoint(a.checkpoint, scene.state, scene.cfg,
                        frame=scene.frame)
        print(f"checkpoint → {a.checkpoint}")
    if a.animate:
        from .render.export import assemble_animation
        # only the frames THIS run wrote — a glob would splice in stale
        # frame_*.png files left in the directory by earlier runs
        if exported:
            print(f"animation → {assemble_animation(exported, a.animate)}")
        else:
            print("no exported frames to animate (use --export-dir)")
    if a.viewer:
        import numpy as np

        from .render.viewer import export_html_viewer
        if viewer_frames:
            export_html_viewer(
                a.viewer, np.stack(viewer_frames),
                np.stack(viewer_speeds), sim_scale=scene.cfg.sim_scale,
                low_speed=scene.cfg.low_speed,
                high_speed=scene.cfg.high_speed)
            print(f"viewer → {a.viewer}")
    last = log.history[-1] if log.history else {}
    print(json.dumps({"frames": scene.frame, **last}))
    return 0


def _run_slab(a) -> int:
    """Multi-device run over the slab decomposition (parallel/slab.py).

    Requires >= --shards devices (real chips, or virtual CPU devices via
    XLA_FLAGS=--xla_force_host_platform_device_count=N).
    """
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from .parallel import slab
    from .params import PhysParams
    from .sim.stepper import initial_state
    from .utils.metrics import MetricsLogger

    # unsupported-in-slab-mode flags fail loudly instead of being silently
    # dropped (the slab step has no corrected mode or frame-export hook)
    unsupported = [flag for flag, on in (
        ("--corrected", a.corrected), ("--export-dir", a.export_dir),
        ("--animate", a.animate), ("--viewer", a.viewer)) if on]
    if unsupported:
        print(f"{', '.join(unsupported)} not supported with --shards > 1",
              file=sys.stderr)
        return 2

    devs = jax.devices()
    if len(devs) < a.shards:
        print(f"need {a.shards} devices, have {len(devs)}; for a virtual "
              "mesh set XLA_FLAGS=--xla_force_host_platform_device_count="
              f"{a.shards} JAX_PLATFORMS=cpu", file=sys.stderr)
        return 2
    start_frame = 0
    if a.resume:
        from .utils.checkpoint import load_checkpoint
        state0, cfg, meta = load_checkpoint(a.resume)
        start_frame = meta.get("frame", 0)
        print(f"resumed frame {start_frame} from {a.resume}")
    else:
        cfg = _config_from_args(a)
        state0 = initial_state(cfg)
    mesh = Mesh(np.array(devs[:a.shards]), ("sp",))
    busiest = int(slab.slab_populations(state0, cfg, a.shards).max())
    step, spec = slab.make_slab_step(cfg, mesh, halo=a.halo,
                                     row_slack=a.row_slack, busiest=busiest)
    step = jax.jit(step)
    phys = PhysParams.from_config(cfg)
    sst = slab.distribute(state0, cfg, spec, mesh)
    # device of each slab shard, in slab order (one shard per device)
    shard_devices = [sh.device.id for sh in sorted(
        sst.pos.addressable_shards, key=lambda sh: sh.index[0].start or 0)]
    log = MetricsLogger(a.metrics, n_particles=cfg.n_particles,
                        substeps=cfg.substeps)
    for f in range(start_frame + 1, start_frame + a.frames + 1):
        sst, m = step(sst, phys)
        rec = log.log(f, m)
        if a.verbose:
            print(json.dumps(rec))
    out, lost = slab.collect(sst, cfg.n_particles)
    if a.checkpoint:
        from .utils.checkpoint import save_checkpoint
        save_checkpoint(a.checkpoint, out, cfg,
                        frame=start_frame + a.frames)
        print(f"checkpoint → {a.checkpoint}")
    last = log.history[-1] if log.history else {}
    print(json.dumps({"frames": start_frame + a.frames, "shards": a.shards,
                      "slab_z": spec.slab_z, "halo": spec.halo,
                      "rows_per_device": spec.cap_rows,
                      "shard_devices": shard_devices,
                      "lost": int(lost), **last}))
    return 0


def _export_frame(scene, out_dir: str) -> str:
    import numpy as np

    from .render.export import render_frame_png, save_png
    from .render.meshprops import RenderParams, speed_colors

    rp = RenderParams.from_config(scene.cfg)
    colors = np.asarray(speed_colors(scene.state.vel, rp,
                                     nan_mask=scene.state.nan_count > 0))
    img = render_frame_png(np.asarray(scene.state.pos), colors,
                           sim_scale=scene.cfg.sim_scale,
                           particle_radius=scene.cfg.particle_radius)
    path = os.path.join(out_dir, f"frame_{scene.frame:05d}.png")
    save_png(path, img)
    return path


def cmd_export(a) -> int:
    import numpy as np

    from .render.export import render_frame_png, save_png, save_ply
    from .render.meshprops import RenderParams, speed_colors
    from .utils.checkpoint import load_checkpoint

    state, cfg, meta = load_checkpoint(a.checkpoint)
    rp = RenderParams.from_config(cfg)
    colors = np.asarray(speed_colors(state.vel, rp,
                                     nan_mask=state.nan_count > 0))
    pos = np.asarray(state.pos)
    if a.png:
        save_png(a.png, render_frame_png(
            pos, colors, sim_scale=cfg.sim_scale,
            particle_radius=cfg.particle_radius))
        print(f"png → {a.png}")
    if a.ply:
        save_ply(a.ply, pos, colors)
        print(f"ply → {a.ply}")
    if a.ply_mesh:
        from .render.export import save_instanced_mesh_ply
        save_instanced_mesh_ply(a.ply_mesh, pos, colors,
                                sim_scale=cfg.sim_scale,
                                particle_radius=cfg.particle_radius,
                                max_particles=a.mesh_max_particles)
        print(f"instanced mesh ply → {a.ply_mesh}")
    return 0


def cmd_sweep(a) -> int:
    """Batched multi-scene sweep (BASELINE config 5): vmapped scenes with
    varied physics, optional per-scene frame export."""
    import numpy as np

    from .parallel.batch import BatchedScenes
    from .render.export import render_frame_png, save_png
    from .render.meshprops import RenderParams, speed_colors

    cfg = _config_from_args(a)
    lo, hi = a.vary_rest_density
    overrides = [
        {"rest_density": float(v), "seed": i}
        for i, v in enumerate(
            np.linspace(lo, hi, a.scenes))
    ]
    bs = BatchedScenes(cfg, overrides, neighbor=a.neighbor,
                       faithful=not a.corrected)
    for _ in range(a.frames):
        bs.step()
    m = bs.last_metrics
    print(json.dumps({
        "scenes": a.scenes, "frames": bs.frame,
        "mean_density": [round(float(x), 4) for x in m.mean_density],
        "max_speed": [float(x) for x in m.max_speed],
        "overflow": [int(x) for x in m.overflow],
        "exact_cert": [int(x) for x in m.exact_cert],
    }))
    if a.export_dir:
        os.makedirs(a.export_dir, exist_ok=True)
        rp = RenderParams.from_config(cfg)
        for i in range(a.scenes):
            colors = np.asarray(speed_colors(bs.states.vel[i], rp))
            img = render_frame_png(np.asarray(bs.states.pos[i]), colors,
                                   sim_scale=cfg.sim_scale,
                                   particle_radius=cfg.particle_radius)
            save_png(os.path.join(a.export_dir, f"scene_{i:02d}.png"), img)
        print(f"frames → {a.export_dir}")
    return 0


def cmd_bench(a) -> int:
    from .bench import run_bench
    result = run_bench(n_particles=a.particles, frames=a.frames,
                       neighbor=a.neighbor, late_after=a.late_after)
    print(json.dumps(result))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sphfluidsimulation_tpu",
        description="SPH fluid simulation in JAX")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="advance a scene and export artifacts")
    _add_config_flags(p)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--metrics", type=str, default=None,
                   help="JSONL metrics path")
    p.add_argument("--export-dir", type=str, default=None)
    p.add_argument("--export-every", type=int, default=10)
    p.add_argument("--animate", type=str, default=None,
                   help="assemble exported frames into a GIF/APNG at this "
                        "path after the run")
    p.add_argument("--viewer", type=str, default=None,
                   help="write a standalone interactive WebGL viewer "
                        "(orbit camera + playback) of the run's frames "
                        "to this html path")
    p.add_argument("--viewer-every", type=int, default=1,
                   help="record every k-th frame into --viewer")
    p.add_argument("--viewer-live", type=int, default=0, metavar="K",
                   help="rewrite --viewer every K recorded frames WHILE "
                        "the run is in progress (auto-refresh) — the "
                        "live view of a still-running sim; 0 = only "
                        "write at the end")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--shards", type=int, default=1,
                   help="spatial slab shards over the device mesh (>1 "
                        "selects the slab-decomposed sharded step)")
    p.add_argument("--halo", type=int, default=2,
                   help="slab halo z-planes (drift tolerance + 1)")
    p.add_argument("--row-slack", type=float, default=2.0,
                   help="per-device particle rows = the busiest slab at "
                        "the start + (slack-1)·N/shards of headroom, at "
                        "most N")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("export", help="render a checkpoint to png/ply")
    p.add_argument("checkpoint")
    p.add_argument("--png", type=str, default=None)
    p.add_argument("--ply", type=str, default=None)
    p.add_argument("--ply-mesh", type=str, default=None,
                   help="octasphere-instanced mesh PLY (the reference's "
                        "actual per-particle draw)")
    p.add_argument("--mesh-max-particles", type=int, default=65536)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("sweep", help="batched multi-scene parameter sweep")
    _add_config_flags(p)
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--vary-rest-density", type=float, nargs=2,
                   default=(1.0, 2.0))
    p.add_argument("--export-dir", type=str, default=None)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("bench", help="measure throughput")
    p.add_argument("--particles", type=int, default=1048576)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--neighbor", choices=list(BENCH_BACKENDS),
                   default=DEFAULT_NEIGHBOR)
    p.add_argument("--late-after", type=int, default=0,
                   help="also time a late window starting at this frame "
                        "(0 = spawn window only)")
    p.set_defaults(fn=cmd_bench)
    return parser


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    from .utils.compcache import enable_compilation_cache
    enable_compilation_cache()
    return a.fn(a)


if __name__ == "__main__":
    sys.exit(main())
