"""Benchmark and smoke harness on the CPU: device labelling, refusal of a
CPU platform, compile-cache placement, the default backend's single
source, the trace reduction, and the smoke script's oracle comparison at a
small size."""

import importlib.util
import inspect
import json
import os

import jax
import jax.numpy as jnp
import pytest

from sphfluidsimulation_tpu import bench, cli
from sphfluidsimulation_tpu.config import SimConfig
from sphfluidsimulation_tpu.sim.stepper import PHASES, make_param_step
from sphfluidsimulation_tpu.utils import compcache, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_root_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_compile_cache_honours_env_dir(monkeypatch, tmp_path,
                                       config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compcache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set in code
    assert "jax_compilation_cache_dir" not in config_updates


def test_compile_cache_defaults_inside_checkout(monkeypatch,
                                                config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compcache.enable_compilation_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert config_updates["jax_compilation_cache_dir"] == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_root_bench_refuses_cpu(capsys):
    assert _load("bench").main(["--particles", "1024"]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs a GPU" in captured.err


def test_chip_smoke_refuses_cpu(capsys):
    smoke = _load("chip_smoke")
    with pytest.raises(smoke.SmokeFailure, match="no GPU"):
        smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_run_bench_records_device():
    res = bench.run_bench(n_particles=1024, frames=1)
    dev = jax.devices()
    assert res["platform"] == dev[0].platform == "cpu"
    assert res["device_kind"] == dev[0].device_kind
    assert res["device_count"] == len(dev)
    assert "gpu_name_power_limit" not in res   # only a GPU run has it
    assert res["neighbor"] == bench.DEFAULT_NEIGHBOR
    assert res["n_particles"] == 1024 and res["value"] > 0


def test_default_backend_has_one_source():
    d = bench.DEFAULT_NEIGHBOR
    assert d in bench.BENCH_BACKENDS
    assert inspect.signature(bench.run_bench).parameters[
        "neighbor"].default == d
    assert cli.build_parser().parse_args(["bench"]).neighbor == d
    assert _load("bench").build_parser().parse_args([]).neighbor == d


def test_pallas_backend_rejected():
    parser = cli.build_parser()
    for argv in (["bench", "--neighbor", "pallas"],
                 ["run", "--neighbor", "pallas"]):
        with pytest.raises(SystemExit):
            parser.parse_args(argv)
    with pytest.raises(SystemExit):
        _load("bench").main(["--neighbor", "pallas"])
    with pytest.raises(ValueError, match="unknown neighbor backend"):
        make_param_step(SimConfig(particle_number=256, bucket_resolution=7),
                        neighbor="pallas")


def test_phase_breakdown_attributes_named_scopes(tmp_path):
    @jax.jit
    def f(x):
        with jax.named_scope("grid_build"):
            y = jnp.sort(x)
        with jax.named_scope("density"):
            z = jnp.sum(jnp.exp(y[:, None] - y[None, :]), axis=1)
        return z

    x = jnp.linspace(0.0, 1.0, 1500)
    jax.block_until_ready(f(x))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(f(x))
    bd = profiling.phase_breakdown(profiling.latest_xplane(str(tmp_path)),
                                   [f.lower(x).compile().as_text()],
                                   PHASES)
    assert bd["events"] > 0
    assert bd["phase_ns"]["grid_build"] > 0
    assert bd["phase_ns"]["density"] > 0
    assert bd["phase_ns"]["force_integrate"] == 0
    assert 0.0 <= bd["idle_share"] <= 1.0
    assert abs(sum(bd["phase_share"].values()) - 1.0) < 1e-9
    json.dumps(bd)


@pytest.mark.parametrize("walk,ref", [("gather", "brute"),
                                      ("slotted", "brute"),
                                      ("gather", "slotted")])
def test_smoke_frame1_comparison(walk, ref):
    """The smoke script's oracle phase at a CPU size: frame-1 density,
    forces and positions within its stated tolerances."""
    from sphfluidsimulation_tpu.sim.stepper import initial_state

    smoke = _load("chip_smoke")
    cfg = bench.scaled_config(4096)
    st = initial_state(cfg)
    d = smoke.compare(smoke.frame1(cfg, walk, st), smoke.frame1(cfg, ref, st),
                      f"{walk} vs {ref}")
    assert set(d) == set(smoke.TOL)


@pytest.mark.parametrize("neighbor", ["slotted", "gather", "sites", "brute"])
def test_step_fields_leave_the_step_unchanged(neighbor):
    """``fields=True`` returns the step's own frame-start density and
    substep forces beside a state and metrics equal to the plain step's."""
    from sphfluidsimulation_tpu.sim.stepper import (initial_state,
                                                    make_frame_step)

    cfg = bench.scaled_config(1024)
    st = initial_state(cfg)
    s0, m0 = jax.jit(make_frame_step(cfg, neighbor=neighbor))(st)
    s1, m1, (rho, f) = jax.jit(
        make_frame_step(cfg, neighbor=neighbor, fields=True))(st)
    for a, b in zip(jax.tree.leaves((s0, m0)), jax.tree.leaves((s1, m1))):
        assert jnp.array_equal(a, b)
    assert rho.shape == (cfg.n_particles,)
    assert f.shape == (cfg.substeps, cfg.n_particles, 3)
    assert float(jnp.mean(rho)) == pytest.approx(float(m1.mean_density),
                                                 rel=1e-6)


def test_step_fields_are_the_oracle_sums():
    """The brute step's returned fields are the oracle's density and
    first-substep force at the frame-start state."""
    from sphfluidsimulation_tpu.ops import brute
    from sphfluidsimulation_tpu.ops.grid import build_bucket
    from sphfluidsimulation_tpu.params import PhysParams
    from sphfluidsimulation_tpu.sim.stepper import (initial_state,
                                                    make_frame_step)

    cfg = bench.scaled_config(1024)
    st = initial_state(cfg)
    p = PhysParams.from_config(cfg)
    r = cfg.bucket_resolution
    b, _ = build_bucket(st.pos, r, cfg.voxel_capacity)
    rho = brute.density_bruteforce(st.pos, b.cell_id, b.in_table, p, r)
    f = brute.fluid_forces_bruteforce(st.pos, st.vel, rho, b.cell_id,
                                      b.in_table, p, r)
    _, _, (rho_s, f_s) = jax.jit(
        make_frame_step(cfg, neighbor="brute", fields=True))(st)
    assert jnp.allclose(rho_s, rho, rtol=1e-6)
    assert jnp.allclose(f_s[0], f, rtol=1e-5,
                        atol=1e-6 * float(jnp.abs(f).max()))
