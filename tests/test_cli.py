"""CLI smoke tests: every subcommand end-to-end at tiny sizes (the CLI is
the reference's inspector+play-mode equivalent, SphFluidSimulation.cs:34-53).
"""

import pytest
import json
import os

from sphfluidsimulation_tpu.cli import main

TINY = ["--particles", "256", "--bucket-resolution", "7",
        "--gas-constant", "1.0", "--neighbor", "slotted"]


def test_run_checkpoint_metrics_export(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    mj = str(tmp_path / "m.jsonl")
    frames = str(tmp_path / "frames")
    rc = main(["run", *TINY, "--frames", "3", "--checkpoint", ck,
               "--metrics", mj, "--export-dir", frames,
               "--export-every", "1", "--animate",
               str(tmp_path / "anim.png")])
    assert rc == 0
    assert os.path.exists(ck)
    assert len(open(mj).read().strip().splitlines()) == 3
    assert len(os.listdir(frames)) == 3
    assert os.path.exists(tmp_path / "anim.png")
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["frames"] == 3

    rc = main(["export", ck, "--png", str(tmp_path / "f.png"),
               "--ply", str(tmp_path / "f.ply"),
               "--ply-mesh", str(tmp_path / "f_mesh.ply")])
    assert rc == 0
    for name in ("f.png", "f.ply", "f_mesh.ply"):
        assert (tmp_path / name).stat().st_size > 0

    rc = main(["run", *TINY, "--frames", "2", "--resume", ck])
    assert rc == 0


def test_sweep(capsys):
    rc = main(["sweep", *TINY, "--scenes", "2", "--frames", "2",
               "--vary-rest-density", "1.0", "1.5"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["scenes"] == 2 and len(rec["mean_density"]) == 2


@pytest.mark.slow
def test_run_slab_shards(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    rc = main(["run", *TINY, "--neighbor", "sites", "--frames", "2",
               "--shards", "4", "--row-slack", "8", "--checkpoint", ck])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["shards"] == 4 and rec["lost"] == 0
    assert sorted(rec["shard_devices"]) == [0, 1, 2, 3]

    # resume continues from the checkpointed frame (slab path honors it)
    rc = main(["run", *TINY, "--neighbor", "sites", "--frames", "1",
               "--shards", "4", "--row-slack", "8", "--resume", ck])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 3


def test_run_slab_rejects_unsupported_flags(tmp_path, capsys):
    rc = main(["run", *TINY, "--frames", "1", "--shards", "2",
               "--corrected"])
    assert rc == 2
    assert "--corrected" in capsys.readouterr().err


def test_bench(capsys):
    # one scan rollout per window on the default backend, spawn and late
    # windows, labelled with the device it ran on
    from sphfluidsimulation_tpu.bench import DEFAULT_NEIGHBOR

    rc = main(["bench", "--particles", "1024", "--frames", "2",
               "--late-after", "3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["neighbor"] == DEFAULT_NEIGHBOR
    assert out["platform"] == "cpu" and out["device_count"] >= 1
    assert out["frames_window"] == [0, 2]
    assert out["late"]["frames_window"] == [4, 6]
    assert out["value"] > 0 and out["late"]["value"] > 0
