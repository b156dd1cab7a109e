"""CLI runner (the reference node analogue) on the shipped TOML configs."""

import json
import os
import tomllib

import pytest

from tpustomp.cli import main

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "..", "configs")


def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k} = {_toml_value(x)}"
                               for k, x in v.items()) + "}"
    return "[" + ", ".join(_toml_value(x) for x in v) + "]"


def _write_toml(path, doc):
    """Write a {section: {key: value}} document as TOML (tests only: the
    standard library reads TOML but does not write it)."""
    lines = []
    for section, table in doc.items():
        lines.append(f"[{section}]")
        lines += [f"{k} = {_toml_value(v)}" for k, v in table.items()]
    path.write_text("\n".join(lines) + "\n")
    assert tomllib.loads(path.read_text()) == doc


@pytest.fixture(autouse=True)
def cache_calls(monkeypatch):
    """main() turns the persistent compile cache on; record the call
    instead, so test compiles stay off the disk."""
    import tpustomp.utils.cache as cache

    calls = []
    monkeypatch.setattr(cache, "enable_compile_cache",
                        lambda: calls.append(True))
    return calls


def _load(name):
    with open(os.path.join(CONFIGS, name), "rb") as f:
        return tomllib.load(f)


def test_cli_config1(capsys, cache_calls):
    rc = main([os.path.join(CONFIGS, "config1_planar.toml"), "--seed", "0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert cache_calls == [True]
    assert out["success"] is True
    assert out["iterations"] > 0


def test_cli_config1_chomp(capsys):
    rc = main([os.path.join(CONFIGS, "config1_planar.toml"),
               "--mode", "chomp"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # CHOMP with config-1's STOMP-tuned weights may or may not solve this
    # scene; the contract here is clean execution + well-formed output
    assert set(out) >= {"success", "iterations", "cost", "wall_seconds"}


def test_cli_config2_grid(capsys):
    rc = main([os.path.join(CONFIGS, "config2_tabletop.toml"), "--grid"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["success"] is True


def test_cli_config4_batch(capsys):
    """BASELINE config 4 from the CLI: sharded scenario batch."""
    rc = main([os.path.join(CONFIGS, "config4_batch.toml"),
               "--scenarios", "8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["num_scenarios"] == 8
    assert out["success_rate"] > 0.5


def test_cli_config5_mpc(capsys, tmp_path):
    """BASELINE config 5 from the CLI: moving-obstacle MPC loop (tiny)."""
    doc = _load("config5_mpc.toml")
    doc["mpc"]["ticks"] = 10
    small = tmp_path / "cfg5_small.toml"
    _write_toml(small, doc)
    rc = main([str(small), "--scenarios", "8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["scenarios"] == 8 and out["ticks"] == 10
    assert 0.0 <= out["collision_rate"] <= 1.0


def test_cli_config5_mpc_grid(capsys, tmp_path):
    """--grid mpc: the voxel scene rides as the CompositeWorld static grid
    (round 5 — previously rejected); a coarse grid keeps the test fast."""
    doc = _load("config5_mpc.toml")
    doc["mpc"]["ticks"] = 5
    doc["scene"] = {
        "robot": "arm_7dof",
        "boxes": [{"center": [0.6, 0.0, 0.2], "half": [0.45, 0.6, 0.25]}],
        "grid": {"origin": [-0.2, -1.0, 0.0], "shape": [16, 20, 12],
                 "resolution": 0.1},
        "q0": [-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0],
        "qN": [0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0],
    }
    small = tmp_path / "cfg5_grid_small.toml"
    _write_toml(small, doc)
    rc = main([str(small), "--grid", "--scenarios", "8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["scenarios"] == 8 and out["ticks"] == 5
    assert "reached_rate" in out and "median_ticks_to_goal" in out


def test_cli_mpc_grid_keeps_scene_spheres_as_movers(capsys, monkeypatch,
                                                    tmp_path):
    """--grid mpc: the scene's spheres must remain the per-scenario MOVING
    obstacles (the function's contract) while only the static boxes are
    voxelized — round-5 fix: previously the whole scene (spheres included)
    was frozen into the grid and a spurious default mover launched."""
    import numpy as np
    from tpustomp.engine import mpc as mpc_mod
    from tpustomp.world.sdf import GridSDF

    captured = {}

    def spy(robot, cfg, states, radius, ticks, world_dt, **kw):
        captured["states"] = states
        captured["radius"] = np.asarray(radius)
        captured["static_world"] = kw.get("static_world")
        return states  # skip the solve; the CLI only summarizes fields

    monkeypatch.setattr(mpc_mod, "run_mpc_sharded", spy)

    sphere_c = [0.9, 0.5, 0.45]
    box_c = [0.6, 0.0, 0.2]
    doc = {
        "planner": {"num_timesteps": 10, "num_rollouts": 4,
                    "max_iterations": 2},
        "scene": {
            "robot": "arm_7dof",
            "spheres": [{"center": sphere_c, "radius": 0.2}],
            "boxes": [{"center": box_c, "half": [0.3, 0.4, 0.2]}],
            "grid": {"origin": [-0.2, -1.0, 0.0], "shape": [16, 20, 12],
                     "resolution": 0.1},
            "q0": [-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0],
            "qN": [0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0],
        },
        "mpc": {"scenarios": 4, "ticks": 3, "world_dt": 0.1,
                "obstacle_speed": 0.2},
    }
    small = tmp_path / "cfg5_spheres.toml"
    _write_toml(small, doc)
    rc = main([str(small), "--grid", "--scenarios", "4"])
    assert rc == 0
    json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    # the scene sphere is the mover, not a default at [0.9, 0.6, 0.5]
    centers = np.asarray(captured["states"].sphere_center)  # [B, S, 3]
    assert centers.shape[1:] == (1, 3)
    np.testing.assert_allclose(centers[0, 0], sphere_c, atol=1e-6)
    np.testing.assert_allclose(captured["radius"], [0.2])

    gw = captured["static_world"]
    assert isinstance(gw, GridSDF)
    # sphere region NOT frozen into the static grid (positive distance at
    # its center voxel), while the box region is inside (negative)
    def vox(p):
        idx = np.round((np.asarray(p) - np.asarray(gw.origin))
                       / float(gw.resolution)).astype(int)
        return float(np.asarray(gw.grid)[tuple(idx)])

    assert vox(sphere_c) > 0.0
    assert vox(box_c) < 0.0
