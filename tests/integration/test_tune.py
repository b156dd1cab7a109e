"""Auto-tuning API (api/tune.py): a hyperparameter grid as one batched
solve, best cell selection, and config bake-in."""

import numpy as np

import jax

from tpustomp.api.config import CostWeights, NoiseConfig, PlannerConfig
from tpustomp.api.plan import plan_batch
from tpustomp.api.problem import ProblemSpec
from tpustomp.api.tune import tune
from tpustomp.robot import model
from tpustomp.world.sdf import AnalyticWorld


def _setup():
    robot = model.planar_2r(body_radius=0.05)
    world = AnalyticWorld.make(spheres=[((1.88, 0.42, 0.0), 0.27)])
    cfg = PlannerConfig(
        num_timesteps=16, duration=1.7, num_rollouts=6,
        noise=NoiseConfig(stddev=0.12, decay=0.99, num_rollouts_reused=2),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.1, max_iterations=10,
        max_iterations_after_collision_free=3, record_metrics=False)
    B = 12
    rng = np.random.default_rng(3)
    q0 = (np.tile([-0.56, 1.65], (B, 1))
          + rng.uniform(-0.08, 0.08, (B, 2))).astype(np.float32)
    qN = (np.tile([1.16, -1.46], (B, 1))
          + rng.uniform(-0.08, 0.08, (B, 2))).astype(np.float32)
    return robot, world, cfg, ProblemSpec(q0=q0, qN=qN)


def test_tune_grid_and_bake_in():
    robot, world, cfg, prob = _setup()
    # power-of-two noise scales: stddev*scale is EXACT in binary float, so
    # the baked-in static config reproduces the traced cell bit-for-bit
    # (arbitrary scales could differ by 1 ULP in sigma and flip a
    # borderline chaotic solve)
    res = tune(robot, world, prob, cfg,
               noise_scale=(0.5, 1.0, 2.0), h=(5.0, 10.0), decay=(1.0,))
    assert len(res.table) == 6
    scale, h, decay = res.best
    label = f"scale={scale:g}/h={h:g}/decay={decay:g}"
    best_row = res.table[label]
    assert best_row["success_rate"] == max(
        v["success_rate"] for v in res.table.values())

    # bake-in produces a config whose static solve reproduces the cell's
    # success rate exactly (same seeds, same math — hyper vs static parity
    # is unit-tested; this checks the bake-in arithmetic end to end)
    cfg_best = res.best_config(cfg)
    assert cfg_best.pi2_h == h
    assert cfg_best.noise.decay == decay
    np.testing.assert_allclose(cfg_best.noise.stddev, 0.12 * scale,
                               rtol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(0), prob.q0.shape[0])
    sol = plan_batch(robot, world, prob, cfg_best, keys=keys)
    got = float(np.asarray(sol.success).mean())
    assert abs(got - best_row["success_rate"]) < 1e-6


def test_best_config_preserves_noise_fields():
    """best_config must bake the winning cell onto the ORIGINAL NoiseConfig
    (round-5 fix): per-joint sigma ratios scale with the cell and the
    other noise fields survive, so the tuned config reproduces the cell."""
    from tpustomp.api.tune import TuneResult

    base = PlannerConfig(noise=NoiseConfig(
        stddev=0.1, stddev_per_joint=(0.1, 0.02), decay=0.99,
        num_rollouts_reused=3))
    out = TuneResult(best=(2.0, 20.0, 1.0), table={}).best_config(base)
    assert out.noise.stddev_per_joint == (0.2, 0.04)
    assert out.noise.stddev == 0.2
    assert out.noise.num_rollouts_reused == 3
    assert out.noise.decay == 1.0 and out.pi2_h == 20.0
    # noise_stddevs (what the solver consumes) matches the evaluated cell
    assert out.noise_stddevs(2) == (0.2, 0.04)
