"""Per-scenario traced hyperparameters (solver.HyperParams).

Contract: hyper=None and hyper=HyperParams.from_config(cfg) compile to the
same numerics (exactly, on the XLA path); per-scenario arrays make each
scenario solve under its own (noise_scale, h, decay) — the mechanism that
lets bench/stomp_sweep.py run a whole hyperparameter grid as ONE batched
solve instead of one recompile per cell.
"""

import numpy as np

import jax
import jax.numpy as jnp

from tpustomp.api.config import CostWeights, NoiseConfig, PlannerConfig
from tpustomp.dynamics.device import device_ops
from tpustomp.engine import solver
from tpustomp.robot import model
from tpustomp.world.sdf import AnalyticWorld


def _scene(**kw):
    robot = model.planar_2r(body_radius=0.05)
    world = AnalyticWorld.make(spheres=[((1.88, 0.42, 0.0), 0.27)])
    base = dict(
        num_timesteps=16, duration=1.7, num_rollouts=6,
        noise=NoiseConfig(stddev=0.25, decay=0.995, num_rollouts_reused=2),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.1, max_iterations=12,
        max_iterations_after_collision_free=4, record_metrics=False)
    base.update(kw)
    cfg = PlannerConfig(**base)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    return robot, world, cfg, ops


Q0 = jnp.asarray([-0.56, 1.65], jnp.float32)
QN = jnp.asarray([1.16, -1.46], jnp.float32)


def test_from_config_hyper_matches_none_exactly():
    robot, world, cfg, ops = _scene()
    key = jax.random.PRNGKey(0)
    a = solver.solve(robot, world, None, cfg, ops, Q0, QN, key)
    b = solver.solve(robot, world, None, cfg, ops, Q0, QN, key,
                     hyper=solver.HyperParams.from_config(cfg))
    np.testing.assert_array_equal(np.asarray(a.trajectory),
                                  np.asarray(b.trajectory))
    assert int(a.iterations) == int(b.iterations)
    assert bool(a.success) == bool(b.success)


def test_batched_hyper_rows_match_scalar_solves():
    robot, world, cfg, ops = _scene()
    B = 4
    rng = np.random.default_rng(0)
    Q0b = jnp.asarray(np.tile(Q0, (B, 1))
                      + rng.uniform(-0.05, 0.05, (B, 2)), jnp.float32)
    QNb = jnp.asarray(np.tile(QN, (B, 1))
                      + rng.uniform(-0.05, 0.05, (B, 2)), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    hyper = solver.HyperParams(
        noise_scale=jnp.asarray([1.0, 0.5, 1.5, 1.0], jnp.float32),
        h=jnp.asarray([10.0, 5.0, 20.0, 10.0], jnp.float32),
        decay=jnp.asarray([0.995, 1.0, 0.99, 0.9], jnp.float32))
    got = solver.solve_batch(robot, world, None, cfg, ops, Q0b, QNb, keys,
                             hyper=hyper)
    for i in range(B):
        hi = jax.tree.map(lambda x: x[i], hyper)
        ref = solver.solve(robot, world, None, cfg, ops, Q0b[i], QNb[i],
                           keys[i], hyper=hi)
        np.testing.assert_allclose(np.asarray(got.trajectory[i]),
                                   np.asarray(ref.trajectory),
                                   rtol=0, atol=0)
        assert int(got.iterations[i]) == int(ref.iterations)


def test_hyper_changes_behavior():
    robot, world, cfg, ops = _scene()
    key = jax.random.PRNGKey(1)
    base = solver.solve(robot, world, None, cfg, ops, Q0, QN, key)
    hot = solver.solve(
        robot, world, None, cfg, ops, Q0, QN, key,
        hyper=solver.HyperParams(noise_scale=jnp.float32(2.0),
                                 h=jnp.float32(3.0),
                                 decay=jnp.float32(1.0)))
    assert not np.allclose(np.asarray(base.trajectory),
                           np.asarray(hot.trajectory))
