"""Distributed tests on 8 virtual CPU devices (SURVEY §5.5): mesh sharding
must not change numerics beyond fusion-order roundoff — per-scenario results
match a single-device vmap run to 1-2 ULP (atol 2e-6)."""

import numpy as np
import jax
import jax.numpy as jnp

from tpustomp.api.config import PlannerConfig, NoiseConfig, CostWeights
from tpustomp.api.plan import plan_batch
from tpustomp.api.problem import ProblemSpec
from tpustomp.engine import distributed
from tpustomp.robot import model
from tpustomp.world.sdf import AnalyticWorld


def _setup(batch):
    robot = model.planar_2r(body_radius=0.05)
    world = AnalyticWorld.make(spheres=[((1.88, 0.42, 0.0), 0.27)])
    rng = np.random.default_rng(0)
    q0 = np.tile(np.array([-0.56, 1.65], np.float32), (batch, 1))
    qN = np.tile(np.array([1.16, -1.46], np.float32), (batch, 1))
    q0 += rng.uniform(-0.05, 0.05, q0.shape).astype(np.float32)
    qN += rng.uniform(-0.05, 0.05, qN.shape).astype(np.float32)
    cfg = PlannerConfig(
        num_timesteps=20, duration=2.1, num_rollouts=8,
        noise=NoiseConfig(stddev=0.25, decay=0.995, num_rollouts_reused=2),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.1, max_iterations=30,
        max_iterations_after_collision_free=5, record_metrics=False,
    )
    keys = jax.random.split(jax.random.PRNGKey(7), batch)
    return robot, world, q0, qN, cfg, keys


def test_mesh_uses_all_devices():
    mesh = distributed.make_mesh()
    assert mesh.devices.size == 8


def test_sharded_matches_single_device():
    """Sharding must not change results. XLA compiles the 16-wide and
    2-per-device programs with different fusion/vectorization, so floats can
    differ by ~1-2 ULP (measured max 1.2e-7); control flow (iterations,
    success) must match exactly."""
    batch = 16  # 2 scenarios per device
    robot, world, q0, qN, cfg, keys = _setup(batch)
    prob = ProblemSpec(q0=q0, qN=qN)

    sol_single = plan_batch(robot, world, prob, cfg, keys=keys)
    mesh = distributed.make_mesh()
    sol_shard = distributed.plan_sharded(robot, world, prob, cfg,
                                         keys=keys, mesh=mesh)

    np.testing.assert_allclose(np.asarray(sol_single.trajectory),
                               np.asarray(sol_shard.trajectory), atol=2e-6)
    np.testing.assert_array_equal(np.asarray(sol_single.success),
                                  np.asarray(sol_shard.success))
    np.testing.assert_allclose(np.asarray(sol_single.cost),
                               np.asarray(sol_shard.cost), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(sol_single.iterations),
                                  np.asarray(sol_shard.iterations))


def test_sharded_solution_is_actually_sharded():
    batch = 8
    robot, world, q0, qN, cfg, keys = _setup(batch)
    mesh = distributed.make_mesh()
    sol = distributed.plan_sharded(robot, world, ProblemSpec(q0=q0, qN=qN),
                                   cfg, keys=keys, mesh=mesh)
    # the trajectory output lives distributed over all 8 devices
    assert len(sol.trajectory.sharding.device_set) == 8


def test_summarize_reductions():
    batch = 8
    robot, world, q0, qN, cfg, keys = _setup(batch)
    mesh = distributed.make_mesh()
    sol = distributed.plan_sharded(robot, world, ProblemSpec(q0=q0, qN=qN),
                                   cfg, keys=keys, mesh=mesh)
    s = distributed.summarize(sol)
    assert s["num_scenarios"] == batch
    assert 0.0 <= s["success_rate"] <= 1.0
    assert np.isfinite(s["mean_cost"])


def test_sharded_hyper_matches_unsharded():
    """Per-scenario hyperparameters shard with their scenarios: a sharded
    hyper solve equals the single-device solve_batch(hyper=...) run — the
    mesh-scale form of api/tune.py's grid-as-a-batch."""
    from tpustomp.dynamics.device import device_ops
    from tpustomp.engine import solver

    batch = 16
    robot, world, q0, qN, cfg, keys = _setup(batch)
    hyper = solver.HyperParams(
        noise_scale=jnp.asarray(np.linspace(0.5, 2.0, batch), jnp.float32),
        h=jnp.asarray(np.tile([5.0, 10.0, 20.0, 10.0], 4), jnp.float32),
        decay=jnp.asarray(np.tile([0.99, 1.0], 8), jnp.float32))

    sol_sharded = distributed.plan_sharded(
        robot, world, ProblemSpec(q0=q0, qN=qN), cfg, keys=np.asarray(keys),
        mesh=distributed.make_mesh(), hyper=hyper)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    sol_ref = solver.solve_batch(robot, world, None, cfg, ops,
                                 jnp.asarray(q0), jnp.asarray(qN), keys,
                                 hyper=hyper)
    np.testing.assert_array_equal(np.asarray(sol_sharded.success),
                                  np.asarray(sol_ref.success))
    np.testing.assert_array_equal(np.asarray(sol_sharded.iterations),
                                  np.asarray(sol_ref.iterations))
    np.testing.assert_allclose(np.asarray(sol_sharded.trajectory),
                               np.asarray(sol_ref.trajectory), atol=2e-6)
    assert len(sol_sharded.trajectory.sharding.device_set) == 8


def test_plan_sharded_accepts_typed_keys():
    """New-style typed PRNG keys (jax.random.key) must work via keys=
    (round-5 fix: np.asarray on typed keys raised before any solve); the
    result must equal the raw-uint32-key run of the same seeds."""
    robot, world, q0, qN, cfg, keys = _setup(8)
    prob = ProblemSpec(q0=q0, qN=qN)
    typed = jax.random.wrap_key_data(keys)
    mesh = distributed.make_mesh()
    a = distributed.plan_sharded(robot, world, prob, cfg, keys=keys,
                                 mesh=mesh)
    b = distributed.plan_sharded(robot, world, prob, cfg, keys=typed,
                                 mesh=mesh)
    np.testing.assert_array_equal(np.asarray(a.trajectory),
                                  np.asarray(b.trajectory))
    import pytest
    with pytest.raises(ValueError, match="threefry"):
        distributed.plan_sharded(
            robot, world, prob, cfg,
            keys=jax.random.split(jax.random.key(0, impl="rbg"), 8),
            mesh=mesh)
