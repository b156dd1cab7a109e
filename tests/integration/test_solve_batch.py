"""solver.solve_batch (the fused batched path, BASELINE config 4) must be
numerically identical per-scenario to jax.vmap(solver.solve): the batched
step shares the per-scenario phase helpers with the single-scenario step and
applies the same done-select that vmap(lax.while_loop) would (see
engine/solver.py make_step_batch).

Reference context: the reference planner (SURVEY §2 L6) handled one query
per service call; batching is a new-framework axis, so the oracle here is
our own single-scenario solver (itself oracle-parity-tested in
test_config1.py).
"""

import numpy as np
import jax
import jax.numpy as jnp

from tpustomp.api.config import PlannerConfig, NoiseConfig, CostWeights
from tpustomp.api.plan import plan_batch
from tpustomp.api.problem import ProblemSpec
from tpustomp.dynamics.device import device_ops
from tpustomp.engine import solver
from tpustomp.robot import model
from tpustomp.world.sdf import AnalyticWorld


def _scene():
    robot = model.planar_2r()
    world = AnalyticWorld.make(spheres=[((1.88, 0.42, 0.0), 0.27)])
    return robot, world


def _cfg(**kw):
    base = dict(
        num_timesteps=20, duration=1.0, num_rollouts=10,
        noise=NoiseConfig(stddev=0.35, decay=0.995, num_rollouts_reused=3),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.05, max_iterations=40,
        max_iterations_after_collision_free=3,
    )
    base.update(kw)
    return PlannerConfig(**base)


def _batch(B=6, seed=0):
    # spread of problems so scenarios converge at DIFFERENT iterations —
    # exercises the done-select masking in make_step_batch
    rng = np.random.default_rng(seed)
    Q0 = np.tile([-0.56, 1.65], (B, 1)).astype(np.float32) \
        + rng.uniform(-0.2, 0.2, (B, 2)).astype(np.float32)
    QN = np.tile([1.16, -1.46], (B, 1)).astype(np.float32) \
        + rng.uniform(-0.2, 0.2, (B, 2)).astype(np.float32)
    return jnp.asarray(Q0), jnp.asarray(QN)


def test_solve_batch_matches_vmap_solve():
    robot, world = _scene()
    cfg = _cfg()
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    Q0, QN = _batch()
    keys = jax.random.split(jax.random.PRNGKey(7), Q0.shape[0])

    ref = jax.jit(jax.vmap(lambda a, b, k: solver.solve(
        robot, world, None, cfg, ops, a, b, k)))(Q0, QN, keys)
    got = jax.jit(lambda a, b, k: solver.solve_batch(
        robot, world, None, cfg, ops, a, b, k))(Q0, QN, keys)

    # scenarios must converge at different iterations for this test to mean
    # anything (otherwise the masking never triggers)
    assert len(set(np.asarray(ref.iterations).tolist())) > 1
    for name in ("trajectory", "success", "cost", "iterations"):
        a, b = getattr(ref, name), getattr(got, name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def test_plan_batch_restart_fold_matches_solve_best_of():
    robot, world = _scene()
    cfg = _cfg(num_restarts=3)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    Q0, QN = _batch(B=4, seed=1)
    keys = jax.random.split(jax.random.PRNGKey(11), Q0.shape[0])

    ref = jax.jit(jax.vmap(lambda a, b, k: solver.solve_best_of(
        robot, world, None, cfg, ops, a, b, k)))(Q0, QN, keys)
    got = plan_batch(robot, world, ProblemSpec(q0=Q0, qN=QN), cfg, keys=keys)

    # The flat [B·R] layout fuses differently from the nested vmap-of-vmap,
    # so results match to roundoff, not bitwise (same 1-2 ULP class as the
    # sharding test — tests/distributed/test_sharding.py).
    np.testing.assert_array_equal(np.asarray(ref.success),
                                  np.asarray(got.success))
    np.testing.assert_allclose(np.asarray(ref.cost), np.asarray(got.cost),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.trajectory),
                               np.asarray(got.trajectory),
                               rtol=1e-4, atol=1e-5)


def test_solve_batch_warm_start():
    robot, world = _scene()
    cfg = _cfg()
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    Q0, QN = _batch(B=3, seed=2)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    from tpustomp.engine.trajectory import min_jerk_init
    theta0 = jax.vmap(lambda a, b: min_jerk_init(a, b, cfg.num_timesteps)
                      )(Q0, QN)

    ref = jax.vmap(lambda a, b, k, t: solver.solve(
        robot, world, None, cfg, ops, a, b, k, t))(Q0, QN, keys, theta0)
    got = solver.solve_batch(robot, world, None, cfg, ops, Q0, QN, keys,
                             theta0)
    np.testing.assert_array_equal(np.asarray(ref.trajectory),
                                  np.asarray(got.trajectory))


def test_solve_batch_compacted_matches_solve_batch():
    """Host-side compaction (engine/solver.solve_batch_compacted) must be a
    pure execution-layout change: per-scenario results identical to the
    single-dispatch solve_batch. min_bucket/chunk forced tiny so the test
    actually exercises multiple compaction steps (pow2 buckets, pad rows,
    scatter/gather round trips) at B=12."""
    robot, world = _scene()
    cfg = _cfg()
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    Q0, QN = _batch(B=12, seed=4)
    keys = jax.random.split(jax.random.PRNGKey(21), Q0.shape[0])

    ref = jax.jit(lambda a, b, k: solver.solve_batch(
        robot, world, None, cfg, ops, a, b, k))(Q0, QN, keys)
    got = solver.solve_batch_compacted(robot, world, None, cfg, ops,
                                       Q0, QN, keys, chunk=2, min_bucket=2)

    # must converge at different iterations, else compaction never triggers
    its = np.asarray(ref.iterations)
    assert len(set(its.tolist())) > 1
    # success/iterations exact; trajectory/cost to roundoff — XLA tiles
    # batched ops differently at different bucket shapes, so per-row values
    # across batch sizes agree to ULPs (measured 3e-8), not bitwise
    np.testing.assert_array_equal(np.asarray(ref.success),
                                  np.asarray(got.success))
    np.testing.assert_array_equal(np.asarray(ref.iterations),
                                  np.asarray(got.iterations))
    np.testing.assert_allclose(np.asarray(ref.cost), np.asarray(got.cost),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.trajectory),
                               np.asarray(got.trajectory),
                               rtol=1e-5, atol=1e-6)


def test_solve_batch_compacted_warm_start_and_world_batched():
    """Compaction composes with MPC-style inputs: per-scenario worlds
    (world_batched leaves with a leading [B] axis) and warm-start theta0."""
    robot, world = _scene()
    cfg = _cfg()
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    B = 8
    Q0, QN = _batch(B=B, seed=5)
    keys = jax.random.split(jax.random.PRNGKey(31), B)
    from tpustomp.engine.trajectory import min_jerk_init
    theta0 = jax.vmap(lambda a, b: min_jerk_init(a, b, cfg.num_timesteps)
                      )(Q0, QN)
    worldB = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), world)

    ref = solver.solve_batch(robot, worldB, None, cfg, ops, Q0, QN, keys,
                             theta0, world_batched=True)
    got = solver.solve_batch_compacted(robot, worldB, None, cfg, ops,
                                       Q0, QN, keys, theta0,
                                       world_batched=True,
                                       chunk=3, min_bucket=2)
    np.testing.assert_array_equal(np.asarray(ref.success),
                                  np.asarray(got.success))
    np.testing.assert_array_equal(np.asarray(ref.iterations),
                                  np.asarray(got.iterations))
    np.testing.assert_allclose(np.asarray(ref.trajectory),
                               np.asarray(got.trajectory),
                               rtol=1e-5, atol=1e-6)


def test_plan_batch_compaction_routing():
    """plan_batch(batch_compaction="on") returns the same solutions as
    "off", including the restart fold."""
    robot, world = _scene()
    Q0, QN = _batch(B=4, seed=6)
    keys = jax.random.split(jax.random.PRNGKey(41), 4)
    prob = ProblemSpec(q0=Q0, qN=QN)

    cfg_off = _cfg(num_restarts=2, batch_compaction="off")
    cfg_on = cfg_off.replace(batch_compaction="on",
                             compaction_chunk=2, compaction_min_bucket=2)
    ref = plan_batch(robot, world, prob, cfg_off, keys=keys)
    got = plan_batch(robot, world, prob, cfg_on, keys=keys)
    np.testing.assert_array_equal(np.asarray(ref.success),
                                  np.asarray(got.success))
    np.testing.assert_array_equal(np.asarray(ref.iterations),
                                  np.asarray(got.iterations))
    np.testing.assert_allclose(np.asarray(ref.trajectory),
                               np.asarray(got.trajectory),
                               rtol=1e-5, atol=1e-6)
