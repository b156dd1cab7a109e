"""BASELINE config-5 style MPC loop: moving obstacle, warm-started
replanning; batched + sharded variant on the 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from tpustomp.api.config import PlannerConfig, NoiseConfig, CostWeights
from tpustomp.engine import mpc
from tpustomp.engine.distributed import make_mesh
from tpustomp.robot import model

Q0 = np.array([-0.56, 1.65], np.float32)
QN = np.array([1.16, -1.46], np.float32)


def _cfg():
    return PlannerConfig(
        num_timesteps=20, duration=2.1, num_rollouts=8,
        noise=NoiseConfig(stddev=0.25, decay=1.0, num_rollouts_reused=2),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.1, max_iterations=8,
        max_iterations_after_collision_free=2, record_metrics=False,
    )


def test_mpc_avoids_moving_obstacle():
    robot = model.planar_2r(body_radius=0.05)
    cfg = _cfg()
    # obstacle sweeping across the workspace toward the arm's path
    center = np.array([[2.4, -0.6, 0.0]], np.float32)
    vel = np.array([[-0.15, 0.25, 0.0]], np.float32)
    radius = jnp.asarray([0.25], jnp.float32)
    state = mpc.init_mpc(robot, cfg, Q0, QN, center, vel,
                         jax.random.PRNGKey(0))
    out = mpc.run_mpc(robot, cfg, state, radius, num_ticks=15, world_dt=0.1)
    assert int(out.steps) == 15
    assert not bool(out.collided), "MPC executed a colliding configuration"
    # obstacle state actually advanced
    np.testing.assert_allclose(np.asarray(out.sphere_center[0]),
                               center[0] + 15 * 0.1 * vel[0], atol=1e-5)
    assert np.all(np.isfinite(np.asarray(out.theta)))


def test_mpc_reached_tick_tracks_completion():
    """Episode-completion bookkeeping: reached_tick latches the FIRST tick
    within goal_eps and never un-latches; an unreached scenario stays -1."""
    robot = model.planar_2r(body_radius=0.05)
    cfg = _cfg()
    # obstacle far away: the plan executes toward the goal unobstructed
    center = np.array([[50.0, 50.0, 0.0]], np.float32)
    vel = np.zeros((1, 3), np.float32)
    radius = jnp.asarray([0.1], jnp.float32)
    state = mpc.init_mpc(robot, cfg, Q0, QN, center, vel,
                         jax.random.PRNGKey(0))
    # the fixed-horizon replan contracts the goal gap geometrically
    # (~0.9/tick here); 60 ticks is comfortably past the 0.05-rad latch
    out = mpc.run_mpc(robot, cfg, state, radius, num_ticks=60, world_dt=0.1)
    rt = int(out.reached_tick)
    assert 1 <= rt <= 60, rt
    assert float(jnp.max(jnp.abs(out.q - out.qN))) < mpc.GOAL_EPS
    # a too-short run has not reached yet
    short = mpc.run_mpc(robot, cfg, state, radius, num_ticks=2, world_dt=0.1)
    assert int(short.reached_tick) == -1
    # batched path agrees with the single-scenario path
    states = jax.tree.map(lambda x: jnp.stack([x, x]), state)
    outB = mpc.run_mpc_batch(robot, cfg, states, radius, num_ticks=60,
                             world_dt=0.1)
    np.testing.assert_array_equal(np.asarray(outB.reached_tick), [rt, rt])


def test_mpc_sharded_matches_vmap():
    robot = model.planar_2r(body_radius=0.05)
    cfg = _cfg()
    B = 8
    rng = np.random.default_rng(0)
    centers = np.tile([[2.4, -0.6, 0.0]], (B, 1, 1)).astype(np.float32)
    centers += rng.uniform(-0.1, 0.1, centers.shape).astype(np.float32)
    vels = np.tile([[-0.15, 0.25, 0.0]], (B, 1, 1)).astype(np.float32)
    radius = np.asarray([0.25], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    states = jax.vmap(
        lambda c, v, k: mpc.init_mpc(robot, cfg, Q0, QN, c, v, k)
    )(jnp.asarray(centers), jnp.asarray(vels), keys)

    out_local = jax.vmap(
        lambda s: mpc.run_mpc(robot, cfg, s, jnp.asarray(radius), 5, 0.1)
    )(states)
    out_shard = mpc.run_mpc_sharded(robot, cfg, states, radius, 5, 0.1,
                                    mesh=make_mesh())
    np.testing.assert_allclose(np.asarray(out_local.q),
                               np.asarray(out_shard.q), atol=2e-6)
    np.testing.assert_array_equal(np.asarray(out_local.collided),
                                  np.asarray(out_shard.collided))
    assert len(out_shard.q.sharding.device_set) == 8


def _batched_states(robot, cfg, B, seed=1):
    rng = np.random.default_rng(seed)
    centers = np.tile([[2.4, -0.6, 0.0]], (B, 1, 1)).astype(np.float32)
    centers += rng.uniform(-0.1, 0.1, centers.shape).astype(np.float32)
    vels = np.tile([[-0.15, 0.25, 0.0]], (B, 1, 1)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.vmap(
        lambda c, v, k: mpc.init_mpc(robot, cfg, Q0, QN, c, v, k)
    )(jnp.asarray(centers), jnp.asarray(vels), keys)


def test_mpc_resilient_recovers_injected_shard_failure():
    """SURVEY §6 failure-recovery row: a shard whose results come back
    corrupted (dead device / numerical blowup) is re-dispatched from the
    last good snapshot, and the recovered run matches a fault-free run."""
    robot = model.planar_2r(body_radius=0.05)
    cfg = _cfg()
    B = 8
    radius = np.asarray([0.25], np.float32)

    # clean baseline is a SINGLE unchunked dispatch, so this test also
    # catches chunked execution diverging from an uninterrupted run
    clean = mpc.run_mpc_sharded(robot, cfg, _batched_states(robot, cfg, B),
                                radius, num_ticks=6, world_dt=0.1,
                                mesh=make_mesh())

    hits = []

    def fault(chunk_idx, out):
        # kill scenarios 2 and 5 in the first chunk (as a dead shard would:
        # their buffers never land -> non-finite)
        if chunk_idx == 0:
            hits.append(chunk_idx)
            out.theta[2] = np.nan
            out.q[5] = np.nan
        return out

    rec = mpc.run_mpc_resilient(robot, cfg, _batched_states(robot, cfg, B),
                                radius, num_ticks=6, world_dt=0.1,
                                mesh=make_mesh(), chunk_ticks=3,
                                _fault_hook=fault)
    assert hits == [0], "fault hook should fire once (first chunk)"
    assert np.all(np.isfinite(np.asarray(rec.theta)))
    # EXACT equality: the retry re-dispatch runs the same batched program as
    # the healthy path (mpc._run_batch_select), so a recovered scenario is
    # bitwise-identical to a never-failed one on the same backend.
    np.testing.assert_array_equal(np.asarray(rec.q), np.asarray(clean.q))
    np.testing.assert_array_equal(np.asarray(rec.theta),
                                  np.asarray(clean.theta))
    np.testing.assert_array_equal(np.asarray(rec.collided),
                                  np.asarray(clean.collided))


def test_mpc_resilient_gives_up_on_persistent_failure():
    """A scenario that fails deterministically (here: NaN already in its
    state, so every re-dispatch reproduces it) must raise, not loop."""
    robot = model.planar_2r(body_radius=0.05)
    cfg = _cfg()
    radius = np.asarray([0.25], np.float32)
    states = _batched_states(robot, cfg, 8)
    th = np.array(states.theta)
    th[1, 0, 0] = np.nan  # poisons q_next -> the replan -> every re-dispatch
    states = states.replace(theta=jnp.asarray(th))

    import pytest
    with pytest.raises(RuntimeError, match=r"scenarios \[1\].*unhealthy"):
        mpc.run_mpc_resilient(robot, cfg, states, radius, num_ticks=3,
                              world_dt=0.1, mesh=make_mesh(), chunk_ticks=3,
                              max_retries=1)


def test_mpc_grid_static_world_with_moving_obstacle():
    """Grid-scene MPC: the static world is a precomputed voxel SDF, the
    moving obstacle rides the CompositeWorld overlay — the incremental-
    update path for grid scenes (world/sdf.CompositeWorld; VERDICT r1
    missing item 4). The arm must avoid BOTH."""
    from tpustomp.world.edt import grid_from_analytic
    from tpustomp.world.sdf import AnalyticWorld, sdf

    robot = model.planar_2r(body_radius=0.05)
    cfg = _cfg()
    # static box near the straight path of the planar arm (z=0 plane)
    static_analytic = AnalyticWorld.make(
        boxes=[((1.3, 1.0, 0.0), (0.25, 0.25, 0.4))])
    grid = grid_from_analytic(static_analytic, origin=(-2.5, -2.5, -0.5),
                              shape=(50, 50, 12), resolution=0.1)
    center = np.array([[2.4, -0.6, 0.0]], np.float32)
    vel = np.array([[-0.15, 0.25, 0.0]], np.float32)
    radius = jnp.asarray([0.25], jnp.float32)
    state = mpc.init_mpc(robot, cfg, Q0, QN, center, vel,
                         jax.random.PRNGKey(0))
    out = mpc.run_mpc(robot, cfg, state, radius, num_ticks=15, world_dt=0.1,
                      static_world=grid)
    assert int(out.steps) == 15
    assert not bool(out.collided)
    # executed configs stayed clear of the STATIC grid too (the collided
    # flag already checks the composite; this pins the grid part)
    from tpustomp.robot.fk import body_positions
    x = body_positions(robot, out.q)
    assert float(jnp.min(sdf(grid, x) - robot.body_radius)) > 0.0


def test_mpc_sharded_grid_static_world_runs():
    from tpustomp.world.edt import grid_from_analytic
    from tpustomp.world.sdf import AnalyticWorld

    robot = model.planar_2r(body_radius=0.05)
    cfg = _cfg()
    grid = grid_from_analytic(
        AnalyticWorld.make(boxes=[((1.3, 1.0, 0.0), (0.25, 0.25, 0.4))]),
        origin=(-2.5, -2.5, -0.5), shape=(50, 50, 12), resolution=0.1)
    B = 8
    centers = np.tile([[2.4, -0.6, 0.0]], (B, 1, 1)).astype(np.float32)
    vels = np.tile([[-0.15, 0.25, 0.0]], (B, 1, 1)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    states = jax.vmap(
        lambda c, v, k: mpc.init_mpc(robot, cfg, Q0, QN, c, v, k)
    )(jnp.asarray(centers), jnp.asarray(vels), keys)
    out = mpc.run_mpc_sharded(robot, cfg, states,
                              np.asarray([0.25], np.float32), 4, 0.1,
                              static_world=grid)
    assert np.all(np.asarray(out.steps) == 4)
    assert np.all(np.isfinite(np.asarray(out.theta)))


def test_goal_flush_reaches_exactly_and_yields_to_obstacles():
    """Near-goal flush guard (mpc.GOAL_FLUSH): within the radius the
    warm-start flush executes (reaching the goal EXACTLY instead of the
    replan's re-spread plateau — round-5 root cause), and the guard yields
    to the replanner the moment the flush plan would collide."""
    robot = model.planar_2r(body_radius=0.05)
    cfg = _cfg()
    center = np.array([[50.0, 50.0, 0.0]], np.float32)
    vel = np.zeros((1, 3), np.float32)
    radius = jnp.asarray([0.1], jnp.float32)
    state = mpc.init_mpc(robot, cfg, Q0, QN, center, vel,
                         jax.random.PRNGKey(3))
    on = mpc.run_mpc(robot, cfg, state, radius, num_ticks=60, world_dt=0.1)
    off = mpc.run_mpc(robot, cfg, state, radius, num_ticks=60, world_dt=0.1,
                      goal_flush=None)
    r_on = float(jnp.max(jnp.abs(on.q - on.qN)))
    r_off = float(jnp.max(jnp.abs(off.q - off.qN)))
    # flush converges exactly (the min-jerk plan fully flushes in N+slack
    # ticks); the replan-only path is no better
    assert r_on == 0.0, r_on
    assert r_on <= r_off + 1e-6

    # safety gate, tested at the selection seam: the flush is taken only
    # when near the goal AND its plan clears the collision threshold; a
    # failing margin hands back the replanned trajectory. (An end-to-end
    # evasion test at the goal is not meaningful: with endpoints clamped
    # at qN, NO endpoint-constrained planner — flush or replan — can evade
    # an obstacle that engulfs the goal configuration itself; verified:
    # both paths produce identical collisions there.)
    theta_r = jnp.ones((4, 2)) * 7.0
    theta_f = jnp.zeros((4, 2))
    near, far = jnp.zeros(2), jnp.asarray([3.0, 0.0])
    goal = jnp.zeros(2)
    pick = lambda q, m: np.asarray(mpc._apply_flush(
        theta_r, theta_f, q, goal, jnp.float32(m), cfg, 0.5))
    np.testing.assert_array_equal(pick(near, 0.2), np.asarray(theta_f))
    np.testing.assert_array_equal(pick(near, -0.01), np.asarray(theta_r))
    np.testing.assert_array_equal(pick(far, 0.2), np.asarray(theta_r))
