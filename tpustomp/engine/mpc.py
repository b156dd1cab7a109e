"""MPC replanning loop with moving obstacles (BASELINE config 5).

Reference equivalent: none — the reference plans once per `GetMotionPlan`
call; replanning against a changing world was done by re-calling the service.
Here replanning is a first-class, batched, shardable loop:

  every control tick:
    1. advance the world (analytic obstacles move; a pytree update — no EDT
       rebuild, SURVEY §8.3 hard part 6),
    2. execute the first waypoint of the current plan (q ← trajectory[1]),
    3. warm-start θ by shifting the previous solution one step toward the
       goal, 4. re-solve with a small iteration budget.

Scenarios are independent (own start/goal/obstacle state), so the whole loop
vmaps over a scenario batch and shards over the "scenario" mesh axis exactly
like plan_sharded (10k scenarios across a device mesh, SURVEY §3.3). Host-level
retry of a failed shard is trivial because MPCState is a pytree and the loop
is stateless given it (SURVEY §6 failure-recovery row).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tpustomp.api.config import PlannerConfig
from tpustomp.dynamics.device import device_ops
from tpustomp.engine import solver
from tpustomp.engine.distributed import SCENARIO_AXIS, make_mesh, _shard_batch
from tpustomp.engine.trajectory import min_jerk_init
from tpustomp.robot.model import RobotSpec
from tpustomp.utils import struct
from tpustomp.world.sdf import AnalyticWorld, CompositeWorld, GridSDF


@struct.dataclass
class MPCState:
    """Per-scenario replanning state (batch axis optional on every leaf)."""

    q: jnp.ndarray              # [d] current configuration
    qN: jnp.ndarray             # [d] goal
    theta: jnp.ndarray          # [N, d] current plan (free waypoints)
    sphere_center: jnp.ndarray  # [S, 3] moving obstacle positions
    sphere_vel: jnp.ndarray     # [S, 3] obstacle velocities
    key: jax.Array
    steps: jnp.ndarray          # int32 ticks executed
    collided: jnp.ndarray       # bool — executed waypoint hit an obstacle
    reached_tick: jnp.ndarray   # int32 first tick with |q−qN|∞ < goal_eps
    #                             (-1 until reached) — episode completion


def init_mpc(robot: RobotSpec, cfg: PlannerConfig, q0, qN, sphere_center,
             sphere_vel, key) -> MPCState:
    from tpustomp.engine.trajectory import wrap_goal
    q0 = jnp.asarray(q0, jnp.float32)
    # wrap once here so the warm-start shift (which appends state.qN) and
    # every replan share the same shortest-path goal for continuous joints
    qN = wrap_goal(q0, jnp.asarray(qN, jnp.float32), robot.joint_limited)
    theta = min_jerk_init(q0, qN, cfg.num_timesteps)
    return MPCState(
        q=jnp.asarray(q0, jnp.float32),
        qN=jnp.asarray(qN, jnp.float32),
        theta=theta,
        sphere_center=jnp.asarray(sphere_center, jnp.float32),
        sphere_vel=jnp.asarray(sphere_vel, jnp.float32),
        key=key,
        steps=jnp.int32(0),
        collided=jnp.bool_(False),
        reached_tick=jnp.int32(-1),
    )


# Interpolation samples per executed q -> q_next segment in the collision
# check (includes the segment endpoint; the start was the previous tick's
# endpoint). 4 sub-samples at typical tick lengths (~0.05 rad joint motion)
# bound the unchecked workspace gap well below common obstacle radii.
_SEGMENT_CHECK_SAMPLES = 4

# Default goal-completion tolerance (rad, per-joint inf-norm): a scenario
# counts as "reached" the first tick its executed configuration is within
# GOAL_EPS of the goal on every joint. Override via the goal_eps argument
# of mpc_step / run_mpc / run_mpc_sharded / run_mpc_resilient.
GOAL_EPS = 0.05

# Near-goal flush guard (radius, rad 2-norm): within it, KEEP EXECUTING the
# warm-start flush plan whenever that plan is collision-free, instead of
# the replan's output. Why (round-5 root cause, measured): the replan
# re-spreads the remaining motion over the FULL fixed horizon — a
# lower-smoothness-cost trajectory than the flushing one — so each tick's
# "better" plan moves waypoint 1 only O(s(1/N)) of the gap and episodes
# stall at ~0.10-0.15 rad forever; with replanning suppressed the flush
# reaches the goal EXACTLY in <= N+slack ticks (traced per-tick on the
# static-tabletop scene: max_iterations=1 hits 0.0 by tick 60 while the
# 8-iteration replan plateaus at 0.087). The guard is per-scenario and
# safety-gated: the moment the flush plan would collide (moving obstacle
# incoming) its margin check fails and the replanned trajectory is used.
# Noise-annealing near the goal was tried first and measured WORSE
# (reached 0.001 vs 0.048 at B=1024x120 ticks) — the stall was never a
# noise-equilibrium problem. Pass goal_flush=None to disable.
GOAL_FLUSH = 0.5


def _flush_margin(robot, world, q_next, qN, theta0, cfg: PlannerConfig):
    """Min collision margin of the warm-start flush plan (one trajectory —
    ~1/(1+K) of the replan's own evaluation work)."""
    from tpustomp.costs.obstacle import obstacle_cost

    full = jnp.concatenate([q_next[None], theta0, qN[None]], axis=0)
    _, margin = obstacle_cost(robot, world, full, cfg.dt,
                              cfg.collision_clearance)
    return margin


def _apply_flush(theta_replan, theta0, q_next, qN, margin, cfg,
                 goal_flush, axis=None):
    """Select flush vs replan per scenario (axis=1 for [B, d] batches)."""
    err = jnp.sqrt(jnp.sum((q_next - qN) ** 2, axis=axis))
    use = (err < jnp.float32(goal_flush)) & (margin
                                             > cfg.collision_threshold)
    shape = use.shape + (1,) * (theta_replan.ndim - use.ndim)
    return jnp.where(use.reshape(shape), theta0, theta_replan)


def _update_reached(reached_tick, q_next, qN, steps, goal_eps, axis=None):
    """First-reach bookkeeping: latch the tick index when |q−qN|∞ first
    drops below goal_eps (axis=1 for a [B, d] batch)."""
    err = jnp.max(jnp.abs(q_next - qN), axis=axis)
    now = err < goal_eps
    return jnp.where((reached_tick < 0) & now, steps + 1, reached_tick)


def _shift_warm_start(theta, qN):
    """Shift the plan one waypoint toward the goal (execute-and-slide)."""
    return jnp.concatenate([theta[1:], qN[None, :]], axis=0)


def _tick_world(centers, sphere_radius, static_world):
    """Compose the per-tick world: moving spheres + optional static scene.

    static_world=None: moving spheres only (original config-5 shape).
    GridSDF: CompositeWorld — the voxel scene stays precomputed, the moving
    obstacles ride the analytic overlay (a pytree update per tick, the
    incremental-update answer for grid scenes; world/sdf.CompositeWorld).
    AnalyticWorld: static primitives merged into one analytic world.
    The isinstance branches resolve at trace time (static_world's pytree
    structure is fixed across ticks)."""
    moving = AnalyticWorld(
        sphere_center=centers, sphere_radius=sphere_radius,
        box_center=jnp.zeros((0, 3), jnp.float32),
        box_half=jnp.zeros((0, 3), jnp.float32))
    if static_world is None:
        return moving
    if isinstance(static_world, GridSDF):
        return CompositeWorld(grid=static_world, overlay=moving)
    return AnalyticWorld(
        sphere_center=jnp.concatenate(
            [centers, static_world.sphere_center], axis=0),
        sphere_radius=jnp.concatenate(
            [sphere_radius, static_world.sphere_radius], axis=0),
        box_center=static_world.box_center,
        box_half=static_world.box_half)


def mpc_step(robot: RobotSpec, cfg: PlannerConfig, ops, state: MPCState,
             sphere_radius: jnp.ndarray, world_dt: float,
             static_world=None, goal_eps: float = GOAL_EPS,
             goal_flush: float | None = GOAL_FLUSH) -> MPCState:
    """One control tick: move world, execute one waypoint, replan."""
    # 1. world advances
    centers = state.sphere_center + state.sphere_vel * world_dt
    world = _tick_world(centers, sphere_radius, static_world)

    # 2. execute the first planned waypoint
    q_next = state.theta[0]

    # 3+4. warm start and replan from the advanced state
    theta0 = _shift_warm_start(state.theta, state.qN)
    key, sub = jax.random.split(state.key)
    sol = solver.solve(robot, world, None, cfg, ops, q_next, state.qN, sub,
                       theta0=theta0)
    theta_new = sol.trajectory[1:-1]
    if goal_flush is not None:
        fm = _flush_margin(robot, world, q_next, state.qN, theta0, cfg)
        theta_new = _apply_flush(theta_new, theta0, q_next, state.qN, fm,
                                 cfg, goal_flush)

    # collision check of the executed MOTION, not just the arrival tick:
    # sample the q -> q_next segment so a fast obstacle cannot pass through
    # between ticks undetected (the previous tick already checked state.q,
    # so the start point is excluded)
    from tpustomp.robot.fk import body_positions
    from tpustomp.world.sdf import sdf
    alphas = jnp.linspace(0.0, 1.0, _SEGMENT_CHECK_SAMPLES + 1)[1:]
    qs = state.q[None, :] + alphas[:, None] * (q_next - state.q)[None, :]
    x = jax.vmap(lambda q: body_positions(robot, q))(qs)
    margin = jnp.min(sdf(world, x) - robot.body_radius)
    return state.replace(
        q=q_next,
        theta=theta_new,
        sphere_center=centers,
        key=key,
        steps=state.steps + 1,
        collided=state.collided | (margin <= 0.0),
        reached_tick=_update_reached(state.reached_tick, q_next, state.qN,
                                     state.steps, goal_eps),
    )


def run_mpc(robot: RobotSpec, cfg: PlannerConfig, state: MPCState,
            sphere_radius, num_ticks: int, world_dt: float,
            static_world=None, goal_eps: float = GOAL_EPS,
            goal_flush: float | None = GOAL_FLUSH) -> MPCState:
    """Run `num_ticks` control steps (lax.scan; jit/vmap/shard-able)."""
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)

    def tick(s, _):
        return mpc_step(robot, cfg, ops, s, sphere_radius, world_dt,
                        static_world, goal_eps, goal_flush), None

    state, _ = jax.lax.scan(tick, state, None, length=num_ticks)
    return state


def _tick_world_batch(centers, sphere_radius, static_world):
    """Batched `_tick_world`: centers [B, S, 3] -> a world whose analytic /
    overlay leaves carry the scenario axis (solver.solve_batch
    world_batched=True)."""
    B = centers.shape[0]
    rad = jnp.broadcast_to(sphere_radius, (B,) + sphere_radius.shape)
    moving = AnalyticWorld(
        sphere_center=centers, sphere_radius=rad,
        box_center=jnp.zeros((B, 0, 3), jnp.float32),
        box_half=jnp.zeros((B, 0, 3), jnp.float32))
    if static_world is None:
        return moving
    if isinstance(static_world, GridSDF):
        return CompositeWorld(grid=static_world, overlay=moving)
    bcast = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    return AnalyticWorld(
        sphere_center=jnp.concatenate(
            [centers, bcast(static_world.sphere_center)], axis=1),
        sphere_radius=jnp.concatenate(
            [rad, bcast(static_world.sphere_radius)], axis=1),
        box_center=bcast(static_world.box_center),
        box_half=bcast(static_world.box_half))


def mpc_step_batch(robot: RobotSpec, cfg: PlannerConfig, ops,
                   state: MPCState, sphere_radius: jnp.ndarray,
                   world_dt: float, static_world=None,
                   goal_eps: float = GOAL_EPS,
                   goal_flush: float | None = GOAL_FLUSH) -> MPCState:
    """Batched `mpc_step`: state leaves carry a leading [B] scenario axis.

    Per-scenario semantics match mpc_step; the replan goes through
    solver.solve_batch with per-scenario worlds, so all scenarios advance
    in one solver loop."""
    from tpustomp.robot.fk import body_positions
    from tpustomp.world.sdf import sdf

    centers = state.sphere_center + state.sphere_vel * world_dt   # [B, S, 3]
    worldB = _tick_world_batch(centers, sphere_radius, static_world)

    q_next = state.theta[:, 0]                                     # [B, d]
    theta0 = jax.vmap(_shift_warm_start)(state.theta, state.qN)
    keys = jax.vmap(jax.random.split)(state.key)
    key, sub = keys[:, 0], keys[:, 1]
    sol = solver.solve_batch(robot, worldB, None, cfg, ops, q_next, state.qN,
                             sub, theta0=theta0, world_batched=True)
    theta_new = sol.trajectory[:, 1:-1]
    waxes = solver._world_axes(worldB, world_batched=True)
    if goal_flush is not None:
        fm = jax.vmap(
            lambda qn, g, th, w: _flush_margin(robot, w, qn, g, th, cfg),
            in_axes=(0, 0, 0, waxes))(q_next, state.qN, theta0, worldB)
        theta_new = _apply_flush(theta_new, theta0, q_next, state.qN, fm,
                                 cfg, goal_flush, axis=1)

    # executed-segment collision check (see mpc_step), vmapped per scenario
    alphas = jnp.linspace(0.0, 1.0, _SEGMENT_CHECK_SAMPLES + 1)[1:]
    qs = (state.q[:, None, :]
          + alphas[None, :, None] * (q_next - state.q)[:, None, :])

    def seg_margin(qrow, w):
        x = jax.vmap(lambda q: body_positions(robot, q))(qrow)
        return jnp.min(sdf(w, x) - robot.body_radius)

    margin = jax.vmap(seg_margin, in_axes=(0, waxes))(qs, worldB)
    return state.replace(
        q=q_next,
        theta=theta_new,
        sphere_center=centers,
        key=key,
        steps=state.steps + 1,
        collided=state.collided | (margin <= 0.0),
        reached_tick=_update_reached(state.reached_tick, q_next, state.qN,
                                     state.steps, goal_eps, axis=1),
    )


def run_mpc_batch(robot: RobotSpec, cfg: PlannerConfig, state: MPCState,
                  sphere_radius, num_ticks: int, world_dt: float,
                  static_world=None, goal_eps: float = GOAL_EPS,
                  goal_flush: float | None = GOAL_FLUSH) -> MPCState:
    """Batched run_mpc: state leaves carry a leading [B] scenario axis."""
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)

    def tick(s, _):
        return mpc_step_batch(robot, cfg, ops, s, sphere_radius, world_dt,
                              static_world, goal_eps, goal_flush), None

    state, _ = jax.lax.scan(tick, state, None, length=num_ticks)
    return state


def _run_batch_select(robot, cfg: PlannerConfig, state, sphere_radius,
                      num_ticks: int, world_dt: float, static_world,
                      goal_eps: float = GOAL_EPS,
                      goal_flush: float | None = GOAL_FLUSH):
    """Batched-execution selector — the ONE code path for batched MPC runs.

    STOMP scenarios replan through the batched solver; CHOMP/HMC fall back
    to plain vmap. The branch resolves at trace time. Shared by the healthy
    sharded dispatch (`_sharded_mpc`) AND the recovery subset re-dispatch
    (`run_mpc_resilient._retry_fn`) so a recovered scenario replays the
    same program a never-failed one ran.
    """
    if cfg.mode == "stomp":
        return run_mpc_batch(robot, cfg, state, sphere_radius, num_ticks,
                             world_dt, static_world, goal_eps, goal_flush)
    return jax.vmap(
        lambda s: run_mpc(robot, cfg, s, sphere_radius, num_ticks,
                          world_dt, static_world, goal_eps, goal_flush)
    )(state)


@functools.lru_cache(maxsize=8)
def _sharded_mpc(cfg: PlannerConfig, mesh, num_ticks: int, world_dt: float,
                 goal_eps: float, goal_flush: float | None):
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))
    replicated = NamedSharding(mesh, P())

    def run(robot, state, sphere_radius, static_world):
        return _run_batch_select(robot, cfg, state, sphere_radius, num_ticks,
                                 world_dt, static_world, goal_eps,
                                 goal_flush)

    return jax.jit(run, in_shardings=(replicated, sharding, replicated,
                                      replicated),
                   out_shardings=sharding)


def run_mpc_sharded(robot: RobotSpec, cfg: PlannerConfig, state: MPCState,
                    sphere_radius, num_ticks: int, world_dt: float,
                    mesh=None, static_world=None,
                    goal_eps: float = GOAL_EPS,
                    goal_flush: float | None = GOAL_FLUSH) -> MPCState:
    """Batched MPC over the scenario mesh (BASELINE config 5).

    `state` leaves carry a leading [batch] axis (process-local shard in
    multi-host mode). Scenario count must divide by the mesh size.
    `static_world` (GridSDF or AnalyticWorld, replicated) composes with the
    per-scenario moving spheres each tick — see _tick_world.
    """
    if mesh is None:
        mesh = make_mesh()
    state = jax.tree.map(lambda x: _shard_batch(np.asarray(x), mesh), state)
    fn = _sharded_mpc(cfg, mesh, num_ticks, world_dt, goal_eps, goal_flush)
    return fn(robot, state, jnp.asarray(sphere_radius, jnp.float32),
              static_world)


def _unhealthy(state_host: MPCState,
               expected_steps: np.ndarray | None = None) -> np.ndarray:
    """Per-scenario failure mask [B]: non-finite leaves or a wrong tick count.

    Non-finite state is the observable signature of both numerical blowup
    and a shard whose device died mid-dispatch (its buffers never landed).
    `expected_steps` additionally catches a dead shard that returned
    zeroed/garbage *integer* leaves with finite floats: after a chunk of
    `ticks` steps every scenario's counter must equal snapshot_steps+ticks.
    """
    bad = None
    for leaf in jax.tree.leaves(state_host):
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        b = ~np.isfinite(arr.reshape(arr.shape[0], -1)).all(axis=1)
        bad = b if bad is None else (bad | b)
    if bad is None:
        return np.zeros(0, bool)
    if expected_steps is not None:
        bad = bad | (np.asarray(state_host.steps) != expected_steps)
    return bad


def run_mpc_resilient(robot: RobotSpec, cfg: PlannerConfig, state: MPCState,
                      sphere_radius, num_ticks: int, world_dt: float,
                      mesh=None, chunk_ticks: int | None = None,
                      max_retries: int = 2, static_world=None,
                      goal_eps: float = GOAL_EPS,
                      goal_flush: float | None = GOAL_FLUSH,
                      _fault_hook=None) -> MPCState:
    """Failure-detecting MPC driver (SURVEY §6 failure-recovery row).

    The reference has no failure handling beyond its planning-time-limit
    failsafe; the SURVEY mandates host-level retry of a failed shard for the
    long-running multi-host MPC loop. Scenarios are stateless given their
    MPCState pytree, so recovery is re-dispatch, not re-sharding:

      - the loop runs in chunks of `chunk_ticks`; before each chunk the
        batched state is snapshotted to host (the recovery point);
      - a chunk that raises (device/runtime fault) is re-dispatched whole,
        up to `max_retries` times;
      - after each chunk, per-scenario health is checked (`_unhealthy`:
        non-finite leaves); failed scenarios alone are re-run from the
        snapshot on a fresh dispatch while healthy results are kept.
        Re-dispatch replays the same PRNG keys, so a recovered scenario is
        numerically identical to a never-failed one.

    `_fault_hook(chunk_idx, state_host) -> state_host` is the fault-injection
    seam used by tests (corrupts results as a dead shard would).
    Single-process scope: in true multi-host runs each process applies this
    driver to its local shard. The subset re-dispatch compiles once per
    distinct failed-count, which is fine at recovery rates worth surviving.
    """
    if chunk_ticks is None:
        chunk_ticks = max(1, min(num_ticks, 10))
    radius = jnp.asarray(sphere_radius, jnp.float32)
    # Device/runtime faults are retryable; deterministic programming errors
    # (shape bugs, tracer leaks) are not — re-raise those immediately.
    from jax.errors import JaxRuntimeError as _RetryableError

    @functools.lru_cache(maxsize=8)
    def _retry_fn(ticks: int):
        # Same batched program as the healthy dispatch (_run_batch_select),
        # just over the failed-row subset.
        return jax.jit(lambda sub: _run_batch_select(
            robot, cfg, sub, radius, ticks, world_dt, static_world,
            goal_eps, goal_flush))

    # np.array (copy): device views are read-only, and the snapshot must not
    # alias buffers the next dispatch may donate
    to_host = lambda st: jax.tree.map(lambda x: np.array(x), st)
    state = to_host(state)  # host-resident: survives a device fault
    done = 0
    chunk_idx = 0
    while done < num_ticks:
        ticks = min(chunk_ticks, num_ticks - done)
        snapshot = state  # already on host
        out = None
        for attempt in range(max_retries + 1):
            try:
                # dispatch from the host snapshot so a retry never feeds
                # buffers that lived on the device that just failed
                out = to_host(run_mpc_sharded(robot, cfg, snapshot, radius,
                                              ticks, world_dt, mesh=mesh,
                                              static_world=static_world,
                                              goal_eps=goal_eps,
                                              goal_flush=goal_flush))
                break
            except _RetryableError as e:
                print(f"[tpustomp.mpc] chunk {chunk_idx} attempt {attempt} "
                      f"failed: {type(e).__name__}: {e}", flush=True)
                if attempt == max_retries:
                    raise
        if _fault_hook is not None:
            out = _fault_hook(chunk_idx, out)
        expected = np.asarray(snapshot.steps) + ticks
        bad = _unhealthy(out, expected)
        for attempt in range(max_retries):
            if not bad.any():
                break
            idx = np.flatnonzero(bad)
            sub = jax.tree.map(lambda x: jnp.asarray(x[idx]), snapshot)
            redo = to_host(_retry_fn(ticks)(sub))
            out = jax.tree.map(
                lambda full, part: _merge_rows(full, part, idx), out, redo)
            bad = _unhealthy(out, expected)
        if bad.any():
            raise RuntimeError(
                f"MPC scenarios {np.flatnonzero(bad).tolist()} still "
                f"unhealthy after {max_retries} re-dispatches "
                f"(chunk {chunk_idx}, ticks {done}..{done + ticks})")
        state = out
        done += ticks
        chunk_idx += 1
    return jax.tree.map(jnp.asarray, state)


def _merge_rows(full: np.ndarray, part: np.ndarray, idx: np.ndarray):
    full = np.array(full)
    full[idx] = part
    return full
