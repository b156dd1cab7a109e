"""Public planning API — the framework's service surface.

Reference equivalents (SURVEY §2 L6/L7): `StompPlannerNode` advertising the
`GetMotionPlan` ROS service and `planKinematicPath` doing msg ⇄ trajectory
conversion. Here a plan is a function call:

    sol = plan(robot, world, ProblemSpec(q0, qN), cfg, key)
    sols = plan_batch(robot, world, batched_problem, cfg, keys)   # vmap
    (sharded multi-chip batching lives in engine/distributed.py)

Everything device-side is jitted once per (config, robot/world shapes) and
cached; the wall-clock planning_time_limit is enforced here on the host by
chunking max_iterations across device calls (the reference checks the clock
between iterations — same semantics at chunk granularity).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpustomp.api.config import PlannerConfig
from tpustomp.api.problem import ProblemSpec, Solution
from tpustomp.dynamics.device import device_ops
from tpustomp.engine import solver
from tpustomp.robot.model import RobotSpec


_GOAL_KEY_SEED = 0x60A1   # fixed seed: goal selection is deterministic
_GOAL_SAMPLES = 64


def resolve_goal_tolerance(robot, world, cfg: PlannerConfig, q0, qN,
                           tol_below, tol_above):
    """Pick the goal configuration inside the per-joint tolerance band.

    Reference equivalent: ``planKinematicPath`` extracting
    ``req.goal_constraints.joint_constraints`` — a position per joint plus
    tolerance_above/below; any endpoint within [qN − below, qN + above]
    satisfies the goal (SURVEY §4.2 [M]). The reference plans to the
    constraint position exactly; here the band is *used*: if the nominal
    goal is joint-limit- or collision-infeasible, the nearest feasible
    configuration in the band is selected (nominal + band-clipped nominal +
    a fixed-seed uniform scan of the band, all checked in ONE vmapped
    FK+SDF batch — negligible next to the solve). Wraparound composes: the
    shortest angular path is taken first, the band rides the wrapped goal.

    Returns the adjusted qN [d]. Pure; jit/vmap-able.
    """
    from tpustomp.engine.trajectory import wrap_goal
    from tpustomp.robot.fk import body_positions
    from tpustomp.world.sdf import sdf

    qN = wrap_goal(q0, qN, robot.joint_limited)
    lo = qN - jnp.broadcast_to(jnp.asarray(tol_below, jnp.float32), qN.shape)
    hi = qN + jnp.broadcast_to(jnp.asarray(tol_above, jnp.float32), qN.shape)
    # band ∩ joint limits (continuous joints keep the full band); an empty
    # intersection collapses to its lower edge
    lo = jnp.where(robot.joint_limited, jnp.maximum(lo, robot.joint_lower), lo)
    hi = jnp.where(robot.joint_limited, jnp.minimum(hi, robot.joint_upper), hi)
    hi = jnp.maximum(hi, lo)
    u = jax.random.uniform(jax.random.PRNGKey(_GOAL_KEY_SEED),
                           (_GOAL_SAMPLES, qN.shape[0]))
    # candidate 0 is the band∩limit-clipped nominal (the blanket clip means
    # an UNclipped nominal is never evaluated — it would be outside joint
    # limits whenever the clip moves it, hence infeasible by definition);
    # d2 below is measured against the true nominal, so candidate 0 still
    # wins exactly when the nominal itself is inside the band and feasible
    cands = jnp.concatenate([qN[None], lo + u * (hi - lo)], axis=0)
    cands = jnp.clip(cands, lo, hi)

    def margin(q):
        return jnp.min(sdf(world, body_positions(robot, q))
                       - robot.body_radius)

    margins = jax.vmap(margin)(cands)
    feasible = margins > cfg.collision_threshold
    d2 = jnp.sum((cands - qN) ** 2, axis=1)
    # nearest feasible candidate (a feasible in-band nominal is candidate 0
    # with d2=0 and always wins = exact reference behavior); if none
    # feasible, the max-margin candidate (best-effort, like the reference's
    # best-so-far failsafe)
    nearest = jnp.argmin(jnp.where(feasible, d2, jnp.inf))
    return jnp.where(jnp.any(feasible), cands[nearest],
                     cands[jnp.argmax(margins)])


@functools.lru_cache(maxsize=32)
def _jitted_goal(cfg: PlannerConfig, batched: bool):
    def run(robot, world, q0, qN, tb, ta):
        if batched:
            return jax.vmap(lambda a, b, x, y: resolve_goal_tolerance(
                robot, world, cfg, a, b, x, y))(q0, qN, tb, ta)
        return resolve_goal_tolerance(robot, world, cfg, q0, qN, tb, ta)

    return jax.jit(run)


def _apply_goal_tolerance(robot, world, problem: ProblemSpec,
                          cfg: PlannerConfig, q0, qN, batched: bool):
    """Resolve the goal band (if any) to a concrete qN. None tolerances mean
    an exact goal and leave qN untouched."""
    tb, ta = problem.goal_tolerance_below, problem.goal_tolerance_above
    if tb is None and ta is None:
        return qN
    zeros = jnp.zeros(qN.shape[-1], jnp.float32)
    tb = zeros if tb is None else jnp.asarray(tb, jnp.float32)
    ta = zeros if ta is None else jnp.asarray(ta, jnp.float32)
    if batched:
        B = q0.shape[0]
        tb = jnp.broadcast_to(tb, (B, qN.shape[-1])) if tb.ndim < 2 else tb
        ta = jnp.broadcast_to(ta, (B, qN.shape[-1])) if ta.ndim < 2 else ta
    else:
        tb = jnp.broadcast_to(tb, qN.shape)
        ta = jnp.broadcast_to(ta, qN.shape)
    return _jitted_goal(cfg, batched)(robot, world, q0, qN, tb, ta)


@functools.lru_cache(maxsize=32)
def _jitted_solve(cfg: PlannerConfig, has_constraints: bool):
    def run(robot, world, constraints, ops, q0, qN, key):
        return solver.solve_best_of(robot, world, constraints, cfg, ops,
                                    q0, qN, key)

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _jitted_solve_batch(cfg: PlannerConfig, has_constraints: bool):
    # STOMP: the batched solver (solver.solve_batch), one while-loop over
    # the whole batch with per-scenario results equal to vmap(solve).
    # Restarts fold into the scenario axis, then select_best per problem.
    if cfg.mode == "stomp":
        R = max(1, cfg.num_restarts)

        def run(robot, world, constraints, ops, q0, qN, keys):
            B = q0.shape[0]
            if R > 1:
                q0r = jnp.repeat(q0, R, axis=0)
                qNr = jnp.repeat(qN, R, axis=0)
                keysr = jax.vmap(lambda k: jax.random.split(k, R)
                                 )(keys).reshape(B * R, -1)
                sols = solver.solve_batch(robot, world, constraints, cfg,
                                          ops, q0r, qNr, keysr)
                grouped = jax.tree.map(
                    lambda x: x.reshape((B, R) + x.shape[1:]), sols)
                return jax.vmap(solver.select_best)(grouped)
            return solver.solve_batch(robot, world, constraints, cfg, ops,
                                      q0, qN, keys)

        return jax.jit(run)

    def run(robot, world, constraints, ops, q0, qN, keys):
        return jax.vmap(
            lambda a, b, k: solver.solve_best_of(robot, world, constraints,
                                                 cfg, ops, a, b, k)
        )(q0, qN, keys)

    return jax.jit(run)


def plan(robot: RobotSpec, world, problem: ProblemSpec,
         cfg: PlannerConfig = PlannerConfig(), key: jax.Array | None = None,
         constraints=None) -> Solution:
    """Solve one planning query. Returns a Solution pytree (device arrays)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    q0 = jnp.asarray(problem.q0, jnp.float32)
    qN = jnp.asarray(problem.qN, jnp.float32)
    qN = _apply_goal_tolerance(robot, world, problem, cfg, q0, qN,
                               batched=False)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    sol = _jitted_solve(cfg, constraints is not None)(
        robot, world, constraints, ops, q0, qN, key)
    _maybe_animate(robot, world, sol, cfg)
    return sol


@functools.lru_cache(maxsize=32)
def _jitted_chunk(cfg: PlannerConfig, has_constraints: bool,
                  restarts: int = 1):
    def run(robot, world, constraints, ops, q0, qN, state, it_limit):
        def one(s):
            return solver.run_until(robot, world, constraints, cfg, ops,
                                    q0, qN, s, it_limit)

        return jax.vmap(one)(state) if restarts > 1 else one(state)

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _jitted_finalize(cfg: PlannerConfig, has_constraints: bool,
                     restarts: int = 1):
    def run(robot, world, constraints, ops, q0, qN, state):
        def one(s):
            return solver.finalize(robot, world, constraints, cfg, ops,
                                   q0, qN, s)

        if restarts > 1:
            return solver.select_best(jax.vmap(one)(state))
        return one(state)

    return jax.jit(run)


def plan_timed(robot: RobotSpec, world, problem: ProblemSpec,
               cfg: PlannerConfig = PlannerConfig(),
               key: jax.Array | None = None, constraints=None,
               chunk_iterations: int = 25) -> Solution:
    """plan() with the reference's wall-clock failsafe: iterate in device
    chunks of `chunk_iterations`, stop when `cfg.planning_time_limit` seconds
    elapse, and return best-so-far (success=False if never collision-free) —
    the behavior of the reference's planning_time_limit (SURVEY §6).

    cfg.num_restarts is honored exactly as in plan(): R independent noise
    streams run vmapped inside each chunk (all sharing the wall-clock
    budget) and select_best picks the winner at finalize."""
    import time

    if key is None:
        key = jax.random.PRNGKey(0)
    q0 = jnp.asarray(problem.q0, jnp.float32)
    qN = jnp.asarray(problem.qN, jnp.float32)
    qN = _apply_goal_tolerance(robot, world, problem, cfg, q0, qN,
                               batched=False)
    # shortest-path goal for continuous joints (solver.solve does this
    # internally; this path drives init_state/run_until directly)
    from tpustomp.engine.trajectory import wrap_goal
    qN = wrap_goal(q0, qN, robot.joint_limited)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    R = max(1, cfg.num_restarts)
    run_chunk = _jitted_chunk(cfg, constraints is not None, R)
    if R > 1:
        state = jax.vmap(lambda k: solver.init_state(robot, cfg, q0, qN, k)
                         )(jax.random.split(key, R))
    else:
        state = solver.init_state(robot, cfg, q0, qN, key)
    deadline = time.monotonic() + cfg.planning_time_limit
    while True:
        it_now = int(jnp.max(state.iteration)) if R > 1 \
            else int(state.iteration)
        limit = jnp.int32(min(it_now + chunk_iterations, cfg.max_iterations))
        state = run_chunk(robot, world, constraints, ops, q0, qN, state, limit)
        done = bool(jnp.all(state.done)) if R > 1 else bool(state.done)
        if done or time.monotonic() >= deadline:
            break
    sol = _jitted_finalize(cfg, constraints is not None, R)(
        robot, world, constraints, ops, q0, qN, state)
    _maybe_animate(robot, world, sol, cfg)
    return sol


def _maybe_animate(robot, world, sol, cfg: PlannerConfig):
    """Reference animate_path / animate_endeffector params -> figure dumps
    (the RViz-marker replacement; see utils/viz.py)."""
    if not (cfg.animate_path or cfg.animate_endeffector):
        return
    import os

    from tpustomp.utils import viz

    os.makedirs("tpustomp_viz", exist_ok=True)
    try:
        viz.plot_ee_path_3d(robot, sol, world,
                            path=os.path.join("tpustomp_viz", "ee_path.png"))
        if cfg.animate_path:
            # the reference's animate_path stepped the robot through the
            # waypoints in RViz; here it writes an animated GIF sweep
            viz.animate_trajectory(
                robot, sol, world,
                path=os.path.join("tpustomp_viz", "trajectory.gif"))
        if sol.metrics is not None:
            viz.plot_metrics(sol, path=os.path.join("tpustomp_viz",
                                                    "metrics.png"))
    except Exception as e:  # viz must never break planning
        print(f"[tpustomp] viz dump failed: {e}")


def plan_batch(robot: RobotSpec, world, problem: ProblemSpec,
               cfg: PlannerConfig = PlannerConfig(),
               keys: jax.Array | None = None, constraints=None) -> Solution:
    """Solve a batch of queries with vmap (BASELINE config 4).

    problem.q0 / problem.qN: [batch, d]. Returns a Solution with a leading
    batch axis on every field. For multi-chip sharding of the batch axis, see
    engine/distributed.py.
    """
    q0 = jnp.asarray(problem.q0, jnp.float32)
    qN = jnp.asarray(problem.qN, jnp.float32)
    if keys is None:
        keys = jax.random.split(jax.random.PRNGKey(0), q0.shape[0])
    qN = _apply_goal_tolerance(robot, world, problem, cfg, q0, qN,
                               batched=True)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    if _use_compaction(cfg):
        return _plan_batch_compacted(robot, world, constraints, cfg, ops,
                                     q0, qN, keys)
    return _jitted_solve_batch(cfg, constraints is not None)(
        robot, world, constraints, ops, q0, qN, keys)


def plan_batch_stream(robot: RobotSpec, world, problems,
                      cfg: PlannerConfig = PlannerConfig(),
                      constraints=None, depth: int = 2,
                      gather: str = "serving", mesh=None):
    """Pipelined batched serving: a generator over batches of queries.

    `problems`: iterable of ProblemSpec (q0/qN: [B, d]) or (ProblemSpec,
    keys) pairs. Yields one result per input batch, in order.

    Why this exists (the multi-host serving loop): `plan_batch` is
    async-dispatch — the jitted solve is queued and control returns — but a
    caller that does prep → solve → gather per batch serializes the three,
    so each host pays solve + host-work per batch. This driver keeps up to
    `depth` batches in flight: while the device solves batch i, the host is
    already preparing and dispatching batch i+1 and gathering batch i−depth
    (the blocking device→host pull overlaps device compute of the queued
    batches). Steady-state time per batch becomes max(t_solve, t_host)
    instead of t_solve + t_host: per-host efficiency in a multi-host run is
    t_solve / max(t_solve, t_host) because scenarios never shard across
    hosts and there are zero in-loop collectives (SURVEY §3.3/§3.4).
    bench/scaling.py run_pipelined_bound drives this loop.

    gather: "serving" yields (trajectory, success) as host numpy arrays —
    the serving-path result; "full" yields the whole Solution pytree as
    numpy; "none" yields the raw device Solution (caller controls the sync
    point). depth=2 is enough to cover host work with device compute;
    deeper queues only add memory.

    mesh: optional jax.sharding.Mesh — batches dispatch through
    engine.distributed.plan_sharded over the mesh's "scenario" axis
    instead of plan_batch (multi-chip serving; in multi-host mode each
    process feeds its local shards and the stream overlaps exactly as in
    the single-chip case, since dispatch stays async). Multi-host callers
    should use gather="none" and read their addressable shards — a host
    numpy gather of a non-fully-addressable global array raises.

    Requires cfg.batch_compaction resolved to off (the default): host-side
    compaction syncs per chunk, which would serialize the stream.
    """
    import collections

    inflight = collections.deque()

    def _out(sol: Solution):
        import numpy as np
        if gather == "serving":
            return np.asarray(sol.trajectory), np.asarray(sol.success)
        if gather == "full":
            return jax.tree.map(np.asarray, sol)
        return sol

    def _dispatch(prob, keys):
        if mesh is not None:
            from tpustomp.engine import distributed
            return distributed.plan_sharded(robot, world, prob, cfg,
                                            keys=keys,
                                            constraints=constraints,
                                            mesh=mesh)
        return plan_batch(robot, world, prob, cfg, keys=keys,
                          constraints=constraints)

    for item in problems:
        prob, keys = item if isinstance(item, tuple) else (item, None)
        # drain BEFORE dispatching so at most `depth` batches are ever
        # resident on the device (the r4 append-first order kept depth+1
        # in flight, one more than documented). The `inflight and` guard
        # keeps depth=0 a valid fully-synchronous mode (dispatch, then
        # drain to empty) instead of popping an empty deque.
        while inflight and len(inflight) >= depth:
            yield _out(inflight.popleft())
        inflight.append(_dispatch(prob, keys))
    while inflight:
        yield _out(inflight.popleft())


def plan_batch_retry(robot: RobotSpec, world, problem: ProblemSpec,
                     cfg: PlannerConfig = PlannerConfig(),
                     keys: jax.Array | None = None, constraints=None,
                     max_rounds: int = 2, retry_restarts: int = 4
                     ) -> Solution:
    """`plan_batch` + targeted re-solve of failed rows (serving pattern).

    The batched headline must hold at success = 1.0, and folding restarts
    into EVERY scenario doubles the whole batch's work to fix a few percent
    of rows. Instead: solve the batch once, pull the success mask (one
    device→host bool pull), gather the failed rows (typically ≤10%), and
    re-solve only those with fresh key splits and `retry_restarts` restarts
    folded into their (small) scenario axis; scatter the recovered rows
    back. Rows are independent, so the merge is exact. Up to `max_rounds`
    retry rounds; each round compiles once per distinct padded retry-batch
    size (padded to the next power of two, min 16, so retry shapes are
    reused across calls).
    """
    import numpy as np

    q0 = jnp.asarray(problem.q0, jnp.float32)
    if keys is None:
        keys = jax.random.split(jax.random.PRNGKey(0), q0.shape[0])
    sol = plan_batch(robot, world, problem, cfg, keys=keys,
                     constraints=constraints)
    for rnd in range(max_rounds):
        failed = np.flatnonzero(~np.asarray(sol.success))
        if failed.size == 0:
            break
        # Every device array in this loop is PADDED to the bucket size, so
        # each (bucket, round) pair compiles exactly once and repeat calls
        # with different failed sets hit warm programs. Un-padded shapes
        # here caused a per-call recompile of the eager merge ops
        # (measured: 8.5 s/call). Padding rows duplicate failed[0] for the
        # GATHER (any valid problem row works), but the SCATTER points them
        # out of bounds so they are dropped: a duplicate in-bounds write
        # has an undefined winner in JAX.
        pad = max(16, 1 << int(np.ceil(np.log2(failed.size))))
        idx = np.concatenate([failed, np.repeat(failed[:1],
                                                pad - failed.size)])
        idx_d = jnp.asarray(idx)
        idx_scatter = jnp.asarray(np.concatenate(
            [failed, np.full(pad - failed.size, q0.shape[0], failed.dtype)]))

        def _rows(x):
            """Gather retry rows; per-row ([B, d]) tolerance arrays must
            follow their problems, scalars/None broadcast unchanged."""
            if x is None:
                return None
            x = jnp.asarray(x, jnp.float32)
            return _gather_rows_jit(x, idx_d) if x.ndim == 2 else x

        sub = ProblemSpec(
            q0=_gather_rows_jit(jnp.asarray(problem.q0, jnp.float32), idx_d),
            qN=_gather_rows_jit(jnp.asarray(problem.qN, jnp.float32), idx_d),
            goal_tolerance_below=_rows(problem.goal_tolerance_below),
            goal_tolerance_above=_rows(problem.goal_tolerance_above))
        # fresh, deterministic noise streams for the retry round
        sub_keys = _retry_keys_jit(keys, idx_d, rnd + 1)
        re = plan_batch(robot, world, sub,
                        cfg.replace(num_restarts=retry_restarts),
                        keys=sub_keys, constraints=constraints)
        sol = _scatter_solution_jit(sol, re, idx_scatter)
    return sol


@jax.jit
def _gather_rows_jit(x, idx):
    return x[idx]


@jax.jit
def _retry_keys_jit(keys, idx, rnd):
    return jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys[idx], rnd)


@jax.jit
def _scatter_solution_jit(sol, part, idx):
    # mode="drop": pad rows arrive with out-of-bounds indices (see
    # plan_batch_retry) so only the real failed rows are merged
    return jax.tree.map(lambda f, p: f.at[idx].set(p, mode="drop"),
                        sol, part)


def _use_compaction(cfg: PlannerConfig) -> bool:
    if cfg.mode != "stomp" or cfg.batch_compaction == "off":
        return False
    if cfg.batch_compaction == "on":
        return True
    # "auto" resolves to OFF: whether the host syncs between chunks repay
    # the convergence-tail work they skip has not been measured on the GPU
    # (compare batch_compaction="on" against "off" before changing this).
    return False


@functools.lru_cache(maxsize=8)
def _jitted_select_best_grouped():
    return jax.jit(jax.vmap(solver.select_best))


def _plan_batch_compacted(robot, world, constraints, cfg: PlannerConfig,
                          ops, q0, qN, keys) -> Solution:
    """Host-orchestrated batched solve with finished-scenario compaction.

    Restarts fold into the scenario axis exactly as in _jitted_solve_batch,
    then select_best per problem."""
    B = q0.shape[0]
    R = max(1, cfg.num_restarts)
    if R > 1:
        q0 = jnp.repeat(q0, R, axis=0)
        qN = jnp.repeat(qN, R, axis=0)
        keys = jax.vmap(lambda k: jax.random.split(k, R)
                        )(keys).reshape(B * R, -1)
    sols = solver.solve_batch_compacted(robot, world, constraints, cfg, ops,
                                        q0, qN, keys)
    if R > 1:
        grouped = jax.tree.map(lambda x: x.reshape((B, R) + x.shape[1:]),
                               sols)
        sols = _jitted_select_best_grouped()(grouped)
    return sols
