"""The optimizer loop: one pure jitted step inside `lax.while_loop`.

Reference equivalents (SURVEY §2, §4.3): ``StompOptimizer::optimize`` +
``PolicyImprovementLoop::runSingleIteration`` + the `Task::execute` callback
inversion between L4 and L5. Here the inversion disappears: a single
pure function `_stomp_step`/`_chomp_step` contains
sample → joint-limit project → FK+SDF cost → PI² softmax → M-smoothed update,
batched over rollouts with vmap; the outer iteration is a `lax.while_loop`
with (iteration, collision-free counter, best-so-far) in the carry (A.12
termination). `vmap` over scenarios stacks on top (api/plan.py); converged
scenarios freeze via the while-loop's done predicate (SURVEY §8.3 part 4).

Deviations from the reference, documented:
  - Reused rollouts are re-evaluated each iteration instead of carrying cached
    costs. The K rollouts are one batched evaluation, so re-evaluating the
    handful of reused ones costs little and removes stale-cost bookkeeping;
    numerics are identical because the cost is deterministic in θ_k.
  - The planning_time_limit is enforced by the host replan wrapper between
    device calls (api/plan.py), not inside the compiled loop; the in-loop
    budget is max_iterations.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from tpustomp.api.config import PlannerConfig
from tpustomp.api.problem import IterationMetrics, Solution
from tpustomp.costs.constraints import constraint_cost
from tpustomp.costs.obstacle import obstacle_cost
from tpustomp.costs.smoothness import smoothness_cost_per_timestep
from tpustomp.costs.torque import torque_cost
from tpustomp.dynamics.device import DeviceOps
from tpustomp.engine import pi2
from tpustomp.engine.chomp import chomp_delta
from tpustomp.engine.limits import project_limits
from tpustomp.engine.sampling import sample_noise
from tpustomp.engine.trajectory import full_trajectory, min_jerk_init, wrap_goal
from tpustomp.robot.model import RobotSpec
from tpustomp.utils import struct


@struct.dataclass
class HyperParams:
    """Traced (per-scenario) solver hyperparameters.

    The reference reads its exploration knobs once from the ROS param server
    per plan; here they can additionally be ARRAYS riding the scenario axis:
    every leaf is a scalar (single solve) or [B] (batched solve), traced —
    so a hyperparameter grid search is one compile and ONE batched solve
    with (grid × problems) scenarios, instead of one recompilation per cell
    (bench/stomp_sweep.py). `None` anywhere a `hyper` argument is accepted
    means "use the static values from PlannerConfig", which compiles the
    exact pre-existing program.

    noise_scale: multiplier on cfg's per-joint noise stddevs (A.3).
    h:           PI² cost sensitivity (A.9; cfg.pi2_h).
    decay:       per-iteration noise decay (A.3; cfg.noise.decay).
    """

    noise_scale: jnp.ndarray
    h: jnp.ndarray
    decay: jnp.ndarray

    @staticmethod
    def from_config(cfg, batch: int | None = None) -> "HyperParams":
        """The static config values as a HyperParams (solve parity helper)."""
        mk = (lambda v: jnp.full((batch,), v, jnp.float32)
              if batch is not None else jnp.float32(v))
        return HyperParams(noise_scale=mk(1.0), h=mk(cfg.pi2_h),
                           decay=mk(cfg.noise.decay))


@struct.dataclass
class SolverState:
    theta: jnp.ndarray        # [N, d] current free waypoints
    key: jax.Array
    iteration: jnp.ndarray    # int32
    best_theta: jnp.ndarray   # [N, d] best *collision-free* trajectory so far
    best_cost: jnp.ndarray    # its total cost (inf while none found)
    found_cf: jnp.ndarray     # bool — any collision-free iterate seen
    cf_count: jnp.ndarray     # int32 — consecutive collision-free iterations
    done: jnp.ndarray         # bool
    reuse_theta: jnp.ndarray  # [K_reuse, N, d] best rollout trajectories
    m_total: jnp.ndarray      # metrics arrays, [max_iterations]
    m_obstacle: jnp.ndarray
    m_smooth: jnp.ndarray
    m_constraint: jnp.ndarray
    m_cf: jnp.ndarray


def _evaluate(robot, world, constraints, cfg: PlannerConfig, ops: DeviceOps,
              q0, qN, theta):
    """State-cost row S [N+2], control row, margin, and breakdown."""
    full = full_trajectory(theta, q0, qN)
    q_obs, margin = obstacle_cost(robot, world, full, cfg.dt,
                                  cfg.collision_clearance)
    q_con = constraint_cost(robot, constraints, full)
    S = cfg.weights.obstacle * q_obs + cfg.weights.constraint * q_con
    if cfg.weights.torque > 0.0:  # static branch; off by default (A.8)
        S = S + cfg.weights.torque * torque_cost(robot, full, cfg.dt)
    ctrl_t = smoothness_cost_per_timestep(ops, theta, q0, qN)
    ctrl = jnp.sum(ctrl_t)
    total = jnp.sum(S) + cfg.weights.smoothness * ctrl
    return S, ctrl_t, margin, total, (jnp.sum(q_obs), ctrl, jnp.sum(q_con))


def _evaluate_batch(robot, world, constraints, cfg: PlannerConfig,
                    ops: DeviceOps, q0, qN, thetas):
    """Batched candidate evaluation: thetas [C, N, d].

    Returns (S [C, N+2], ctrl_t [C, N+2], margins [C], totals [C],
    parts ([C] obstacle sums, [C] ctrl sums, [C] constraint sums)).
    """
    return jax.vmap(lambda th: _evaluate(robot, world, constraints, cfg,
                                         ops, q0, qN, th))(thetas)


def _record(state: SolverState, it, total, parts, cf) -> dict:
    if state.m_total.shape[0] == 0:     # record_metrics off (init_state)
        return {}
    return dict(
        m_total=state.m_total.at[it].set(total),
        m_obstacle=state.m_obstacle.at[it].set(parts[0]),
        m_smooth=state.m_smooth.at[it].set(parts[1]),
        m_constraint=state.m_constraint.at[it].set(parts[2]),
        m_cf=state.m_cf.at[it].set(cf),
    )


def _make_stomp_phases(robot: RobotSpec, cfg: PlannerConfig, ops: DeviceOps,
                       project, sigma0):
    """The two per-scenario halves of one STOMP iteration, split around the
    candidate evaluation so the batched path (`solve_batch`) can evaluate all
    scenarios' candidates between them. `make_step` composes them back into
    the single-scenario step; numerics are shared by construction."""

    def propose(state: SolverState, hyper: HyperParams | None = None):
        """Sample noise, assemble the candidate set, apply per-rollout joint
        limits. Returns (advanced key, cand [1+K+reuse, N, d]); slot 0 is
        the current trajectory (see stomp_step's latency note).
        hyper: optional traced overrides (noise_scale/decay used here)."""
        it = state.iteration
        decay_base = (jnp.float32(cfg.noise.decay) if hyper is None
                      else hyper.decay)
        decay = jnp.power(decay_base, it.astype(jnp.float32))
        sigma = sigma0 * decay
        if hyper is not None:
            sigma = sigma * hyper.noise_scale
        key, k_noise = jax.random.split(state.key)

        eps_new = sample_noise(k_noise, ops.L_sample, sigma, cfg.num_rollouts)
        cand = jnp.concatenate(
            [state.theta[None], state.theta[None] + eps_new,
             state.reuse_theta], axis=0)
        # per-rollout joint limits (see config.rollout_limit_projection)
        if cfg.rollout_limit_projection == "smooth":
            cand = jax.vmap(project)(cand)
        else:
            cand = jnp.where(robot.joint_limited[None, None, :],
                             jnp.clip(cand, robot.joint_lower[None, None, :],
                                      robot.joint_upper[None, None, :]),
                             cand)
        return key, cand

    def apply_update(state: SolverState, key, cand, S_all, ctrl_all, margins,
                     cand_total, parts,
                     hyper: HyperParams | None = None) -> SolverState:
        """Everything after evaluation: A.12 bookkeeping on slot 0, the
        PI² update from slots 1:, and rollout reuse. hyper: optional traced
        overrides (h used here)."""
        it = state.iteration
        eps = cand - state.theta[None]                 # re-centered noise (A.3)

        # --- bookkeeping on the current θ (slot 0) --------------------- A.12
        total0 = cand_total[0]
        cf = margins[0] > cfg.collision_threshold
        cf_count = jnp.where(cf, state.cf_count + 1, jnp.int32(0))
        improved = cf & (total0 < state.best_cost)
        done = ((it + 1 >= cfg.max_iterations)
                | (cf_count >= cfg.max_iterations_after_collision_free))

        # --- PI² update from the noisy candidates (slots 1:) ------- A.9/A.10
        S_used = S_all[1:]
        if cfg.pi2_include_control_cost:
            S_used = S_used + cfg.weights.smoothness * ctrl_all[1:]
        if cfg.pi2_cost_mode == "cumulative":
            # cost-to-go: S(t) = sum_{t'>=t} q(t') (PI^2 proper; see config)
            S_used = jnp.cumsum(S_used[:, ::-1], axis=1)[:, ::-1]
        h = cfg.pi2_h if hyper is None else hyper.h
        delta = pi2.update(eps[1:], S_used[:, 1:-1], ops.M, h)
        theta_new = project(state.theta + delta)

        # rollout reuse: keep the lowest-total-cost noisy candidates (A.3)
        _, keep = jax.lax.top_k(-cand_total[1:], cfg.noise.num_rollouts_reused)
        return state.replace(
            theta=theta_new,
            key=key,
            iteration=it + 1,
            best_theta=jnp.where(improved, state.theta, state.best_theta),
            best_cost=jnp.where(improved, total0, state.best_cost),
            found_cf=state.found_cf | cf,
            cf_count=cf_count,
            done=done,
            reuse_theta=cand[1:][keep],
            **_record(state, it, total0,
                      (parts[0][0], parts[1][0], parts[2][0]), cf),
        )

    return propose, apply_update


def make_step(robot: RobotSpec, world, constraints, cfg: PlannerConfig,
              ops: DeviceOps, q0, qN, hyper: HyperParams | None = None):
    """Build the per-iteration pure function (mode chosen at trace time).
    hyper: optional traced scalar overrides (STOMP mode; see HyperParams)."""
    sigma0 = jnp.asarray(cfg.noise_stddevs(robot.num_joints), jnp.float32)
    project = lambda th: project_limits(th, robot.joint_lower, robot.joint_upper,
                                        robot.joint_limited, ops.Rinv,
                                        cfg.joint_limit_iterations,
                                        cfg.joint_limit_method)
    evaluate = lambda th: _evaluate(robot, world, constraints, cfg, ops, q0, qN, th)

    def finish(state, theta_new, extra_updates):
        S_new, _, margin, total, parts = evaluate(theta_new)
        cf = margin > cfg.collision_threshold
        cf_count = jnp.where(cf, state.cf_count + 1, jnp.int32(0))
        # Track the best *collision-free* trajectory (the reference updates its
        # best only when the iterate is collision-free and returns best-so-far
        # with success=false otherwise, SURVEY A.12).
        improved = cf & (total < state.best_cost)
        it = state.iteration
        new_it = it + 1
        done = ((new_it >= cfg.max_iterations)
                | (cf_count >= cfg.max_iterations_after_collision_free))
        return state.replace(
            theta=theta_new,
            iteration=new_it,
            best_theta=jnp.where(improved, theta_new, state.best_theta),
            best_cost=jnp.where(improved, total, state.best_cost),
            found_cf=state.found_cf | cf,
            cf_count=cf_count,
            done=done,
            **_record(state, it, total, parts, cf),
            **extra_updates,
        )

    propose, apply_update = _make_stomp_phases(robot, cfg, ops, project,
                                               sigma0)

    def stomp_step(state: SolverState) -> SolverState:
        # Latency-critical structure: ONE batched FK+SDF evaluation per
        # iteration. The current θ rides along as zero-noise candidate 0, so
        # its cost/margin (needed for termination, best-tracking, metrics)
        # comes out of the same batch that evaluates the noisy rollouts —
        # instead of a second serial evaluation of the post-update θ as in
        # the reference flow (bookkeeping for iterate i thus happens at the
        # start of iteration i, same values, half the serial latency).
        key, cand = propose(state, hyper)
        # [1+Ktot, N+2] rows; slot 0 is the current trajectory
        S_all, ctrl_all, margins, cand_total, parts = _evaluate_batch(
            robot, world, constraints, cfg, ops, q0, qN, cand)
        return apply_update(state, key, cand, S_all, ctrl_all, margins,
                            cand_total, parts, hyper)

    def chomp_step(state: SolverState) -> SolverState:
        full = full_trajectory(state.theta, q0, qN)
        delta = chomp_delta(ops, robot, world, state.theta, q0, qN, full,
                            cfg.dt, cfg.collision_clearance,
                            cfg.weights.obstacle, cfg.weights.smoothness,
                            cfg.learning_rate,
                            use_pseudo_inverse=cfg.use_pseudo_inverse,
                            pinv_ridge=cfg.pseudo_inverse_ridge_factor,
                            gradient_mode=cfg.chomp_gradient_mode,
                            constraints=constraints,
                            w_constraint=cfg.weights.constraint,
                            w_torque=cfg.weights.torque)
        # direction-preserving update cap (reference joint_update_limit)
        max_d = jnp.max(jnp.abs(delta))
        scale = jnp.minimum(1.0, cfg.chomp_joint_update_limit / (max_d + 1e-12))
        theta_new = project(state.theta + scale * delta)
        return finish(state, theta_new, {})

    def chomp_hmc_step(state: SolverState) -> SolverState:
        # Hamiltonian exploration from the CHOMP-HMC lineage (reference flag
        # use_hamiltonian_monte_carlo, SURVEY A.11 [L]). Velocity-form
        # leapfrog with mass matrix A = c·R where c = ops.cov_scale, chosen
        # so the velocity distribution N(0, temp·A⁻¹) = N(0, temp·R⁻¹/c) is
        # EXACTLY what the smooth sampler draws (v = √temp·L z with
        # L Lᵀ = R⁻¹/c) — the position flow θ̇ = v stays in the span of
        # smooth perturbations. Consistency matters: with A = R instead, the
        # force term A⁻¹∇U is c-times too strong relative to the sampled
        # velocity, proposals explode, and Metropolis rejects everything
        # (observed: 0/125 success on the 7-DOF suite before this fix).
        # Kinetic energy K = ½ vᵀA v = (c/2)·Σ v·(R v). One solver iteration
        # = one HMC proposal of `hmc_leapfrog_steps` leapfrog steps +
        # Metropolis accept at temperature temp (decaying over iterations),
        # annealing toward pure descent.
        from tpustomp.engine.chomp import chomp_gradient

        eta = jnp.float32(cfg.hmc_step_size)
        inv_mass = jnp.float32(1.0 / ops.cov_scale)
        temp = (cfg.hmc_temperature
                * jnp.power(jnp.float32(cfg.noise.decay),
                            state.iteration.astype(jnp.float32)))
        key, k_mom, k_acc = jax.random.split(state.key, 3)

        def U(th):
            return _evaluate(robot, world, constraints, cfg, ops, q0, qN,
                             th)[3]

        def gradU(th):
            return chomp_gradient(ops, robot, world, th, q0, qN,
                                  full_trajectory(th, q0, qN), cfg.dt,
                                  cfg.collision_clearance,
                                  cfg.weights.obstacle,
                                  cfg.weights.smoothness,
                                  use_pseudo_inverse=cfg.use_pseudo_inverse,
                                  pinv_ridge=cfg.pseudo_inverse_ridge_factor,
                                  gradient_mode=cfg.chomp_gradient_mode,
                                  constraints=constraints,
                                  w_constraint=cfg.weights.constraint,
                                  w_torque=cfg.weights.torque)

        # see chomp_delta: reduced-precision matmuls break the R/R⁻¹
        # cancellations this integrator depends on
        _hi = jax.lax.Precision.HIGHEST

        def kinetic(v):
            Rv = jnp.matmul(ops.R, v, precision=_hi)
            return 0.5 * jnp.float32(ops.cov_scale) * jnp.sum(v * Rv)

        v0 = sample_noise(k_mom, ops.L_sample,
                          jnp.sqrt(temp) * jnp.ones((robot.num_joints,),
                                                    jnp.float32), 1)[0]
        th0 = state.theta

        def leapfrog(_, carry):
            th, v, g = carry
            v = v - (0.5 * eta * inv_mass) * jnp.matmul(ops.Rinv, g,
                                                        precision=_hi)
            dth = eta * v
            if not cfg.hmc_metropolis:
                # heuristic mode: trust-region cap each position step, like
                # the plain CHOMP update (no accept test to preserve)
                max_d = jnp.max(jnp.abs(dth))
                dth = dth * jnp.minimum(
                    1.0, cfg.chomp_joint_update_limit / (max_d + 1e-12))
            th = th + dth
            g = gradU(th)
            v = v - (0.5 * eta * inv_mass) * jnp.matmul(ops.Rinv, g,
                                                        precision=_hi)
            return th, v, g

        th1, v1, _ = jax.lax.fori_loop(
            0, cfg.hmc_leapfrog_steps, leapfrog, (th0, v0, gradU(th0)))
        if cfg.hmc_metropolis:
            # Known, accepted inefficiency: U(th0) equals the previous
            # iteration's accepted U(th1) and could be carried in
            # SolverState (~1 extra full evaluation per iteration,
            # ~1/(hmc_leapfrog_steps+1) of the step). Not worth widening
            # the state pytree (checkpoint format, every init/carry site)
            # for an optional exploration mode.
            H0 = U(th0) + kinetic(v0)
            H1 = U(th1) + kinetic(v1)
            accept = (jax.random.uniform(k_acc)
                      < jnp.exp(-(H1 - H0) / jnp.maximum(temp, 1e-6)))
            th1 = jnp.where(accept, th1, th0)
        theta_new = project(th1)
        return finish(state, theta_new, dict(key=key))

    if cfg.mode == "stomp":
        return stomp_step
    return chomp_hmc_step if cfg.use_hamiltonian_monte_carlo else chomp_step


def init_state(robot: RobotSpec, cfg: PlannerConfig, q0, qN,
               key: jax.Array, theta0: jnp.ndarray | None = None) -> SolverState:
    """theta0: optional warm start (MPC replanning); default min-jerk (A.1)."""
    N = cfg.num_timesteps
    d = robot.num_joints
    if theta0 is None:
        theta0 = min_jerk_init(q0, qN, N)
    # with record_metrics off the per-iteration series are zero-length:
    # _record's scatters become dropped-OOB no-ops and the while-loop carry
    # stops hauling 5×[max_iterations] buffers per scenario
    n_m = cfg.max_iterations if cfg.record_metrics else 0
    zeros_m = jnp.zeros((n_m,), jnp.float32)
    return SolverState(
        theta=theta0,
        key=key,
        iteration=jnp.int32(0),
        best_theta=theta0,
        best_cost=jnp.float32(jnp.inf),
        found_cf=jnp.bool_(False),
        cf_count=jnp.int32(0),
        done=jnp.bool_(False),
        reuse_theta=jnp.broadcast_to(
            theta0, (cfg.noise.num_rollouts_reused, N, d)),
        m_total=zeros_m, m_obstacle=zeros_m, m_smooth=zeros_m,
        m_constraint=zeros_m, m_cf=jnp.zeros((n_m,), bool),
    )


def run_until(robot: RobotSpec, world, constraints, cfg: PlannerConfig,
              ops: DeviceOps, q0, qN, state: SolverState,
              it_limit, hyper: HyperParams | None = None) -> SolverState:
    """Advance the solver until done or `it_limit` iterations (traced bound).

    Used by the host replan wrapper to enforce the wall-clock
    planning_time_limit between device chunks (reference failsafe, SURVEY §6).
    """
    step = make_step(robot, world, constraints, cfg, ops, q0, qN, hyper)
    return jax.lax.while_loop(
        lambda s: (~s.done) & (s.iteration < it_limit), step, state)


def finalize(robot: RobotSpec, world, constraints, cfg: PlannerConfig,
             ops: DeviceOps, q0, qN, state: SolverState) -> Solution:
    """Assemble the Solution from a (possibly budget-exhausted) state.

    Returns the best collision-free trajectory if any was found; otherwise
    the final iterate with success=False (reference failsafe, SURVEY §6).
    """
    ret_theta = jnp.where(state.found_cf, state.best_theta, state.theta)
    _, _, margin, ret_total, _ = _evaluate(robot, world, constraints, cfg, ops,
                                           q0, qN, ret_theta)
    dt = cfg.dt
    times = jnp.arange(cfg.num_timesteps + 2, dtype=jnp.float32) * dt
    metrics = IterationMetrics(
        total_cost=state.m_total, obstacle_cost=state.m_obstacle,
        smoothness_cost=state.m_smooth, constraint_cost=state.m_constraint,
        collision_free=state.m_cf,
    ) if cfg.record_metrics else None
    return Solution(
        trajectory=full_trajectory(ret_theta, q0, qN),
        times=times,
        success=state.found_cf & (margin > cfg.collision_threshold),
        cost=ret_total,
        iterations=state.iteration,
        metrics=metrics,
    )


def solve(robot: RobotSpec, world, constraints, cfg: PlannerConfig,
          ops: DeviceOps, q0: jnp.ndarray, qN: jnp.ndarray,
          key: jax.Array, theta0: jnp.ndarray | None = None,
          hyper: HyperParams | None = None) -> Solution:
    """Run one full planning query to termination (A.12). Pure; jit/vmap-able.

    hyper: optional traced scalar hyperparameter overrides (HyperParams)."""
    # continuous joints take the shortest angular path to the goal
    # (reference: stomp_utils.h angle normalization; engine/trajectory.py)
    qN = wrap_goal(q0, qN, robot.joint_limited)
    state = init_state(robot, cfg, q0, qN, key, theta0)
    state = run_until(robot, world, constraints, cfg, ops, q0, qN, state,
                      jnp.int32(cfg.max_iterations), hyper)
    return finalize(robot, world, constraints, cfg, ops, q0, qN, state)


def _world_axes(world, world_batched: bool):
    """vmap in_axes prefix for a possibly per-scenario world.

    world_batched=True means the analytic/overlay leaves carry a leading
    scenario axis [B, ...] (MPC moving obstacles — each scenario sees its
    own world). A CompositeWorld's grid stays shared/replicated; only the
    overlay is per-scenario."""
    from tpustomp.world.sdf import CompositeWorld

    if not world_batched:
        return None
    if isinstance(world, CompositeWorld):
        return CompositeWorld(grid=None, overlay=0)
    return 0


def make_step_batch(robot: RobotSpec, world, constraints, cfg: PlannerConfig,
                    ops: DeviceOps, Q0, QN, world_batched: bool = False,
                    hyper: HyperParams | None = None):
    """One STOMP iteration over a leading scenario axis (Q0/QN: [B, d]).

    Per-scenario numerics are identical to `make_step`'s stomp_step — both
    compose the same `_make_stomp_phases` helpers — so a scenario's result
    matches `jax.vmap(solve)` (tested). Unlike vmap(solve), whose
    while-loop runs each scenario's own trip count under a batched
    predicate, this step is the body of ONE loop over the whole batch;
    finished scenarios are frozen by a select (see `step`).

    world_batched: the world's analytic/overlay leaves carry a leading
    scenario axis (per-scenario moving obstacles, MPC).
    """
    sigma0 = jnp.asarray(cfg.noise_stddevs(robot.num_joints), jnp.float32)
    project = lambda th: project_limits(th, robot.joint_lower,
                                        robot.joint_upper,
                                        robot.joint_limited, ops.Rinv,
                                        cfg.joint_limit_iterations,
                                        cfg.joint_limit_method)
    propose, apply_update = _make_stomp_phases(robot, cfg, ops, project,
                                               sigma0)
    hy_ax = None if hyper is None else 0
    propose_v = jax.vmap(propose, in_axes=(0, hy_ax))
    apply_v = jax.vmap(apply_update,
                       in_axes=(0, 0, 0, 0, 0, 0, 0, 0, hy_ax))
    world_axes = _world_axes(world, world_batched)
    evaluate_all = jax.vmap(
        lambda th, a, b, w: _evaluate_batch(robot, w, constraints, cfg, ops,
                                            a, b, th),
        in_axes=(0, 0, 0, world_axes))

    def step(stateB: SolverState) -> SolverState:
        # named scopes label the step's stages in device traces
        # (bench/trace_config4.py)
        with jax.named_scope("propose"):
            keys, cands = propose_v(stateB, hyper)
        with jax.named_scope("evaluate"):
            outs = evaluate_all(cands, Q0, QN, world)
        with jax.named_scope("update"):
            new = apply_v(stateB, keys, cands, *outs, hyper)
            # freeze finished scenarios — the same per-element select that
            # jax.vmap(lax.while_loop) applies, so results match vmap(solve)
            B = stateB.done.shape[0]
            mask = lambda o, n: jnp.where(
                stateB.done.reshape((B,) + (1,) * (n.ndim - 1)), o, n)
            return jax.tree.map(mask, stateB, new)

    return step


def solve_batch(robot: RobotSpec, world, constraints, cfg: PlannerConfig,
                ops: DeviceOps, Q0: jnp.ndarray, QN: jnp.ndarray,
                keys: jax.Array, theta0: jnp.ndarray | None = None,
                world_batched: bool = False,
                hyper: HyperParams | None = None) -> Solution:
    """Batched planning (BASELINE config 4): B scenarios to termination.

    Per-scenario results match `jax.vmap(solve)` (tested); all scenarios
    advance in one while-loop (see make_step_batch). STOMP mode only —
    CHOMP/HMC callers use vmap(solve).

    world_batched=True: world analytic/overlay leaves carry a leading [B]
    scenario axis (per-scenario worlds — MPC moving obstacles).
    """
    assert cfg.mode == "stomp", "solve_batch is the STOMP batched path"
    QN, init = _init_batch(robot, cfg, Q0, QN, keys, theta0)
    step = make_step_batch(robot, world, constraints, cfg, ops, Q0, QN,
                           world_batched=world_batched, hyper=hyper)
    stateB = jax.lax.while_loop(lambda s: jnp.any(~s.done), step, init)
    return _finalize_batch(robot, world, constraints, cfg, ops, Q0, QN,
                           stateB, world_batched)


def _init_batch(robot: RobotSpec, cfg: PlannerConfig, Q0, QN, keys, theta0):
    """Wrap goals + build the initial batched SolverState. Returns (QN, state)."""
    QN = jax.vmap(lambda a, b: wrap_goal(a, b, robot.joint_limited))(Q0, QN)
    if theta0 is None:
        init = jax.vmap(lambda a, b, k: init_state(robot, cfg, a, b, k)
                        )(Q0, QN, keys)
    else:
        init = jax.vmap(lambda a, b, k, t: init_state(robot, cfg, a, b, k, t)
                        )(Q0, QN, keys, theta0)
    return QN, init


def _finalize_batch(robot: RobotSpec, world, constraints, cfg: PlannerConfig,
                    ops: DeviceOps, Q0, QN, stateB, world_batched: bool):
    world_axes = _world_axes(world, world_batched)
    return jax.vmap(
        lambda a, b, s, w: finalize(robot, w, constraints, cfg, ops, a, b, s),
        in_axes=(0, 0, 0, world_axes),
    )(Q0, QN, stateB, world)


def _gather_world(world, idx, world_batched: bool):
    """Row-select a (possibly per-scenario) world along the scenario axis."""
    from tpustomp.world.sdf import CompositeWorld

    if not world_batched:
        return world
    if isinstance(world, CompositeWorld):
        return CompositeWorld(
            grid=world.grid,
            overlay=jax.tree.map(lambda x: x[idx], world.overlay))
    return jax.tree.map(lambda x: x[idx], world)


@jax.jit
def _scatter_rows(buf, rows, idx):
    # mode="drop": callers point pad rows at an out-of-bounds index so the
    # scatter ignores them — duplicate in-bounds writes (whose winner is
    # undefined in JAX) never occur, whatever the pad rows computed
    return jax.tree.map(lambda b, x: b.at[idx].set(x, mode="drop"),
                        buf, rows)


@jax.jit
def _gather_rows(tree, idx):
    return jax.tree.map(lambda x: x[idx], tree)


@functools.lru_cache(maxsize=32)
def _jitted_chunk_batch(cfg: PlannerConfig, world_batched: bool, chunk: int):
    """Advance a batched state by up to `chunk` iterations (or until all
    scenarios are done). One compiled program per (cfg, bucket-shape)."""

    def run(robot, world, constraints, ops, Q0, QN, stateB):
        step = make_step_batch(robot, world, constraints, cfg, ops, Q0, QN,
                               world_batched=world_batched)

        def body(carry):
            s, i = carry
            return step(s), i + jnp.int32(1)

        s, _ = jax.lax.while_loop(
            lambda c: jnp.any(~c[0].done) & (c[1] < chunk),
            body, (stateB, jnp.int32(0)))
        return s

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _jitted_init_batch(cfg: PlannerConfig, with_theta0: bool):
    if with_theta0:
        return jax.jit(lambda robot, Q0, QN, keys, theta0: _init_batch(
            robot, cfg, Q0, QN, keys, theta0))
    return jax.jit(lambda robot, Q0, QN, keys: _init_batch(
        robot, cfg, Q0, QN, keys, None))


@functools.lru_cache(maxsize=32)
def _jitted_finalize_batch(cfg: PlannerConfig, world_batched: bool):
    return jax.jit(lambda robot, world, constraints, ops, Q0, QN, stateB:
                   _finalize_batch(robot, world, constraints, cfg, ops,
                                   Q0, QN, stateB, world_batched))


def solve_batch_compacted(robot: RobotSpec, world, constraints,
                          cfg: PlannerConfig, ops: DeviceOps,
                          Q0: jnp.ndarray, QN: jnp.ndarray, keys: jax.Array,
                          theta0: jnp.ndarray | None = None,
                          world_batched: bool = False,
                          chunk: int | None = None,
                          min_bucket: int | None = None) -> Solution:
    """`solve_batch` with host-side compaction of finished scenarios.

    The pure batched path runs its `while_loop` until ALL scenarios finish,
    so frozen (done) scenarios keep evaluating their full candidate set every
    iteration in the convergence tail. This variant
    runs the same per-scenario step in chunks of `chunk` iterations; between
    chunks the host reads the done mask, scatters finished rows into a
    full-batch result buffer, and re-dispatches only the still-active
    scenarios, padded up to the next power-of-two bucket (each bucket size
    compiles once; `min_bucket` floors the bucket so the device stays
    well-fed). Pad rows are duplicates of an active row, but their results
    are NEVER merged: the done-mask merge reads only the non-pad prefix and
    the row scatter points pads out of bounds (mode="drop"), so nothing
    depends on a pad row evolving identically to its original.

    Per-scenario results match `solve_batch` to roundoff: gather/scatter
    permute whole rows, but XLA may tile batched ops differently at
    different bucket shapes, so values agree to ULPs (measured ≤3e-8;
    success/iteration counts identical — tested in test_solve_batch.py)
    rather than bitwise. Host orchestration means
    this function is NOT jittable/vmappable — it is the production entry for
    large single-process batches (api/plan.plan_batch routes here via
    cfg.batch_compaction); sharded and in-jit callers use `solve_batch`.
    """
    assert cfg.mode == "stomp", "compaction is the STOMP batched path"
    chunk = cfg.compaction_chunk if chunk is None else chunk
    min_bucket = cfg.compaction_min_bucket if min_bucket is None else min_bucket
    B = Q0.shape[0]

    if theta0 is None:
        QN, buf = _jitted_init_batch(cfg, False)(robot, Q0, QN, keys)
    else:
        QN, buf = _jitted_init_batch(cfg, True)(robot, Q0, QN, keys, theta0)
    runner = _jitted_chunk_batch(cfg, world_batched, chunk)

    Q0d, QNd = jnp.asarray(Q0), jnp.asarray(QN)
    cur_idx = np.arange(B)
    cur_valid = B  # rows [:cur_valid] of cur_idx are real; the rest are pads
    cur_state, cur_Q0, cur_QN, cur_world = buf, Q0d, QNd, world
    global_done = np.zeros(B, bool)

    while True:
        cur_state = runner(robot, cur_world, constraints, ops,
                           cur_Q0, cur_QN, cur_state)
        done = np.asarray(cur_state.done)
        full_pass = cur_idx.size == B and bool((cur_idx == np.arange(B)).all())
        if full_pass:
            buf = cur_state
        else:
            # pads scatter out of bounds (dropped) — see _scatter_rows
            scatter_idx = np.concatenate(
                [cur_idx[:cur_valid],
                 np.full(cur_idx.size - cur_valid, B, cur_idx.dtype)])
            buf = _scatter_rows(buf, cur_state, jnp.asarray(scatter_idx))
        global_done[cur_idx[:cur_valid]] = done[:cur_valid]
        active = np.flatnonzero(~global_done)
        if active.size == 0:
            break
        bucket = max(min_bucket, 1 << int(np.ceil(np.log2(active.size))))
        if bucket >= cur_idx.size:
            continue  # no compaction win at this size; keep running as-is
        sel = np.concatenate(
            [active, np.repeat(active[:1], bucket - active.size)])
        sel_dev = jnp.asarray(sel)
        cur_state = _gather_rows(buf, sel_dev)
        cur_Q0, cur_QN = Q0d[sel_dev], QNd[sel_dev]
        cur_world = _gather_world(world, sel_dev, world_batched)
        cur_idx = sel
        cur_valid = active.size

    return _jitted_finalize_batch(cfg, world_batched)(
        robot, world, constraints, ops, Q0d, QNd, buf)


def select_best(sols: Solution) -> Solution:
    """Pick one Solution from a leading restart axis: any successful one
    beats every failed one; ties broken by lowest total cost."""
    cost = jnp.minimum(sols.cost, jnp.float32(1e18))
    score = jnp.where(sols.success, cost, cost + jnp.float32(1e20))
    idx = jnp.argmin(score)
    return jax.tree.map(lambda x: x[idx], sols)


def solve_best_of(robot: RobotSpec, world, constraints, cfg: PlannerConfig,
                  ops: DeviceOps, q0: jnp.ndarray, qN: jnp.ndarray,
                  key: jax.Array, theta0: jnp.ndarray | None = None
                  ) -> Solution:
    """`solve` with `cfg.num_restarts` independent noise streams, best kept.

    The reference planner's recourse after a failed plan was to call the
    `GetMotionPlan` service again with a fresh seed; here the restarts are a
    vmapped axis evaluated concurrently on-chip, so extra attempts cost
    parallelism (which the chip has idle at batch 1) instead of latency.
    """
    if cfg.num_restarts <= 1:
        return solve(robot, world, constraints, cfg, ops, q0, qN, key, theta0)
    keys = jax.random.split(key, cfg.num_restarts)
    sols = jax.vmap(
        lambda k: solve(robot, world, constraints, cfg, ops, q0, qN, k,
                        theta0))(keys)
    return select_best(sols)
