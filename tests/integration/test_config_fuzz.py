"""Config-surface fuzz: random valid PlannerConfigs through the public API.

The parameter surface (SURVEY §7.3) is ~20 interacting knobs; the dedicated
tests cover each feature's contract in isolation, this file covers the
CROSS-PRODUCT: a deterministic sample of random-but-valid configurations
must all solve a tiny problem without violating the solver's invariants —
finite costs, exactly preserved endpoints (A.1/A.10), success implying a
real collision margin (A.12), joint limits respected when enabled (A.7),
and metrics arrays consistent with record_metrics. Shapes are tiny so the
whole sweep stays CPU-fast; what is being exercised is trace/compile-time
feature composition, not numerics (the oracle-parity tests own those).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpustomp.api.config import (CostWeights, NoiseConfig, PlannerConfig,
                                 SmoothnessConfig)
from tpustomp.api.plan import plan
from tpustomp.api.problem import ProblemSpec
from tpustomp.robot import model
from tpustomp.world.sdf import AnalyticWorld


def _random_config(rng: np.random.Generator) -> tuple[PlannerConfig, bool]:
    """A random valid config, and whether to also drive it through the
    batched path (plan_batch)."""
    mode = rng.choice(["stomp", "stomp", "stomp", "chomp"])  # stomp-weighted
    smoothness = SmoothnessConfig(
        weight_velocity=float(rng.choice([0.0, 0.5])),
        weight_acceleration=1.0,
        weight_jerk=float(rng.choice([0.0, 0.05])),
        stencil=str(rng.choice(["fd3", "fd5", "fd7"])),
        ridge_factor=float(rng.choice([0.0, 1e-6])),
    )
    noise = NoiseConfig(
        stddev=float(rng.uniform(0.1, 0.3)),
        decay=float(rng.choice([1.0, 0.99])),
        num_rollouts_reused=int(rng.choice([0, 2, 4])),
    )
    batched = bool(rng.choice([False, True]))
    cfg = PlannerConfig(
        num_timesteps=int(rng.choice([10, 14])),
        duration=float(rng.choice([2.0, 5.0])),
        max_iterations=25,
        max_iterations_after_collision_free=int(rng.choice([1, 3])),
        num_restarts=int(rng.choice([1, 2])),
        num_rollouts=int(rng.choice([6, 10])),
        noise=noise,
        pi2_h=float(rng.choice([10.0, 20.0])),
        pi2_cost_mode=str(rng.choice(["local", "cumulative"])),
        pi2_include_control_cost=bool(rng.choice([False, True])),
        mode=str(mode),
        smoothness=smoothness,
        weights=CostWeights(obstacle=1.0, smoothness=0.1,
                            torque=float(rng.choice([0.0, 0.001]))),
        joint_limit_method=str(rng.choice(["jacobi", "sequential"])),
        joint_limit_iterations=int(rng.choice([2, 5])),
        record_metrics=bool(rng.choice([False, True])),
    )
    return cfg, batched


SEEDS = list(range(10))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_config_solves_with_invariants(seed):
    rng = np.random.default_rng(seed)
    cfg, batched = _random_config(rng)
    robot = model.planar_2r(masses=(1.0, 1.0))  # masses: torque-cost ready
    world = AnalyticWorld.make(spheres=[((1.0, 0.8, 0.0), 0.2)])
    q0 = jnp.zeros(2)
    qN = jnp.array([2.0, -0.8])
    sol = plan(robot, world, ProblemSpec(q0=q0, qN=qN), cfg,
               key=jax.random.PRNGKey(seed))

    traj = np.asarray(sol.trajectory)
    assert np.isfinite(traj).all(), cfg
    assert np.isfinite(float(sol.cost)), cfg
    # endpoints exactly preserved through every feature combination
    np.testing.assert_allclose(traj[0], np.asarray(q0), atol=1e-6)
    np.testing.assert_allclose(traj[-1], np.asarray(qN), atol=1e-6)
    # joint limits respected where enforced (planar_2r limits are wide;
    # check the invariant anyway — the projection must never overshoot)
    lim = np.asarray(robot.joint_limited)
    lo = np.asarray(robot.joint_lower) - 1e-5
    hi = np.asarray(robot.joint_upper) + 1e-5
    if lim.any():
        inner = traj[1:-1][:, lim]
        assert (inner >= lo[lim]).all() and (inner <= hi[lim]).all(), cfg
    # metrics arrays present iff requested (zero-length-carry contract)
    if cfg.record_metrics:
        assert sol.metrics is not None
        assert np.isfinite(
            np.asarray(sol.metrics.total_cost)[:int(sol.iterations)]).all()
    else:
        assert sol.metrics is None
    # iteration count inside the budget
    assert 0 < int(sol.iterations) <= cfg.max_iterations

    # STOMP configs drawn for it ALSO run the batched path (one solver
    # loop over the whole batch, solver.solve_batch) under the same
    # invariants.
    if batched and cfg.mode == "stomp":
        from tpustomp.api.plan import plan_batch

        probB = ProblemSpec(q0=jnp.stack([q0, q0 + 0.01]),
                            qN=jnp.stack([qN, qN - 0.01]))
        solB = plan_batch(robot, world, probB, cfg,
                          keys=jax.random.split(jax.random.PRNGKey(seed), 2))
        trajB = np.asarray(solB.trajectory)
        assert np.isfinite(trajB).all(), cfg
        np.testing.assert_allclose(trajB[:, 0], np.asarray(probB.q0),
                                   atol=1e-6)
        np.testing.assert_allclose(trajB[:, -1], np.asarray(probB.qN),
                                   atol=1e-6)


def test_fuzz_covers_both_modes_and_impls():
    """Guard the sweep's coverage: the sampled set must include both solver
    modes, STOMP configs on the batched path, and both limit methods (so a
    refactor of _random_config can't silently shrink what the fuzz
    exercises)."""
    drawn = [_random_config(np.random.default_rng(s)) for s in SEEDS]
    cfgs = [c for c, _ in drawn]
    assert {c.mode for c in cfgs} == {"stomp", "chomp"}
    assert any(b and c.mode == "stomp" for c, b in drawn)
    assert any(b and c.mode == "stomp" and c.weights.torque > 0.0
               for c, b in drawn)
    assert {c.joint_limit_method for c in cfgs} == {"jacobi", "sequential"}
    assert {c.smoothness.stencil for c in cfgs} == {"fd3", "fd5", "fd7"}
