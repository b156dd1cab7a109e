"""solver.solve_batch (one while-loop over the whole batch, finished
scenarios frozen by a select) against jax.vmap(solver.solve) (each scenario
its own loop) on the scenes that stress the batched step: staggered
convergence, per-scenario worlds, grid and composite worlds, traced
hyperparameters, constraints and the torque cost."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpustomp.api.config import CostWeights, NoiseConfig, PlannerConfig
from tpustomp.costs.constraints import OrientationConstraint
from tpustomp.dynamics.device import device_ops
from tpustomp.engine import solver
from tpustomp.robot import model
from tpustomp.world.sdf import AnalyticWorld, CompositeWorld

B = 6


def _cfg(**kw):
    base = dict(
        num_timesteps=20, duration=1.0, num_rollouts=8, max_iterations=30,
        noise=NoiseConfig(stddev=0.25, decay=0.99, num_rollouts_reused=2),
        weights=CostWeights(obstacle=1.0, smoothness=0.05),
        collision_clearance=0.05, max_iterations_after_collision_free=2,
        record_metrics=False)
    base.update(kw)
    return PlannerConfig(**base)


def _planar_problems(seed=11):
    rng = np.random.default_rng(seed)
    Q0 = jnp.asarray(rng.uniform(-0.3, 0.3, (B, 2)), jnp.float32)
    QN = jnp.asarray(np.pi / 2 + rng.uniform(-1.0, 1.0, (B, 2)), jnp.float32)
    return Q0, QN


def _arm_problems(seed=3):
    rng = np.random.default_rng(seed)
    Q0 = np.tile([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], (B, 1))
    QN = np.tile([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], (B, 1))
    return (jnp.asarray(Q0 + rng.uniform(-0.05, 0.05, Q0.shape), jnp.float32),
            jnp.asarray(QN + rng.uniform(-0.05, 0.05, QN.shape), jnp.float32))


def _per_scenario_spheres(seed=4):
    rng = np.random.default_rng(seed)
    return AnalyticWorld(
        sphere_center=jnp.asarray(
            np.c_[rng.uniform(0.9, 1.4, (B, 1)), rng.uniform(0.3, 0.9, (B, 1)),
                  np.zeros((B, 1))][:, None, :], jnp.float32),
        sphere_radius=jnp.asarray(rng.uniform(0.2, 0.35, (B, 1)),
                                  jnp.float32),
        box_center=jnp.zeros((B, 0, 3), jnp.float32),
        box_half=jnp.zeros((B, 0, 3), jnp.float32))


def _planar_grid():
    from tpustomp.world.edt import grid_from_analytic

    return grid_from_analytic(
        AnalyticWorld.make(spheres=[((1.2, 0.6, 0.0), 0.3)]),
        origin=(-2.2, -2.2, -0.3), shape=(45, 45, 7), resolution=0.1)


def _scene(name):
    """(robot, world, constraints, cfg, Q0, QN, world_batched, hyper)."""
    planar = model.planar_2r()
    sphere = AnalyticWorld.make(spheres=[((1.2, 0.6, 0.0), 0.3)])
    if name == "staggered_done":
        return (planar, sphere, None, _cfg(), *_planar_problems(), False,
                None)
    if name == "per_scenario_worlds":
        return (planar, _per_scenario_spheres(), None, _cfg(),
                *_planar_problems(), True, None)
    if name == "grid":
        return (planar, _planar_grid(), None, _cfg(), *_planar_problems(),
                False, None)
    if name == "composite_per_scenario_overlay":
        world = CompositeWorld(grid=_planar_grid(),
                               overlay=_per_scenario_spheres(seed=9))
        return (planar, world, None, _cfg(), *_planar_problems(), True, None)
    if name == "hyper":
        hyper = solver.HyperParams(
            noise_scale=jnp.asarray([1.0, 0.75, 1.25, 1.0, 0.5, 1.5],
                                    jnp.float32),
            h=jnp.asarray([10.0, 6.0, 15.0, 10.0, 20.0, 8.0], jnp.float32),
            decay=jnp.asarray([0.995, 1.0, 0.99, 0.995, 1.0, 0.98],
                              jnp.float32))
        return (planar, sphere, None, _cfg(), *_planar_problems(), False,
                hyper)
    if name == "constraints":
        cons = OrientationConstraint.make(axis_local=(0, 0, 1),
                                          target_world=(0, 0, 1),
                                          tolerance=0.3, weight=1.0)
        cfg = _cfg(num_timesteps=16, duration=1.5, max_iterations=12,
                   noise=NoiseConfig(stddev=0.15, decay=0.99,
                                     num_rollouts_reused=2),
                   weights=CostWeights(obstacle=1.0, smoothness=0.05,
                                       constraint=1.0))
        world = AnalyticWorld.make(boxes=[((0.6, 0.0, 0.2),
                                           (0.45, 0.6, 0.25))])
        return (model.arm_7dof(), world, cons, cfg, *_arm_problems(), False,
                None)
    if name == "torque":
        cfg = _cfg(weights=CostWeights(obstacle=1.0, smoothness=0.05,
                                       torque=0.005))
        return (model.planar_2r(masses=(1.0, 1.0)), sphere, None, cfg,
                *_planar_problems(), False, None)
    raise ValueError(name)


# (rtol, atol) on trajectories. The RNE torque stage's vmapped 3x3 products
# fuse differently in the two layouts, so that scene agrees to roundoff
# (the same bound the repo held the torque path to before).
TRAJ_TOL = {"torque": (1e-4, 1e-4)}

SCENES = ["staggered_done", "per_scenario_worlds", "grid",
          "composite_per_scenario_overlay", "hyper", "constraints",
          "torque"]


@pytest.mark.parametrize("name", SCENES)
def test_solve_batch_matches_vmap_solve(name):
    robot, world, cons, cfg, Q0, QN, world_batched, hyper = _scene(name)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    keys = jax.random.split(jax.random.PRNGKey(2), B)

    got = jax.jit(lambda r, w, a, b, k, hy: solver.solve_batch(
        r, w, cons, cfg, ops, a, b, k, world_batched=world_batched,
        hyper=hy))(robot, world, Q0, QN, keys, hyper)

    w_ax = solver._world_axes(world, world_batched)
    h_ax = None if hyper is None else 0
    ref = jax.jit(jax.vmap(
        lambda a, b, k, w, hy: solver.solve(robot, w, cons, cfg, ops, a, b,
                                            k, hyper=hy),
        in_axes=(0, 0, 0, w_ax, h_ax)))(Q0, QN, keys, world, hyper)

    its = np.asarray(ref.iterations)
    if name == "staggered_done":
        assert len(set(its.tolist())) > 1, "need staggered convergence"
    np.testing.assert_array_equal(np.asarray(got.success),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(np.asarray(got.iterations), its)
    rtol, atol = TRAJ_TOL.get(name, (1e-5, 1e-6))
    np.testing.assert_allclose(np.asarray(got.trajectory),
                               np.asarray(ref.trajectory),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost),
                               rtol=max(rtol, 1e-5), atol=max(atol, 1e-5))
