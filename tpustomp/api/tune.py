"""Hyperparameter auto-tuning as a batched solve (public API).

Reference equivalent: none — the reference's exploration knobs
(noise_stddev, decay, the PI² h constant baked into policy_improvement.cpp;
SURVEY §7.3) were hand-set per robot in YAML, and evaluating a setting
meant re-running the planner problem by problem. Here tuning IS planning:
the traced hyperparameters (engine/solver.HyperParams) ride the scenario
axis, so an entire (noise_scale × h × decay) grid over a problem set is ONE
compile and ONE batched solve, and re-evaluating a *different* grid of the
same size re-dispatches warm with zero recompilation (bench/stomp_sweep.py
drives this machinery).

    result = tune(robot, world, problems, cfg,
                  noise_scale=(0.7, 1.0, 1.5, 2.0),
                  h=(5.0, 10.0, 20.0), decay=(0.99, 1.0))
    best_cfg = result.best_config(cfg)     # PlannerConfig with winners baked
    result.table                           # per-cell success/iterations

Selection: highest success rate, ties broken by fewest mean iterations
(faster convergence at equal reliability), then by lowest mean cost.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np

import jax
import jax.numpy as jnp

from tpustomp.api.config import PlannerConfig
from tpustomp.api.problem import ProblemSpec
from tpustomp.dynamics.device import device_ops
from tpustomp.engine import solver


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of a tune() grid. `table` maps cell label -> metrics dict;
    `best` is (noise_scale, h, decay) of the winning cell."""

    best: tuple
    table: dict

    def best_config(self, cfg: PlannerConfig) -> PlannerConfig:
        """cfg with the winning cell baked in as static values.

        dataclasses.replace (not a rebuild) so every NoiseConfig field the
        cells inherited from cfg — stddev_per_joint (which noise_stddevs
        prefers over the scalar), num_rollouts_reused — carries into the
        baked config; a rebuild silently reverted per-joint sigma ratios,
        so the "tuned" config did not reproduce the winning cell."""
        scale, h, decay = self.best
        noise = dataclasses.replace(
            cfg.noise,
            stddev=float(cfg.noise.stddev) * scale,
            stddev_per_joint=tuple(
                s * scale for s in cfg.noise.stddev_per_joint),
            decay=decay)
        return cfg.replace(noise=noise, pi2_h=h)


def tune(robot, world, problem: ProblemSpec,
         cfg: PlannerConfig = PlannerConfig(),
         noise_scale=(0.7, 1.0, 1.5, 2.0), h=(5.0, 10.0, 20.0),
         decay=(0.995, 1.0), keys=None, constraints=None) -> TuneResult:
    """Grid-search STOMP exploration hyperparameters over a problem batch.

    problem.q0/qN: [n, d] — the evaluation set (e.g. sampled hard problems
    for the deployment scene). The full grid of G = |noise_scale|·|h|·
    |decay| cells runs as one batched solve of G·n scenarios; every cell
    sees the same problems and the same per-problem noise streams, so
    cells differ only in hyperparameters. STOMP mode only (CHOMP's knobs
    are its learning rate/weights — static by nature).
    """
    assert cfg.mode == "stomp", "tune() sweeps STOMP exploration knobs"
    q0s = np.asarray(problem.q0, np.float32)
    qNs = np.asarray(problem.qN, np.float32)
    n = q0s.shape[0]
    cells = list(itertools.product(noise_scale, h, decay))
    G = len(cells)
    # Resolve the goal tolerance band exactly as plan_batch will at
    # deployment (no-op for exact goals) — otherwise cells are scored on a
    # harder problem distribution than the tuned config actually solves.
    from tpustomp.api.plan import _apply_goal_tolerance
    qNs = np.asarray(_apply_goal_tolerance(
        robot, world, problem, cfg, jnp.asarray(q0s), jnp.asarray(qNs),
        batched=True), np.float32)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    if keys is None:
        keys = jax.random.split(jax.random.PRNGKey(0), n)

    Q0 = jnp.asarray(np.tile(q0s, (G, 1)))
    QN = jnp.asarray(np.tile(qNs, (G, 1)))
    keys_g = jnp.tile(jnp.asarray(keys), (G, 1))
    hyper = solver.HyperParams(
        noise_scale=jnp.repeat(
            jnp.asarray([c[0] for c in cells], jnp.float32), n),
        h=jnp.repeat(jnp.asarray([c[1] for c in cells], jnp.float32), n),
        decay=jnp.repeat(
            jnp.asarray([c[2] for c in cells], jnp.float32), n))

    sol = _tune_solve(cfg, constraints is not None)(
        robot, world, constraints, ops, Q0, QN, keys_g, hyper)
    succ = np.asarray(sol.success).reshape(G, n)
    iters = np.asarray(sol.iterations, np.float32).reshape(G, n)
    cost = np.asarray(sol.cost).reshape(G, n)

    table = {}
    scored = []
    for c, sc, it, co in zip(cells, succ, iters, cost):
        label = f"scale={c[0]:g}/h={c[1]:g}/decay={c[2]:g}"
        # mean over successful rows with FINITE cost only: a successful row
        # carrying inf/NaN cost must neither poison the mean nor make the
        # max() tie-break order-dependent (NaN compares are unordered)
        fin = sc & np.isfinite(co)
        mcost = float(co[fin].mean()) if fin.any() else float("inf")
        table[label] = {
            "success_rate": float(sc.mean()),
            "mean_iterations": float(it.mean()),
            "mean_cost_successful": mcost,
        }
        scored.append((float(sc.mean()), -float(it.mean()), -mcost, c))
    best = max(scored)[3]
    return TuneResult(best=best, table=table)


@functools.lru_cache(maxsize=8)
def _tune_solve(cfg: PlannerConfig, has_constraints: bool):
    return jax.jit(
        lambda robot, world, constraints, ops, Q0, QN, keys, hyper:
        solver.solve_batch(robot, world, constraints, cfg, ops, Q0, QN,
                           keys, hyper=hyper))
