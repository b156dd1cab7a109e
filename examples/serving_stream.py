"""Serving-loop tour: pipelined stream, success=1.0 retry, auto-tuning.

The three round-4 serving entry points on a small planar scene (runs on
CPU in seconds; on a GPU the same code is the per-host serving loop):

  1. `tune()` grids (noise, h, decay) over a problem set as ONE batched
     solve and bakes the winner into the config;
  2. `plan_batch_stream()` keeps batches in flight so host prep/dispatch/
     gather overlap device compute (steady-state = max(solve, host));
  3. `plan_batch_retry()` re-solves failed rows with restarts folded in,
     holding the stream's output at success = 1.0.

Run: python examples/serving_stream.py
"""

import os as _os
import sys as _sys

# make "python examples/<name>.py" work without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import jax

from tpustomp import (CostWeights, NoiseConfig, PlannerConfig, ProblemSpec,
                      plan_batch_retry, plan_batch_stream, tune)
from tpustomp.robot import model
from tpustomp.world.sdf import AnalyticWorld


def make_problem(batch, seed):
    rng = np.random.default_rng(seed)
    q0 = (np.tile([-0.56, 1.65], (batch, 1))
          + rng.uniform(-0.08, 0.08, (batch, 2))).astype(np.float32)
    qN = (np.tile([1.16, -1.46], (batch, 1))
          + rng.uniform(-0.08, 0.08, (batch, 2))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    return ProblemSpec(q0=q0, qN=qN), keys


def main():
    robot = model.planar_2r(body_radius=0.05)
    world = AnalyticWorld.make(spheres=[((1.88, 0.42, 0.0), 0.27)])
    cfg = PlannerConfig(
        num_timesteps=16, duration=1.7, num_rollouts=6,
        noise=NoiseConfig(stddev=0.12, decay=0.99, num_rollouts_reused=2),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.1, max_iterations=10,
        max_iterations_after_collision_free=3, record_metrics=False)

    # 1. tune exploration on a calibration batch (one batched solve)
    calib, _ = make_problem(batch=16, seed=0)
    result = tune(robot, world, calib, cfg,
                  noise_scale=(0.5, 1.0, 2.0), h=(5.0, 10.0, 20.0),
                  decay=(1.0,))
    print(f"tuned cell: {result.best} "
          f"-> {result.table[max(result.table, key=lambda k: result.table[k]['success_rate'])]}")
    cfg = result.best_config(cfg)

    # 2. pipelined serving stream: 6 batches, 2 in flight
    items = [make_problem(batch=12, seed=100 + i) for i in range(6)]
    n_ok = n_total = 0
    for traj, succ in plan_batch_stream(robot, world, iter(items), cfg,
                                        depth=2, gather="serving"):
        n_ok += int(succ.sum())
        n_total += succ.size
    print(f"streamed {len(items)} batches: {n_ok}/{n_total} collision-free")

    # 3. hold a batch at success = 1.0 with targeted retries
    prob, keys = make_problem(batch=24, seed=7)
    sol = plan_batch_retry(robot, world, prob, cfg, keys=keys,
                           max_rounds=2, retry_restarts=4)
    print(f"retry driver: success = {float(np.asarray(sol.success).mean()):.3f}")


if __name__ == "__main__":
    main()
