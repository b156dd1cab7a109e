"""Auto-tune STOMP exploration for a scene, then plan with the winner.

The documented path for new robots/scenes (VERDICT r4 item 4): the shipped
config-file exploration values were found by exactly this machinery
(bench/stomp_sweep.py at 72 cells x 125 problems); `api.tune.tune()` is the
public one-call form — the whole hyperparameter grid solves as ONE batched
call (traced per-scenario hyperparameters, engine/solver.HyperParams).

Run: python examples/tune_and_plan.py
"""

import os as _os
import sys as _sys

# make "python examples/<name>.py" work without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import jax

from tpustomp.api.config import CostWeights, NoiseConfig, PlannerConfig
from tpustomp.api.plan import plan
from tpustomp.api.problem import ProblemSpec
from tpustomp.api.tune import tune
from tpustomp.robot import model
from tpustomp.world.sdf import AnalyticWorld


def main():
    robot = model.planar_2r(body_radius=0.05)
    world = AnalyticWorld.make(spheres=[((1.88, 0.42, 0.0), 0.27)])
    base = PlannerConfig(
        num_timesteps=20, duration=2.1, num_rollouts=10,
        noise=NoiseConfig(stddev=0.1, decay=0.995, num_rollouts_reused=3),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.1, max_iterations=40,
        max_iterations_after_collision_free=5, record_metrics=False)

    # evaluation set: jittered copies of the deployment problem (use
    # bench.experiment_suite.sample_problems for a hard-problem set)
    rng = np.random.default_rng(0)
    n = 32
    q0s = (np.tile([-0.56, 1.65], (n, 1))
           + rng.uniform(-0.1, 0.1, (n, 2))).astype(np.float32)
    qNs = (np.tile([1.16, -1.46], (n, 1))
           + rng.uniform(-0.1, 0.1, (n, 2))).astype(np.float32)

    result = tune(robot, world, ProblemSpec(q0=q0s, qN=qNs), base,
                  noise_scale=(1.0, 1.5, 2.5), h=(10.0, 20.0),
                  decay=(0.995, 1.0))
    print("grid results:")
    for label, row in result.table.items():
        print(f"  {label}: {row}")
    print("winner:", result.best)

    cfg = result.best_config(base)
    sol = plan(robot, world,
               ProblemSpec(q0=q0s[0], qN=qNs[0]), cfg,
               key=jax.random.PRNGKey(1))
    print(f"plan with tuned config: success={bool(sol.success)} "
          f"iterations={int(sol.iterations)} cost={float(sol.cost):.3f}")


if __name__ == "__main__":
    main()
