"""Plan a 7-DOF arm over a tabletop scene (BASELINE config 2) and dump plots.

Run:  python examples/plan_tabletop.py            (GPU or CPU)
"""

import os as _os
import sys as _sys

# make "python examples/<name>.py" work without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import jax

from tpustomp import plan, PlannerConfig, NoiseConfig, ProblemSpec
from tpustomp.robot import model
from tpustomp.utils import viz
from tpustomp.world.sdf import AnalyticWorld


def main():
    robot = model.arm_7dof()
    world = AnalyticWorld.make(
        boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),     # table
               ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))])  # bottle
    cfg = PlannerConfig(
        num_timesteps=100, duration=5.0, num_rollouts=50, pi2_h=20.0,
        # swept exploration (bench/stomp_sweep.py, docs/EXPERIMENTS.md):
        # wide undecayed noise converges in ~11 iterations at success 1.0;
        # the reference-style sigma=0.08/decay=0.995 needs ~25 and drops to
        # ~0.59 success on hard problem distributions
        noise=NoiseConfig(stddev=0.25, decay=1.0, num_rollouts_reused=5),
        collision_clearance=0.05, max_iterations=100,
        max_iterations_after_collision_free=5)
    prob = ProblemSpec(
        q0=np.asarray([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32),
        qN=np.asarray([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32))

    sol = plan(robot, world, prob, cfg, key=jax.random.PRNGKey(0))
    print(f"success={bool(sol.success)} iterations={int(sol.iterations)} "
          f"cost={float(sol.cost):.4f}")
    print("EE path figure:", viz.plot_ee_path_3d(robot, sol, world))
    print("metrics figure:", viz.plot_metrics(sol))


if __name__ == "__main__":
    main()
