"""Compile a voxel occupancy grid into analytic boxes and plan on it.

The gather-free path for static voxel scenes (world/decompose.py): the
voxel SDF query gathers one table row per sample, while analytic
primitives are evaluated in closed form. A tabletop occupancy decomposes to
exactly 2 boxes.

Run: python examples/voxel_to_boxes.py
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
from tpustomp.robot import model
from tpustomp.world import edt
from tpustomp.world.decompose import analytic_from_occupancy, \
    boxes_from_occupancy
from tpustomp.world.sdf import AnalyticWorld


def main():
    # pretend this occupancy arrived from a collision map / point cloud
    # (world.edt.voxelize rasterizes point clouds the same way)
    scene = AnalyticWorld.make(
        boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
               ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))])
    origin, shape, res = (-0.2, -1.0, 0.0), (64, 80, 48), 0.025
    occ = edt.occupancy_from_analytic(scene, origin, shape, res)

    boxes = boxes_from_occupancy(occ)
    print(f"occupancy {occ.shape} ({int(occ.sum())} voxels) "
          f"-> {len(boxes)} boxes")
    # max_boxes guards against scenes where the fused-primitive path would
    # be slower than the grid gather — it raises instead of truncating
    world = analytic_from_occupancy(occ, res, origin, max_boxes=256)

    robot = model.arm_7dof()
    cfg = PlannerConfig(
        num_timesteps=100, duration=5.0, num_rollouts=50, pi2_h=20.0,
        noise=NoiseConfig(stddev=0.25, decay=1.0, num_rollouts_reused=5),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.05, max_iterations=100,
        max_iterations_after_collision_free=5)
    sol = plan(robot, world,
               ProblemSpec(
                   q0=np.asarray([-0.6, 0.5, 0, -0.8, 0, -0.5, 0],
                                 np.float32),
                   qN=np.asarray([0.4, 0.5, 0, -0.8, 0, -0.5, 0],
                                 np.float32)),
               cfg, key=jax.random.PRNGKey(0))
    print(f"plan on decomposed world: success={bool(sol.success)} "
          f"iterations={int(sol.iterations)} cost={float(sol.cost):.3f}")


if __name__ == "__main__":
    main()
