"""Shared benchmark scaffolding.

Timing methodology: every timed region ends by pulling a scalar result to
the host (a real device→host transfer, so the work has finished), and
per-iteration costs are derived from slopes between two workload sizes so
fixed dispatch overhead cancels.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def timed(fn, *args, n=5, warmup=1):
    """Median wall time (s) of fn(*args); forces a scalar pull each call."""
    for _ in range(warmup):
        _sync(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _sync(out):
    leaf = jax.tree.leaves(out)[0]
    return float(jnp.sum(leaf))


def config2_scene():
    from tpustomp.robot import model
    from tpustomp.world.sdf import AnalyticWorld

    robot = model.arm_7dof()
    world = AnalyticWorld.make(
        boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
               ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))])
    q0 = np.asarray([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    qN = np.asarray([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    return robot, world, q0, qN


def config2_grid_scene():
    """config-2 with the config file's OWN voxel grid spec (configs/
    config2_tabletop.toml `grid`): the tabletop scene voxelized at 2.5 cm
    through the signed-EDT pipeline — BASELINE configs[1]'s literal
    "tabletop SDF world". Same robot/start/goal as config2_scene; only the
    world representation changes (GridSDF packed-corner table), so analytic
    vs grid rows isolate the SDF-gather cost."""
    from tpustomp.world import edt

    robot, analytic, q0, qN = config2_scene()
    occ = edt.occupancy_from_analytic(analytic, (-0.2, -1.0, 0.0),
                                      (64, 80, 48), 0.025)
    grid = edt.signed_edt(occ, 0.025, (-0.2, -1.0, 0.0))
    return robot, grid, q0, qN


def config2_decomposed_scene():
    """config-2's voxel occupancy COMPILED to analytic boxes
    (world/decompose.py): the gather-free path for static voxel scenes —
    the tabletop occupancy decomposes to exactly 2 boxes, evaluated in
    closed form instead of by the trilinear grid gather. Same voxel data as
    config2_grid_scene; only the SDF representation differs (accuracy
    contract in world/decompose.py)."""
    from tpustomp.world import edt
    from tpustomp.world.decompose import analytic_from_occupancy

    robot, analytic, q0, qN = config2_scene()
    occ = edt.occupancy_from_analytic(analytic, (-0.2, -1.0, 0.0),
                                      (64, 80, 48), 0.025)
    world = analytic_from_occupancy(occ, 0.025, (-0.2, -1.0, 0.0))
    return robot, world, q0, qN


def config2_cfg(**kw):
    from tpustomp.api.config import PlannerConfig, NoiseConfig, CostWeights

    base = dict(
        num_timesteps=100, duration=5.0, num_rollouts=50,
        noise=NoiseConfig(stddev=0.08, decay=0.995, num_rollouts_reused=5),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.05, max_iterations=100,
        max_iterations_after_collision_free=5, record_metrics=False,
    )
    base.update(kw)
    return __import__("tpustomp.api.config", fromlist=["PlannerConfig"]
                      ).PlannerConfig(**base)


def emit(payload: dict, details_path: str | None = None):
    if details_path:
        with open(details_path, "w") as f:
            json.dump(payload, f, indent=2)
    print(json.dumps(payload))
