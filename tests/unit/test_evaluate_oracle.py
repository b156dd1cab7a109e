"""The batched candidate evaluation (FK → sphere bodies → SDF → potential →
cost rows, solver._evaluate_batch) against the NumPy chain-FK + SDF
reference in tests/oracle/oracle.py, across robots and world kinds.

`check_evaluate` is also what chip_smoke.py runs on the card at config-2
widths (C=56 candidates, T=102 waypoints, d=7).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from tpustomp.api.config import CostWeights, PlannerConfig
from tpustomp.dynamics.device import device_ops
from tpustomp.engine import solver
from tpustomp.robot import model
from tpustomp.world.sdf import AnalyticWorld, CompositeWorld, GridSDF

# float32 evaluation against a float64 reference: per-row relative error
# of a 7-joint FK chain is ~1e-6, so 1e-4 leaves two orders of headroom
# while still catching any wrong frame, body or SDF term.
EVAL_RTOL = 1e-4
EVAL_ATOL = 1e-5

_CHAIN_FIELDS = ("joint_type", "joint_axis", "joint_offset", "joint_rot",
                 "base_pos", "base_rot", "body_link", "body_offset",
                 "body_radius")

_GROUP_URDF = """
<robot name="group">
  <link name="base"/>
  <link name="l0"><collision><origin xyz="0 0 0.2"/>
    <geometry><sphere radius="0.08"/></geometry></collision></link>
  <link name="l1"><collision><origin xyz="0.25 0 0"/>
    <geometry><sphere radius="0.06"/></geometry></collision></link>
  <link name="l2"><collision><origin xyz="0.2 0 0"/>
    <geometry><sphere radius="0.05"/></geometry></collision></link>
  <link name="tool"><collision><origin xyz="0.05 0 0"/>
    <geometry><sphere radius="0.03"/></geometry></collision></link>
  <joint name="lift" type="prismatic">
    <parent link="base"/><child link="l0"/>
    <origin xyz="0 0 0.3"/><axis xyz="0 0 1"/><limit lower="0" upper="0.4"/>
  </joint>
  <joint name="shoulder" type="revolute">
    <parent link="l0"/><child link="l1"/>
    <origin xyz="0.1 0 0.3" rpy="0.3 0 0.2"/><axis xyz="0 0 1"/>
    <limit lower="-2" upper="2"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0.5 0 0" rpy="0 0.4 0"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2"/>
  </joint>
  <joint name="tool_fix" type="fixed">
    <parent link="l2"/><child link="tool"/><origin xyz="0.4 0 0"/>
  </joint>
</robot>
"""


def _prismatic_robot():
    """RPR chain with a prismatic joint and non-identity fixed rotations."""
    from tpustomp.robot.fk import rodrigues

    rots = np.stack([
        np.asarray(rodrigues(jnp.asarray([0.0, 0.0, 1.0]), jnp.float32(a)))
        for a in (0.3, -0.5, 0.2)])
    return model._spec(
        joint_axis=[[0, 0, 1], [1, 0, 0], [0, 1, 0]],
        joint_offset=[[0, 0, 0.3], [0.4, 0, 0], [0.3, 0, 0]],
        joint_rot=rots,
        lower=[-3.0, 0.0, -3.0], upper=[3.0, 0.6, 3.0],
        limited=[True, True, True],
        joint_type=[model.REVOLUTE, model.PRISMATIC, model.REVOLUTE],
        body_link=[0, 1, 2, 2],
        body_offset=[[0.2, 0, 0], [0.1, 0, 0], [0.15, 0, 0], [0.3, 0, 0]],
        body_radius=[0.06, 0.05, 0.05, 0.04])


def _group_robot():
    from tpustomp.robot.urdf_lite import load_urdf_group

    spec, _ = load_urdf_group(_GROUP_URDF, root="base", tip="tool",
                              group_joints=["shoulder", "elbow"],
                              fixed_positions={"lift": 0.15})
    return spec


ROBOTS = {
    "arm_7dof": model.arm_7dof,
    "planar_2r": lambda: model.planar_2r(bodies_per_link=2),
    "prismatic": _prismatic_robot,
    "urdf_group": _group_robot,
}

_SPHERES = [((0.5, 0.3, 0.6), 0.3), ((0.8, -0.2, 0.1), 0.25),
            ((-0.3, 0.5, 0.4), 0.2)]
_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
          ((0.2, -0.5, 0.5), (0.15, 0.15, 0.3))]
_GRID = dict(origin=(-1.2, -1.2, -0.6), shape=(40, 40, 36), resolution=0.06)


def _grid(analytic):
    from tpustomp.world.edt import grid_from_analytic

    return grid_from_analytic(analytic, **_GRID)


WORLDS = {
    "boxes": lambda: AnalyticWorld.make(boxes=_BOXES),
    "spheres": lambda: AnalyticWorld.make(spheres=_SPHERES),
    "mixed": lambda: AnalyticWorld.make(spheres=_SPHERES, boxes=_BOXES),
    "grid": lambda: _grid(AnalyticWorld.make(spheres=_SPHERES,
                                             boxes=_BOXES)),
    "composite": lambda: CompositeWorld.make(
        _grid(AnalyticWorld.make(boxes=_BOXES)), spheres=_SPHERES),
    "empty": lambda: AnalyticWorld.make(),
}


def oracle_chain(robot) -> dict:
    return {k: np.asarray(getattr(robot, k), np.float64) if k not in
            ("joint_type", "body_link") else np.asarray(getattr(robot, k))
            for k in _CHAIN_FIELDS}


def oracle_world(world) -> dict:
    """The oracle's dict form of an AnalyticWorld / GridSDF / CompositeWorld."""
    if isinstance(world, CompositeWorld):
        return {**oracle_world(world.grid), **oracle_world(world.overlay)}
    if isinstance(world, GridSDF):
        return {"grid": (np.asarray(world.grid, np.float64),
                         np.asarray(world.origin, np.float64),
                         float(world.resolution))}
    out = {}
    if world.sphere_radius.shape[0]:
        out["spheres"] = (np.asarray(world.sphere_center, np.float64),
                          np.asarray(world.sphere_radius, np.float64))
    if world.box_half.shape[0]:
        out["boxes"] = (np.asarray(world.box_center, np.float64),
                        np.asarray(world.box_half, np.float64))
    return out


@functools.lru_cache(maxsize=None)
def _evaluate_fn(cfg):
    return jax.jit(lambda robot, world, ops, q0, qN, th:
                   solver._evaluate_batch(robot, world, None, cfg, ops,
                                          q0, qN, th))


def check_evaluate(robot, world, C: int, T: int, seed: int = 0) -> dict:
    """Evaluate C random candidates of T waypoints on the default device and
    assert agreement with the NumPy reference within EVAL_RTOL/EVAL_ATOL.
    Returns, per quantity, the largest error as a share of its tolerance
    (|got - ref| / (EVAL_ATOL + EVAL_RTOL·|ref|); 1.0 is the limit)."""
    cfg = PlannerConfig(num_timesteps=T - 2, duration=5.0,
                        collision_clearance=0.08,
                        weights=CostWeights(obstacle=1.0, smoothness=0.1))
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    rng = np.random.default_rng(seed)
    d = robot.num_joints
    q0 = rng.uniform(-1.0, 1.0, d).astype(np.float32)
    qN = rng.uniform(-1.0, 1.0, d).astype(np.float32)
    thetas = rng.uniform(-1.2, 1.2, (C, T - 2, d)).astype(np.float32)
    S, ctrl, margins, totals, _ = jax.device_get(_evaluate_fn(cfg)(
        robot, world, ops, jnp.asarray(q0), jnp.asarray(qN),
        jnp.asarray(thetas)))

    chain, ref_world = oracle_chain(robot), oracle_world(world)
    ref_q = np.zeros((C, T))
    ref_m = np.zeros(C)
    ref_c = np.zeros((C, T))
    for c in range(C):
        full = np.vstack([q0[None], thetas[c], qN[None]]).astype(np.float64)
        ref_q[c], ref_m[c] = oracle.obstacle_cost_chain(
            chain, ref_world, full, cfg.dt, cfg.collision_clearance)
        ref_c[c] = oracle.control_cost_rows(
            thetas[c].astype(np.float64), full[0], full[-1], cfg.dt)
    ref_total = ref_q.sum(axis=1) + cfg.weights.smoothness * ref_c.sum(axis=1)

    kw = dict(rtol=EVAL_RTOL, atol=EVAL_ATOL)
    np.testing.assert_allclose(S, ref_q, **kw, err_msg="obstacle rows")
    np.testing.assert_allclose(margins, ref_m, **kw, err_msg="margins")
    np.testing.assert_allclose(ctrl, ref_c, **kw, err_msg="control rows")
    np.testing.assert_allclose(totals, ref_total, **kw, err_msg="totals")
    used = lambda a, b: float(np.max(np.abs(a - b)
                                     / (EVAL_ATOL + EVAL_RTOL * np.abs(b))))
    return {"obstacle": used(S, ref_q), "margin": used(margins, ref_m),
            "control": used(ctrl, ref_c), "total": used(totals, ref_total),
            "obstacle_active": bool(ref_q.sum() > 0.0)}


@pytest.mark.parametrize("world_name", list(WORLDS))
@pytest.mark.parametrize("robot_name", list(ROBOTS))
def test_evaluate_matches_oracle(robot_name, world_name):
    out = check_evaluate(ROBOTS[robot_name](), WORLDS[world_name](),
                         C=4, T=12, seed=len(robot_name) + len(world_name))
    # every non-empty world must actually exercise the potential
    assert out["obstacle_active"] == (world_name != "empty"), out


@pytest.mark.gpu
def test_evaluate_matches_oracle_on_card():
    """Config-2 widths (C=56 candidates, T=102 waypoints, d=7) on the GPU."""
    out = check_evaluate(model.arm_7dof(), WORLDS["mixed"](), C=56, T=102)
    assert out["obstacle_active"], out
