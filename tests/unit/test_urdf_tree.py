"""Tree-structured URDFs / planning groups (reference: StompRobotModel
planning groups over the full URDF→KDL tree, SURVEY §3.1). A torso + two-arm
robot plans the right arm while (a) the left arm's and torso's geometry acts
as static world obstacles, (b) a gripper on the planned wrist rides it, and
(c) a frozen torso joint poses the arm base correctly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpustomp.robot.fk import body_positions
from tpustomp.robot.urdf_lite import load_urdf, load_urdf_group
from tpustomp.world.sdf import AnalyticWorld, sdf

TWO_ARM_URDF = """
<robot name="two_arm">
  <link name="base"/>
  <link name="torso">
    <collision><origin xyz="0 0 0.3"/>
      <geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <link name="head">
    <collision><geometry><sphere radius="0.1"/></geometry></collision>
  </link>
  <link name="r_upper">
    <collision><origin xyz="0.2 0 0"/>
      <geometry><sphere radius="0.06"/></geometry></collision>
  </link>
  <link name="r_fore">
    <collision><origin xyz="0.15 0 0"/>
      <geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <link name="r_gripper">
    <collision><origin xyz="0.05 0 0"/>
      <geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <link name="l_upper">
    <collision><origin xyz="0.2 0 0"/>
      <geometry><sphere radius="0.06"/></geometry></collision>
  </link>
  <link name="l_fore">
    <collision><origin xyz="0.25 0 0"/>
      <geometry><sphere radius="0.07"/></geometry></collision>
  </link>

  <joint name="torso_lift" type="prismatic">
    <parent link="base"/><child link="torso"/>
    <origin xyz="0 0 0.5"/><axis xyz="0 0 1"/>
    <limit lower="0" upper="0.3"/>
  </joint>
  <joint name="head_fix" type="fixed">
    <parent link="torso"/><child link="head"/><origin xyz="0 0 0.6"/>
  </joint>
  <joint name="r_shoulder" type="revolute">
    <parent link="torso"/><child link="r_upper"/>
    <origin xyz="0 -0.3 0.4"/><axis xyz="0 0 1"/>
    <limit lower="-2" upper="2"/>
  </joint>
  <joint name="r_elbow" type="revolute">
    <parent link="r_upper"/><child link="r_fore"/>
    <origin xyz="0.4 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2"/>
  </joint>
  <joint name="r_grip_fix" type="fixed">
    <parent link="r_fore"/><child link="r_gripper"/><origin xyz="0.3 0 0"/>
  </joint>
  <joint name="l_shoulder" type="revolute">
    <parent link="torso"/><child link="l_upper"/>
    <origin xyz="0 0.3 0.4"/><axis xyz="0 0 1"/>
    <limit lower="-2" upper="2"/>
  </joint>
  <joint name="l_elbow" type="revolute">
    <parent link="l_upper"/><child link="l_fore"/>
    <origin xyz="0.55 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2"/>
  </joint>
</robot>
"""


def _load_right_arm(torso_q=0.0, l_shoulder=0.0):
    return load_urdf_group(
        TWO_ARM_URDF, root="base", tip="r_gripper",
        group_joints=["r_shoulder", "r_elbow"],
        fixed_positions={"torso_lift": torso_q, "l_shoulder": l_shoulder})


def test_group_spec_shape_and_gripper_rides_wrist():
    spec, static = _load_right_arm()
    assert spec.num_joints == 2
    # right arm: upper sphere on joint 0, fore + gripper spheres on joint 1
    counts = np.bincount(np.asarray(spec.body_link), minlength=2)
    assert tuple(counts) == (1, 2)
    # gripper sphere offset = fore joint frame + 0.3 (fix) + 0.05 (collision)
    offs = np.asarray(spec.body_offset)
    assert any(np.allclose(o, [0.35, 0, 0], atol=1e-6) for o in offs)


def test_static_branch_geometry_world_positions():
    """Torso, head, and the whole left arm (frozen) are static spheres in
    world frame — nothing is silently dropped."""
    spec, static = _load_right_arm(torso_q=0.1)
    centers = np.array([c for c, _ in static])
    radii = np.array([r for _, r in static])
    assert len(static) == 4  # torso, head, l_upper, l_fore
    # torso sphere: base 0.5 + lift 0.1 + collision 0.3 = z 0.9
    assert any(np.allclose(c, [0, 0, 0.9], atol=1e-6) for c in centers)
    # head: 0.5 + 0.1 + 0.6 = z 1.2
    assert any(np.allclose(c, [0, 0, 1.2], atol=1e-6) for c in centers)
    # l_upper collision @ l_shoulder(0)+0.2 along x: [0.2, 0.3, 1.0]
    assert any(np.allclose(c, [0.2, 0.3, 1.0], atol=1e-6) for c in centers)
    # l_fore @ elbow 0.55 + 0.25: [0.8, 0.3, 1.0]
    assert any(np.allclose(c, [0.8, 0.3, 1.0], atol=1e-6) for c in centers)
    assert sorted(np.round(radii, 3)) == [0.05, 0.06, 0.07, 0.1]


def test_frozen_joint_positions_pose_the_branch():
    """Rotating the frozen left shoulder by π/2 swings l_fore's static
    sphere; lifting the torso raises the planned arm's base."""
    _, static0 = _load_right_arm(l_shoulder=0.0)
    _, static90 = _load_right_arm(l_shoulder=np.pi / 2)
    c0 = sorted(np.round(c, 4).tolist() for c, _ in static0)
    c90 = sorted(np.round(c, 4).tolist() for c, _ in static90)
    assert c0 != c90
    assert any(np.allclose(c, [0.0, 1.1, 0.9], atol=1e-6)
               for c, _ in static90)  # l_fore swung to +y

    spec_lo, _ = _load_right_arm(torso_q=0.0)
    spec_hi, _ = _load_right_arm(torso_q=0.3)
    q = jnp.zeros(2, jnp.float32)
    z_lo = np.asarray(body_positions(spec_lo, q))[:, 2]
    z_hi = np.asarray(body_positions(spec_hi, q))[:, 2]
    np.testing.assert_allclose(z_hi - z_lo, 0.3, atol=1e-6)


def test_fk_of_planned_group_matches_hand_calc():
    spec, _ = _load_right_arm(torso_q=0.2)
    # r_shoulder at [0, -0.3, 0.5+0.2+0.4]; elbow 0.4 along x after pan
    q = jnp.asarray([np.pi / 2, 0.0], jnp.float32)
    x = np.asarray(body_positions(spec, q))
    # upper-arm sphere (0.2 along x, panned to +y): [0, -0.3+0.2, 1.1]
    np.testing.assert_allclose(x[0], [0.0, -0.1, 1.1], atol=1e-5)
    # fore sphere: elbow at [0, 0.1, 1.1], +0.15 panned: [0, 0.25, 1.1]
    np.testing.assert_allclose(x[1], [0.0, -0.3 + 0.4 + 0.15, 1.1], atol=1e-5)


def test_plan_right_arm_avoids_left_arm():
    """End-to-end: the left arm's static spheres are real obstacles — a
    straight-line right-arm plan through the left arm must route around it
    and report collision-free."""
    from tpustomp.api.config import CostWeights, NoiseConfig, PlannerConfig
    from tpustomp.api.plan import plan
    from tpustomp.api.problem import ProblemSpec

    # pose the left forearm across the right forearm's sweep: calibrated so
    # the straight-line min-jerk path penetrates the left forearm sphere by
    # 0.10 m while endpoints AND the (plane-confined) right upper-arm stay
    # clear — i.e. a collision-free path exists and requires elbow motion
    spec, static = load_urdf_group(
        TWO_ARM_URDF, root="base", tip="r_gripper",
        group_joints=["r_shoulder", "r_elbow"],
        fixed_positions={"torso_lift": 0.0, "l_shoulder": -0.8,
                         "l_elbow": -0.2})
    world = AnalyticWorld.make(spheres=[(tuple(c), r) for c, r in static])
    cfg = PlannerConfig(
        num_timesteps=30, duration=3.1, num_rollouts=10, max_iterations=60,
        noise=NoiseConfig(stddev=0.25, decay=1.0, num_rollouts_reused=3),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.05, record_metrics=False)
    q0 = np.array([-1.3, -0.4], np.float32)
    qN = np.array([1.0, -0.4], np.float32)
    sol = plan(spec, world, ProblemSpec(q0=q0, qN=qN), cfg,
               key=jax.random.PRNGKey(0))
    assert bool(sol.success), "plan around the left arm failed"
    # verify true clearance of every waypoint against the static spheres
    for q in np.asarray(sol.trajectory):
        x = body_positions(spec, jnp.asarray(q))
        margin = np.min(np.asarray(sdf(world, x)) - np.asarray(spec.body_radius))
        assert margin > 0.0, f"waypoint {q} intersects the left arm"


def test_load_urdf_warns_on_dropped_static_geometry():
    # root="torso" keeps torso_lift out of the group, so head/left-arm
    # geometry has no moving ancestor and would be dropped by plain load_urdf
    with pytest.warns(UserWarning, match="static world obstacles"):
        load_urdf(TWO_ARM_URDF, root="torso", tip="r_gripper")


def test_full_chain_load_attaches_whole_tree_to_torso_lift():
    """With root="base" every link rides the (planned) torso lift — nothing
    is static, so load_urdf returns all 7 spheres as moving bodies."""
    spec = load_urdf(TWO_ARM_URDF, root="base", tip="r_gripper")
    assert spec.num_joints == 3  # torso_lift, r_shoulder, r_elbow
    assert spec.num_bodies == 7  # torso, head, l_upper, l_fore + right arm
    # head/left-arm spheres ride joint 0 (torso_lift)
    assert tuple(np.bincount(np.asarray(spec.body_link), minlength=3)) \
        == (4, 1, 2)
