"""Robot model: kinematic chain spec + sphere collision bodies, as arrays.

Reference equivalents (SURVEY §3.1): ``StompRobotModel`` (URDF→KDL tree,
planning groups, collision-point generation, joint limits) and
``StompCollisionPoint`` (sphere radius/clearance/offset/parent-joint chain).

Design: no tree objects in the hot path — a planning group is a
*serial chain* flattened to stacked arrays (axes, fixed offsets/rotations,
limits) plus a sphere set (attach link index, offset in link frame, radius).
FK over the chain is a `lax.scan` of frame compositions (robot/fk.py), and
every per-sphere quantity is a vectorized gather over `body_link`.

Built-in models: `planar_2r` (BASELINE config 1) and `arm_7dof`
(PR2-like 7-DOF arm, BASELINE config 2). URDF-lite loading lives in
robot/urdf_lite.py and produces the same RobotSpec.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from tpustomp.utils import struct

REVOLUTE = 0
PRISMATIC = 1


@struct.dataclass
class RobotSpec:
    """Serial-chain robot + sphere bodies. d joints, B bodies.

    Frame convention: joint i's frame is
        T_i = T_{i-1} · Trans(offset_i) · RotFixed_i · Joint(axis_i, q_i)
    with T_{-1} = (base_rot, base_pos). `offset_i`/`rot_fixed_i` are the fixed
    link transform from parent joint frame to this joint's origin; the joint
    motion is a rotation about (revolute) or translation along (prismatic)
    `axis_i` expressed in the joint's own frame.
    """

    joint_type: jnp.ndarray     # [d] int32 (REVOLUTE | PRISMATIC)
    joint_axis: jnp.ndarray     # [d, 3] unit axes in joint frame
    joint_offset: jnp.ndarray   # [d, 3]
    joint_rot: jnp.ndarray      # [d, 3, 3] fixed rotations
    joint_lower: jnp.ndarray    # [d]
    joint_upper: jnp.ndarray    # [d]
    # wrap-around (continuous) joints have no limits; mask excludes them from
    # the limit projection (reference: wrap-around flags in StompRobotModel)
    joint_limited: jnp.ndarray  # [d] bool
    base_pos: jnp.ndarray       # [3]
    base_rot: jnp.ndarray       # [3, 3]
    # tool/end-effector point in the last joint's frame (constraint costs)
    ee_offset: jnp.ndarray      # [3]
    # sphere collision bodies (reference: StompCollisionPoint)
    body_link: jnp.ndarray      # [B] int32 — joint index the sphere rides on
    body_offset: jnp.ndarray    # [B, 3] position in that joint's frame
    body_radius: jnp.ndarray    # [B]
    # link mass properties (for the optional torque cost, SURVEY A.8;
    # zeros => torque cost is identically 0, matching the reference default)
    link_mass: jnp.ndarray      # [d] kg
    link_com: jnp.ndarray       # [d, 3] center of mass in the joint frame
    link_inertia: jnp.ndarray   # [d, 3, 3] inertia about the com, joint frame
    # Static (treedef) hint: every joint_rot is exactly identity, so FK can
    # skip the R @ rot_fixed multiply per joint. Computed from concrete
    # values at construction; True for both built-in arms and most URDF
    # chains with zero rpy.
    rot_fixed_identity: bool = struct.field(pytree_node=False, default=False)

    @property
    def num_joints(self) -> int:
        return self.joint_axis.shape[0]

    @property
    def num_bodies(self) -> int:
        return self.body_radius.shape[0]


def _spec(joint_axis, joint_offset, joint_rot, lower, upper, limited,
          body_link, body_offset, body_radius, joint_type=None,
          base_pos=None, base_rot=None, link_mass=None, link_com=None,
          link_inertia=None, ee_offset=None) -> RobotSpec:
    d = len(joint_axis)
    f32 = jnp.float32
    return RobotSpec(
        joint_type=jnp.asarray(
            joint_type if joint_type is not None else [REVOLUTE] * d, jnp.int32),
        joint_axis=jnp.asarray(joint_axis, f32),
        joint_offset=jnp.asarray(joint_offset, f32),
        joint_rot=jnp.asarray(joint_rot, f32),
        joint_lower=jnp.asarray(lower, f32),
        joint_upper=jnp.asarray(upper, f32),
        joint_limited=jnp.asarray(limited, bool),
        base_pos=jnp.asarray(base_pos if base_pos is not None else [0, 0, 0], f32),
        base_rot=jnp.asarray(base_rot if base_rot is not None else np.eye(3), f32),
        ee_offset=jnp.asarray(
            ee_offset if ee_offset is not None else [0, 0, 0], f32),
        body_link=jnp.asarray(body_link, jnp.int32).reshape(-1),
        body_offset=jnp.asarray(body_offset, f32).reshape(-1, 3),
        body_radius=jnp.asarray(body_radius, f32).reshape(-1),
        link_mass=jnp.asarray(
            link_mass if link_mass is not None else np.zeros(d), f32),
        link_com=jnp.asarray(
            link_com if link_com is not None else np.zeros((d, 3)), f32),
        link_inertia=jnp.asarray(
            link_inertia if link_inertia is not None else np.zeros((d, 3, 3)),
            f32),
        rot_fixed_identity=bool(
            np.allclose(np.asarray(joint_rot, np.float64),
                        np.broadcast_to(np.eye(3), (d, 3, 3)), atol=0.0)),
    )


def _eye(d):
    return np.broadcast_to(np.eye(3), (d, 3, 3)).copy()


def planar_2r(link_lengths=(1.0, 1.0), body_radius=0.05,
              bodies_per_link: int = 1, masses=(0.0, 0.0)) -> RobotSpec:
    """Planar 2R arm in the z=0 plane (BASELINE config 1).

    Default bodies: the joint-2 origin and the end-effector tip, matching the
    CPU oracle (tests/oracle/oracle.py::obstacle_cost_planar). With
    bodies_per_link>1 additional spheres are spread along each link.
    `masses` places point masses at the link tips (for the torque cost /
    dynamics tests — the textbook 2R manipulator).
    """
    l1, l2 = link_lengths
    axes = [[0, 0, 1], [0, 0, 1]]
    offsets = [[0, 0, 0], [l1, 0, 0]]
    lower, upper = [-np.pi, -np.pi], [np.pi, np.pi]
    body_link, body_offset, body_radius_l = [], [], []
    # link-1 spheres ride joint 0's frame; the sphere at frac=1 coincides
    # with the joint-2 origin (the oracle's p1). Link-2 spheres ride joint 1.
    for s in range(bodies_per_link):
        frac = (s + 1) / bodies_per_link
        body_link.append(0)
        body_offset.append([l1 * frac, 0.0, 0.0])
        body_radius_l.append(body_radius)
    for s in range(bodies_per_link):
        frac = (s + 1) / bodies_per_link
        body_link.append(1)
        body_offset.append([l2 * frac, 0.0, 0.0])
        body_radius_l.append(body_radius)
    return _spec(axes, offsets, _eye(2), lower, upper, [False, False],
                 body_link, body_offset, body_radius_l,
                 link_mass=list(masses),
                 link_com=[[l1, 0, 0], [l2, 0, 0]],
                 ee_offset=[l2, 0, 0])


def arm_7dof(spheres_per_link: int = 4) -> RobotSpec:
    """PR2-like 7-DOF arm (BASELINE config 2).

    Kinematic structure mirrors the PR2 right arm's joint sequence (pan, lift,
    upper-arm roll, elbow flex, forearm roll, wrist flex, wrist roll) with
    round-number link dimensions — the reference loads exact values from the
    robot URDF; ours is a representative 7-DOF chain with the same topology,
    alternating-axis structure, limits, and sphere coverage (~`spheres_per_link`
    per moving link, reference generates ~50-100 spheres for the PR2 arm).
    """
    upper_arm, forearm, hand = 0.40, 0.32, 0.16
    axes = [
        [0, 0, 1],   # shoulder pan
        [0, 1, 0],   # shoulder lift
        [1, 0, 0],   # upper-arm roll
        [0, 1, 0],   # elbow flex
        [1, 0, 0],   # forearm roll
        [0, 1, 0],   # wrist flex
        [1, 0, 0],   # wrist roll
    ]
    offsets = [
        [0.0, 0.0, 0.8],          # base -> shoulder (torso height)
        [0.1, 0.0, 0.0],          # pan -> lift
        [0.0, 0.0, 0.0],          # lift -> roll (coincident)
        [upper_arm, 0.0, 0.0],    # roll -> elbow
        [0.0, 0.0, 0.0],          # elbow -> forearm roll
        [forearm, 0.0, 0.0],      # forearm roll -> wrist flex
        [0.0, 0.0, 0.0],          # wrist flex -> wrist roll
    ]
    lower = [-2.28, -0.52, -3.9, -2.32, -np.pi, -2.18, -np.pi]
    upper = [0.71, 1.39, 0.8, 0.0, np.pi, 0.0, np.pi]
    limited = [True, True, True, True, False, True, False]

    # Sphere bodies along the three long links. Each link's spheres ride the
    # joint frame at the *proximal* end of that link (so they move with the
    # link, not with the next joint): upper arm -> joint 2 (roll, origin at
    # shoulder), forearm -> joint 4 (roll, origin at elbow), hand -> joint 6.
    segments = [(2, upper_arm, 0.06), (4, forearm, 0.05), (6, hand, 0.04)]
    body_link, body_offset, body_radius = [], [], []
    for link, span, rad in segments:
        for s in range(spheres_per_link):
            frac = (s + 1) / spheres_per_link
            body_link.append(link)
            body_offset.append([span * frac, 0.0, 0.0])
            body_radius.append(rad)
    masses = [2.5, 2.5, 2.0, 1.6, 1.0, 0.6, 0.4]
    coms = [[0.05, 0, 0], [0, 0, 0], [upper_arm / 2, 0, 0], [0, 0, 0],
            [forearm / 2, 0, 0], [0, 0, 0], [hand / 2, 0, 0]]
    inertias = [np.eye(3) * v for v in
                (0.01, 0.01, 0.02, 0.008, 0.01, 0.003, 0.001)]
    return _spec(axes, offsets, _eye(7), lower, upper, limited,
                 body_link, body_offset, body_radius,
                 link_mass=masses, link_com=coms, link_inertia=inertias,
                 ee_offset=[hand, 0, 0])
