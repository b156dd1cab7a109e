"""Batched forward kinematics + point Jacobians for serial chains.

Reference equivalents (SURVEY §3.1): orocos-KDL frame composition plus the
package's custom ``TreeFkSolverJointPosAxis`` solvers, which return every
segment frame *and* joint origins/axes in one pass precisely so point
Jacobians can be formed without per-point chain solves. This module is the
same idea: one unrolled pass down the chain yields all joint
frames, origins, and world axes; bodies and Jacobians are vectorized gathers
on top.

Batching: every function takes a single configuration q[d]; callers `vmap`
over waypoints, rollouts, and scenarios (SURVEY §4.3 device mapping).

Performance note: ALL 3x3/3-vector algebra here is written as explicit
elementwise multiply-add (`_mat_mul`/`_mat_vec`), never `jnp.dot`/`einsum`
with a contraction — a batched 3x3 dot becomes a separate batched-matmul
call per product, while the elementwise form fuses into the surrounding
ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpustomp.robot.model import RobotSpec, PRISMATIC


def _mat_mul(a, b):
    """[..., 3, 3] @ [..., 3, 3] as elementwise multiply-add (module note)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _mat_vec(R, v):
    """[..., 3, 3] @ [..., 3] as elementwise multiply-add."""
    return jnp.sum(R * v[..., None, :], axis=-1)


def rodrigues(axis: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix about unit `axis` by `angle` (Rodrigues formula)."""
    x, y, z = axis[0], axis[1], axis[2]
    zero = jnp.zeros_like(x)
    K = jnp.stack([
        jnp.stack([zero, -z, y]),
        jnp.stack([z, zero, -x]),
        jnp.stack([-y, x, zero]),
    ])
    s, c = jnp.sin(angle), jnp.cos(angle)
    return jnp.eye(3, dtype=axis.dtype) + s * K + (1.0 - c) * _mat_mul(K, K)


def fk_frames(robot: RobotSpec, q: jnp.ndarray):
    """All joint frames for one configuration.

    Returns (pos [d,3] joint origins, rot [d,3,3] post-joint rotations,
    axis_w [d,3] joint axes in world frame). Fully unrolled over joints
    (d <= ~10): a rolled scan would nest a while loop inside the solver's
    iteration loop, which is launch-latency-bound.
    """

    def step(carry, inp):
        p, R = carry
        jtype, axis, offset, rot_fixed, qi = inp
        p_j = p + _mat_vec(R, offset)
        # static skip (RobotSpec.rot_fixed_identity, computed at
        # construction): identity fixed rotations are the common case and
        # the 3x3 multiply is wasted work
        R_mid = R if robot.rot_fixed_identity else _mat_mul(R, rot_fixed)
        axis_w = _mat_vec(R_mid, axis)
        is_prism = (jtype == PRISMATIC)
        R_new = jnp.where(is_prism, R_mid, _mat_mul(R_mid, rodrigues(axis, qi)))
        # Emit the POST-joint-motion origin: identical to p_j for revolute
        # joints (rotation fixes the origin), but for prismatic joints the
        # link frame must carry the translation so that bodies attached to
        # the link move with q (matches the prismatic Jacobian column below).
        p_new = jnp.where(is_prism, p_j + axis_w * qi, p_j)
        return (p_new, R_new), (p_new, R_new, axis_w)

    init = (robot.base_pos.astype(q.dtype), robot.base_rot.astype(q.dtype))
    xs = (robot.joint_type, robot.joint_axis.astype(q.dtype),
          robot.joint_offset.astype(q.dtype), robot.joint_rot.astype(q.dtype), q)
    _, (pos, rot, axis_w) = jax.lax.scan(step, init, xs, unroll=True)
    return pos, rot, axis_w


def body_positions(robot: RobotSpec, q: jnp.ndarray) -> jnp.ndarray:
    """World positions of the sphere bodies: [B, 3]."""
    pos, rot, _ = fk_frames(robot, q)
    link_p = pos[robot.body_link]                     # [B, 3] joint origins
    link_R = rot[robot.body_link]                     # [B, 3, 3]
    return link_p + _mat_vec(link_R, robot.body_offset.astype(q.dtype))


def body_positions_and_jacobians(robot: RobotSpec, q: jnp.ndarray):
    """Sphere positions [B,3] and point Jacobians J [B,3,d] (CHOMP, A.11).

    For a serial chain, joint i moves body b iff i <= body_link[b]:
    revolute column  w_i x (x_b - p_i), prismatic column w_i.
    """
    pos, rot, axis_w = fk_frames(robot, q)
    link_p = pos[robot.body_link]
    link_R = rot[robot.body_link]
    x = link_p + _mat_vec(link_R, robot.body_offset.astype(q.dtype))

    rel = x[:, None, :] - pos[None, :, :]             # [B, d, 3]
    rev_cols = jnp.cross(axis_w[None, :, :], rel)     # [B, d, 3]
    prism = (robot.joint_type == PRISMATIC)[None, :, None]
    cols = jnp.where(prism, axis_w[None, :, :], rev_cols)
    d = robot.num_joints
    mask = (jnp.arange(d)[None, :] <= robot.body_link[:, None])[:, :, None]
    J = jnp.where(mask, cols, 0.0)                    # [B, d, 3]
    return x, jnp.swapaxes(J, 1, 2)                   # [B, 3, d]


# Convenience batched forms (waypoint axis), used by the cost pipeline.
body_positions_traj = jax.vmap(body_positions, in_axes=(None, 0))
body_pos_jac_traj = jax.vmap(body_positions_and_jacobians, in_axes=(None, 0))
