"""Cartesian constraint costs (end-effector position / orientation).

Reference equivalent: the constraint evaluator the optimizer adds to the
state cost — e.g. keeping the end effector upright within a tolerance, the
ICRA paper's "glass of water" task (SURVEY §3.1 "Constraint evaluator",
contract A.6).

A constraint is a pytree evaluated at every waypoint on the *last* chain
frame (the end effector). `None` means unconstrained (zero cost) and is
resolved at trace time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpustomp.robot.fk import fk_frames
from tpustomp.robot.model import RobotSpec
from tpustomp.utils import struct


@struct.dataclass
class OrientationConstraint:
    """Keep an EE body axis within `tolerance` radians of a world direction.

    axis_local: [3] unit axis in the EE frame (e.g. the cup's up axis).
    target_world: [3] unit world direction it should point along.
    tolerance: radians of allowed cone half-angle (cost is quadratic in the
    excess geodesic angle, A.6).
    weight: per-constraint scale (multiplies CostWeights.constraint).
    """

    axis_local: jnp.ndarray
    target_world: jnp.ndarray
    tolerance: jnp.ndarray
    weight: jnp.ndarray

    @staticmethod
    def make(axis_local=(0, 0, 1), target_world=(0, 0, 1),
             tolerance=0.2, weight=1.0) -> "OrientationConstraint":
        f32 = jnp.float32
        return OrientationConstraint(
            axis_local=jnp.asarray(axis_local, f32),
            target_world=jnp.asarray(target_world, f32),
            tolerance=jnp.asarray(tolerance, f32),
            weight=jnp.asarray(weight, f32),
        )


@struct.dataclass
class PositionConstraint:
    """Keep the EE origin within `tolerance` meters of a world point."""

    target_world: jnp.ndarray
    tolerance: jnp.ndarray
    weight: jnp.ndarray

    @staticmethod
    def make(target_world, tolerance=0.05, weight=1.0) -> "PositionConstraint":
        f32 = jnp.float32
        return PositionConstraint(
            target_world=jnp.asarray(target_world, f32),
            tolerance=jnp.asarray(tolerance, f32),
            weight=jnp.asarray(weight, f32),
        )


def _cost_one(robot: RobotSpec, constraint, q: jnp.ndarray) -> jnp.ndarray:
    """One constraint's cost at configuration q, from the EE frame."""
    pos, rot, _ = fk_frames(robot, q)
    p, R = pos[-1], rot[-1]
    if isinstance(constraint, OrientationConstraint):
        a = constraint.axis_local
        ach = [R[i, 0] * a[0] + R[i, 1] * a[1] + R[i, 2] * a[2]
               for i in range(3)]
        t = constraint.target_world
        cosang = jnp.clip(ach[0] * t[0] + ach[1] * t[1] + ach[2] * t[2],
                          -1.0, 1.0)
        excess = jnp.maximum(jnp.arccos(cosang) - constraint.tolerance, 0.0)
        return constraint.weight * excess**2
    if isinstance(constraint, PositionConstraint):
        o = robot.ee_offset
        rel = [p[i] + R[i, 0] * o[0] + R[i, 1] * o[1] + R[i, 2] * o[2]
               - constraint.target_world[i] for i in range(3)]
        dist = jnp.sqrt(rel[0]**2 + rel[1]**2 + rel[2]**2)
        excess = jnp.maximum(dist - constraint.tolerance, 0.0)
        return constraint.weight * excess**2
    raise TypeError(f"unknown constraint type {type(constraint)}")


def constraint_cost(robot: RobotSpec, constraints, full_traj: jnp.ndarray) -> jnp.ndarray:
    """Summed constraint cost per waypoint. full_traj [N+2, d] -> [N+2].

    `constraints`: None, a single constraint, or a tuple of constraints
    (resolved statically at trace time).
    """
    T = full_traj.shape[0]
    if constraints is None:
        return jnp.zeros((T,), full_traj.dtype)
    if not isinstance(constraints, (tuple, list)):
        constraints = (constraints,)
    total = jnp.zeros((T,), full_traj.dtype)
    for c in constraints:
        total = total + jax.vmap(lambda q, c=c: _cost_one(robot, c, q))(full_traj)
    return total
