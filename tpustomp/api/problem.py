"""Problem and solution types — the framework's "service API" payloads.

Reference equivalent: the `GetMotionPlan` request/response handled by
`StompPlannerNode::planKinematicPath` (SURVEY §2 L6/L7, §4.2): start joint
state + goal joint constraints in, `JointTrajectory` + success + timing out.
Here both sides are jit-able pytrees so that thousands of problems batch with
`vmap` and shard over a device mesh (SURVEY §3.3 — the scenario axis is the
primary parallel axis).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpustomp.utils import struct


@struct.dataclass
class ProblemSpec:
    """One planning query: go from q0 to qN.

    q0, qN: [d] joint values (the reference's start_state / joint goal
    constraints). Batched problems stack a leading axis on both.

    goal_tolerance_below / goal_tolerance_above: optional per-joint
    tolerance band around qN — the reference's
    ``req.goal_constraints.joint_constraints`` carry a position plus
    tolerance_above/below, and any endpoint within
    [qN − below, qN + above] satisfies the goal (SURVEY §4.2 [M]). A scalar
    broadcasts over joints; None (default) means an exact goal. When a band
    is given, the planner selects the feasible endpoint in the band nearest
    the nominal (api/plan.resolve_goal_tolerance), so a goal that is
    joint-limit- or collision-infeasible but reachable within tolerance
    still plans successfully.
    """

    q0: jnp.ndarray
    qN: jnp.ndarray
    goal_tolerance_below: jnp.ndarray | None = None
    goal_tolerance_above: jnp.ndarray | None = None


@struct.dataclass
class IterationMetrics:
    """Per-iteration observability arrays (SURVEY §6 metrics row).

    All [max_iterations]-shaped; entries past the converged iteration hold the
    frozen final values (masked fixed-trip iteration, SURVEY §8.3 part 4).
    """

    total_cost: jnp.ndarray       # cost of the updated trajectory
    obstacle_cost: jnp.ndarray
    smoothness_cost: jnp.ndarray
    constraint_cost: jnp.ndarray
    collision_free: jnp.ndarray   # bool per iteration


@struct.dataclass
class Solution:
    """Planner output.

    trajectory: [N+2, d] — all true waypoints including the fixed endpoints
    (the reference returns a `JointTrajectory` with uniform dt timing; here
    `times` carries the same information).
    """

    trajectory: jnp.ndarray
    times: jnp.ndarray            # [N+2] uniform dt timestamps
    success: jnp.ndarray          # bool — collision-free at termination
    cost: jnp.ndarray             # best total cost achieved
    iterations: jnp.ndarray       # iterations actually used
    metrics: IterationMetrics | None = None
