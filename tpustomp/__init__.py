"""tpustomp — STOMP/CHOMP trajectory optimization in JAX.

A from-scratch re-architecture of the capabilities of the reference planner
``kalakris/stomp_motion_planner_icra2011`` (a single-threaded C++ ROS package;
see SURVEY.md — the reference mount was empty at build time, so the behavioral
contract is SURVEY.md Appendix A, pinned by the NumPy oracle in
``tests/oracle/``).

Design (SURVEY.md §8): everything per-iteration is one pure jitted function —
sample K noisy rollouts from N(0, R^-1), evaluate FK + SDF collision cost for
every (rollout, waypoint, sphere), PI^2 exponentiated-cost softmax over
rollouts, M-smoothed update — batched with vmap over (scenario, rollout,
waypoint, sphere) axes and sharded over a device mesh on the scenario axis.
CHOMP is the deterministic variant on the same kernels.
"""

from tpustomp.api.config import (
    PlannerConfig,
    NoiseConfig,
    CostWeights,
    SmoothnessConfig,
)
from tpustomp.api.problem import ProblemSpec, Solution
from tpustomp.api.plan import (plan, plan_batch, plan_batch_retry,
                               plan_batch_stream, plan_timed)
from tpustomp.api.tune import tune

__version__ = "0.1.0"

__all__ = [
    "PlannerConfig",
    "NoiseConfig",
    "CostWeights",
    "SmoothnessConfig",
    "ProblemSpec",
    "Solution",
    "plan",
    "plan_batch",
    "plan_batch_retry",
    "plan_batch_stream",
    "plan_timed",
    "tune",
]
