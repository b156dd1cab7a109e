"""Device-side smoothness (control) cost: 1/2 Σ_j Σ_d w_d ||A_d θ_j + B_d q_j||².

Reference equivalent: ``CovariantTrajectoryPolicy::computeControlCosts`` /
``StompCost`` (SURVEY §3.1); contract SURVEY A.2. The endpoint bias B q
replaces the reference's duplicated-endpoint padding (SURVEY §8.1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpustomp.dynamics.device import DeviceOps

# The A-operator rows are finite-difference stencils: their dot with θ
# suffers catastrophic cancellation if inputs are rounded (bf16, TF32; adjacent
# waypoints differ in the 3rd decimal), so these matmuls stay true-fp32.
_HI = jax.lax.Precision.HIGHEST


def smoothness_cost_per_timestep(ops: DeviceOps, theta: jnp.ndarray,
                                 q0: jnp.ndarray, qN: jnp.ndarray) -> jnp.ndarray:
    """Control cost resolved per true waypoint: [N+2] row.

    Row t = 1/2 Σ_d w_d Σ_j deriv_d(t, j)²; sums to the scalar cost. The PI²
    probability weighting optionally consumes this row (pi2_include_control_cost).
    """
    q = jnp.stack([q0, qN], axis=0)                     # [2, d]
    deriv = (jnp.einsum("arn,nd->ard", ops.A_stack, theta, precision=_HI)
             + jnp.einsum("arq,qd->ard", ops.B_stack, q, precision=_HI))
    per_dt = 0.5 * jnp.sum(deriv * deriv, axis=2)          # [D, N+2]
    return jnp.einsum("a,ar->r", ops.w, per_dt)            # [N+2]


def smoothness_cost(ops: DeviceOps, theta: jnp.ndarray,
                    q0: jnp.ndarray, qN: jnp.ndarray) -> jnp.ndarray:
    """theta [N, d]; q0, qN [d] -> scalar cost."""
    return jnp.sum(smoothness_cost_per_timestep(ops, theta, q0, qN))


def smoothness_gradient(ops: DeviceOps, theta: jnp.ndarray,
                        q0: jnp.ndarray, qN: jnp.ndarray) -> jnp.ndarray:
    """∂cost/∂θ = R θ + R_bias [q0; qN]  (CHOMP smoothness term, A.11)."""
    q = jnp.stack([q0, qN], axis=0)
    return (jnp.einsum("nm,md->nd", ops.R, theta, precision=_HI)
            + jnp.einsum("nq,qd->nd", ops.R_bias, q, precision=_HI))
