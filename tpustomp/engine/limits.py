"""Joint-limit handling: smoothness-preserving projection inside jit.

Reference equivalent: ``StompOptimizer::handleJointLimits`` (SURVEY §3.1) —
iteratively finds the worst violation at waypoint t*, adds a multiple of the
R⁻¹ column through t* (so the correction is maximally smooth and endpoint-
preserving), and repeats until clean.

Two array formulations (SURVEY §8.3 hard part 3), selected by
``PlannerConfig.joint_limit_method``:

  - "sequential": the reference's scheme with a fixed trip count (a no-op
    once clean) — bit-matches the CPU oracle; its per-trip argmax + dynamic
    column gather forms a long dependency chain of small ops, so it is the
    slower choice inside the latency-critical solver loop.
  - "jacobi" (default): all violations corrected simultaneously each pass,
    θ ← θ − R⁻¹ (v ⊘ diag R⁻¹), i.e. the same per-column smooth correction
    applied in parallel (Jacobi iteration on the violated block). One
    [N,N]×[N,d] matmul per pass for ALL joints — straight-line code.
    Overlapping columns can overshoot transiently; passes contract and the
    final clamp guarantees feasibility either way (documented deviation;
    equivalence-of-outcome covered by tests/unit/test_limits.py).

Both end with a hard clamp, so feasibility is unconditional.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _violation(th, lo, hi):
    return jnp.maximum(th - hi, 0.0) + jnp.minimum(th - lo, 0.0)


def project_limits_sequential(theta: jnp.ndarray, lower, upper, limited,
                              Rinv: jnp.ndarray, iterations: int) -> jnp.ndarray:
    """Reference-style worst-violation-first projection (A.7)."""

    def per_joint(th, lo, hi, lim):
        def body(_, th):
            viol = _violation(th, lo, hi)
            t_star = jnp.argmax(jnp.abs(viol))
            v = viol[t_star]
            col = Rinv[:, t_star] / Rinv[t_star, t_star]
            return th - v * col

        # static trip count, unrolled: keeps the projection inside the outer
        # jit as straight-line fusible ops instead of a nested while loop
        smoothed = jax.lax.fori_loop(0, iterations, body, th, unroll=True)
        clamped = jnp.clip(smoothed, lo, hi)
        return jnp.where(lim, clamped, th)

    return jax.vmap(per_joint, in_axes=(1, 0, 0, 0), out_axes=1)(
        theta, lower, upper, limited)


def project_limits_jacobi(theta: jnp.ndarray, lower, upper, limited,
                          Rinv: jnp.ndarray, iterations: int) -> jnp.ndarray:
    """Simultaneous smooth correction: one matmul per pass over all joints."""
    diag = jnp.diagonal(Rinv)[:, None]                  # [N, 1]
    lim = limited[None, :]
    lo = lower[None, :]
    hi = upper[None, :]
    th = theta
    for _ in range(iterations):
        v = jnp.where(lim, _violation(th, lo, hi), 0.0)  # [N, d]
        c = Rinv @ (v / diag)                            # smooth correction
        # trust region: overlapping columns can overshoot when many waypoints
        # violate at once; cap each joint's correction at its worst violation
        # magnitude (exact for an isolated violation, contractive in general)
        v_max = jnp.max(jnp.abs(v), axis=0, keepdims=True)
        c_max = jnp.max(jnp.abs(c), axis=0, keepdims=True)
        th = th - c * jnp.minimum(1.0, v_max / (c_max + 1e-12))
    return jnp.where(lim, jnp.clip(th, lo, hi), theta)


def project_limits(theta: jnp.ndarray, lower, upper, limited,
                   Rinv: jnp.ndarray, iterations: int,
                   method: str = "jacobi") -> jnp.ndarray:
    """theta [N, d] -> limit-feasible [N, d] (A.7)."""
    if method == "sequential":
        return project_limits_sequential(theta, lower, upper, limited, Rinv,
                                         iterations)
    return project_limits_jacobi(theta, lower, upper, limited, Rinv,
                                 iterations)
