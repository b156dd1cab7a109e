"""CHOMP functional-gradient step — the deterministic variant on the same kernels.

Reference equivalent: the ``ChompOptimizer`` lineage this package was forked
from (SURVEY §4.5); required by BASELINE config 3. Shares FK, SDF, potential,
R⁻¹/M, and joint-limit machinery with STOMP; only the update rule differs.

Contract: SURVEY Appendix A.11. Both forms are provided:
  - simplified: ∇q(t) = Σ_b J_bᵀ (pot'·∇d) ‖ẋ_b‖ dt
  - full CHOMP: ∇q(t) = Σ_b J_bᵀ ‖ẋ_b‖ [(I − x̂̇x̂̇ᵀ) pot'·∇d − pot·κ] dt with
    curvature κ = ‖ẋ‖⁻² (I − x̂̇x̂̇ᵀ) ẍ
plus the smoothness term Rθ + R_bias q; update θ ← θ − η·M·∇.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpustomp.costs.obstacle import potential, potential_deriv, workspace_velocity
from tpustomp.costs.smoothness import smoothness_gradient
from tpustomp.robot.fk import body_pos_jac_traj
from tpustomp.robot.model import RobotSpec
from tpustomp.world.sdf import sdf_grad

_SPEED_EPS = 1e-6


def _dls_solve3(J: jnp.ndarray, b: jnp.ndarray, ridge: float) -> jnp.ndarray:
    """(J Jᵀ + ridge·I)⁻¹ b for J: [..., 3, d], b: [..., 3] → [..., 3].

    Closed-form symmetric 3×3 solve (adjugate/det) in explicit multiply-add —
    a batched ``linalg.solve`` would run a tiny LU factorization per body
    and waypoint as a separate batched library call instead of fusing.
    """
    G = jnp.sum(J[..., :, None, :] * J[..., None, :, :], axis=-1)
    a = G[..., 0, 0] + ridge
    p = G[..., 0, 1]
    q = G[..., 0, 2]
    d = G[..., 1, 1] + ridge
    r = G[..., 1, 2]
    f = G[..., 2, 2] + ridge
    # adjugate of the symmetric matrix [[a,p,q],[p,d,r],[q,r,f]]
    A = d * f - r * r
    B = q * r - p * f
    C = p * r - q * d
    D = a * f - q * q
    E = p * q - a * r
    F = a * d - p * p
    det = a * A + p * B + q * C
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    y0 = (A * b0 + B * b1 + C * b2) / det
    y1 = (B * b0 + D * b1 + E * b2) / det
    y2 = (C * b0 + E * b1 + F * b2) / det
    return jnp.stack([y0, y1, y2], axis=-1)


def obstacle_functional_gradient(robot: RobotSpec, world, full_traj: jnp.ndarray,
                                 dt: float, clearance: float,
                                 use_curvature: bool = True,
                                 use_pseudo_inverse: bool = False,
                                 pinv_ridge: float = 1e-4) -> jnp.ndarray:
    """∇_θ q_obs at the interior waypoints: [N, d] (A.11).

    ``use_pseudo_inverse`` maps each body's workspace term through the damped
    Jacobian pseudo-inverse J⁺ = Jᵀ(JJᵀ + ridge·I)⁻¹ instead of plain Jᵀ —
    the reference's ``use_pseudo_inverse`` / ``pseudo_inverse_ridge_factor``
    knobs (SURVEY §7.3): the update then follows the joint motion that
    *realizes* the workspace displacement rather than the force map, which
    equalizes step size across well- and poorly-conditioned arm poses.
    """
    x, J = body_pos_jac_traj(robot, full_traj)        # [T,B,3], [T,B,3,d]
    vel = workspace_velocity(x, dt)                   # [T,B,3]
    speed = jnp.linalg.norm(vel, axis=-1)             # [T,B]
    dist, grad_d = sdf_grad(world, x)                 # [T,B], [T,B,3]
    d_sig = dist - robot.body_radius[None, :] - clearance
    pd = potential_deriv(d_sig, clearance)            # [T,B]

    if use_curvature:
        xhat = vel / (speed[..., None] + _SPEED_EPS)
        proj = lambda v: v - xhat * jnp.sum(xhat * v, axis=-1, keepdims=True)
        accel = workspace_velocity(vel, dt)           # central diff of velocity
        kappa = proj(accel) / (speed[..., None] ** 2 + _SPEED_EPS)
        pot_val = potential(d_sig, clearance)
        ws = speed[..., None] * (proj(pd[..., None] * grad_d)
                                 - pot_val[..., None] * kappa) * dt
    else:
        ws = pd[..., None] * grad_d * speed[..., None] * dt

    if use_pseudo_inverse:
        ws = _dls_solve3(J, ws, pinv_ridge)           # (JJᵀ+λI)⁻¹ ws

    # explicit multiply-add instead of einsum: the contraction dims (B, 3)
    # are tiny, so a dot buys nothing over a fused elementwise reduce
    g = jnp.sum(ws[..., None] * J, axis=(1, 2))       # [T, d]
    return g[1:-1]                                    # interior rows only


def exact_obstacle_gradient(robot: RobotSpec, world, theta: jnp.ndarray,
                            q0: jnp.ndarray, qN: jnp.ndarray, dt: float,
                            clearance: float) -> jnp.ndarray:
    """∇_θ Σ_t q_obs(t) by reverse-mode autodiff of the *discretized* cost.

    The functional gradient (A.11) is the continuous-time gradient of
    ∫ pot·‖ẋ‖ dt; after discretization it differs from the true gradient of
    the cost the solver actually monitors by O(dt) terms (the ∂‖ẋ_b(t±1)‖/∂θ_t
    coupling through the central difference). The reference, limited to what
    KDL exposes, could only build the functional form; here the exact
    discrete gradient is one `jax.grad` through the same FK→SDF→potential
    pipeline the evaluator runs (tested against finite differences at 7-DOF,
    tests/unit/test_chomp_gradient7.py). Select with
    PlannerConfig.chomp_gradient_mode="exact".
    """
    from tpustomp.costs.obstacle import obstacle_cost
    from tpustomp.engine.trajectory import full_trajectory

    def cost(th):
        full = full_trajectory(th, q0, qN)
        q, _ = obstacle_cost(robot, world, full, dt, clearance)
        return jnp.sum(q)

    return jax.grad(cost)(theta)


def exact_extra_gradient(robot: RobotSpec, theta: jnp.ndarray,
                         q0: jnp.ndarray, qN: jnp.ndarray, dt: float,
                         constraints, w_constraint: float,
                         w_torque: float) -> jnp.ndarray:
    """∇_θ of the configured constraint (+ torque) cost terms by autodiff.

    The reference's CHOMP ancestor had neither term, and until round 5 the
    CHOMP mode here monitored them in the total while descending a gradient
    without them — a constrained CHOMP solve reported success while leaving
    the constraint violation exactly where the initialization put it. Both
    terms are plain differentiable JAX (quaternion-free frame algebra /
    RNE), so the exact discrete gradient is one `jax.grad` through the same
    functions the evaluator runs."""
    from tpustomp.costs.constraints import constraint_cost
    from tpustomp.costs.torque import torque_cost
    from tpustomp.engine.trajectory import full_trajectory

    def cost(th):
        full = full_trajectory(th, q0, qN)
        c = jnp.float32(0.0)
        if constraints is not None and w_constraint > 0.0:
            c = c + w_constraint * jnp.sum(
                constraint_cost(robot, constraints, full))
        if w_torque > 0.0:
            c = c + w_torque * jnp.sum(torque_cost(robot, full, dt))
        return c

    return jax.grad(cost)(theta)


def chomp_gradient(ops, robot: RobotSpec, world, theta: jnp.ndarray,
                   q0: jnp.ndarray, qN: jnp.ndarray, full_traj: jnp.ndarray,
                   dt: float, clearance: float, w_obstacle: float,
                   w_smoothness: float,
                   use_curvature: bool = True,
                   use_pseudo_inverse: bool = False,
                   pinv_ridge: float = 1e-4,
                   gradient_mode: str = "functional",
                   constraints=None, w_constraint: float = 0.0,
                   w_torque: float = 0.0) -> jnp.ndarray:
    """Raw gradient ∇U = w_o ∇q_obs + w_s (Rθ + R_bias q)
    [+ w_c ∇q_con + w_τ ∇q_τ]: [N, d].

    Shared by the plain CHOMP update and the HMC leapfrog force term (so
    the force field matches the U the Metropolis test evaluates).
    gradient_mode: "functional" (A.11, curvature per use_curvature) or
    "exact" (autodiff of the discretized cost; ignores use_pseudo_inverse,
    which reshapes the workspace force map and has no exact-gradient
    analogue). The constraint/torque terms are always the exact autodiff
    gradient — they have no functional form in the reference."""
    if gradient_mode == "exact":
        g_obs = exact_obstacle_gradient(robot, world, theta, q0, qN, dt,
                                        clearance)
    else:
        g_obs = obstacle_functional_gradient(robot, world, full_traj, dt,
                                             clearance, use_curvature,
                                             use_pseudo_inverse, pinv_ridge)
    g_smooth = smoothness_gradient(ops, theta, q0, qN)
    g = w_obstacle * g_obs + w_smoothness * g_smooth
    if (constraints is not None and w_constraint > 0.0) or w_torque > 0.0:
        g = g + exact_extra_gradient(robot, theta, q0, qN, dt, constraints,
                                     w_constraint, w_torque)
    return g


def chomp_delta(ops, robot: RobotSpec, world, theta: jnp.ndarray,
                q0: jnp.ndarray, qN: jnp.ndarray, full_traj: jnp.ndarray,
                dt: float, clearance: float, w_obstacle: float,
                w_smoothness: float, learning_rate: float,
                use_curvature: bool = True,
                use_pseudo_inverse: bool = False,
                pinv_ridge: float = 1e-4,
                gradient_mode: str = "functional",
                constraints=None, w_constraint: float = 0.0,
                w_torque: float = 0.0) -> jnp.ndarray:
    """One CHOMP update direction: −η·R⁻¹·(w_o ∇q_obs + w_s (Rθ + R_bias q)).

    The R⁻¹ preconditioner makes the smoothness part an exact Newton step
    (R⁻¹(Rθ + R_bias q) = θ − θ*, the pull toward the smoothness minimizer),
    which is what keeps the covariant update stable — STOMP's column-scaled M
    would destroy that exactness and diverge (A.11).
    """
    grad = chomp_gradient(ops, robot, world, theta, q0, qN, full_traj, dt,
                          clearance, w_obstacle, w_smoothness, use_curvature,
                          use_pseudo_inverse, pinv_ridge, gradient_mode,
                          constraints, w_constraint, w_torque)
    # precision=HIGHEST is load-bearing, not hygiene: the Newton-step
    # exactness above is the cancellation R⁻¹(Rθ + R_bias q) = θ − θ*, and
    # a reduced-precision float32 matmul (bf16 passes or TF32, 2⁻⁸–2⁻¹¹
    # relative error against cond(R) ~ N⁴) destroys it — suite success fell
    # from 0.73 to 0.10 without it (docs/EXPERIMENTS.md round-2 note). The
    # 100×100 matmul is far off the hot path, so exact fp32 costs nothing.
    return -learning_rate * jnp.matmul(ops.Rinv, grad,
                                       precision=jax.lax.Precision.HIGHEST)
