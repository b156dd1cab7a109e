"""Optional torque cost via batched recursive Newton-Euler inverse dynamics.

Reference equivalent (SURVEY §3.2/A.8): KDL's ``ChainIdSolver_RNE`` feeding
``StompOptimizer``'s torque cost term; off by default there and here
(CostWeights.torque = 0).

Formulation: the world-frame Newton-Euler recursion down and up the
serial chain, written as two `lax.scan`s (unrolled — d ≤ ~10); joint
velocities/accelerations come from the same central-difference stencils as
the smoothness operator. All of it vmaps over waypoints/rollouts/scenarios.

Cost contract (A.8): q_torque(t) = Σ_j |τ_j(t)| · dt.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpustomp.robot.fk import fk_frames, _mat_mul, _mat_vec
from tpustomp.robot.model import RobotSpec, PRISMATIC

GRAVITY = jnp.asarray([0.0, 0.0, -9.81], jnp.float32)


def rne_torques(robot: RobotSpec, q: jnp.ndarray, qd: jnp.ndarray,
                qdd: jnp.ndarray, gravity=GRAVITY) -> jnp.ndarray:
    """Joint torques for one configuration. q, qd, qdd: [d] -> tau [d]."""
    d = robot.num_joints
    pos, rot, axis_w = fk_frames(robot, q)
    is_prism = (robot.joint_type == PRISMATIC)

    # ---- forward pass: velocities/accelerations of each joint frame ----
    def fwd(carry, i):
        om_p, al_p, a_p, p_p = carry
        w = axis_w[i]
        r = pos[i] - p_p
        # acceleration of this frame's origin (rigidly attached to parent)
        a_o = a_p + jnp.cross(al_p, r) + jnp.cross(om_p, jnp.cross(om_p, r))
        prism = is_prism[i]
        om = om_p + jnp.where(prism, 0.0, 1.0) * w * qd[i]
        al = (al_p + jnp.where(prism, 0.0, 1.0)
              * (w * qdd[i] + jnp.cross(om_p, w * qd[i])))
        a = jnp.where(
            prism,
            a_o + w * qdd[i] + 2.0 * jnp.cross(om_p, w * qd[i]),
            a_o)
        return (om, al, a, pos[i]), (om, al, a)

    # emulate gravity by accelerating the base at -g (standard RNE trick)
    init = (jnp.zeros(3, q.dtype), jnp.zeros(3, q.dtype),
            -gravity.astype(q.dtype), robot.base_pos.astype(q.dtype))
    _, (omega, alpha, acc) = jax.lax.scan(fwd, init, jnp.arange(d), unroll=True)

    # ---- link wrenches about each joint origin ----
    com_w = pos + _mat_vec(rot, robot.link_com.astype(q.dtype))
    rc = com_w - pos
    a_com = (acc + jnp.cross(alpha, rc)
             + jnp.cross(omega, jnp.cross(omega, rc)))
    F = robot.link_mass[:, None] * a_com                       # [d, 3]
    I_w = _mat_mul(_mat_mul(rot, robot.link_inertia.astype(q.dtype)),
                   jnp.swapaxes(rot, -1, -2))
    N = (_mat_vec(I_w, alpha) + jnp.cross(omega, _mat_vec(I_w, omega)))

    # ---- backward pass: accumulate child wrenches toward the base ----
    def bwd(carry, i):
        f_c, n_c, p_c = carry
        f = F[i] + f_c
        n = (N[i] + n_c + jnp.cross(com_w[i] - pos[i], F[i])
             + jnp.cross(p_c - pos[i], f_c))
        return (f, n, pos[i]), (f, n)

    initb = (jnp.zeros(3, q.dtype), jnp.zeros(3, q.dtype), pos[d - 1])
    _, (f_all, n_all) = jax.lax.scan(bwd, initb, jnp.arange(d - 1, -1, -1),
                                     unroll=True)
    f_all = f_all[::-1]
    n_all = n_all[::-1]
    tau = jnp.where(is_prism,
                    jnp.sum(axis_w * f_all, axis=-1),
                    jnp.sum(axis_w * n_all, axis=-1))
    return tau


def joint_derivatives(full_traj: jnp.ndarray, dt: float):
    """Central-difference q̇, q̈ at the true waypoints. [T, d] -> ([T,d],[T,d])."""
    qd = jnp.zeros_like(full_traj)
    qd = qd.at[1:-1].set((full_traj[2:] - full_traj[:-2]) / (2.0 * dt))
    qdd = jnp.zeros_like(full_traj)
    qdd = qdd.at[1:-1].set(
        (full_traj[2:] - 2.0 * full_traj[1:-1] + full_traj[:-2]) / dt**2)
    return qd, qdd


def torque_cost(robot: RobotSpec, full_traj: jnp.ndarray, dt: float,
                gravity=GRAVITY) -> jnp.ndarray:
    """Per-waypoint torque cost row [T]: Σ_j |τ_j(t)| · dt  (A.8)."""
    qd, qdd = joint_derivatives(full_traj, dt)
    tau = jax.vmap(lambda a, b, c: rne_torques(robot, a, b, c, gravity))(
        full_traj, qd, qdd)
    return jnp.sum(jnp.abs(tau), axis=-1) * dt
