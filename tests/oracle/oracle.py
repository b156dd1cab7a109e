"""Golden CPU oracle — dependency-free NumPy reference for SURVEY.md Appendix A.

This file IS the ground truth while /root/reference is empty (SURVEY §0, §5):
every JAX kernel in tpustomp must match it to fp32 tolerance under shared
noise. It is deliberately written with plain loops and without importing
tpustomp, so agreement between the two is a real check, not a tautology.

Conventions (shared contract, documented once here):
  - A trajectory θ is [N, d]: N free interior waypoints, d joints. The true
    trajectory adds fixed endpoints q0 (t=0) and qN (t=N+1); dt = T/(N+1).
  - Derivatives are evaluated at all N+2 true waypoints using central
    stencils over the endpoint-duplicated padded sequence.
  - Sampling covariance = R^-1 / max|R^-1| (so stddev sets waypoint scale).
  - M = R^-1 with columns rescaled to max-abs 1/N.
  - PI^2: per-timestep min-max normalize state costs over rollouts,
    P = softmax(-h S~), update δθ = Σ_k P_k ε_k, smoothed through M.
"""

from __future__ import annotations

import numpy as np

STENCILS = {
    "fd3": {1: ([-0.5, 0.0, 0.5], 1), 2: ([1.0, -2.0, 1.0], 1),
            3: ([-0.5, 1.0, 0.0, -1.0, 0.5], 2)},
    "fd5": {1: ([1 / 12, -8 / 12, 0.0, 8 / 12, -1 / 12], 2),
            2: ([-1 / 12, 16 / 12, -30 / 12, 16 / 12, -1 / 12], 2),
            3: ([-0.5, 1.0, 0.0, -1.0, 0.5], 2)},
    "fd7": {1: ([-1 / 60, 9 / 60, -45 / 60, 0.0, 45 / 60, -9 / 60, 1 / 60], 3),
            2: ([2 / 180, -27 / 180, 270 / 180, -490 / 180, 270 / 180,
                 -27 / 180, 2 / 180], 3),
            3: ([1 / 8, -8 / 8, 13 / 8, 0.0, -13 / 8, 8 / 8, -1 / 8], 3)},
}


# --------------------------------------------------------------- A.1 init
def min_jerk(q0, qN, N, T):
    """Min-jerk interpolation at the N interior waypoints. q0,qN: [d]."""
    q0, qN = np.asarray(q0, float), np.asarray(qN, float)
    out = np.zeros((N, len(q0)))
    for i in range(N):
        u = (i + 1) * (T / (N + 1)) / T
        s = 10 * u**3 - 15 * u**4 + 6 * u**5
        out[i] = q0 + s * (qN - q0)
    return out


def padded(theta_j, q0_j, qN_j, r):
    """Endpoint-duplicated padded sequence for one joint: length N+2+2r."""
    N = len(theta_j)
    seq = np.empty(N + 2 + 2 * r)
    seq[: r + 1] = q0_j
    seq[r + 1 : r + 1 + N] = theta_j
    seq[r + 1 + N :] = qN_j
    return seq


def derivative(theta_j, q0_j, qN_j, order, dt, stencil="fd3"):
    """d-th derivative at the N+2 true waypoints (loops, per joint)."""
    coeffs, r = STENCILS[stencil][order]
    seq = padded(theta_j, q0_j, qN_j, r)
    N = len(theta_j)
    out = np.zeros(N + 2)
    for t in range(N + 2):
        # padded index of true waypoint t is t + r; taps cover t .. t + 2r
        acc = 0.0
        for k, c in enumerate(coeffs):
            acc += c * seq[t + k]
        out[t] = acc / dt**order
    return out


# --------------------------------------------------------------- A.2 R
def build_R(N, dt, weights=(0.0, 1.0, 0.0), stencil="fd3", ridge=0.0):
    """R via quadratic-form extraction: R[i,j] from cost of basis vectors.

    Independent construction: evaluates 1/2 Σ_d w_d ||deriv_d||^2 on unit
    vectors, so any indexing bug in a direct assembly would be caught.
    """
    def cost(theta_j):
        c = 0.0
        for order, w in zip((1, 2, 3), weights):
            if w == 0.0:
                continue
            dv = derivative(theta_j, 0.0, 0.0, order, dt, stencil)
            c += 0.5 * w * float(dv @ dv)
        return c

    R = np.zeros((N, N))
    e = np.eye(N)
    diag = np.array([2 * cost(e[i]) for i in range(N)])
    for i in range(N):
        R[i, i] = diag[i]
        for j in range(i + 1, N):
            cij = cost(e[i] + e[j])
            R[i, j] = R[j, i] = cij - 0.5 * diag[i] - 0.5 * diag[j]
    if ridge:
        R += ridge * np.eye(N)
    return R


def smoothness_cost(theta, q0, qN, dt, weights=(0.0, 1.0, 0.0), stencil="fd3"):
    """1/2 Σ_j Σ_d w_d ||deriv_d(θ_j)||^2 with endpoint bias included."""
    total = 0.0
    for j in range(theta.shape[1]):
        for order, w in zip((1, 2, 3), weights):
            if w == 0.0:
                continue
            dv = derivative(theta[:, j], q0[j], qN[j], order, dt, stencil)
            total += 0.5 * w * float(dv @ dv)
    return total


def sampling_factor(R):
    """L with cov = R^-1/max|R^-1|; returns (L, cov_scale)."""
    Rinv = np.linalg.inv(R)
    Rinv = 0.5 * (Rinv + Rinv.T)
    s = np.abs(Rinv).max()
    return np.linalg.cholesky(Rinv / s), s


def M_matrix(R):
    """R^-1 with columns rescaled so each column's max-abs element is 1/N."""
    N = R.shape[0]
    Rinv = np.linalg.inv(R)
    Rinv = 0.5 * (Rinv + Rinv.T)
    M = np.zeros_like(Rinv)
    for c in range(N):
        M[:, c] = Rinv[:, c] / (N * np.abs(Rinv[:, c]).max())
    return M


# --------------------------------------------------------------- A.4 potential
def potential(d_signed, eps):
    """CHOMP obstacle potential, C^1 at d=0 and d=eps."""
    d = np.asarray(d_signed, float)
    out = np.where(
        d < 0.0, -d + 0.5 * eps,
        np.where(d <= eps, (d - eps) ** 2 / (2.0 * eps), 0.0),
    )
    return out


# --------------------------------------------------------------- planar 2R FK
def fk_planar2r(q, link_lengths=(1.0, 1.0)):
    """Joint-2 and end-effector xy positions of a planar 2R arm. q: [2]."""
    l1, l2 = link_lengths
    p1 = np.array([l1 * np.cos(q[0]), l1 * np.sin(q[0])])
    p2 = p1 + np.array([l2 * np.cos(q[0] + q[1]), l2 * np.sin(q[0] + q[1])])
    return p1, p2


def jac_planar2r_ee(q, link_lengths=(1.0, 1.0)):
    """Analytic end-effector Jacobian (2x2) of the planar 2R arm."""
    l1, l2 = link_lengths
    s1, c1 = np.sin(q[0]), np.cos(q[0])
    s12, c12 = np.sin(q[0] + q[1]), np.cos(q[0] + q[1])
    return np.array([[-l1 * s1 - l2 * s12, -l2 * s12],
                     [l1 * c1 + l2 * c12, l2 * c12]])


# --------------------------------------------------------------- EDT / SDF
def brute_force_edt(occ, resolution):
    """Signed EDT of a boolean occupancy grid by brute force. occ: [X,Y,Z]."""
    occ = np.asarray(occ, bool)
    shape = occ.shape
    pts = np.argwhere(occ)
    free = np.argwhere(~occ)
    out = np.zeros(shape, float)
    idx = np.indices(shape).reshape(3, -1).T
    if len(pts):
        d_occ = np.sqrt(((idx[:, None, :] - pts[None, :, :]) ** 2).sum(-1)).min(1)
    else:
        d_occ = np.full(len(idx), np.inf)
    if len(free):
        d_free = np.sqrt(((idx[:, None, :] - free[None, :, :]) ** 2).sum(-1)).min(1)
    else:
        d_free = np.full(len(idx), np.inf)
    signed = np.where(occ.reshape(-1), -d_free, d_occ)
    return (signed * resolution).reshape(shape)


def trilinear(grid, origin, resolution, p):
    """Trilinear interpolation of grid at world point p (clamped)."""
    g = (np.asarray(p, float) - origin) / resolution
    g = np.clip(g, 0.0, np.array(grid.shape) - 1.000001)
    i = np.floor(g).astype(int)
    i = np.minimum(i, np.array(grid.shape) - 2)
    f = g - i
    v = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[0] if dx else 1 - f[0]) * (f[1] if dy else 1 - f[1])
                     * (f[2] if dz else 1 - f[2]))
                v += w * grid[i[0] + dx, i[1] + dy, i[2] + dz]
    return v


# --------------------------------------------------------------- A.9/A.10 PI^2
def pi2_probabilities(S, h=10.0):
    """S: [K, N] per-rollout per-timestep state cost -> P: [K, N]."""
    K, N = S.shape
    P = np.zeros_like(S)
    for t in range(N):
        col = S[:, t]
        lo, hi = col.min(), col.max()
        Snorm = (col - lo) / (hi - lo + 1e-8)
        e = np.exp(-h * Snorm)
        P[:, t] = e / e.sum()
    return P


def pi2_update(eps, S, M, h=10.0):
    """eps: [K, N, d] noise; S: [K, N] costs -> smoothed update [N, d]."""
    P = pi2_probabilities(S, h)
    K, N, d = eps.shape
    delta = np.zeros((N, d))
    for t in range(N):
        for j in range(d):
            delta[t, j] = float(P[:, t] @ eps[:, t, j])
    return M @ delta


# --------------------------------------------------------------- A.7 limits
def joint_limit_projection(theta, lo, hi, Rinv, iters=10):
    """Reference-style iterative clamp: push worst violation through R^-1 col."""
    theta = theta.copy()
    N, d = theta.shape
    for j in range(d):
        for _ in range(iters):
            viol = np.maximum(theta[:, j] - hi[j], 0) + np.minimum(theta[:, j] - lo[j], 0)
            if np.all(viol == 0):
                break
            t_star = int(np.argmax(np.abs(viol)))
            v = viol[t_star]
            theta[:, j] -= v * Rinv[:, t_star] / Rinv[t_star, t_star]
        theta[:, j] = np.clip(theta[:, j], lo[j], hi[j])
    return theta


# --------------------------------------------------------------- config-1 solve
def workspace_velocity(pos, dt):
    """Central-difference velocity of body positions over time.

    pos: [N+2, B, 3] positions at all true waypoints -> vel: [N+2, B, 3],
    one-sided at the ends.
    """
    v = np.zeros_like(pos)
    v[1:-1] = (pos[2:] - pos[:-2]) / (2 * dt)
    v[0] = (pos[1] - pos[0]) / dt
    v[-1] = (pos[-1] - pos[-2]) / dt
    return v


def obstacle_cost_planar(theta, q0, qN, dt, sphere_c, sphere_r, body_r,
                         clearance, link_lengths=(1.0, 1.0)):
    """Config-1 obstacle cost per true waypoint: analytic circle SDF in 2D.

    Bodies: joint-2 point and EE point of the planar arm, each a disc of
    radius body_r. Returns q_obs: [N+2].
    """
    N, d = theta.shape
    full = np.vstack([q0[None], theta, qN[None]])     # [N+2, 2]
    pos = np.zeros((N + 2, 2, 3))
    for t in range(N + 2):
        p1, p2 = fk_planar2r(full[t], link_lengths)
        pos[t, 0, :2] = p1
        pos[t, 1, :2] = p2
    vel = workspace_velocity(pos, dt)
    q_obs = np.zeros(N + 2)
    for t in range(N + 2):
        for b in range(2):
            dist = np.linalg.norm(pos[t, b] - sphere_c) - sphere_r
            dsig = dist - body_r - clearance
            q_obs[t] += potential(dsig, clearance) * np.linalg.norm(vel[t, b]) * dt
    return q_obs


def stomp_solve_config1(q0, qN, N, T, z_seq, sphere_c, sphere_r,
                        noise_std=0.1, h=10.0, clearance=0.1, body_r=0.05,
                        decay=0.99, iters=30, weights=(0.0, 1.0, 0.0),
                        link_lengths=(1.0, 1.0), cost_mode="local"):
    """Full STOMP solve of BASELINE config 1 given an injected noise sequence.

    z_seq: [iters, K, N, d] standard-normal draws (shared with the JAX engine
    for exact-parity testing). cost_mode: "local" per-timestep cost or
    "cumulative" cost-to-go (reversed cumsum). Returns (theta, cost_history).
    """
    d = 2
    dt = T / (N + 1)
    R = build_R(N, dt, weights)
    L, _ = sampling_factor(R)
    M = M_matrix(R)
    theta = min_jerk(q0, qN, N, T)
    history = []

    def state_cost(th):
        qo = obstacle_cost_planar(th, q0, qN, dt, sphere_c, sphere_r,
                                  body_r, clearance, link_lengths)
        return qo  # [N+2]

    for it in range(z_seq.shape[0]):
        K = z_seq.shape[1]
        sigma = noise_std * decay**it
        eps = np.zeros((K, N, d))
        S = np.zeros((K, N + 2))
        for k in range(K):
            for j in range(d):
                eps[k, :, j] = sigma * (L @ z_seq[it, k, :, j])
            S[k] = state_cost(theta + eps[k])
        if cost_mode == "cumulative":
            S = np.cumsum(S[:, ::-1], axis=1)[:, ::-1]
        # interior timesteps drive the update (endpoints are fixed)
        delta = pi2_update(eps, S[:, 1:-1], M, h)
        theta = theta + delta
        total = float(state_cost(theta).sum()) + 0.1 * smoothness_cost(
            theta, q0, qN, dt, weights)
        history.append(total)
    return theta, np.array(history)


# --------------------------------------------------------------- chain FK + SDF
# A general serial chain, as plain arrays (the fields of RobotSpec):
#   joint_type [d] (0 revolute, 1 prismatic), joint_axis [d, 3],
#   joint_offset [d, 3], joint_rot [d, 3, 3], base_pos [3], base_rot [3, 3],
#   body_link [B], body_offset [B, 3], body_radius [B].
# Joint i's frame: T_i = T_{i-1} · Trans(offset_i) · RotFixed_i · Joint(q_i).
def rotation(axis, angle):
    """Rotation about unit `axis` by `angle` (axis-angle, Rodrigues)."""
    x, y, z = axis
    K = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def chain_body_positions(chain, q):
    """World positions [B, 3] of the sphere bodies at configuration q [d]."""
    p = np.asarray(chain["base_pos"], float)
    R = np.asarray(chain["base_rot"], float)
    frames_p, frames_R = [], []
    for i in range(len(q)):
        p = p + R @ chain["joint_offset"][i]
        R = R @ chain["joint_rot"][i]
        if chain["joint_type"][i] == 1:             # prismatic
            p = p + (R @ chain["joint_axis"][i]) * q[i]
        else:                                       # revolute
            R = R @ rotation(chain["joint_axis"][i], q[i])
        frames_p.append(p)
        frames_R.append(R)
    out = np.zeros((len(chain["body_link"]), 3))
    for b, link in enumerate(chain["body_link"]):
        out[b] = frames_p[link] + frames_R[link] @ chain["body_offset"][b]
    return out


def trilinear_many(grid, origin, resolution, pts):
    """`trilinear` at every point of pts [..., 3]."""
    flat = np.asarray(pts, float).reshape(-1, 3)
    vals = [trilinear(grid, origin, resolution, p) for p in flat]
    return np.asarray(vals).reshape(np.shape(pts)[:-1])


def world_sdf(world, pts):
    """Signed distance at pts [..., 3] to a world given as a dict with
    optional "spheres" (centers [S, 3], radii [S]), "boxes" (centers [X, 3],
    half extents [X, 3]) and "grid" (values [X, Y, Z], origin [3],
    resolution); the union of all present parts. An empty world is 1e6."""
    pts = np.asarray(pts, float)
    d = np.full(pts.shape[:-1], 1e6)
    if "spheres" in world:
        c, r = world["spheres"]
        for ci, ri in zip(c, r):
            d = np.minimum(d, np.linalg.norm(pts - ci, axis=-1) - ri)
    if "boxes" in world:
        c, h = world["boxes"]
        for ci, hi in zip(c, h):
            q = np.abs(pts - ci) - hi
            outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
            inside = np.minimum(q.max(axis=-1), 0.0)
            d = np.minimum(d, outside + inside)
    if "grid" in world:
        d = np.minimum(d, trilinear_many(*world["grid"], pts))
    return d


def obstacle_cost_chain(chain, world, full, dt, clearance):
    """A.4/A.5 obstacle cost of one full trajectory full [T, d]: the
    potential of each body's clearance, weighted by its workspace speed.
    Returns (q_obs [T], margin), margin = min over waypoints and bodies of
    signed distance minus body radius."""
    pos = np.stack([chain_body_positions(chain, q) for q in full])  # [T,B,3]
    speed = np.linalg.norm(workspace_velocity(pos, dt), axis=-1)     # [T, B]
    dist = world_sdf(world, pos)                                     # [T, B]
    radius = np.asarray(chain["body_radius"], float)
    q_obs = (potential(dist - radius - clearance, clearance)
             * speed).sum(axis=1) * dt
    return q_obs, float((dist - radius).min())


def control_cost_rows(theta, q0, qN, dt, weights=(0.0, 1.0, 0.0),
                      stencil="fd3"):
    """Smoothness cost resolved per true waypoint [N+2]; sums to
    `smoothness_cost`."""
    rows = np.zeros(theta.shape[0] + 2)
    for j in range(theta.shape[1]):
        for order, w in zip((1, 2, 3), weights):
            if w == 0.0:
                continue
            dv = derivative(theta[:, j], q0[j], qN[j], order, dt, stencil)
            rows += 0.5 * w * dv * dv
    return rows
