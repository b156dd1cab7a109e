"""Finite-difference smoothness operators: A_d, R, R^-1, M, chol.

Reference equivalents (SURVEY.md §3.1, mount empty at build time):
  - ``CovariantTrajectoryPolicy`` — builds differentiation matrices from
    DIFF_RULES and the control-cost matrix R = sum_d w_d A_d^T A_d (+ ridge).
  - ``StompCost`` — per-joint quadratic cost, R^-1, scaled inverse for the
    joint-limit projection.
  - ``stomp_utils.h`` — the FD stencil constants.
  - ``multivariate_gaussian.h`` — N(0, R^-1) sampling via Cholesky.

Deviations from the reference (SURVEY §8.1):
  - The trajectory θ holds ONLY the N free interior waypoints; the fixed
    endpoints (and the stencil padding the reference implements by duplicating
    endpoints in a padded buffer) are folded into a bias matrix B so that the
    derivative at all N+2 true waypoints is  A @ θ + B @ [q0, qN].  Noise
    drawn from N(0, R^-1) therefore has exact zeros at the endpoints by
    construction — no padding hack on device.
  - All N×N precomputation (inverse, Cholesky) is done on host in float64 and
    shipped to device as float32 (SURVEY §8.3 hard part 5). Nothing here runs
    in the hot loop; results are cached per (N, dt, smoothness config).

Contract: SURVEY.md Appendix A.2 (R), A.3 (sampling), A.10 (M).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from tpustomp.api.config import SmoothnessConfig

# Central finite-difference stencils, indexed [derivative][tap]. These are the
# textbook central-difference coefficients (NOT copied from the reference; the
# reference's 7-point DIFF_RULES family serves the same A.2 contract).
_STENCILS = {
    # 3-point family (STOMP-paper formulation)
    "fd3": {
        1: (np.array([-0.5, 0.0, 0.5]), 1),          # velocity, radius 1
        2: (np.array([1.0, -2.0, 1.0]), 1),          # acceleration, radius 1
        3: (np.array([-0.5, 1.0, 0.0, -1.0, 0.5]), 2),  # jerk, radius 2
    },
    # 5-point family (higher order, closer to the reference's 7-pt rules)
    "fd5": {
        1: (np.array([1.0, -8.0, 0.0, 8.0, -1.0]) / 12.0, 2),
        2: (np.array([-1.0, 16.0, -30.0, 16.0, -1.0]) / 12.0, 2),
        3: (np.array([1.0, -2.0, 0.0, 2.0, -1.0]) / -2.0, 2),
    },
    # 7-point family — same DIFF_RULE_LENGTH=7 shape as the reference's
    # stomp_utils.h rules (SURVEY A.2 [M]), built from textbook central
    # coefficients (vel/acc O(h^6), jerk O(h^4)); verified exact on degree-5
    # polynomials in tests. If a populated mount reveals different reference
    # constants, swapping them here is a pure config-level change
    # (SURVEY §8.3 hard part 2).
    "fd7": {
        1: (np.array([-1.0, 9.0, -45.0, 0.0, 45.0, -9.0, 1.0]) / 60.0, 3),
        2: (np.array([2.0, -27.0, 270.0, -490.0, 270.0, -27.0, 2.0]) / 180.0, 3),
        3: (np.array([1.0, -8.0, 13.0, 0.0, -13.0, 8.0, -1.0]) / 8.0, 3),
    },
}


@dataclass(frozen=True)
class SmoothnessOperators:
    """Host-precomputed per-(N, dt, config) operator bundle (float64 NumPy).

    Shapes: N = number of free waypoints. Derivative rows run over the N+2
    true waypoints t = 0..N+1 (endpoints included, as the reference evaluates
    cost over the whole padded trajectory).

    A[d]     : [N+2, N]   maps free waypoints -> d-th derivative rows
    B[d]     : [N+2, 2]   endpoint contribution (columns: q0, qN)
    R        : [N, N]     sum_d w_d A_d^T A_d + ridge I        (A.2)
    R_bias   : [N, 2]     sum_d w_d A_d^T B_d  (cross term so that
                          1/2||Aθ+Bq||^2 = 1/2 θᵀRθ + θᵀ R_bias q + const)
    Rinv     : [N, N]
    M        : [N, N]     R^-1 with columns rescaled to max 1/N     (A.10)
    L_sample : [N, N]     chol(R^-1 / max|R^-1|) — sampling factor so that
                          ε = σ · L z has waypoint-scale magnitude ~σ   (A.3)
    limit_gain : [N]      diag-normalized columns R^-1[:,t]/R^-1[t,t] used by
                          the joint-limit projection                  (A.7)
    """

    N: int
    dt: float
    A: tuple          # tuple of [N+2, N] arrays, one per active derivative
    B: tuple          # matching [N+2, 2] arrays
    w: tuple          # matching weights
    R: np.ndarray
    R_bias: np.ndarray
    Rinv: np.ndarray
    M: np.ndarray
    L_sample: np.ndarray
    cov_scale: float  # max|R^-1| used to normalize the sampling covariance


def _derivative_operator(N: int, dt: float, order: int, stencil: str):
    """Build (A, B): derivative rows at the N+2 true waypoints.

    The padded sequence is [q0]*r + [q0, θ_1..θ_N, qN] + [qN]*r  (duplicated
    endpoints, mirroring the reference's DIFF_RULE_LENGTH/2 padding), and the
    derivative at true waypoint t uses taps t-r..t+r of that sequence.
    """
    coeffs, r = _STENCILS[stencil][order]
    scale = 1.0 / dt**order
    rows = N + 2
    A = np.zeros((rows, N))
    B = np.zeros((rows, 2))
    for t in range(rows):          # true waypoint index 0..N+1
        for k, c in enumerate(coeffs):
            if c == 0.0:
                continue
            p = t + (k - r)        # position in true-waypoint coordinates
            if p <= 0:
                B[t, 0] += c       # q0 (covers duplicated left padding)
            elif p >= N + 1:
                B[t, 1] += c       # qN
            else:
                A[t, p - 1] += c   # free waypoint θ_p  (1-indexed -> column p-1)
    return A * scale, B * scale


@functools.lru_cache(maxsize=64)
def build_operators(N: int, dt: float, cfg: SmoothnessConfig) -> SmoothnessOperators:
    """Build and cache the full operator bundle for (N, dt, cfg)."""
    if N < 2:
        raise ValueError(f"need at least 2 free waypoints, got N={N}")
    weights = cfg.derivative_weights()
    A_list, B_list, w_list = [], [], []
    R = np.zeros((N, N))
    R_bias = np.zeros((N, 2))
    for order, w in zip((1, 2, 3), weights):
        if w == 0.0:
            continue
        A, B = _derivative_operator(N, dt, order, cfg.stencil)
        A_list.append(A)
        B_list.append(B)
        w_list.append(w)
        R += w * (A.T @ A)
        R_bias += w * (A.T @ B)
    if not A_list:
        raise ValueError("all derivative weights are zero — R would be singular")
    if cfg.ridge_factor:
        R += cfg.ridge_factor * np.eye(N)

    Rinv = np.linalg.inv(R)
    Rinv = 0.5 * (Rinv + Rinv.T)  # symmetrize against roundoff

    # M: R^-1 with each column rescaled so its max-abs element is 1/N  (A.10).
    col_max = np.abs(Rinv).max(axis=0)
    M = Rinv / (N * col_max[None, :])

    # Sampling covariance: R^-1 normalized by its max element so that the
    # per-joint stddev knob directly sets mid-trajectory noise scale (A.3).
    cov_scale = float(np.abs(Rinv).max())
    cov = Rinv / cov_scale
    # Cholesky with a graded jitter fallback (cov is SPD in exact arithmetic).
    jitter = 0.0
    for _ in range(6):
        try:
            L = np.linalg.cholesky(cov + jitter * np.eye(N))
            break
        except np.linalg.LinAlgError:
            jitter = max(jitter * 10.0, 1e-12)
    else:  # pragma: no cover
        raise np.linalg.LinAlgError("cov not SPD even with jitter")

    return SmoothnessOperators(
        N=N,
        dt=dt,
        A=tuple(A_list),
        B=tuple(B_list),
        w=tuple(w_list),
        R=R,
        R_bias=R_bias,
        Rinv=Rinv,
        M=M,
        L_sample=L,
        cov_scale=cov_scale,
    )


def smoothness_cost(ops: SmoothnessOperators, theta: np.ndarray,
                    q0: np.ndarray, qN: np.ndarray) -> float:
    """Host-side 1/2 sum_d w_d ||A_d θ_j + B_d [q0_j, qN_j]||^2 over joints.

    theta: [N, d]; q0, qN: [d]. Device-side equivalent lives in
    costs/smoothness.py; this NumPy version is for host checks.
    """
    total = 0.0
    q = np.stack([q0, qN], axis=0)  # [2, d]
    for A, B, w in zip(ops.A, ops.B, ops.w):
        deriv = A @ theta + B @ q   # [N+2, d]
        total += 0.5 * w * float(np.sum(deriv * deriv))
    return total
