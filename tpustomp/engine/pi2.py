"""PI² probability weighting and parameter update.

Reference equivalents: ``PolicyImprovement::{setRolloutCosts,
computeProbabilities, computeParameterUpdates}`` (SURVEY §3.1).
Contract: SURVEY Appendix A.9 (per-timestep min-max normalized,
exponentiated-cost softmax over rollouts) and A.10 (probability-weighted
noise average smoothed through M = column-scaled R⁻¹).

The softmax over K rollouts is a small reduction and the M-projection is one
[N,N]×[N,d] matmul; everything vmaps over scenarios.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def probabilities(S: jnp.ndarray, h: float) -> jnp.ndarray:
    """S [K, N] per-rollout per-(interior)-timestep state cost -> P [K, N].

    P_k(t) = exp(-h·S̃_k(t)) / Σ_k' exp(-h·S̃_k'(t)), S̃ min-max normalized
    per timestep (A.9).
    """
    lo = S.min(axis=0, keepdims=True)
    hi = S.max(axis=0, keepdims=True)
    S_norm = (S - lo) / (hi - lo + _EPS)
    e = jnp.exp(-h * S_norm)
    return e / e.sum(axis=0, keepdims=True)


def update(eps: jnp.ndarray, S: jnp.ndarray, M: jnp.ndarray,
           h: float) -> jnp.ndarray:
    """Probability-weighted noise average, M-smoothed (A.10).

    eps [K, N, d], S [K, N] -> δθ [N, d] = M Σ_k P_k ⊙ ε_k.
    """
    P = probabilities(S, h)                       # [K, N]
    delta = jnp.einsum("kn,knd->nd", P, eps)
    return M @ delta
