"""Noisy rollout generation: ε ~ N(0, σ² R⁻¹-shaped), batched over K and d.

Reference equivalents: ``PolicyImprovement::generateRollouts`` +
``MultivariateGaussian`` (SURVEY §3.1, A.3). The reference loops K×d calls of
an Eigen Cholesky sampler; here one einsum applies the precomputed factor L
(= chol(R⁻¹ / max|R⁻¹|), dynamics/smoothness.py) to a [K, N, d] standard
normal block — one matmul.

Rollout *reuse* (the reference keeps the best `num_rollouts_reused` rollouts,
noise retained) is handled in engine/solver.py by carrying the kept rollouts'
trajectories in the solver state; their noise relative to the *current* θ is
re-derived as ε_k = θ_k − θ, matching the reference's re-centering.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_noise(key: jax.Array, L: jnp.ndarray, sigma: jnp.ndarray,
                 num_rollouts: int) -> jnp.ndarray:
    """Draw ε [K, N, d] with per-joint scale sigma [d] (A.3).

    ε_kj = σ_j · L z_kj with z standard normal; endpoints are exactly zero by
    construction because L acts only on free waypoints.

    z is drawn in (d, K, N) axis order (iid normals; the order only fixes
    which stream element lands where, so it is part of the seeded result).
    """
    N = L.shape[0]
    d = sigma.shape[0]
    z = jax.random.normal(key, (d, num_rollouts, N), dtype=L.dtype)
    return jnp.einsum("nm,dkm->knd", L, z) * sigma[None, None, :]
