"""Device-resident smoothness operator bundle.

Host builds everything in float64 (dynamics/smoothness.py); this module ships
the float32 views the jitted solver needs. One bundle per (N, dt, smoothness
config), cached; `jax.device_put` happens lazily at first use inside jit.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tpustomp.api.config import SmoothnessConfig
from tpustomp.dynamics.smoothness import build_operators
from tpustomp.utils import struct


@struct.dataclass
class DeviceOps:
    """Float32 operator arrays used inside the solver (SURVEY A.2/A.3/A.10).

    A_stack [D, N+2, N], B_stack [D, N+2, 2], w [D]: derivative operators +
    endpoint bias + weights for the smoothness cost 1/2 Σ_d w_d ||Aθ + Bq||².
    R [N,N], R_bias [N,2]: quadratic form (CHOMP smoothness gradient Rθ+R_bias q).
    Rinv [N,N]: joint-limit projection columns.
    M [N,N]: update smoother (columns scaled to max 1/N).
    L_sample [N,N]: chol of the normalized sampling covariance.
    cov_scale: the max|R⁻¹| normalizer (static float) — L L^T = R⁻¹/cov_scale;
    the HMC kinetic-energy metric needs it to stay consistent with L_sample.
    """

    A_stack: jnp.ndarray
    B_stack: jnp.ndarray
    w: jnp.ndarray
    R: jnp.ndarray
    R_bias: jnp.ndarray
    Rinv: jnp.ndarray
    M: jnp.ndarray
    L_sample: jnp.ndarray
    cov_scale: float = struct.field(pytree_node=False, default=1.0)


@functools.lru_cache(maxsize=64)
def device_ops(N: int, dt: float, cfg: SmoothnessConfig) -> DeviceOps:
    ops = build_operators(N, dt, cfg)
    f32 = np.float32
    # The cache must never hold tracers: if the first call for a given key
    # happens inside a jit/vmap trace, jnp.asarray would yield traced
    # constants that leak into every later dispatch (UnexpectedTracerError).
    with jax.ensure_compile_time_eval():
        return _device_ops_arrays(ops, f32)


def _device_ops_arrays(ops, f32) -> DeviceOps:
    return DeviceOps(
        A_stack=jnp.asarray(np.stack(ops.A), f32),
        B_stack=jnp.asarray(np.stack(ops.B), f32),
        w=jnp.asarray(np.array(ops.w), f32),
        R=jnp.asarray(ops.R, f32),
        R_bias=jnp.asarray(ops.R_bias, f32),
        Rinv=jnp.asarray(ops.Rinv, f32),
        M=jnp.asarray(ops.M, f32),
        L_sample=jnp.asarray(ops.L_sample, f32),
        cov_scale=float(ops.cov_scale),
    )
