"""STOMP hyperparameter sweep on the 125-problem suite (VERDICT r3 item 6).

Round 3 left an inversion unexplained: plain STOMP scored 0.944-0.96 on the
hard-sampled shelf/tabletop suites while pinv-CHOMP scored 0.992-1.0 —
backwards from the ICRA-2011 headline (STOMP solves all/nearly all where
gradient CHOMP gets stuck). This sweep grids the PI² exploration knobs at
equal iteration budget to find whether hyperparameters close the gap.

Mechanics: (noise_stddev scale, h, decay) are TRACED per-scenario
values (solver.HyperParams), so the whole grid × 125 problems is ONE batched
solve — G=36 cells × 125 = 4500 scenarios in a single compile + launch —
instead of 36 recompiles of a static-config program. Static knobs that
change program structure (K rollouts, cost mode) are separate compiles,
swept around the best traced-grid cell.

Run:  python -m bench.stomp_sweep [n_problems] [out.json]
"""

from __future__ import annotations

import itertools
import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
from bench.common import config2_cfg, log  # noqa: E402
from bench.experiment_suite import (sample_problems, shelf_scene,  # noqa: E402
                                    tabletop_scene)

# stddev is swept as a multiplier on the suite's baseline 0.12
STDDEV = (0.08, 0.12, 0.16, 0.20)
H = (5.0, 10.0, 20.0)
DECAY = (0.99, 0.995, 1.0)
BASE_STD = 0.12


def _grid():
    cells = list(itertools.product(STDDEV, H, DECAY))
    return cells


def sweep_scene(robot, world, q0s, qNs, n, seed=0, num_rollouts=50,
                cost_mode="local", max_iterations=150):
    """One traced-grid sweep: returns {cell_label: success_rate}."""
    from tpustomp.api.config import NoiseConfig
    from tpustomp.dynamics.device import device_ops
    from tpustomp.engine import solver

    cells = _grid()
    G = len(cells)
    cfg = config2_cfg(
        max_iterations=max_iterations, num_rollouts=num_rollouts,
        pi2_cost_mode=cost_mode,
        noise=NoiseConfig(stddev=BASE_STD, decay=0.995,
                          num_rollouts_reused=5))
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)

    Q0 = jnp.asarray(np.tile(q0s, (G, 1)))          # [G*n, d], cell-major
    QN = jnp.asarray(np.tile(qNs, (G, 1)))
    keys = jnp.tile(jax.random.split(jax.random.PRNGKey(seed), n), (G, 1))
    hyper = solver.HyperParams(
        noise_scale=jnp.repeat(jnp.asarray([s / BASE_STD for s, _, _ in
                                            cells], jnp.float32), n),
        h=jnp.repeat(jnp.asarray([h for _, h, _ in cells], jnp.float32), n),
        decay=jnp.repeat(jnp.asarray([d for _, _, d in cells], jnp.float32),
                         n))

    fn = jax.jit(lambda a, b, k, hy: solver.solve_batch(
        robot, world, None, cfg, ops, a, b, k, hyper=hy))
    t0 = time.perf_counter()
    sol = fn(Q0, QN, keys, hyper)
    succ = np.asarray(sol.success).reshape(G, n)
    iters = np.asarray(sol.iterations).reshape(G, n)
    wall = time.perf_counter() - t0
    log(f"grid of {G} cells x {n} problems solved in {wall:.1f}s "
        f"(incl. compile)")
    out = {}
    for (s, h, d), sc, it in zip(cells, succ, iters):
        out[f"std={s}/h={h:g}/decay={d}"] = {
            "success_rate": float(sc.mean()),
            "mean_iterations": float(it.mean())}
    return out


def run(n=125, seed=0, out_path=None):
    from tpustomp.robot import model

    robot = model.arm_7dof()
    results = {}
    best = {}
    for scene_name, scene in (("tabletop", tabletop_scene()),
                              ("shelf", shelf_scene())):
        log(f"[{scene_name}] sampling {n} hard problems...")
        q0s, qNs = sample_problems(robot, scene, n, seed=seed)
        grid = sweep_scene(robot, scene, q0s, qNs, n, seed=seed)
        results[f"{scene_name}/grid"] = grid
        best_cell = max(grid.items(), key=lambda kv: kv[1]["success_rate"])
        best[scene_name] = best_cell
        log(f"[{scene_name}] best: {best_cell}")

        # static knobs around the best traced cell: cost mode and K
        sstr = best_cell[0]
        parts = dict(p.split("=") for p in sstr.split("/"))
        std, h, dec = (float(parts["std"]), float(parts["h"]),
                       float(parts["decay"]))
        for label, kw in (
                ("cumulative", dict(cost_mode="cumulative")),
                ("K=100", dict(num_rollouts=100)),
                ("K=25", dict(num_rollouts=25))):
            g1 = sweep_one(robot, scene, q0s, qNs, n, seed, std, h, dec,
                           **kw)
            results[f"{scene_name}/best+{label}"] = g1
            log(f"[{scene_name}] best+{label}: {g1}")
    results["best_cells"] = {k: v[0] for k, v in best.items()}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def sweep_one(robot, world, q0s, qNs, n, seed, std, h, decay,
              num_rollouts=50, cost_mode="local", max_iterations=150):
    """Solve the suite at ONE hyper cell under static-knob variations."""
    from tpustomp.api.config import NoiseConfig
    from tpustomp.dynamics.device import device_ops
    from tpustomp.engine import solver

    cfg = config2_cfg(
        max_iterations=max_iterations, num_rollouts=num_rollouts,
        pi2_cost_mode=cost_mode,
        noise=NoiseConfig(stddev=std, decay=decay, num_rollouts_reused=5))
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    hyper = solver.HyperParams(
        noise_scale=jnp.full((n,), 1.0, jnp.float32),
        h=jnp.full((n,), h, jnp.float32),
        decay=jnp.full((n,), decay, jnp.float32))
    fn = jax.jit(lambda a, b, k, hy: solver.solve_batch(
        robot, world, None, cfg, ops, a, b, k, hyper=hy))
    sol = fn(jnp.asarray(q0s), jnp.asarray(qNs), keys, hyper)
    return {
        "success_rate": float(np.asarray(sol.success).mean()),
        "mean_iterations": float(np.asarray(sol.iterations,
                                            np.float32).mean())}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 125
    out = sys.argv[2] if len(sys.argv) > 2 else None
    print(json.dumps(run(n=n, out_path=out), indent=2))
