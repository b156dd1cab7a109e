"""BASELINE config-5 performance: the sharded MPC replanning loop at scale.

BASELINE.json configs[4]: "10k scenarios, MPC replanning loop against moving
obstacles, multi-host". Correctness of the loop is covered by
tests/integration/test_mpc.py; this bench produces the perf artifact
(VERDICT r3 item 3): scenario-ticks/s (= effective replans/s — every tick
replans every scenario), measured at >=8k scenarios on one device
through the production entry (`engine.mpc.run_mpc_sharded`, 1-device mesh),
with the same slope methodology as the config-4 numbers: per-tick time from
the slope between two scan lengths, so fixed dispatch/gather cost cancels;
median + spread over `reps` within-process repeats.

Scenario shape follows configs/config5_mpc.toml: 7-DOF arm, N=50 waypoints,
K=16 rollouts + 4 reused, 8 solver iterations per replan, world_dt=0.1 s,
one moving sphere per scenario (speed 0.2 m/s, random direction) over the
config-2 static tabletop — a CompositeWorld-free analytic compose, so the
per-tick world advance is a pytree update (SURVEY §8.3 hard part 6).

B=8192 fits one device comfortably (the candidate tensor is
[T=52, d=7, B*21] ~ 250 MB fp32); 10k-scenario runs shard this same
program over devices with zero in-loop collectives.
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
from bench.common import config2_scene, log  # noqa: E402


def _scene(grid):
    """grid: False = analytic static tabletop; True = voxel GridSDF (the
    CompositeWorld gather path, engine/mpc._tick_world_batch); "decomposed"
    = the voxel occupancy compiled to analytic boxes (world/decompose.py)
    merged into the per-scenario analytic world — gather-free at full
    scale."""
    if grid == "decomposed":
        from bench.common import config2_decomposed_scene
        return config2_decomposed_scene()
    if grid:
        from bench.common import config2_grid_scene
        return config2_grid_scene()
    return config2_scene()


def _cfg5():
    from tpustomp.api.config import CostWeights, NoiseConfig, PlannerConfig

    # mirrors configs/config5_mpc.toml (swept exploration, round 5): the
    # per-tick cost is iteration-count-fixed
    return PlannerConfig(
        num_timesteps=50, duration=3.0, num_rollouts=16, pi2_h=20.0,
        noise=NoiseConfig(stddev=0.25, decay=1.0, num_rollouts_reused=4),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.05, max_iterations=8,
        max_iterations_after_collision_free=2, record_metrics=False)


def _init_states(robot, cfg, B, q0, qN, speed=0.2, seed=0):
    from tpustomp.engine import mpc

    rng = np.random.default_rng(seed)
    Q0 = (np.tile(q0, (B, 1))
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    QN = (np.tile(qN, (B, 1))
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    # moving sphere starts outside the arm's initial envelope, heading
    # through the workspace
    centers = np.stack([
        rng.uniform(0.9, 1.2, B), rng.uniform(-0.6, 0.6, B),
        rng.uniform(0.3, 0.8, B)], axis=1).astype(np.float32)[:, None, :]
    dirs = rng.normal(size=(B, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-9
    vels = (-dirs * speed).astype(np.float32)[:, None, :]
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    states = jax.vmap(
        lambda a, b, c, v, k: mpc.init_mpc(robot, cfg, a, b, c, v, k)
    )(jnp.asarray(Q0), jnp.asarray(QN), jnp.asarray(centers),
      jnp.asarray(vels), keys)
    return states


def run(B=8192, ticks_lo=4, ticks_hi=8, reps=3, world_dt=0.1, grid=False):
    from tpustomp.engine import mpc
    from tpustomp.engine.distributed import make_mesh

    robot, static_world, q0, qN = _scene(grid)
    cfg = _cfg5()
    radius = np.asarray([0.12], np.float32)
    mesh = make_mesh()
    states = _init_states(robot, cfg, B, q0, qN)

    def run_ticks(n):
        out = mpc.run_mpc_sharded(robot, cfg, states, radius, n, world_dt,
                                  mesh=mesh, static_world=static_world)
        # end the timed region with a real device->host pull
        return out, float(jnp.sum(out.q))

    t0 = time.perf_counter()
    out, _ = run_ticks(ticks_lo)
    log(f"mpc B={B} ticks={ticks_lo} compile+first: "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    out_hi, _ = run_ticks(ticks_hi)
    log(f"mpc B={B} ticks={ticks_hi} compile+first: "
        f"{time.perf_counter() - t0:.1f}s")

    per_tick, rates = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, _ = run_ticks(ticks_lo)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_hi, _ = run_ticks(ticks_hi)
        t_hi = time.perf_counter() - t0
        pt = (t_hi - t_lo) / (ticks_hi - ticks_lo)
        per_tick.append(pt)
        rates.append(B / pt)

    coll = float(jnp.mean(out_hi.collided.astype(jnp.float32)))
    dist = float(jnp.mean(jnp.linalg.norm(out_hi.q - out_hi.qN, axis=1)))
    res = {
        "world": ("grid_decomposed" if grid == "decomposed" else
                  "grid_composite" if grid else "analytic"),
        "batch": B,
        "ticks_slope": [ticks_lo, ticks_hi],
        "n": reps,
        "t_per_tick_s": {
            "median": float(np.median(per_tick)),
            "min": float(np.min(per_tick)),
            "max": float(np.max(per_tick))},
        "replans_per_sec": {
            "median": float(np.median(rates)),
            "min": float(np.min(rates)), "max": float(np.max(rates))},
        "collision_rate": coll,
        "mean_goal_distance_rad": dist,
        "solver_iterations_per_replan": cfg.max_iterations,
        "note": "replans/s = scenario-ticks/s (each tick warm-start replans "
                "every scenario, 8 solver iterations, K=16+4 rollouts, "
                "N=50 waypoints, 7-DOF, per-scenario moving sphere over "
                "the static tabletop); slope between scan lengths cancels "
                "dispatch+gather.",
    }
    log(f"mpc_config5: {res}")
    return res


def run_episode(B=8192, ticks=120, reps=2, world_dt=0.1, grid=False,
                chunk_ticks=10, goal_eps=0.05):
    """Episode-level config-5 completion metrics (VERDICT r4 item 2).

    Runs FULL episodes (`ticks` control steps, >= 2x the ~60-tick goal-
    contraction horizon of this cfg) at scale through the production
    resilient driver (`run_mpc_resilient`, chunked host snapshots — the
    code path a real long-running deployment uses), and reports the task-
    completion half of the config-5 story:

      - reached_rate: fraction of scenarios whose executed configuration
        came within `goal_eps` rad (inf-norm, per joint) of the goal at
        any tick (MPCState.reached_tick >= 0);
      - median_ticks_to_goal over the reached scenarios;
      - collision_rate: cumulative over the whole episode;
      - residual_goal_distance_rad: mean ||q - qN||_2 at episode end;
      - sustained replans/s over the whole episode INCLUDING chunk-
        boundary host syncs (the honest serving figure; the slope-based
        `run()` number is the pure-device rate).

    reps episodes are timed after a first compile+run episode; scenario
    initial states are identical across reps (same seeds), so completion
    metrics are deterministic and timing spread is visible.
    """
    from tpustomp.engine import mpc
    from tpustomp.engine.distributed import make_mesh

    robot, static_world, q0, qN = _scene(grid)
    cfg = _cfg5()
    radius = np.asarray([0.12], np.float32)
    mesh = make_mesh()
    states = _init_states(robot, cfg, B, q0, qN)

    def episode():
        t0 = time.perf_counter()
        out = mpc.run_mpc_resilient(robot, cfg, states, radius, ticks,
                                    world_dt, mesh=mesh,
                                    chunk_ticks=chunk_ticks,
                                    static_world=static_world,
                                    goal_eps=goal_eps)
        _ = float(jnp.sum(out.q))
        return out, time.perf_counter() - t0

    out, t_first = episode()
    log(f"mpc episode B={B} ticks={ticks} grid={grid} compile+first: "
        f"{t_first:.1f}s")
    walls = []
    for _ in range(reps):
        out, w = episode()
        walls.append(w)

    reached = np.asarray(out.reached_tick)
    ok = reached >= 0
    res = {
        "world": ("grid_decomposed" if grid == "decomposed" else
                  "grid_composite" if grid else "analytic"),
        "batch": B,
        "ticks": ticks,
        "chunk_ticks": chunk_ticks,
        "goal_eps_rad_inf": goal_eps,
        "n": reps,
        "reached_rate": float(ok.mean()),
        "median_ticks_to_goal": (float(np.median(reached[ok]))
                                 if ok.any() else None),
        "collision_rate": float(np.mean(np.asarray(out.collided))),
        "residual_goal_distance_rad": float(np.mean(
            np.linalg.norm(np.asarray(out.q - out.qN), axis=1))),
        "sustained_replans_per_sec": {
            "median": B * ticks / float(np.median(walls)),
            "min": B * ticks / float(np.max(walls)),
            "max": B * ticks / float(np.min(walls))},
        "episode_wall_s": {"median": float(np.median(walls)),
                           "min": float(np.min(walls)),
                           "max": float(np.max(walls))},
    }
    log(f"mpc_config5_episode grid={grid}: {res}")
    return res


if __name__ == "__main__":
    import json

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    print(json.dumps(run(B=B)))
