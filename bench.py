"""Benchmark entry point: prints ONE JSON line to stdout.

Headline metric: p50 replan latency on BASELINE config 2 (7-DOF arm, 100
waypoints, 50 noisy rollouts/iteration) on one device — full solve to
collision-free termination, *end-to-end* including dispatch and result
transfer. Target from BASELINE.json: < 100 ms; `vs_baseline` = 100 ms /
measured (>1 ⇒ faster than target).

ALL THREE BASELINE metrics are produced every run and MERGED (never
overwritten) into BENCH_DETAILS.json:
  1. p50 replan latency, config 2 (analytic and voxel-grid worlds)
  2. noisy rollouts/s/device — slope between two iteration counts, so fixed
     dispatch overhead cancels
  3. solves/s at the config-4 shape, B=1024 scenarios on one device
plus the config-5 MPC rows and the serving-loop efficiency bounds. A
failing section fails the run.

Run: python bench.py                  (every section)
     BENCH_FAST=1 python bench.py     (headline only — quick iteration)
     BENCH_FULL=1 python bench.py     (also the 25-problem experiment suite)
     JAX_PLATFORMS=cpu python bench.py   (CPU smoke)
"""

import json
import os
import sys
import time

import numpy as np
import jax


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def headline(grid=False):
    """p50 replan latency, config 2, B=1.

    grid=True: the config file's own voxel-SDF world (64x80x48 @ 2.5 cm
    signed EDT) instead of the analytic tabletop — BASELINE configs[1]'s
    literal world type (VERDICT r4 missing #1).
    """
    from tpustomp.api.plan import plan
    from tpustomp.api.problem import ProblemSpec
    from bench.common import config2_cfg, config2_grid_scene, config2_scene

    robot, world, q0, qN = (config2_grid_scene() if grid
                            else config2_scene())
    # num_restarts=2: closes the ~5%-of-seeds convergence failures (r2
    # recorded success_rate 0.95 without comment — VERDICT r2 item 6).
    # Restarts are a vmapped axis, so the latency cost is bounded by the
    # slower of two parallel solves, not 2x.
    # Round 4: the headline runs the SWEPT exploration config (sigma=0.25,
    # h=20, decay=1.0 — found by bench/stomp_sweep.py): converges in ~11
    # iterations instead of ~25 at success 1.0.
    from tpustomp.api.config import NoiseConfig
    cfg = config2_cfg(num_restarts=2, pi2_h=20.0,
                      noise=NoiseConfig(stddev=0.25, decay=1.0,
                                        num_rollouts_reused=5))
    prob = ProblemSpec(q0=q0, qN=qN)

    t0 = time.perf_counter()
    sol = plan(robot, world, prob, cfg, key=jax.random.PRNGKey(0))
    _ = float(sol.cost)
    log(f"compile+first solve: {time.perf_counter() - t0:.2f}s "
        f"(success={bool(sol.success)}, iters={int(sol.iterations)})")

    lat, succ, iters = [], 0, []
    for i in range(20):
        t0 = time.perf_counter()
        sol = plan(robot, world, prob, cfg, key=jax.random.PRNGKey(i))
        _ = float(sol.cost)  # force a real device->host transfer
        lat.append((time.perf_counter() - t0) * 1e3)
        succ += int(bool(sol.success))
        iters.append(int(sol.iterations))
    lat = np.asarray(lat)
    res = {
        "p50_ms": float(np.percentile(lat, 50)),
        "p90_ms": float(np.percentile(lat, 90)),
        "min_ms": float(lat.min()),
        "success_rate": succ / 20,
        "mean_iterations": float(np.mean(iters)),
    }
    log(f"replan latency (grid={grid}): {res}")
    return res


def solves_per_sec(B=1024, retry=False, n=5, swept=False, grid=False,
                   constrained=False, torque_weight=0.0):
    """BASELINE metric 3: solves/s at the config-4 shape (B scenarios on one
    device, full solve-to-termination workload).

    retry=True: the success=1.0 row (VERDICT r3 item 2) — plan_batch_retry
    re-solves failed rows (typically <=10%) with 4 restarts folded into the
    small retry batch, so the headline holds at full success for the cost of
    one extra small dispatch instead of doubling the whole batch's work.

    swept=True: the round-4 sweep's exploration config (sigma=0.25, h=20,
    decay=1.0 — bench/stomp_sweep.py / docs/EXPERIMENTS.md) instead of the
    config-2 defaults. Measured: success 1.0 on every seed at ~12 mean
    iterations (vs 0.93 at ~30), i.e. 2.4x the raw solves/s at FULL
    success with no retry pass — wide undecayed exploration is simply the
    better solver configuration for this problem distribution.
    grid=True: the voxel signed-EDT tabletop (config2_grid_scene) —
    exercises the trilinear grid gather at batch scale (the SURVEY §8.3
    hard-part-1 path).

    constrained=True: an upright orientation cone on the EE (A.6, the
    paper's "glass of water") rides the solve, so the delta vs the
    unconstrained row IS the constraint-evaluation cost.
    Every scalar is reported as {median, min, max, n} over `n` repeats.
    """
    import jax.numpy as jnp
    from tpustomp.api.plan import plan_batch, plan_batch_retry
    from tpustomp.api.problem import ProblemSpec
    from bench.common import (config2_cfg, config2_decomposed_scene,
                              config2_grid_scene, config2_scene)

    # grid: False = analytic tabletop; True = voxel signed-EDT grid;
    # "decomposed" = the same voxel occupancy compiled to analytic boxes
    # (world/decompose.py — gather-free)
    if grid == "decomposed":
        robot, world, q0, qN = config2_decomposed_scene()
    elif grid:
        robot, world, q0, qN = config2_grid_scene()
    else:
        robot, world, q0, qN = config2_scene()
    cfg = config2_cfg(max_iterations=50)
    if swept:
        from tpustomp.api.config import NoiseConfig
        cfg = cfg.replace(pi2_h=20.0,
                          noise=NoiseConfig(stddev=0.25, decay=1.0,
                                            num_rollouts_reused=5))
    if torque_weight:
        # A.8 end-to-end row (VERDICT r4 item 6): RNE inverse dynamics on
        # every candidate waypoint.
        # The weight sits well below the obstacle scale (gravity torques
        # are O(10) Nm vs O(0.1) potentials — tests/integration/
        # test_torque_e2e.py).
        from tpustomp.api.config import CostWeights
        cfg = cfg.replace(weights=CostWeights(
            obstacle=1.0, smoothness=0.1, torque=torque_weight))
    constraints = None
    if constrained:
        from tpustomp.costs.constraints import OrientationConstraint
        # This row measures the constraint-EVALUATION cost as an
        # EQUAL-WORK comparison: both arms run exactly `max_iterations`
        # solver iterations (cf-termination disabled), same problems, same
        # noise; the only difference is the cone cost riding the fused
        # path. Convergence-rate effects are thereby excluded — those are
        # task-level questions answered by the 125-problem tradeoff curve
        # (experiment_suite_constrained_125). Two earlier cuts conflated
        # the two and recorded success 0.0 (the per-timestep min-max
        # normalization amplifies ANY cross-candidate constraint variance
        # to obstacle scale, so an endpoint-infeasible cone hijacks the
        # softmax regardless of weight).
        constraints = OrientationConstraint.make(
            axis_local=(0, 0, 1), target_world=(0, 0, 1),
            tolerance=0.25, weight=0.3)
        cfg = cfg.replace(max_iterations_after_collision_free=10**6)
    rng = np.random.default_rng(0)
    Q0 = (np.tile(q0, (B, 1)) + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    QN = (np.tile(qN, (B, 1)) + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    prob = ProblemSpec(q0=Q0, qN=QN)
    solve = plan_batch_retry if retry else plan_batch

    t0 = time.perf_counter()
    if retry:
        # Warm EVERY plausible retry bucket, not just the one the warmup
        # call's own failed set hits: plan_batch_retry pads the failed set
        # to the next power of two (min 16), and each bucket size is a
        # distinct compiled program. r4's artifact had min 57 solves/s vs
        # median 1274 — a bucket compile landing inside the timed loop
        # (VERDICT r4 weak #1). Failure rates here are <=~10% of B, so
        # buckets up to B//4 cover every observed round.
        rcfg = cfg.replace(num_restarts=4)
        wsol_full = None
        for bs in (16, 32, 64, 128, 256):
            if bs > B:
                break
            wsol = plan_batch(robot, world,
                              ProblemSpec(q0=Q0[:bs], qN=QN[:bs]), rcfg,
                              keys=jax.random.split(jax.random.PRNGKey(99),
                                                    bs))
            _ = float(jnp.sum(wsol.cost))
        # also warm the per-bucket merge jits (gather/fold/scatter) — the
        # residual ~1.5 s outlier after solver warming was these small
        # programs compiling at first-seen bucket shapes
        from tpustomp.api.plan import (_gather_rows_jit, _retry_keys_jit,
                                       _scatter_solution_jit)
        wsol_full = plan_batch(robot, world, prob, cfg,
                               keys=jax.random.split(jax.random.PRNGKey(98),
                                                     B))
        wkeys = jax.random.split(jax.random.PRNGKey(98), B)
        for bs in (16, 32, 64, 128, 256):
            if bs > B:
                break
            idx = jnp.asarray(np.arange(bs) % B)
            _gather_rows_jit(jnp.asarray(Q0), idx)
            _retry_keys_jit(wkeys, idx, 1)
            part = jax.tree.map(lambda x: x[idx], wsol_full)
            _ = _scatter_solution_jit(wsol_full, part, idx)
        log(f"retry buckets warmed (16..min(256,B)): "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
    variant = (f"grid={grid} " if grid else "") + \
        ("constrained " if constrained else "") + \
        (f"torque={torque_weight} " if torque_weight else "")
    sol = solve(robot, world, prob, cfg,
                keys=jax.random.split(jax.random.PRNGKey(0), B),
                constraints=constraints)
    _ = float(jnp.sum(sol.cost))
    log(f"batched B={B} retry={retry} swept={swept} {variant}compile+first: "
        f"{time.perf_counter() - t0:.1f}s")
    ts, succs = [], []
    for i in range(1, n + 1):
        t0 = time.perf_counter()
        sol = solve(robot, world, prob, cfg,
                    keys=jax.random.split(jax.random.PRNGKey(i), B),
                    constraints=constraints)
        _ = float(jnp.sum(sol.cost))
        ts.append(time.perf_counter() - t0)
        succs.append(float(jnp.mean(sol.success.astype(jnp.float32))))
    dt = float(np.median(ts))
    mi = float(jnp.mean(sol.iterations.astype(jnp.float32)))
    res = {
        "batch": B,
        "n": n,
        "solves_per_sec": {"median": B / dt,
                           "min": B / float(np.max(ts)),
                           "max": B / float(np.min(ts))},
        "success_rate": {"median": float(np.median(succs)),
                         "min": float(np.min(succs)),
                         "max": float(np.max(succs))},
        "mean_iterations": mi,
        "rollouts_per_sec_implied": B * 56 * mi / dt,  # 56 candidates/iter
    }
    if constrained:
        # equal-work unconstrained arm (same fixed iteration count)
        sol0 = plan_batch(robot, world, prob, cfg,
                          keys=jax.random.split(jax.random.PRNGKey(0), B))
        _ = float(jnp.sum(sol0.cost))
        ts0 = []
        for i in range(1, n + 1):
            t0 = time.perf_counter()
            sol0 = plan_batch(robot, world, prob, cfg,
                              keys=jax.random.split(jax.random.PRNGKey(i),
                                                    B))
            _ = float(jnp.sum(sol0.cost))
            ts0.append(time.perf_counter() - t0)
        dt0 = float(np.median(ts0))
        res["equal_work_iterations"] = int(cfg.max_iterations)
        res["unconstrained_solves_per_sec_median"] = B / dt0
        res["constraint_eval_overhead_pct"] = 100.0 * (dt - dt0) / dt0
        res["note"] = ("equal-work comparison: both arms run exactly "
                       "max_iterations solver iterations; overhead = the "
                       "cone cost")
    log(f"solves/s B={B} retry={retry} swept={swept} {variant}: {res}")
    return res


def main():
    from tpustomp.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    log(f"device: {dev} ({dev.platform})")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    details = {"device": str(dev)}
    res = headline()
    details["replan_latency_config2"] = res
    if os.environ.get("BENCH_FAST") != "1":
        details["replan_latency_config2_grid"] = headline(grid=True)
        from bench.rollouts_per_sec import run as rps_run
        details["rollouts_per_sec"] = rps_run(batch=256)
        details["throughput_config4_B256"] = solves_per_sec(256)
        details["throughput_config4_B1024"] = solves_per_sec(1024)
        details["throughput_config4_B1024_full_success"] = solves_per_sec(
            1024, retry=True)
        details["throughput_config4_B1024_swept"] = solves_per_sec(
            1024, swept=True)
        details["throughput_config4_B256_grid"] = solves_per_sec(
            256, grid=True, n=3)
        details["throughput_config4_B256_torque"] = solves_per_sec(
            256, torque_weight=0.005)
        details["throughput_config4_B1024_grid"] = solves_per_sec(
            1024, grid=True, n=2)
        details["throughput_config4_B1024_grid_decomposed"] = \
            solves_per_sec(1024, grid="decomposed")
        # constrained vs its like-for-like control is the _swept row
        # (same exploration config)
        details["throughput_config4_B1024_constrained"] = solves_per_sec(
            1024, constrained=True, swept=True)
        from bench.scaling import run_dispatch_bound, run_pipelined_bound
        details["multi_host_efficiency_pipelined"] = \
            run_pipelined_bound(1024)
        details["multi_host_dispatch_bound_serialized"] = \
            run_dispatch_bound(1024)
        from bench.mpc_bench import run as mpc_run
        details["mpc_config5"] = mpc_run(B=8192)
        details["mpc_config5_grid"] = mpc_run(
            B=8192, grid=True, ticks_lo=2, ticks_hi=4, reps=2)
        details["mpc_config5_grid_decomposed"] = mpc_run(
            B=8192, grid="decomposed")
        from bench.mpc_bench import run_episode as mpc_episode
        details["mpc_config5_episode"] = mpc_episode(B=8192)
        details["mpc_config5_episode_grid_decomposed"] = mpc_episode(
            B=8192, grid="decomposed")
        details["mpc_config5_episode_grid"] = mpc_episode(
            B=1024, grid=True, reps=1)
    if os.environ.get("BENCH_FULL") == "1":
        from bench.experiment_suite import (run_constrained_suite,
                                            run_suite)
        details["experiment_suite_25"] = run_suite(
            n=25, modes=("stomp", "chomp"))
        details["experiment_suite_constrained"] = run_constrained_suite(
            n=25)

    # MERGE into BENCH_DETAILS.json — never overwrite other sections
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BENCH_DETAILS.json")
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged.update(details)
    with open(path, "w") as f:
        json.dump(merged, f, indent=2)

    print(json.dumps({
        "metric": "p50_replan_latency_config2",
        "value": round(res["p50_ms"], 3),
        "unit": "ms",
        "vs_baseline": round(100.0 / res["p50_ms"], 3),
    }))


if __name__ == "__main__":
    main()
