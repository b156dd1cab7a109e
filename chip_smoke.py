#!/usr/bin/env python3
"""Smoke test of the planner on one NVIDIA GPU, through the public entry
points, at the BASELINE shapes.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One card, one process. Phases (one line each, then a JSON last line):
  - the card's name and power limit, as nvidia-smi reports them;
  - config 2: plan() on the analytic tabletop and on the 64x80x48 voxel
    grid (signed EDT): success, iterations, cold wall time, warm p50 of 20;
  - config 3: plan() in CHOMP mode;
  - config 4: plan_batch at B=1024: success rate, solves/s;
  - config 5: run_mpc_sharded at 10,000 scenarios x 10 ticks: replans/s,
    collision rate;
  - parity: the batched evaluation on the card against the NumPy chain-FK +
    SDF reference (tests/oracle) at config-2 widths; config 1's shared-noise
    oracle parity (tests/integration/test_config1.py) on the card; config-2
    success over 8 seeds on the card against the host CPU on the same seeds;
    the float32 matmul precision in effect.

--four-cards runs plan_sharded at B=4096 over a 4-card mesh and the same
scenarios on one card, checks that they agree, then runs run_mpc_sharded at
4 x 2,500 scenarios.

Any failed phase raises, so the exit code is non-zero and no JSON line is
printed. Without a GPU the script stops before any phase: it never falls
back to the CPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# agreement of the 4-card and 1-card config-4 solves (see four_cards)
SHARD_ATOL = 1e-4          # rad, per-scenario max |trajectory difference|
SHARD_MIN_AGREE = 0.99     # share of scenarios that must be within it


def require_gpu(devices) -> None:
    """Stop unless JAX's default devices are NVIDIA GPUs."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's default device is {platform!r}, "
                         "not a GPU; nothing is run on the CPU instead")


def _phase(name: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"{name}: {body}", flush=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _load_module(relpath: str):
    """Import a repo file by path (the test helpers live outside the
    package)."""
    path = os.path.join(ROOT, relpath)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ready(tree):
    import jax
    return jax.block_until_ready(tree)


def _config(name: str):
    from tpustomp.api.config import load_toml, read_toml
    path = os.path.join(ROOT, "configs", name)
    return load_toml(path), read_toml(path)


def _scene(doc, use_grid=False):
    from tpustomp.cli import DEFAULT_SCENE, build_scene
    return build_scene(doc.get("scene", DEFAULT_SCENE), use_grid)


def _check_traj(traj, q0, qN, what: str) -> None:
    t = np.asarray(traj)
    _check(np.isfinite(t).all(), f"{what}: non-finite trajectory")
    _check(np.allclose(t[..., 0, :], q0, atol=1e-5)
           and np.allclose(t[..., -1, :], qN, atol=1e-5),
           f"{what}: endpoints moved")


def config2(grid: bool) -> None:
    import jax
    from tpustomp.api.plan import plan
    from tpustomp.api.problem import ProblemSpec

    cfg, doc = _config("config2_tabletop.toml")
    robot, world, q0, qN = _scene(doc, use_grid=grid)
    prob = ProblemSpec(q0=q0, qN=qN)
    t0 = time.perf_counter()
    sol = _ready(plan(robot, world, prob, cfg, key=jax.random.PRNGKey(0)))
    cold = time.perf_counter() - t0
    lat, succ, iters = [], [], []
    for i in range(1, 21):
        t0 = time.perf_counter()
        s = _ready(plan(robot, world, prob, cfg, key=jax.random.PRNGKey(i)))
        lat.append(time.perf_counter() - t0)
        _check_traj(s.trajectory, q0, qN, "config2")
        succ.append(bool(s.success))
        iters.append(int(s.iterations))
    rate = float(np.mean(succ))
    _phase("config2_grid" if grid else "config2_analytic",
           success=bool(sol.success), iterations=int(sol.iterations),
           cold_s=f"{cold:.3f}",
           warm_p50_ms=f"{1e3 * float(np.median(lat)):.3f}",
           warm_p90_ms=f"{1e3 * float(np.percentile(lat, 90)):.3f}",
           warm_success_rate=f"{rate:.3f}",
           warm_mean_iterations=f"{np.mean(iters):.2f}")
    _check(rate >= 0.75, f"config2 success rate {rate} over 20 queries")


def config3() -> None:
    import jax
    from tpustomp.api.plan import plan
    from tpustomp.api.problem import ProblemSpec

    cfg, doc = _config("config3_chomp.toml")
    robot, world, q0, qN = _scene(doc)
    t0 = time.perf_counter()
    sol = _ready(plan(robot, world, ProblemSpec(q0=q0, qN=qN), cfg,
                      key=jax.random.PRNGKey(0)))
    _check_traj(sol.trajectory, q0, qN, "config3")
    _phase("config3_chomp", success=bool(sol.success),
           iterations=int(sol.iterations),
           cold_s=f"{time.perf_counter() - t0:.3f}")
    _check(bool(sol.success), "config3 CHOMP did not reach collision-free")


def config4(B: int = 1024, reps: int = 3) -> None:
    import jax
    from tpustomp.api.plan import plan_batch
    from tpustomp.cli import batch_problems

    cfg, doc = _config("config4_batch.toml")
    robot, world, q0, qN = _scene(doc)
    prob, keys = batch_problems(q0, qN, B, 0.03, seed=0)
    t0 = time.perf_counter()
    _ready(plan_batch(robot, world, prob, cfg, keys=keys))
    cold = time.perf_counter() - t0
    walls, rates, iters = [], [], []
    for r in range(1, reps + 1):
        keys = jax.random.split(jax.random.PRNGKey(r), B)
        t0 = time.perf_counter()
        sol = _ready(plan_batch(robot, world, prob, cfg, keys=keys))
        walls.append(time.perf_counter() - t0)
        _check_traj(sol.trajectory, prob.q0, prob.qN, "config4")
        rates.append(float(np.mean(np.asarray(sol.success))))
        iters.append(float(np.mean(np.asarray(sol.iterations))))
    rate = float(np.mean(rates))
    _phase("config4_plan_batch", batch=B, cold_s=f"{cold:.3f}",
           solves_per_s=f"{B / float(np.median(walls)):.1f}",
           warm_median_s=f"{float(np.median(walls)):.4f}",
           success_rate=f"{rate:.4f}",
           mean_iterations=f"{np.mean(iters):.2f}", reps=reps)
    _check(rate > 0.5, f"config4 success rate {rate}")


def _mpc_setup(n: int, seed: int):
    import jax.numpy as jnp
    from tpustomp.cli import mpc_scenarios
    from tpustomp.world.sdf import AnalyticWorld

    cfg, doc = _config("config5_mpc.toml")
    robot, world, q0, qN = _scene(doc)
    # the CLI's config-5 run: the tabletop boxes stay static, one sphere
    # per scenario moves (tpustomp/cli.py _run_mpc)
    static = AnalyticWorld(sphere_center=jnp.zeros((0, 3), jnp.float32),
                           sphere_radius=jnp.zeros((0,), jnp.float32),
                           box_center=world.box_center,
                           box_half=world.box_half)
    centers = np.asarray([[0.9, 0.6, 0.5]], np.float32)
    radius = jnp.asarray([0.12], jnp.float32)
    spec = doc["mpc"]
    states = mpc_scenarios(robot, cfg, q0, qN, centers, n,
                           float(spec["obstacle_speed"]), seed)
    return robot, cfg, states, radius, static, float(spec["world_dt"])


def config5(n: int = 10_000, ticks: int = 10, mesh=None,
            name: str = "config5_mpc") -> None:
    from tpustomp.engine.mpc import run_mpc_sharded

    robot, cfg, states, radius, static, world_dt = _mpc_setup(n, seed=0)
    t0 = time.perf_counter()
    _ready(run_mpc_sharded(robot, cfg, states, radius, ticks, world_dt,
                           mesh=mesh, static_world=static))
    cold = time.perf_counter() - t0
    _, _, states, _, _, _ = _mpc_setup(n, seed=1)
    t0 = time.perf_counter()
    out = _ready(run_mpc_sharded(robot, cfg, states, radius, ticks,
                                 world_dt, mesh=mesh, static_world=static))
    wall = time.perf_counter() - t0
    _check(np.isfinite(np.asarray(out.q)).all(), "config5: non-finite q")
    _check(bool((np.asarray(out.steps) == ticks).all()),
           "config5: wrong tick count")
    collided = float(np.mean(np.asarray(out.collided)))
    _phase(name, scenarios=n, ticks=ticks, cold_s=f"{cold:.3f}",
           warm_s=f"{wall:.4f}", replans_per_s=f"{n * ticks / wall:.1f}",
           collision_rate=f"{collided:.4f}")
    _check(collided < 0.5, f"config5 collision rate {collided}")


def parity_evaluate() -> None:
    from tpustomp.robot import model
    from tpustomp.world.sdf import AnalyticWorld

    sys.path.insert(0, os.path.join(ROOT, "tests", "oracle"))
    ev = _load_module(os.path.join("tests", "unit", "test_evaluate_oracle.py"))
    _, doc = _config("config2_tabletop.toml")
    robot, grid, _, _ = _scene(doc, use_grid=True)
    tabletop = AnalyticWorld.make(boxes=[
        (tuple(b["center"]), tuple(b["half"])) for b in doc["scene"]["boxes"]])
    for name, world in (("analytic", tabletop), ("grid", grid)):
        err = ev.check_evaluate(model.arm_7dof(), world, C=56, T=102)
        # *_tol_used: worst error as a share of rtol/atol (1.0 = limit)
        _phase(f"parity_evaluate_{name}", C=56, T=102, d=7,
               rtol=ev.EVAL_RTOL, atol=ev.EVAL_ATOL,
               **{f"{k}_tol_used" if isinstance(v, float) else k:
                  (f"{v:.3f}" if isinstance(v, float) else v)
                  for k, v in err.items()})


def parity_config1() -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests", "oracle"))
    t1 = _load_module(os.path.join("tests", "integration", "test_config1.py"))
    for mode in ("local", "cumulative"):
        t1.test_stomp_matches_oracle_with_shared_noise(mode)
    _phase("parity_config1_oracle", modes="local,cumulative", rtol=2e-3,
           result="pass")


def parity_success(seeds: int = 8) -> None:
    """Config-2 success on the card vs the host CPU, same seeds."""
    import jax
    from tpustomp.api.plan import plan
    from tpustomp.api.problem import ProblemSpec

    def run():
        cfg, doc = _config("config2_tabletop.toml")
        robot, world, q0, qN = _scene(doc)
        return [bool(plan(robot, world, ProblemSpec(q0=q0, qN=qN), cfg,
                          key=jax.random.PRNGKey(s)).success)
                for s in range(seeds)]

    gpu = run()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = run()
    _phase("parity_success_config2", seeds=seeds, gpu=sum(gpu), cpu=sum(cpu),
           same_per_seed=sum(a == b for a, b in zip(gpu, cpu)))
    _check(sum(gpu) >= sum(cpu) - 1,
           f"GPU success {sum(gpu)}/{seeds} vs CPU {sum(cpu)}/{seeds}")


def matmul_precision() -> None:
    """Which float32 matmul precision the card applies by default: the
    error of an unannotated product against float64 (TF32 keeps 10
    mantissa bits, ~1e-3 relative; full float32 ~1e-6)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    b = rng.standard_normal((512, 512)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    err = lambda p: float(np.abs(np.asarray(jnp.matmul(
        jnp.asarray(a), jnp.asarray(b), precision=p)) - exact).max() / scale)
    _phase("matmul_precision",
           config=jax.config.jax_default_matmul_precision or "default",
           f32_default_rel_err=f"{err(None):.2e}",
           f32_highest_rel_err=f"{err(jax.lax.Precision.HIGHEST):.2e}")


def four_cards(devices, B: int = 4096, mpc_per_card: int = 2500) -> None:
    from tpustomp.cli import batch_problems
    from tpustomp.engine.distributed import make_mesh, plan_sharded

    _check(len(devices) >= 4, f"--four-cards needs 4 GPUs, has "
           f"{len(devices)}")
    mesh4, mesh1 = make_mesh(devices[:4]), make_mesh(devices[:1])
    cfg, doc = _config("config4_batch.toml")
    robot, world, q0, qN = _scene(doc)
    prob, keys = batch_problems(q0, qN, B, 0.03, seed=0)
    sols = {}
    for name, mesh in (("4 cards", mesh4), ("1 card", mesh1)):
        _ready(plan_sharded(robot, world, prob, cfg, keys=keys, mesh=mesh))
        t0 = time.perf_counter()
        sol = _ready(plan_sharded(robot, world, prob, cfg, keys=keys,
                                  mesh=mesh))
        wall = time.perf_counter() - t0
        _check_traj(sol.trajectory, prob.q0, prob.qN, f"config4 {name}")
        sols[name] = sol
        _phase(f"config4_plan_sharded_{name.replace(' ', '_')}", batch=B,
               devices=len(mesh.devices.flat), warm_s=f"{wall:.4f}",
               solves_per_s=f"{B / wall:.1f}",
               success_rate=f"{float(np.mean(np.asarray(sol.success))):.4f}")
    a, b = sols["4 cards"], sols["1 card"]
    diff = np.abs(np.asarray(a.trajectory) - np.asarray(b.trajectory)
                  ).max(axis=(1, 2))
    agree = float(np.mean(diff <= SHARD_ATOL))
    same_success = float(np.mean(np.asarray(a.success)
                                 == np.asarray(b.success)))
    same_iters = float(np.mean(np.asarray(a.iterations)
                               == np.asarray(b.iterations)))
    _phase("config4_sharded_vs_one_card", atol=SHARD_ATOL,
           share_within_atol=f"{agree:.4f}",
           max_abs_diff=f"{float(diff.max()):.3e}",
           same_success=f"{same_success:.4f}",
           same_iterations=f"{same_iters:.4f}")
    _check(agree >= SHARD_MIN_AGREE,
           f"only {agree:.4f} of scenarios agree within {SHARD_ATOL}")
    config5(n=4 * mpc_per_card, ticks=10, mesh=mesh4,
            name="config5_mpc_4_cards")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card sharded path")
    args = p.parse_args(argv)

    import jax
    # CUDA first (the default device); the host CPU stays available for the
    # success-parity replay. A machine without CUDA fails right here.
    jax.config.update("jax_platforms", "cuda,cpu")
    devices = jax.devices()
    require_gpu(devices)

    sys.path.insert(0, ROOT)
    import tpustomp
    if not os.path.abspath(tpustomp.__file__).startswith(ROOT + os.sep):
        raise SystemExit(f"chip_smoke: imported tpustomp from "
                         f"{tpustomp.__file__}, not from {ROOT}")
    from tpustomp.utils.cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t_start = time.perf_counter()
    if args.four_cards:
        four_cards(devices)
    else:
        matmul_precision()
        config2(grid=False)
        config2(grid=True)
        config3()
        config4()
        config5()
        parity_evaluate()
        parity_config1()
        parity_success()
    print(f"total_s: {time.perf_counter() - t_start:.1f}", flush=True)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
