"""Command-line runner — the reference's node + launch-file analogue.

Reference equivalent (SURVEY §2 L7): `stomp_planner_node` launched with a
YAML param file, serving GetMotionPlan. Here:

    python -m tpustomp configs/config2_tabletop.toml [--mode chomp]
        [--seed 0] [--viz] [--grid] [--scenarios N]

reads a TOML config file containing `[planner]` (PlannerConfig fields) and
`[scene]` (robot, primitives, q0/qN; the config-2 tabletop scene is the
default when absent), runs one plan, and prints a JSON result line.
`--grid` voxelizes the scene through the signed-EDT pipeline instead of the
analytic SDF. A `[batch]` section (BASELINE config 4) switches to a sharded
scenario batch; an `[mpc]` section (config 5) runs the moving-obstacle
replanning loop; `--scenarios` overrides their scenario counts for quick
runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


DEFAULT_SCENE = {  # BASELINE config-2 tabletop (bench/common.py)
    "robot": "arm_7dof",
    "boxes": [{"center": [0.6, 0.0, 0.2], "half": [0.45, 0.6, 0.25]},
              {"center": [0.68, -0.05, 0.62], "half": [0.06, 0.06, 0.18]}],
    "grid": {"origin": [-0.2, -1.0, 0.0], "shape": [64, 80, 48],
             "resolution": 0.025},
    "q0": [-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0],
    "qN": [0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0],
}


def build_scene(scene: dict, use_grid: bool):
    """(robot, world, q0, qN) from a config's [scene] table; use_grid
    voxelizes the primitives through the signed-EDT pipeline."""
    from tpustomp.robot import model
    from tpustomp.world import edt
    from tpustomp.world.sdf import AnalyticWorld

    robot_name = scene.get("robot", "arm_7dof")
    kwargs = {}
    if "body_radius" in scene:
        kwargs["body_radius"] = scene["body_radius"]
    robot = getattr(model, robot_name)(**kwargs)

    spheres = [(tuple(s["center"]), float(s["radius"]))
               for s in scene.get("spheres", [])]
    boxes = [(tuple(b["center"]), tuple(b["half"]))
             for b in scene.get("boxes", [])]
    world = AnalyticWorld.make(spheres=spheres, boxes=boxes)
    if use_grid:
        g = scene.get("grid")
        if g is None:
            raise SystemExit("--grid requested but scene has no grid: spec")
        occ = edt.occupancy_from_analytic(world, tuple(g["origin"]),
                                          tuple(g["shape"]),
                                          float(g["resolution"]))
        world = edt.signed_edt(occ, float(g["resolution"]),
                               tuple(g["origin"]))
    q0 = np.asarray(scene["q0"], np.float32)
    qN = np.asarray(scene["qN"], np.float32)
    return robot, world, q0, qN


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpustomp",
                                description="STOMP/CHOMP trajectory planner")
    p.add_argument("config", help="TOML file with [planner] and [scene]")
    p.add_argument("--mode", choices=["stomp", "chomp"], default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--viz", action="store_true",
                   help="dump trajectory/metrics figures (tpustomp_viz/)")
    p.add_argument("--grid", action="store_true",
                   help="use the voxel signed-EDT world instead of analytic")
    p.add_argument("--timed", action="store_true",
                   help="enforce planning_time_limit (plan_timed)")
    def positive_int(v):
        n = int(v)
        if n <= 0:
            raise argparse.ArgumentTypeError("must be a positive integer")
        return n

    p.add_argument("--scenarios", type=positive_int, default=None,
                   help="override batch:/mpc: scenario count (quick runs)")
    args = p.parse_args(argv)

    import jax

    from tpustomp.api.config import from_dict, read_toml
    from tpustomp.api.plan import plan, plan_timed
    from tpustomp.api.problem import ProblemSpec
    from tpustomp.utils.cache import enable_compile_cache

    enable_compile_cache()
    doc = read_toml(args.config)
    cfg = from_dict(doc.get("planner", {}))
    if args.mode:
        cfg = cfg.replace(mode=args.mode)
    if args.viz:
        cfg = cfg.replace(animate_path=True)
    robot, world, q0, qN = build_scene(doc.get("scene", DEFAULT_SCENE),
                                        args.grid)

    if "batch" in doc:
        return _run_batch(doc, robot, world, q0, qN, cfg, args)
    if "mpc" in doc:
        return _run_mpc(doc, robot, world, q0, qN, cfg, args)

    t0 = time.perf_counter()
    runner = plan_timed if args.timed else plan
    sol = runner(robot, world, ProblemSpec(q0=q0, qN=qN), cfg,
                 key=jax.random.PRNGKey(args.seed))
    wall = time.perf_counter() - t0
    out = {
        "success": bool(sol.success),
        "iterations": int(sol.iterations),
        "cost": float(sol.cost),
        "wall_seconds": round(wall, 3),
        "num_waypoints": int(sol.trajectory.shape[0]),
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(out))
    return 0 if out["success"] else 1


def batch_problems(q0, qN, n: int, jitter: float, seed: int):
    """n problems around one start/goal, each joint jittered uniformly by
    ±jitter rad (config 4). Returns (ProblemSpec with [n, d] leaves, keys)."""
    import jax

    from tpustomp.api.problem import ProblemSpec

    rng = np.random.default_rng(seed)
    d = q0.shape[0]
    q0b = (np.tile(q0, (n, 1))
           + rng.uniform(-jitter, jitter, (n, d))).astype(np.float32)
    qNb = (np.tile(qN, (n, 1))
           + rng.uniform(-jitter, jitter, (n, d))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return ProblemSpec(q0=q0b, qN=qNb), keys


def mpc_scenarios(robot, cfg, q0, qN, centers, n: int, speed: float,
                  seed: int):
    """n MPC scenarios around one start/goal (config 5): start and goal
    jittered by ±0.02 rad per joint, every obstacle sphere launched from
    `centers` [S, 3] at `speed` m/s in a random direction. Returns the
    batched MPCState (leaves [n, ...])."""
    import jax
    import jax.numpy as jnp

    from tpustomp.engine import mpc as mpc_mod

    rng = np.random.default_rng(seed)
    d = q0.shape[0]
    vel = rng.normal(0, 1, (n,) + centers.shape)
    vel = (speed * vel / np.linalg.norm(vel, axis=-1, keepdims=True)
           ).astype(np.float32)
    q0b = (q0 + rng.uniform(-0.02, 0.02, (n, d))).astype(np.float32)
    qNb = (qN + rng.uniform(-0.02, 0.02, (n, d))).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(seed + jnp.arange(n))
    init = jax.jit(jax.vmap(
        lambda rob, a, b, v, k: mpc_mod.init_mpc(rob, cfg, a, b, centers, v,
                                                 k),
        in_axes=(None, 0, 0, 0, 0)))
    return init(robot, q0b, qNb, vel, keys)


def _run_batch(doc, robot, world, q0, qN, cfg, args):
    """BASELINE config 4: sharded scenario batch around the scene problem."""
    import jax

    from tpustomp.engine import distributed

    spec = doc["batch"]
    n = (args.scenarios if args.scenarios is not None
         else int(spec.get("scenarios_per_chip", 256)))
    problem, keys = batch_problems(q0, qN, n,
                                   float(spec.get("start_goal_jitter", 0.03)),
                                   args.seed)
    t0 = time.perf_counter()
    sol = distributed.plan_sharded(robot, world, problem, cfg, keys=keys)
    jax.block_until_ready(sol.trajectory)
    wall = time.perf_counter() - t0
    out = distributed.summarize(sol)
    out.update(wall_seconds=round(wall, 3),
               solves_per_sec_incl_compile=round(n / wall, 1),
               device=str(jax.devices()[0]))
    print(json.dumps(out))
    return 0 if out["success_rate"] > 0.5 else 1


def _run_mpc(doc, robot, world, q0, qN, cfg, args):
    """BASELINE config 5: moving-obstacle MPC replanning loop.

    The scene's SPHERES become the per-scenario moving obstacles; its
    static geometry stays in the world every tick: analytic boxes ride as
    an AnalyticWorld static part, and with --grid the voxel signed-EDT
    field rides as the CompositeWorld static grid (engine/mpc._tick_world;
    round 5 — previously the CLI dropped static geometry and rejected
    --grid for [mpc] runs)."""
    import jax
    import jax.numpy as jnp

    from tpustomp.engine import mpc as mpc_mod
    from tpustomp.world.sdf import AnalyticWorld, GridSDF

    spec = doc["mpc"]
    n = (args.scenarios if args.scenarios is not None
         else int(spec.get("scenarios", 64)))
    ticks = int(spec.get("ticks", 50))
    world_dt = float(spec.get("world_dt", 0.1))
    speed = float(spec.get("obstacle_speed", 0.2))
    if isinstance(world, GridSDF):
        # --grid: build_scene voxelized the WHOLE analytic scene, spheres
        # included — but this function's contract makes the scene spheres
        # the per-scenario MOVING obstacles. Re-voxelize only the static
        # geometry (boxes) and keep the spheres analytic; otherwise the
        # spheres are silently frozen into the grid at their initial
        # positions and a spurious default mover is launched instead,
        # making --grid dynamics differ from the analytic run.
        scene = doc.get("scene", {})
        sph = scene.get("spheres", [])
        if sph:
            from tpustomp.world import edt
            g = scene["grid"]
            boxes_only = AnalyticWorld.make(
                boxes=[(tuple(b["center"]), tuple(b["half"]))
                       for b in scene.get("boxes", [])])
            occ = edt.occupancy_from_analytic(
                boxes_only, tuple(g["origin"]), tuple(g["shape"]),
                float(g["resolution"]))
            world = edt.signed_edt(occ, float(g["resolution"]),
                                   tuple(g["origin"]))
            scene_spheres = np.asarray([s["center"] for s in sph],
                                       np.float32)
            scene_radii = np.asarray([float(s["radius"]) for s in sph],
                                     np.float32)
        else:
            scene_spheres = np.zeros((0, 3), np.float32)
            scene_radii = np.zeros((0,), np.float32)
        static_world = world          # voxel scene -> CompositeWorld grid
    else:
        assert isinstance(world, AnalyticWorld), type(world)
        static_world = (AnalyticWorld(
            sphere_center=jnp.zeros((0, 3), jnp.float32),
            sphere_radius=jnp.zeros((0,), jnp.float32),
            box_center=world.box_center, box_half=world.box_half)
            if world.box_half.shape[0] else None)
        scene_spheres = np.asarray(world.sphere_center, np.float32)
        scene_radii = np.asarray(world.sphere_radius, np.float32)
    # one moving sphere per scenario, launched toward the workspace center
    S = max(1, scene_spheres.shape[0])
    centers = np.tile(np.asarray([[0.9, 0.6, 0.5]], np.float32), (S, 1)) \
        if scene_spheres.shape[0] == 0 else scene_spheres
    radius = np.full((S,), 0.12, np.float32) \
        if scene_radii.shape[0] == 0 else scene_radii

    states = mpc_scenarios(robot, cfg, q0, qN, centers, n, speed, args.seed)
    t0 = time.perf_counter()
    out_state = mpc_mod.run_mpc_sharded(robot, cfg, states,
                                        jnp.asarray(radius), ticks, world_dt,
                                        static_world=static_world)
    jax.block_until_ready(out_state.q)
    wall = time.perf_counter() - t0
    goal_dist = np.linalg.norm(np.asarray(out_state.q - out_state.qN),
                               axis=-1)
    reached = np.asarray(out_state.reached_tick)
    out = {
        "scenarios": n,
        "ticks": ticks,
        "collision_rate": float(np.mean(np.asarray(out_state.collided))),
        "mean_goal_distance": float(goal_dist.mean()),
        "reached_rate_0.2rad": float((goal_dist < 0.2).mean()),
        "reached_rate": float((reached >= 0).mean()),
        "median_ticks_to_goal": (float(np.median(reached[reached >= 0]))
                                 if (reached >= 0).any() else None),
        "wall_seconds": round(wall, 3),
        "replans_per_sec_incl_compile": round(n * ticks / wall, 1),
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(out))
    return 0 if out["collision_rate"] < 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
