"""The paper's evaluation harness, batched: N planning problems in
shelf/tabletop scenes, STOMP vs CHOMP success rates.

Reference equivalent (SURVEY §5, §7.1): the ICRA-2011 experiments — 125
planning problems on a simulated PR2 in shelf/tabletop worlds, where STOMP
succeeded on (nearly) all and gradient-only CHOMP got stuck in local minima
on a substantial minority. The reference ran these one at a time through the
ROS service; here the whole problem set is ONE `plan_batch` call (scenarios
are a vmapped array axis), so the full suite runs in seconds per planner.

Problems: rejection-sample collision-free (start, goal) configuration pairs,
keep pairs whose straight-line (min-jerk) interpolation COLLIDES — i.e. the
planner must actually find a detour ("hard" problems, like reaching between
shelf levels). Success = collision-free trajectory within the iteration
budget (A.12 semantics).

Run:  python -m bench.experiment_suite [n_problems] [out.json]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

from bench.common import log, config2_cfg


def shelf_scene():
    """A bookshelf in front of the arm: side walls, back wall, 3 shelf boards.

    The arm (base at z=0.8 shoulder) reaches into the cavities between
    boards; straight-line joint interpolations between cavities sweep through
    the boards.
    """
    from tpustomp.world.sdf import AnalyticWorld

    x0, depth, half_w = 0.55, 0.18, 0.42
    boards_z = (0.45, 0.75, 1.05)
    boxes = [
        # back wall
        ((x0 + depth, 0.0, 0.75), (0.02, half_w, 0.45)),
        # side walls
        ((x0 + depth / 2, -half_w, 0.75), (depth / 2, 0.02, 0.45)),
        ((x0 + depth / 2, +half_w, 0.75), (depth / 2, 0.02, 0.45)),
    ] + [((x0 + depth / 2, 0.0, z), (depth / 2, half_w, 0.015))
         for z in boards_z]
    return AnalyticWorld.make(boxes=boxes)


def tabletop_scene():
    from tpustomp.world.sdf import AnalyticWorld

    return AnalyticWorld.make(
        boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
               ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18)),
               ((0.45, 0.35, 0.58), (0.05, 0.05, 0.14))])


def _config_margin_fn(robot, world, clearance):
    from tpustomp.robot.fk import body_positions
    from tpustomp.world.sdf import sdf

    @jax.jit
    def margins(qs):  # [M, d] -> [M] min signed clearance over bodies
        def one(q):
            x = body_positions(robot, q)
            return jnp.min(sdf(world, x) - robot.body_radius)
        return jax.vmap(one)(qs)

    return margins


def upright_filter(robot, axis_local=(0, 0, 1), target_world=(0, 0, 1),
                   tol=0.25):
    """[M, d] -> [M] bool: EE axis within `tol` rad of the world target —
    endpoint filter for the constrained ("glass of water") suite row, since
    clamped endpoints must satisfy the cone themselves."""
    from tpustomp.robot.fk import fk_frames

    a = jnp.asarray(axis_local, jnp.float32)
    t = jnp.asarray(target_world, jnp.float32)

    @jax.jit
    def f(qs):
        def one(q):
            _, rot, _ = fk_frames(robot, q)
            ach = rot[-1] @ a
            return jnp.arccos(jnp.clip(jnp.dot(ach, t), -1.0, 1.0)) < tol
        return jax.vmap(one)(qs)

    return f


def sample_problems(robot, world, n, clearance=0.03, seed=0,
                    max_batches=400, config_filter=None):
    """Rejection-sample `n` hard problems: endpoints free, straight line in
    collision. Returns (q0s [n,d], qNs [n,d]).

    config_filter: optional [M, d] -> [M] bool — additional endpoint
    acceptance (e.g. upright_filter for the constrained row)."""
    from tpustomp.engine.trajectory import min_jerk_init
    from tpustomp.robot.fk import body_positions
    from tpustomp.world.sdf import sdf

    d = robot.num_joints
    lo = np.where(np.asarray(robot.joint_limited),
                  np.asarray(robot.joint_lower), -np.pi)
    hi = np.where(np.asarray(robot.joint_limited),
                  np.asarray(robot.joint_upper), np.pi)
    margins = _config_margin_fn(robot, world, clearance)

    @jax.jit
    def line_margin(q0, qN):  # min clearance along the min-jerk line (16 wp)
        # wrap continuous joints first: the solver plans toward the wrapped
        # goal (engine/trajectory.wrap_goal), so "the straight line collides"
        # must be judged on the same line the planner starts from — without
        # this, a raw 350-degree forearm-roll sweep can flag a problem hard
        # whose wrapped 10-degree line is trivially free
        from tpustomp.engine.trajectory import wrap_goal
        qN = wrap_goal(q0, qN, robot.joint_limited)
        th = min_jerk_init(q0, qN, 16)
        full = jnp.concatenate([q0[None], th, qN[None]], axis=0)
        def one(q):
            x = body_positions(robot, q)
            return jnp.min(sdf(world, x) - robot.body_radius)
        return jnp.min(jax.vmap(one)(full))

    line_margins = jax.jit(jax.vmap(line_margin))

    rng = np.random.default_rng(seed)
    q0s, qNs = [], []
    for _ in range(max_batches):
        if len(q0s) >= n:
            break
        cand = rng.uniform(lo, hi, (512, d)).astype(np.float32)
        ok = np.asarray(margins(jnp.asarray(cand))) > clearance
        if config_filter is not None:
            ok &= np.asarray(config_filter(jnp.asarray(cand)))
        free = cand[ok]
        if len(free) < 2:
            continue
        pairs = free[: (len(free) // 2) * 2].reshape(-1, 2, d)
        lm = np.asarray(line_margins(jnp.asarray(pairs[:, 0]),
                                     jnp.asarray(pairs[:, 1])))
        hard = pairs[lm < 0.0]  # straight line collides => planner must work
        for p in hard:
            q0s.append(p[0]); qNs.append(p[1])
    if len(q0s) < n:
        raise RuntimeError(f"only sampled {len(q0s)}/{n} hard problems")
    return (np.asarray(q0s[:n], np.float32), np.asarray(qNs[:n], np.float32))


def run_suite(n=125, seed=0, scenes=("tabletop", "shelf"),
              modes=("stomp", "stomp-r4", "chomp", "chomp-pinv",
                     "chomp-hmc")):
    import time

    from tpustomp.api.plan import plan_batch
    from tpustomp.api.problem import ProblemSpec
    from tpustomp.robot import model

    robot = model.arm_7dof()
    results = {}
    for scene_name in scenes:
        world = shelf_scene() if scene_name == "shelf" else tabletop_scene()
        log(f"[{scene_name}] sampling {n} hard problems...")
        q0s, qNs = sample_problems(robot, world, n, seed=seed)
        prob = ProblemSpec(q0=q0s, qN=qNs)
        for mode in modes:
            from tpustomp.api.config import CostWeights

            if mode.startswith("stomp"):
                # (stddev=0.25, h=20, decay=1.0): the round-4 traced-grid
                # sweep optimum (bench/stomp_sweep.py — 72 cells x 125
                # problems per scene as ONE batched solve each): plain
                # STOMP 0.992 tabletop / 1.000 shelf, vs 0.944/0.960 at
                # the r3 config (stddev 0.12, h=10, decay 0.995). Hard
                # problems need wide, UNdecayed exploration; h=20 sharpens
                # the softmax once rollouts differ and roughly halves
                # iterations-to-success (15 vs 22). "stomp-r4" adds 4
                # parallel restarts per problem (num_restarts — the batched
                # answer to the reference's "call the service again with a
                # new seed").
                from tpustomp.api.config import NoiseConfig
                cfg = config2_cfg(
                    max_iterations=150, pi2_h=20.0,
                    num_restarts=4 if mode == "stomp-r4" else 1,
                    noise=NoiseConfig(stddev=0.25, decay=1.0,
                                      num_rollouts_reused=5))
            else:
                # swept at 7-DOF (docs/EXPERIMENTS.md): w_obs=20/lr=0.6 ->
                # 0.93 vs 0.73 at the earlier w_obs=5/lr=0.3; matches
                # configs/config3_chomp.toml
                cfg = config2_cfg(
                    mode="chomp", learning_rate=0.6, max_iterations=150,
                    use_pseudo_inverse=(mode == "chomp-pinv"),
                    weights=CostWeights(obstacle=20.0, smoothness=0.1))
                if mode == "chomp-hmc":
                    # noise.decay drives the HMC temperature anneal (chomp
                    # mode has no rollout sampling); 0.95^150 ≈ 0 lets the
                    # explorer settle into pure descent and terminate
                    from tpustomp.api.config import NoiseConfig
                    cfg = cfg.replace(
                        use_hamiltonian_monte_carlo=True,
                        hmc_step_size=0.3, hmc_leapfrog_steps=3,
                        hmc_temperature=0.05,
                        noise=NoiseConfig(stddev=0.08, decay=0.95,
                                          num_rollouts_reused=5))
            keys = jax.random.split(jax.random.PRNGKey(seed), n)
            t0 = time.perf_counter()
            sol = plan_batch(robot, world, prob, cfg, keys=keys)
            succ = np.asarray(sol.success)
            wall = time.perf_counter() - t0
            res = {
                "n": n,
                "success_rate": float(succ.mean()),
                "mean_iterations": float(np.asarray(
                    sol.iterations, np.float32).mean()),
                "wall_seconds_incl_compile": round(wall, 2),
            }
            log(f"[{scene_name}] {mode}: {res}")
            results[f"{scene_name}/{mode}"] = res
    return results


def run_constrained_suite(n=125, seed=0, tol=0.25,
                          weights_sd=((0.3, 0.12), (3.0, 0.12),
                                      (10.0, 0.25))):
    """The paper's "glass of water" task at suite scale (VERDICT r4 item 3a):
    an orientation cone on the EE (axis z within `tol` rad of world-up)
    through the tabletop scene, n hard problems whose endpoints satisfy the
    cone, solved as ONE batched call per setting.

    The artifact is a measured TRADEOFF CURVE, not one cherry-picked point
    (round-5 weight×noise probes on 16-problem subsets): the cone term
    competes with obstacle avoidance in the PI² softmax — when the cone is
    violated its quadratic (w·excess², ~0.9 at w=10, excess 0.3) dwarfs
    obstacle differences (~0.05), so candidates that tilt to dodge get
    rejected. Measured: w=0.3/σ=0.12 keeps success 1.00 with the cone
    satisfied on ~0.6 of problems (soft task preference, recommended
    default); w=10/σ=0.25 drives residual excess lowest (mean 0.10 rad vs
    the 0.93 unconstrained control) but halves collision-free success —
    ~1/3 of hard+upright problems appear to require >0.05 rad of cone
    excess at all. An unconstrained control on the same problems anchors
    the curve.
    """
    import time

    from tpustomp.api.plan import plan_batch
    from tpustomp.api.problem import ProblemSpec
    from tpustomp.costs.constraints import OrientationConstraint
    from tpustomp.robot import model
    from tpustomp.robot.fk import fk_frames
    from tpustomp.api.config import NoiseConfig

    robot = model.arm_7dof()
    world = tabletop_scene()
    log(f"[constrained] sampling {n} upright-endpoint hard problems...")
    q0s, qNs = sample_problems(robot, world, n, seed=seed,
                               config_filter=upright_filter(robot, tol=tol))
    prob = ProblemSpec(q0=q0s, qN=qNs)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)

    @jax.jit
    def max_excess(traj):  # [T, d] -> worst cone excess (rad) over waypoints
        def one(q):
            _, rot, _ = fk_frames(robot, q)
            ach = rot[-1] @ jnp.asarray([0.0, 0.0, 1.0])
            ang = jnp.arccos(jnp.clip(ach[2], -1.0, 1.0))
            return jnp.maximum(ang - tol, 0.0)
        return jnp.max(jax.vmap(one)(traj))

    settings = [(f"w{w:g}_sd{sd:g}",
                 OrientationConstraint.make(axis_local=(0, 0, 1),
                                            target_world=(0, 0, 1),
                                            tolerance=tol, weight=w), sd)
                for w, sd in weights_sd]
    settings.append(("unconstrained_control", None, 0.25))

    results = {}
    for label, c, sd in settings:
        cfg = config2_cfg(max_iterations=300, pi2_h=20.0, num_restarts=2,
                          noise=NoiseConfig(stddev=sd, decay=1.0,
                                            num_rollouts_reused=5))
        t0 = time.perf_counter()
        sol = plan_batch(robot, world, prob, cfg, keys=keys, constraints=c)
        succ = np.asarray(sol.success)
        exc = np.asarray(jax.vmap(max_excess)(sol.trajectory))
        wall = time.perf_counter() - t0
        results[label] = {
            "n": n,
            "cone_tolerance_rad": tol,
            "success_rate": float(succ.mean()),
            "mean_max_excess_rad": float(exc.mean()),
            "p90_max_excess_rad": float(np.percentile(exc, 90)),
            "satisfied_rate_0.05rad": float((exc < 0.05).mean()),
            "success_and_satisfied_rate": float(
                (succ & (exc < 0.05)).mean()),
            "mean_iterations": float(np.asarray(
                sol.iterations, np.float32).mean()),
            "wall_seconds_incl_compile": round(wall, 2),
        }
        log(f"[constrained/{label}]: {results[label]}")
    return results


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 125
    out = sys.argv[2] if len(sys.argv) > 2 else None
    res = run_suite(n=n)
    payload = json.dumps(res, indent=2)
    if out:
        with open(out, "w") as f:
            f.write(payload)
    print(payload)
