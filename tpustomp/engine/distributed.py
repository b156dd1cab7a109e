"""Scenario-parallel execution over a device mesh (+ multi-host).

Reference equivalent: none — the reference is a single-threaded ROS node whose
only "communication layer" is TCPROS topics/services (SURVEY §3.3/§3.4). This
module is the new framework's first-class scale-out story:

  - Data parallelism over *scenarios* (independent planning problems) is the
    primary axis: a scenario never shards across chips, so the PI² softmax
    and update stay chip-local and cross-chip traffic is only problem
    dispatch / result gather / metric reductions. That asymmetry is why ≥80%
    multi-host scaling efficiency is the design target (BASELINE.json).
  - Within a chip, rollouts/waypoints/spheres are vmapped array axes.
  - Mesh axis name: "scenario". Sharding via NamedSharding; XLA inserts the
    (few) collectives. Multi-host: `init_multihost()` then the same code —
    the mesh spans all processes' devices, inputs are built from
    process-local shards with `make_array_from_process_local_data`.

Tests exercise this on 8 virtual CPU devices (tests/distributed/), asserting
per-scenario results match single-device runs to float32 tolerance (atol 2e-6;
XLA fusion order differs by 1-2 ULP across shardings — SURVEY §5.5).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpustomp.api.config import PlannerConfig
from tpustomp.api.problem import ProblemSpec, Solution
from tpustomp.dynamics.device import device_ops
from tpustomp.engine import solver

SCENARIO_AXIS = "scenario"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over the given (default: all) devices, axis "scenario"."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (SCENARIO_AXIS,))


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None) -> None:
    """Initialize the JAX multi-host runtime (one process per host).

    Thin wrapper over jax.distributed.initialize so callers don't import jax
    internals; no-op if already initialized.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError:
        pass  # already initialized


@functools.lru_cache(maxsize=16)
def _sharded_solve(cfg: PlannerConfig, mesh: Mesh, has_constraints: bool,
                   has_hyper: bool = False):
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))
    replicated = NamedSharding(mesh, P())

    if cfg.mode == "stomp" and cfg.num_restarts <= 1:
        # batched path: per shard, all local scenarios advance in one
        # solver loop (solver.solve_batch; the scenario axis stays sharded,
        # no cross-shard traffic). hyper leaves ([B]) shard with their
        # scenarios, so a mesh-wide hyperparameter grid is just a bigger
        # batch.
        def run(robot, world, constraints, ops, q0, qN, keys, hyper):
            return solver.solve_batch(robot, world, constraints, cfg, ops,
                                      q0, qN, keys, hyper=hyper)
    else:
        assert not has_hyper, \
            "per-scenario hyper needs the STOMP batched path (num_restarts<=1)"

        def run(robot, world, constraints, ops, q0, qN, keys, hyper):
            return jax.vmap(
                lambda a, b, k: solver.solve_best_of(robot, world, constraints,
                                                     cfg, ops, a, b, k)
            )(q0, qN, keys)

    return jax.jit(
        run,
        in_shardings=(replicated, replicated,
                      replicated if has_constraints else None,
                      replicated, sharding, sharding, sharding,
                      sharding if has_hyper else None),
        out_shardings=sharding,
    )


def _key_rows(keys) -> np.ndarray:
    """[B] PRNG keys as a shardable [B, W] uint32 array. New-style typed
    keys (jax.random.key) cannot pass through np.asarray — unwrap them the
    with jax.random.key_data; raw uint32 keys pass unchanged."""
    if jnp.issubdtype(jnp.asarray(keys).dtype, jax.dtypes.prng_key):
        data = np.asarray(jax.random.key_data(keys))
        if data.shape[-1] != 2:
            raise ValueError(
                f"plan_sharded scenario keys must be threefry (2-word) "
                f"keys; got key_data width {data.shape[-1]} "
                f"(impl {jax.random.key_impl(keys)}). Use "
                "jax.random.split(jax.random.PRNGKey(seed), B).")
        return data
    return np.asarray(keys)


def _shard_batch(x: np.ndarray, mesh: Mesh):
    """Build a global device array from (process-local) batch data."""
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS,
                                     *([None] * (x.ndim - 1))))
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(x), sharding)
    return jax.make_array_from_process_local_data(sharding, np.asarray(x))


def plan_sharded(robot, world, problem: ProblemSpec,
                 cfg: PlannerConfig = PlannerConfig(),
                 keys=None, constraints=None, mesh: Mesh | None = None,
                 hyper=None) -> Solution:
    """Solve a batch of scenarios sharded over the mesh (BASELINE config 4/5).

    problem.q0/qN: [batch, d] — batch must divide evenly by the mesh size
    (pad with duplicates if needed; scenarios are independent so padding is
    harmless). In multi-host mode, pass each process's local shard; the
    global batch is their concatenation.

    hyper: optional solver.HyperParams with [batch] leaves (process-local
    shard in multi-host mode) — per-scenario traced hyperparameters shard
    with their scenarios, so a MESH-WIDE hyperparameter grid is one sharded
    solve (api/tune.py is the single-process form). STOMP batched path
    only.
    """
    if mesh is None:
        mesh = make_mesh()
    q0 = np.asarray(problem.q0, np.float32)
    qN = np.asarray(problem.qN, np.float32)
    if keys is None:
        keys = jax.random.split(jax.random.PRNGKey(0),
                                q0.shape[0] * jax.process_count())
        local = q0.shape[0]
        keys = keys[jax.process_index() * local:(jax.process_index() + 1) * local]
    from tpustomp.api.plan import _apply_goal_tolerance
    # Resolve the goal tolerance band exactly as plan_batch does (no-op for
    # exact goals): without this, the same problems gave different results
    # the moment a user scaled from plan_batch to the mesh path. Runs on
    # each process's local shard (rows are independent).
    qN = np.asarray(_apply_goal_tolerance(
        robot, world, problem, cfg, jnp.asarray(q0), jnp.asarray(qN),
        batched=True), np.float32)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    fn = _sharded_solve(cfg, mesh, constraints is not None,
                        has_hyper=hyper is not None)
    if hyper is not None:
        hyper = jax.tree.map(
            lambda x: _shard_batch(np.asarray(x, np.float32), mesh), hyper)
    return fn(robot, world, constraints, ops,
              _shard_batch(q0, mesh), _shard_batch(qN, mesh),
              _shard_batch(_key_rows(keys), mesh), hyper)


@functools.lru_cache(maxsize=1)
def _summarize_jit():
    return jax.jit(lambda succ, cost, iters: (
        jnp.mean(succ.astype(jnp.float32)),
        jnp.mean(cost),
        jnp.mean(iters.astype(jnp.float32))))


def summarize(sol: Solution) -> dict:
    """Global scalar metrics of a batched Solution.

    Correct for both plain batched arrays and the globally-sharded output
    of `plan_sharded` in real multi-process runs: the leading axis of a
    global jax.Array is already the GLOBAL scenario count (never multiply
    by process_count), and the reductions run under jit so the scalars
    come back fully replicated — every process can read them, whereas
    `float(jnp.mean(x))` on a non-fully-addressable sharded operand raises.
    Exercised under 2-process jax.distributed in tests/distributed/
    (_mp_worker.py asserts the global count and cross-process agreement).
    """
    sr, mc, mi = _summarize_jit()(sol.success, sol.cost, sol.iterations)
    return {
        "num_scenarios": int(sol.success.shape[0]),
        "success_rate": float(sr),
        "mean_cost": float(mc),
        "mean_iterations": float(mi),
    }
