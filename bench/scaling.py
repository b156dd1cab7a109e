"""BASELINE metric: solves/s scaling over devices/hosts.

`run` measures the *sharding overhead*: the same batch solved with and
without a mesh over all local devices. For this collective-free program
(SURVEY §3.4: comms only at dispatch/gather) that overhead, with zero
in-loop collectives, is what decides multi-device efficiency.
"""

import sys

import numpy as np
import jax

sys.path.insert(0, ".")
from bench.common import config2_cfg, config2_scene, log, timed  # noqa: E402


def run(B=64):
    from tpustomp.api.plan import plan_batch
    from tpustomp.api.problem import ProblemSpec
    from tpustomp.engine import distributed

    robot, world, q0, qN = config2_scene()
    cfg = config2_cfg(num_timesteps=30, num_rollouts=10, max_iterations=30,
                      max_iterations_after_collision_free=10**6)
    ndev = jax.device_count()
    rng = np.random.default_rng(0)
    Q0 = (np.tile(q0, (B, 1))
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    QN = (np.tile(qN, (B, 1))
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    prob = ProblemSpec(q0=Q0, qN=QN)

    t_plain = timed(lambda: plan_batch(robot, world, prob, cfg, keys=keys),
                    n=3)
    mesh = distributed.make_mesh()
    t_mesh = timed(lambda: distributed.plan_sharded(
        robot, world, prob, cfg, keys=keys, mesh=mesh), n=3)
    out = {
        "batch": B,
        "devices": ndev,
        "solves_per_sec_unsharded": B / t_plain,
        "solves_per_sec_sharded": B / t_mesh,
        "sharding_overhead": t_mesh / t_plain - 1.0,
    }
    log(f"scaling: {out}")
    return out


def run_multiprocess(nprocs=2, B_local=32, devs_per_proc=4):
    """Per-host solves/s through a REAL jax.distributed process group on
    localhost (VERDICT round-1 item 9): nprocs processes × devs_per_proc
    virtual CPU devices each, global mesh spanning all of them — the exact
    code path of a multi-host run (only device kind and coordinator
    address differ), runnable without a cluster. The workers stay on the
    CPU: no more than one JAX process opens a card.

    Weak-scaling efficiency = per-host solves/s at nprocs vs at 1 process
    (same per-host workload). Caveat on this machine: all processes share
    the same physical CPU cores, so contention UNDERSTATES true multi-host
    efficiency; the program has zero in-loop collectives (SURVEY §3.4), so
    on real hardware the dispatch/gather overhead measured here is the whole
    cost.
    """
    import json as _json
    import socket
    import subprocess
    import tempfile

    worker = __file__.replace("scaling.py", "_scaling_worker.py")

    def launch(n):
        if n > 1:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
            s.close()
        else:
            port = "none"
        procs, outs = [], []
        with tempfile.TemporaryDirectory() as td:
            for pid in range(n):
                out = f"{td}/proc{pid}.json"
                outs.append(out)
                procs.append(subprocess.Popen(
                    [sys.executable, worker, str(pid), str(n), port, out,
                     str(B_local), str(devs_per_proc)],
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
            results = []
            for p in procs:
                _, err = p.communicate(timeout=900)
                if p.returncode != 0:
                    raise RuntimeError(err.decode()[-2000:])
            for out in outs:
                with open(out) as f:
                    results.append(_json.load(f))
        return results

    single = launch(1)
    multi = launch(nprocs)
    sps_1 = single[0]["solves_per_sec_per_host"]
    sps_n = [r["solves_per_sec_per_host"] for r in multi]
    out = {
        "nprocs": nprocs,
        "devices_per_proc": devs_per_proc,
        "local_batch": B_local,
        "solves_per_sec_per_host_1proc": sps_1,
        "solves_per_sec_per_host_nproc": sps_n,
        "weak_scaling_efficiency": float(np.mean(sps_n)) / sps_1,
        "caveat": "localhost CPUs share cores; contention understates "
                  "real multi-host efficiency (zero in-loop collectives)",
    }
    log(f"multiprocess scaling: {out}")
    return out


def run_dispatch_bound(B=1024):
    """Contention-free multi-host efficiency bound, measured on one device
    (VERDICT r2 item 4): turn ">=80% because zero in-loop collectives" from a
    design claim into arithmetic.

    In a multi-host run each host dispatches its own local shard and there
    are no in-loop collectives (SURVEY §3.4), so per-host weak-scaling
    efficiency = t_device_solve / (t_device_solve + t_host_nonoverlapped):
    the only per-host costs on top of the solve are shard build, dispatch,
    and result gather — all host-local. This measures both terms at the
    config-4 shape on one device:

      t_chain_slope — pure device+queue time per batched solve, from the
        slope between 1 and 3 back-to-back solves (fixed dispatch cost
        cancels in the slope);
      t_e2e — a full plan_batch call end to end (host prep + dispatch +
        solve + gather of the Solution pytree to host), the per-host cost a
        multi-host run pays per shard.

    Reported bound = t_chain_slope / t_e2e. The localhost multi-process
    number (run_multiprocess) bounds from below under full core contention;
    this bounds from above without it.
    """
    import time

    import jax.numpy as jnp

    from tpustomp.api.config import PlannerConfig  # noqa: F401 (doc pointer)
    from tpustomp.api.plan import plan_batch
    from tpustomp.api.problem import ProblemSpec
    from tpustomp.dynamics.device import device_ops
    from tpustomp.engine import solver

    robot, world, q0, qN = config2_scene()
    cfg = config2_cfg(max_iterations=50)
    rng = np.random.default_rng(0)
    Q0 = (np.tile(q0, (B, 1))
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    QN = (np.tile(qN, (B, 1))
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)

    fn = jax.jit(lambda s, a, b, k: solver.solve_batch(
        robot, world, None, cfg, ops, a, b, k).cost.sum() + 0.0 * s)
    Q0d, QNd = jnp.asarray(Q0), jnp.asarray(QN)

    def chain(n):
        s = jnp.float32(0.0)
        t0 = time.perf_counter()
        for _ in range(n):
            s = fn(0.0 * s, Q0d, QNd, keys)
        _ = float(s)  # one device->host pull ends the region
        return time.perf_counter() - t0

    chain(1)  # compile + warm
    t1s = [chain(1) for _ in range(5)]
    t3s = [chain(3) for _ in range(5)]
    t_solve = (min(t3s) - min(t1s)) / 2.0
    solve_spread = ((np.median(t3s) - np.median(t1s)) / 2.0 - t_solve)

    prob = ProblemSpec(q0=Q0, qN=QN)
    cfgp = cfg.replace(batch_compaction="off")
    plan_batch(robot, world, prob, cfgp, keys=keys)  # warm

    def e2e(gather, n=5):
        ts = []
        for i in range(n):
            t0 = time.perf_counter()
            sol = plan_batch(robot, world, prob, cfgp, keys=keys)
            if gather == "full":       # every Solution leaf to host
                _ = jax.tree.map(np.asarray, sol)
            else:                      # serving path: results + one flag
                _ = np.asarray(sol.trajectory)
                _ = np.asarray(sol.success)
            ts.append(time.perf_counter() - t0)
        return {"median_s": float(np.median(ts)), "min_s": float(np.min(ts)),
                "max_s": float(np.max(ts)), "n": n}

    t_full = e2e("full")
    t_min = e2e("min")

    out = {
        "batch": B,
        "t_device_solve_slope_s": t_solve,
        "t_device_solve_slope_spread_s": float(abs(solve_spread)),
        "t_end_to_end_full_gather": t_full,
        "t_end_to_end_min_gather": t_min,
        "serialized_efficiency_full_gather":
            t_solve / t_full["median_s"],
        "serialized_efficiency_min_gather":
            t_solve / t_min["median_s"],
        "note": "SERIALIZED bound (prep->solve->gather per batch, no "
                "overlap): what a naive per-batch caller pays. The "
                "production serving loop is plan_batch_stream, measured by "
                "run_pipelined_bound — host work there overlaps device "
                "compute, so this serialized figure is a floor, not the "
                "operative efficiency.",
    }
    log(f"dispatch bound: {out}")
    return out


def run_pipelined_bound(B=1024, nbatches=8, reps=5, max_iterations=50):
    """THE operative multi-host efficiency number (VERDICT r3 item 1):
    steady-state per-host efficiency of the PIPELINED serving loop
    (api/plan.plan_batch_stream), measured on one device with the slope
    methodology and reported as a distribution (median + spread over
    `reps` within-process repeats), not a best run.

    Per-host weak-scaling efficiency on independent hosts
      = t_device_solve / t_sustained_per_batch,
    because scenarios never shard across hosts and there are zero in-loop
    collectives (SURVEY §3.3/§3.4) — each host just needs to keep its own
    chip fed. The stream keeps `depth` batches in flight, so host
    prep/dispatch/gather overlap device compute and the sustained per-batch
    time approaches max(t_solve, t_host) instead of t_solve + t_host.

    Methodology: t_solve from the chained-solve slope (fixed dispatch cost
    cancels); sustained per-batch time from the slope between
    nbatches- and 2*nbatches-long streams (pipeline fill/drain cancels).
    Every streamed batch reuses the same (Q0, QN, keys) so the device work
    per batch is IDENTICAL to the slope chain's; the generator still
    rebuilds the host-side problem arrays each batch, so realistic host
    prep cost stays in the loop.
    """
    import time

    import jax.numpy as jnp

    from tpustomp.api.plan import plan_batch, plan_batch_stream
    from tpustomp.api.problem import ProblemSpec
    from tpustomp.dynamics.device import device_ops
    from tpustomp.engine import solver

    robot, world, q0, qN = config2_scene()
    cfg = config2_cfg(max_iterations=max_iterations).replace(
        batch_compaction="off")
    keys = jax.random.split(jax.random.PRNGKey(0), B)

    def make_arrays():
        rng = np.random.default_rng(0)
        Q0 = (np.tile(q0, (B, 1))
              + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
        QN = (np.tile(qN, (B, 1))
              + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
        return Q0, QN

    Q0, QN = make_arrays()
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)

    # --- device-only slope (same batch as the stream) -------------------
    fn = jax.jit(lambda s, a, b, k: solver.solve_batch(
        robot, world, None, cfg, ops, a, b, k).cost.sum() + 0.0 * s)
    Q0d, QNd = jnp.asarray(Q0), jnp.asarray(QN)

    def chain(n):
        s = jnp.float32(0.0)
        t0 = time.perf_counter()
        for _ in range(n):
            s = fn(0.0 * s, Q0d, QNd, keys)
        _ = float(s)
        return time.perf_counter() - t0

    chain(1)  # compile + warm
    t_solves = [(chain(3) - chain(1)) / 2.0 for _ in range(reps)]
    t_solve = float(np.median(t_solves))

    # --- pipelined stream slope ----------------------------------------
    prob_warm = ProblemSpec(q0=Q0, qN=QN)
    plan_batch(robot, world, prob_warm, cfg, keys=keys)  # warm jit cache

    def gen(n):
        for _ in range(n):
            a, b = make_arrays()  # realistic per-batch host prep
            yield ProblemSpec(q0=a, qN=b), keys

    def stream_time(n):
        t0 = time.perf_counter()
        for _out in plan_batch_stream(robot, world, gen(n), cfg, depth=2):
            pass
        return time.perf_counter() - t0

    stream_time(2)  # prime
    per_batch, effs = [], []
    for _ in range(reps):
        tn = stream_time(nbatches)
        t2n = stream_time(2 * nbatches)
        pb = (t2n - tn) / nbatches
        per_batch.append(pb)
        effs.append(t_solve / pb)
    out = {
        "batch": B,
        "nbatches_slope": nbatches,
        "n": reps,
        "t_device_solve_slope_s": {
            "median": t_solve, "min": float(np.min(t_solves)),
            "max": float(np.max(t_solves))},
        "t_sustained_per_batch_s": {
            "median": float(np.median(per_batch)),
            "min": float(np.min(per_batch)),
            "max": float(np.max(per_batch))},
        "pipelined_efficiency": {
            "median": float(np.median(effs)), "min": float(np.min(effs)),
            "max": float(np.max(effs))},
        "sustained_solves_per_sec": B / float(np.median(per_batch)),
        "note": "per-host multi-host weak-scaling efficiency = device "
                "slope / sustained streamed per-batch time (pipeline "
                "fill/drain and fixed dispatch costs cancel in the "
                "slopes); "
                "distribution over within-process repeats.",
    }
    log(f"pipelined bound: {out}")
    return out


if __name__ == "__main__":
    import json
    if "--multiprocess" in sys.argv:
        print(json.dumps(run_multiprocess()))
    elif "--dispatch-bound" in sys.argv:
        print(json.dumps(run_dispatch_bound()))
    elif "--pipelined" in sys.argv:
        print(json.dumps(run_pipelined_bound()))
    else:
        print(json.dumps(run()))
