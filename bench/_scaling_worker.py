"""Worker for the multi-process scaling bench (bench/scaling.py).

Launched as:
  python _scaling_worker.py <proc_id> <nprocs> <port|none> <out> <B_local> <devs>

Each process owns <devs> virtual CPU devices; with port != "none" it joins a
jax.distributed process group whose global mesh spans nprocs*devs devices
(exactly the code path a real multi-host run takes — only the device kind
and the coordinator address change). It times plan_sharded over its local
shard and writes per-host solves/s as JSON. Workers stay on the CPU: no
more than one JAX process opens a card.
"""

import json
import os
import sys
import time

(proc_id, nprocs, port, out_file, B_local, devs) = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    int(sys.argv[5]), int(sys.argv[6]))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devs}"

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
if port != "none":
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nprocs, process_id=proc_id)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench.common import config2_cfg, config2_scene  # noqa: E402
from tpustomp.api.problem import ProblemSpec  # noqa: E402
from tpustomp.engine import distributed  # noqa: E402

robot, world, q0, qN = config2_scene()
cfg = config2_cfg(num_timesteps=30, num_rollouts=10, max_iterations=30,
                  max_iterations_after_collision_free=10**6)

rng = np.random.default_rng(100 + proc_id)
Q0 = (np.tile(q0, (B_local, 1))
      + rng.uniform(-0.03, 0.03, (B_local, 7))).astype(np.float32)
QN = (np.tile(qN, (B_local, 1))
      + rng.uniform(-0.03, 0.03, (B_local, 7))).astype(np.float32)
keys = np.asarray(jax.random.split(jax.random.PRNGKey(proc_id), B_local))
prob = ProblemSpec(q0=Q0, qN=QN)
mesh = distributed.make_mesh()


def solve_once(seed):
    k = np.asarray(jax.random.split(jax.random.PRNGKey(seed), B_local))
    sol = distributed.plan_sharded(robot, world, prob, cfg, keys=k, mesh=mesh)
    # force completion of the local shard (device->host pull)
    return float(np.sum([np.sum(np.asarray(s.data))
                         for s in sol.cost.addressable_shards]))


solve_once(0)  # compile
ts = []
for i in (1, 2, 3):
    t0 = time.perf_counter()
    solve_once(i)
    ts.append(time.perf_counter() - t0)
dt = float(np.median(ts))
with open(out_file, "w") as f:
    json.dump({"proc_id": proc_id, "nprocs": nprocs,
               "local_batch": B_local, "seconds": dt,
               "solves_per_sec_per_host": B_local / dt}, f)
