"""One profiler trace of plan_batch at the config-4 shape, reduced to the
numbers the evaluation layer is judged by.

    python bench/trace_config4.py [--out chiprun_out] [--command-buffers]

Config 4: B=1024 scenarios, N=100 waypoints, K=50 noisy + 5 reused
rollouts (C=56 candidates), 7-DOF arm, analytic tabletop. After two warm
solves, one solve runs under `utils.tracing.profile`; the device trace is
reduced to
  - device time per XLA op, and per step stage (propose / evaluate /
    update, from the `jax.named_scope`s in engine/solver.make_step_batch;
    an op belongs to the scope of its HLO instruction's metadata);
  - device busy time and idle share over the traced call;
  - the evaluate stage's time per solver iteration against its roofline:
    ~110 KFLOP and ~3.7 KB of HBM traffic per candidate evaluation (FK
    ~60 KFLOP, bodies + SDF ~30 KFLOP, velocity + potential + reduce
    ~20 KFLOP; a 102×7 float32 trajectory in, two 102-row cost rows out),
    against the card's float32 (non-tensor-core) rate and HBM bandwidth.
XLA runs the solver loop's body as a CUDA command buffer (graph) by default,
which the trace shows as one opaque `command_buffer` op. The breakdown run
therefore turns command buffers off (--xla_gpu_enable_command_buffer=) so
every fusion appears as its own kernel; its untraced warm wall time is
reported beside the breakdown, and `--command-buffers` keeps XLA's default.
A GPU is required; the result is printed and written as JSON to --out.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FLOP_PER_EVAL = 110e3
BYTES_PER_EVAL = 3.7e3
# Published dense peaks (NVIDIA H100 SXM data sheet): float32 outside the
# tensor cores, HBM3 bandwidth. Keyed by jax device_kind; a card missing
# here is an error.
PEAKS = {"NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}}
SCOPES = ("propose", "evaluate", "update")


def scope_map(hlo_text: str) -> dict:
    """HLO instruction name -> step stage, from op_name metadata."""
    out = {}
    for m in re.finditer(r"^\s*(?:ROOT )?%?([\w.\-]+) = .*?"
                         r"metadata=\{[^}]*op_name=\"([^\"]*)\"", hlo_text,
                         re.M):
        name, op_name = m.group(1), m.group(2)
        for s in SCOPES:
            if f"/{s}/" in op_name + "/":
                out[name] = s
                break
    return out


def _union(intervals) -> int:
    total, end = 0, -1
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce_trace(path: str, scopes: dict, window_name: str) -> dict:
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    window = None
    for plane in pd.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for e in line.events:
                    if e.name == window_name:
                        window = (e.start_ns, e.start_ns + e.duration_ns)
    dev = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not dev:
        raise RuntimeError("trace has no GPU device plane")
    lines = {}
    samples = {}
    per_op = collections.Counter()
    per_scope = collections.Counter()
    intervals = []
    for line in dev[0].lines:
        n = 0
        for e in line.events:
            stats = dict(e.stats)
            op = str(stats.get("hlo_op") or e.name)
            if n < 2:
                samples.setdefault(line.name, []).append(
                    {"name": e.name, "stats": {k: str(v)[:80]
                                               for k, v in stats.items()}})
            n += 1
            if "Stream" not in line.name:
                continue
            if window and not (window[0] <= e.start_ns <= window[1]):
                continue
            intervals.append((e.start_ns, e.start_ns + e.duration_ns))
            per_op[op] += e.duration_ns
            per_scope[scopes.get(op, "other")] += e.duration_ns
        lines[line.name] = n
    busy = _union(intervals)
    span = ((window[1] - window[0]) if window
            else max(e for _, e in intervals) - min(s for s, _ in intervals))
    return {"device_plane": dev[0].name, "lines": lines,
            "window_ns": span, "busy_ns": busy,
            "idle_share": 1.0 - busy / span,
            "per_scope_ns": dict(per_scope), "event_samples": samples,
            "top_ops_ns": dict(per_op.most_common(25))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    p.add_argument("--command-buffers", action="store_true",
                   help="keep XLA's CUDA command buffers on (ops then hide "
                        "inside one command_buffer event)")
    args = p.parse_args(argv)
    if not args.command_buffers:
        # before JAX initializes its backend (module docstring)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax
    import jax.numpy as jnp
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"trace_config4: needs a GPU, found {dev.platform}")
    peaks = PEAKS[dev.device_kind]

    from tpustomp.api import plan as plan_mod
    from tpustomp.api.config import load_toml
    from tpustomp.cli import DEFAULT_SCENE, batch_problems, build_scene
    from tpustomp.dynamics.device import device_ops
    from tpustomp.utils.cache import enable_compile_cache
    from tpustomp.utils.tracing import profile

    enable_compile_cache()
    cfg = load_toml(os.path.join(ROOT, "configs", "config4_batch.toml"))
    robot, world, q0, qN = build_scene(DEFAULT_SCENE, False)
    B = 1024
    prob, keys = batch_problems(q0, qN, B, 0.03, seed=0)
    for r in range(2):
        jax.block_until_ready(plan_mod.plan_batch(
            robot, world, prob, cfg, keys=jax.random.split(
                jax.random.PRNGKey(10 + r), B)))
    walls = []
    for r in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(plan_mod.plan_batch(robot, world, prob, cfg,
                                                  keys=keys))
        walls.append(time.perf_counter() - t0)

    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness)
    compiled = plan_mod._jitted_solve_batch(cfg, False).lower(
        robot, world, None, ops, jnp.asarray(prob.q0), jnp.asarray(prob.qN),
        keys).compile()
    scopes = scope_map(compiled.as_text())

    logdir = os.path.join(args.out, "trace_config4")
    with profile(logdir):
        with jax.profiler.TraceAnnotation("config4_solve"):
            t0 = time.perf_counter()
            sol = jax.block_until_ready(plan_mod.plan_batch(
                robot, world, prob, cfg, keys=keys))
            wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    red = reduce_trace(path, scopes, "config4_solve")

    trips = int(np.max(np.asarray(sol.iterations)))
    C = 1 + cfg.num_rollouts + cfg.noise.num_rollouts_reused
    evals = B * C
    t_flop = evals * FLOP_PER_EVAL / peaks["fp32_flops"]
    t_byte = evals * BYTES_PER_EVAL / peaks["hbm_bytes"]
    ev_ns = red["per_scope_ns"].get("evaluate", 0)
    step_ns = sum(red["per_scope_ns"].get(s, 0) for s in SCOPES)
    ev_iter_s = ev_ns / 1e9 / trips
    result = {
        "device_kind": dev.device_kind, "batch": B, "candidates": C,
        "command_buffers": args.command_buffers,
        "untraced_wall_s": float(np.median(walls)),
        "traced_wall_s": wall, "trips": trips,
        "success_rate": float(np.mean(np.asarray(sol.success))),
        "evaluate_s_per_iteration": ev_iter_s,
        "evaluate_share_of_step": ev_ns / step_ns if step_ns else None,
        "evaluate_share_of_busy": ev_ns / red["busy_ns"],
        "idle_share": red["idle_share"],
        "roofline_s_per_iteration": max(t_flop, t_byte),
        "roofline_bound": "fp32 compute" if t_flop >= t_byte else "HBM",
        "evaluate_roofline_share": max(t_flop, t_byte) / ev_iter_s
        if ev_iter_s else None,
        "scoped_ops": len(scopes),
        **red,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trace_config4.json"), "w") as f:
        json.dump(result, f, indent=1)
    for k in ("device_kind", "command_buffers", "untraced_wall_s",
              "traced_wall_s", "trips", "success_rate",
              "evaluate_s_per_iteration", "evaluate_share_of_step",
              "evaluate_share_of_busy", "idle_share",
              "roofline_s_per_iteration", "roofline_bound",
              "evaluate_roofline_share", "per_scope_ns", "lines",
              "event_samples"):
        print(f"{k}: {result[k]}")
    print("top ops (ns over the traced solve):")
    for op, ns in result["top_ops_ns"].items():
        print(f"  {ns:>12} {scopes.get(op, 'other'):>9} {op}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
