"""Planner configuration — the full parameter surface of the reference planner.

Reference equivalent: ``StompParameters::initFromNodeHandle`` reading ~20 knobs
from the ROS parameter server (SURVEY.md §3.1 "Parameters", §7.3 for the knob
list; mount empty at build time so names follow SURVEY §7.3). Here the knobs
are frozen, hashable dataclasses so a config can be a ``jax.jit`` static
argument; files load via :func:`load_toml` (TOML, read by the standard
library's ``tomllib``) and dump via :func:`to_dict`.

Every constant whose reference value is uncertain (tagged [L] in SURVEY.md) is
isolated here so a later diff against a populated reference mount is a config
change, not a rewrite (SURVEY §8.3 hard part 2).
"""

from __future__ import annotations

import dataclasses
import tomllib
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class SmoothnessConfig:
    """Finite-difference smoothness operator R = sum_d w_d A_d^T A_d.

    Reference equivalent: ``CovariantTrajectoryPolicy``/``StompCost`` building
    R from DIFF_RULES stencils (SURVEY §3.1, Appendix A.2).
    """

    # Derivative weights (velocity, acceleration, jerk). Reference default:
    # acceleration-only (0/1/0 typical, SURVEY §7.3 [L]).
    weight_velocity: float = 0.0
    weight_acceleration: float = 1.0
    weight_jerk: float = 0.0
    # "fd3": classic 3-point stencils (STOMP paper formulation);
    # "fd5": 5-point central stencils (higher order);
    # "fd7": 7-point central stencils — the reference's DIFF_RULE_LENGTH=7
    # family shape (stomp_utils.h, SURVEY A.2 [M]). Any choice satisfies the
    # A.2 contract if used consistently in R, sampling, and M.
    stencil: str = "fd3"
    # Tikhonov ridge added to R (reference `ridge_factor`, default 0/tiny).
    ridge_factor: float = 0.0

    def derivative_weights(self) -> Tuple[float, float, float]:
        return (self.weight_velocity, self.weight_acceleration, self.weight_jerk)


@dataclass(frozen=True)
class NoiseConfig:
    """Exploration noise for PI^2 rollouts (SURVEY Appendix A.3)."""

    # Per-joint noise stddev in radians. A scalar here is broadcast over
    # joints; per-joint overrides go through `stddev_per_joint`.
    stddev: float = 0.05
    stddev_per_joint: Tuple[float, ...] = ()  # empty = broadcast `stddev`
    # Multiplicative decay of stddev per iteration (reference `noise_decay`).
    decay: float = 0.99
    # Number of best rollouts kept (noise retained, not resampled) across
    # iterations (reference `num_rollouts_reused`).
    num_rollouts_reused: int = 5


@dataclass(frozen=True)
class CostWeights:
    """Weights of the cost terms (SURVEY §7.3)."""

    obstacle: float = 1.0
    smoothness: float = 0.1
    constraint: float = 1.0
    torque: float = 0.0  # off by default, as in the reference


@dataclass(frozen=True)
class PlannerConfig:
    """Top-level planner knobs.

    Reference equivalent: `StompParameters` + per-request fields of the
    `GetMotionPlan` call (SURVEY §3.1, §7.3). Frozen + hashable => usable as a
    jit static argument; the arrays it parameterizes are rebuilt (and cached)
    whenever (num_timesteps, dt, smoothness) change.
    """

    # --- trajectory discretization -------------------------------------
    num_timesteps: int = 100        # N free (interior) waypoints
    duration: float = 5.0           # seconds; dt = duration / (N + 1)

    # --- iteration budget ----------------------------------------------
    max_iterations: int = 500
    max_iterations_after_collision_free: int = 5
    # Wall-clock analogue of the reference's planning_time_limit. The device
    # loop is compiled with a fixed max trip count; this limit is enforced by
    # the host-side replan loop (api/plan.py) between device steps.
    planning_time_limit: float = 10.0
    # Independent restarts per query (fresh noise stream each), best solution
    # kept — successful first, then lowest cost. The reference-era answer to
    # a failed plan was to call the service again with a new seed; here the
    # restarts are one extra vmap axis and run concurrently, so this is the
    # idiomatic way to buy success rate with parallel hardware rather than
    # wall-clock (see solver.solve_best_of). 1 = reference behavior.
    num_restarts: int = 1

    # --- STOMP (PI^2) ---------------------------------------------------
    num_rollouts: int = 10          # K new noisy rollouts per iteration
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    # PI^2 inverse-temperature h in P_k(t) = softmax_k(-h * S~_k(t)).
    # Reference value h=10 (SURVEY A.9 [M]).
    pi2_h: float = 10.0
    # Per-timestep cost fed to the softmax: "local" q(t) (the reference's
    # choice, SURVEY A.9 [M]) or "cumulative" cost-to-go sum_{t'>=t} q(t')
    # (PI^2 proper). Both solve config 2 at N=100 (measured 8/8 seeds);
    # local needs ~2.6x the iterations (66-119 vs 28-41) because only
    # timesteps whose rollouts differ in cost get informative probability
    # weights — collision-free stretches see a uniform softmax and average
    # the noise to ~0 — while cost-to-go propagates the collision signal to
    # the entire approach path, moving every earlier waypoint each
    # iteration. Cumulative stays the default for wall-clock; set "local"
    # for reference-faithful behavior (integration-tested to converge).
    pi2_cost_mode: str = "cumulative"
    # Add each rollout's per-timestep control cost (weighted by
    # weights.smoothness) into S before the softmax, as the PI^2 lineage
    # formulates it. Off by default: with the quadratic acceleration cost the
    # control term is orders of magnitude larger than the obstacle term and
    # drowns the collision signal (measured: kills convergence on config 2).
    pi2_include_control_cost: bool = False

    # --- CHOMP mode -----------------------------------------------------
    mode: str = "stomp"             # "stomp" | "chomp"
    learning_rate: float = 0.1      # CHOMP eta (stomp mode ignores it)
    # Per-iteration cap on max |δθ| (radians) in CHOMP mode; the update is
    # rescaled, not clipped per-element, to preserve its direction.
    # (Reference lineage: ChompParameters joint_update_limit.)
    chomp_joint_update_limit: float = 0.1
    # Map workspace gradients through the damped Jacobian pseudo-inverse
    # J^T (J J^T + ridge I)^-1 instead of plain J^T (reference knobs,
    # SURVEY §7.3; engine/chomp.py). STOMP mode ignores both.
    use_pseudo_inverse: bool = False
    pseudo_inverse_ridge_factor: float = 1e-4
    # Obstacle-gradient formulation in CHOMP mode:
    # "functional": the reference's continuous-time functional gradient
    #   (A.11, with curvature term) — kept as the parity default;
    # "exact": reverse-mode autodiff of the *discretized* cost the solver
    #   actually monitors (engine/chomp.exact_obstacle_gradient). An
    #   option with no reference analogue; verified against finite
    #   differences at 7-DOF. Ignores use_pseudo_inverse.
    chomp_gradient_mode: str = "functional"
    use_hamiltonian_monte_carlo: bool = False  # reference flag; off (SURVEY A.11 [L])
    hmc_step_size: float = 0.01
    hmc_leapfrog_steps: int = 10
    hmc_temperature: float = 1.0
    # Metropolis-correct the HMC proposals. Off by default: the reference
    # lineage's flag was heuristic exploration (momentum resampling, no
    # accept test), and exact HMC over N·d dims with a stiff contact
    # potential rejects nearly everything at useful step sizes (measured:
    # 0/125 on the 7-DOF suite). When off, every leapfrog position step is
    # trust-region capped like the plain CHOMP update.
    hmc_metropolis: bool = False

    # --- costs ----------------------------------------------------------
    weights: CostWeights = field(default_factory=CostWeights)
    smoothness: SmoothnessConfig = field(default_factory=SmoothnessConfig)
    # Obstacle-potential clearance epsilon in meters (reference
    # `collision_clearance`, SURVEY A.4).
    collision_clearance: float = 0.05
    # Signed distance (beyond sphere radius) above which a body is counted
    # collision-free for termination (reference `collision_threshold`).
    collision_threshold: float = 0.0

    # --- batched execution (plan_batch / BASELINE config 4) -------------
    # Host-side compaction of finished scenarios between device chunks
    # (engine/solver.solve_batch_compacted). The pure batched while_loop
    # runs until ALL scenarios terminate, so finished scenarios keep
    # computing in the convergence tail; compaction trades a host sync per
    # chunk for skipping them. "auto" resolves to OFF (api/plan.
    # _use_compaction); "on" forces it. Per-scenario numerics are
    # identical either way (tested).
    batch_compaction: str = "auto"
    # Iterations per device dispatch between host done-mask reads (each
    # chunk boundary pays one host sync).
    compaction_chunk: int = 10
    # Bucket floor: below this the device is underfilled and shrinking the
    # batch further stops paying.
    compaction_min_bucket: int = 128

    # --- joint limits ---------------------------------------------------
    # Bounded trip count for the smoothness-preserving limit projection
    # (reference iterates until clean; SURVEY A.7 + §8.3 hard part 3).
    joint_limit_iterations: int = 10
    # "jacobi": all violations corrected at once per pass (one matmul).
    # "sequential": reference-style worst-violation-first loop.
    joint_limit_method: str = "jacobi"
    # How noisy *rollouts* are kept inside limits before evaluation:
    # "clip" (default): plain clamp — cheap, endpoint-preserving (noise is
    # zero at endpoints by construction), slightly flattens noise at limits;
    # "smooth": the full projection, as applied to the trajectory itself
    # (reference behavior, ~K× the projection cost per iteration).
    rollout_limit_projection: str = "clip"

    # --- viz / debug (reference animate_path / animate_endeffector) -----
    animate_path: bool = False
    animate_endeffector: bool = False
    # Record per-iteration cost breakdown arrays in the Solution.
    record_metrics: bool = True

    # ---------------------------------------------------------------------
    @property
    def dt(self) -> float:
        return self.duration / (self.num_timesteps + 1)

    def noise_stddevs(self, num_joints: int) -> Tuple[float, ...]:
        if self.noise.stddev_per_joint:
            if len(self.noise.stddev_per_joint) != num_joints:
                raise ValueError(
                    f"stddev_per_joint has {len(self.noise.stddev_per_joint)} "
                    f"entries, robot has {num_joints} joints"
                )
            return tuple(self.noise.stddev_per_joint)
        return tuple(float(self.noise.stddev) for _ in range(num_joints))

    def __post_init__(self):
        # The A.4 potential's quadratic region divides by the clearance
        # epsilon, so clearance=0 yields 0/0 = NaN exactly at touching
        # distance and poisons the PI2 softmax. Fail at construction with
        # the workaround instead of silently diverging mid-solve.
        if self.collision_clearance <= 0.0:
            raise ValueError(
                f"collision_clearance={self.collision_clearance}: must be "
                "> 0 (the A.4 potential divides by it); use a small value "
                "like 1e-4 m for effectively-zero padding")

    def replace(self, **kw) -> "PlannerConfig":
        return dataclasses.replace(self, **kw)


def to_dict(cfg) -> dict:
    """Recursively convert a config dataclass to a plain dict."""
    return dataclasses.asdict(cfg)


def _from_dict(cls, d: dict):
    import typing

    # `from __future__ import annotations` stringifies f.type, so resolve the
    # real types once per class; any nested dataclass field then loads
    # recursively without a per-name special case.
    hints = typing.get_type_hints(cls)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        # silently dropping a misspelled knob ("num_timestep", "sttdev")
        # leaves the default in place with no signal — the classic
        # silently-wrong-config failure; fail loudly instead
        raise ValueError(
            f"unknown {cls.__name__} key(s) {unknown}; "
            f"valid keys: {sorted(known)}")
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _from_dict(ftype, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def from_dict(d: dict) -> PlannerConfig:
    return _from_dict(PlannerConfig, d)


# Top-level sections of a config file: `planner` holds PlannerConfig
# fields; the others describe the CLI's scene, batch (config 4) and MPC
# (config 5) runs (tpustomp/cli.py).
SECTIONS = ("planner", "scene", "batch", "mpc")


def read_toml(path: str) -> dict:
    """Parse a config file, rejecting unknown top-level sections."""
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    if "planner" in doc:
        unknown = sorted(set(doc) - set(SECTIONS))
        if unknown:
            raise ValueError(f"unknown config section(s) {unknown} in "
                             f"{path}; valid sections: {list(SECTIONS)}")
    return doc


def load_toml(path: str) -> PlannerConfig:
    """Load a PlannerConfig from a TOML file (reference: config/*.yaml)."""
    doc = read_toml(path)
    if "planner" in doc:
        return from_dict(doc["planner"])
    # bare planner table (no [planner] section): tolerate the CLI's
    # sibling sections, but still reject unknown knobs
    return from_dict({k: v for k, v in doc.items() if k not in SECTIONS})
