"""The pytree dataclass helper (tpustomp.utils.struct), checked on every
class the package builds with it: flatten/unflatten and jit round trips,
static (treedef) fields, and `.replace` on a frozen instance."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpustomp.api.config import PlannerConfig, SmoothnessConfig
from tpustomp.utils import struct


def _robot():
    from tpustomp.robot import model
    return model.planar_2r()


def _cfg():
    return PlannerConfig(num_timesteps=6, max_iterations=4)


def _examples():
    from tpustomp.api.problem import IterationMetrics, ProblemSpec, Solution
    from tpustomp.costs.constraints import (OrientationConstraint,
                                            PositionConstraint)
    from tpustomp.dynamics.device import device_ops
    from tpustomp.engine import mpc, solver
    from tpustomp.world.sdf import AnalyticWorld, CompositeWorld, GridSDF

    q0, qN = jnp.zeros(2), jnp.ones(2)
    grid = GridSDF.make(np.ones((4, 4, 4), np.float32), (0, 0, 0), 0.1)
    metrics = IterationMetrics(*(jnp.zeros(4) for _ in range(4)),
                               collision_free=jnp.zeros(4, bool))
    return {
        "HyperParams": lambda: solver.HyperParams.from_config(_cfg()),
        "SolverState": lambda: solver.init_state(
            _robot(), _cfg(), q0, qN, jax.random.PRNGKey(0)),
        "MPCState": lambda: mpc.init_mpc(
            _robot(), _cfg(), q0, qN, jnp.zeros((1, 3)), jnp.zeros((1, 3)),
            jax.random.PRNGKey(0)),
        "RobotSpec": _robot,
        "AnalyticWorld": lambda: AnalyticWorld.make(
            spheres=[((0, 0, 0), 0.1)]),
        "GridSDF": lambda: grid,
        "CompositeWorld": lambda: CompositeWorld.make(
            grid, spheres=[((0, 0, 0), 0.1)]),
        "OrientationConstraint": OrientationConstraint.make,
        "PositionConstraint": lambda: PositionConstraint.make((0, 0, 1)),
        "DeviceOps": lambda: device_ops(6, 0.1, SmoothnessConfig()),
        "ProblemSpec": lambda: ProblemSpec(q0=q0, qN=qN),
        "IterationMetrics": lambda: metrics,
        "Solution": lambda: Solution(
            trajectory=jnp.zeros((8, 2)), times=jnp.zeros(8),
            success=jnp.bool_(True), cost=jnp.float32(0.0),
            iterations=jnp.int32(1), metrics=metrics),
    }


CLASSES = list(_examples())

# classes with fields that ride in the treedef instead of the leaves
STATIC = {"RobotSpec": ("rot_fixed_identity",), "DeviceOps": ("cov_scale",)}


def _make(name):
    obj = _examples()[name]()
    assert type(obj).__name__ == name
    return obj


@pytest.mark.parametrize("name", CLASSES)
def test_flatten_and_jit_round_trip(name):
    obj = _make(name)
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    through_jit = jax.jit(lambda x: x)(obj)
    assert jax.tree_util.tree_structure(through_jit) == treedef
    for a, b in zip(jax.tree.leaves(through_jit), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", CLASSES)
def test_static_fields_ride_in_treedef(name):
    obj = _make(name)
    fields = dataclasses.fields(obj)
    static = {f.name for f in fields
              if not f.metadata.get("pytree_node", True)}
    assert static == set(STATIC.get(name, ()))
    treedef = jax.tree_util.tree_structure(obj)
    hash(treedef)                         # static values must hash (jit keys)
    for fname in static:
        value = getattr(obj, fname)
        assert not any(leaf is value for leaf in jax.tree.leaves(obj))
        changed = obj.replace(**{fname: type(value)(not value)
                                 if isinstance(value, bool) else value * 2})
        # a new static value is a new program for jit
        assert jax.tree_util.tree_structure(changed) != treedef


@pytest.mark.parametrize("name", CLASSES)
def test_replace_returns_copy_of_frozen_instance(name):
    obj = _make(name)
    first = dataclasses.fields(obj)[0].name
    new_value = jax.tree.map(lambda x: x + 1, getattr(obj, first))
    out = obj.replace(**{first: new_value})
    assert type(out) is type(obj)
    assert getattr(out, first) is new_value
    for f in dataclasses.fields(obj)[1:]:
        assert getattr(out, f.name) is getattr(obj, f.name)
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, first, new_value)


def test_field_keeps_other_metadata():
    @struct.dataclass
    class Tagged:
        x: jnp.ndarray
        tag: str = struct.field(pytree_node=False, default="a",
                                metadata={"doc": "label"})

    f = dataclasses.fields(Tagged)[1]
    assert f.metadata == {"doc": "label", "pytree_node": False}
    assert jax.tree.leaves(Tagged(jnp.ones(2))) != []
    assert len(jax.tree.leaves(Tagged(jnp.ones(2), tag="b"))) == 1
