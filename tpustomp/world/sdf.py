"""Signed-distance-field worlds: voxel grid + analytic primitive composition.

Reference equivalents (SURVEY §3.1/§3.2): ``StompCollisionSpace`` owning a
``distance_field::PropagationDistanceField`` (voxelized signed EDT, distance +
finite-difference gradient query at a 3-D point, world population from
collision maps / static cuboids).

Design:
  - `GridSDF`: a dense [X,Y,Z] float32 grid. Query = one flat gather of the 8
    cell corners per point + trilinear weights; the gradient is the *analytic*
    gradient of the trilinear interpolant (exact for the interpolated field,
    replacing the reference's central-difference lookup — one gather instead
    of seven). This is the only memory-irregular op in the hot loop
    (SURVEY §8.3 hard part 1).
  - `AnalyticWorld`: closed-form SDF of sphere/box primitives composed via
    min. Zero memory traffic, exact gradients via `jax.grad`-free algebra;
    also the moving-obstacle world for the MPC loop (BASELINE config 5) —
    updating obstacle positions is a pytree update, no EDT rebuild
    (SURVEY §8.3 hard part 6).

Both implement `sdf(world, points)` / `sdf_grad(world, points)` with points
[..., 3]; grid/primitive construction lives in world/edt.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpustomp.utils import struct


@struct.dataclass
class AnalyticWorld:
    """Union of spheres and axis-aligned boxes (min-composed SDF).

    Fixed shapes for jit: S spheres, X boxes; "absent" entries use radius<0
    sentinel handled by padding with far-away tiny spheres via `make`.
    """

    sphere_center: jnp.ndarray  # [S, 3]
    sphere_radius: jnp.ndarray  # [S]
    box_center: jnp.ndarray     # [X, 3]
    box_half: jnp.ndarray       # [X, 3]

    @staticmethod
    def make(spheres=(), boxes=()) -> "AnalyticWorld":
        """spheres: iterable of (center xyz, radius); boxes: (center, half-extents)."""
        f32 = jnp.float32
        # materialize first: a generator input would be exhausted by the
        # first comprehension below (silently obstacle-free world), and
        # array inputs make bare truthiness ambiguous
        spheres, boxes = list(spheres), list(boxes)
        if spheres:
            sc = jnp.asarray([s[0] for s in spheres], f32)
            sr = jnp.asarray([s[1] for s in spheres], f32)
        else:
            sc, sr = jnp.zeros((0, 3), f32), jnp.zeros((0,), f32)
        if boxes:
            bc = jnp.asarray([b[0] for b in boxes], f32)
            bh = jnp.asarray([b[1] for b in boxes], f32)
        else:
            bc, bh = jnp.zeros((0, 3), f32), jnp.zeros((0, 3), f32)
        return AnalyticWorld(sc, sr, bc, bh)


@struct.dataclass
class GridSDF:
    """Dense voxel signed-distance grid (world/edt.py builds these).

    `packed` is an optional [X*Y*Z, 8] corner table: row i stores the 8 cell
    corners G[x+dx, y+dy, z+dz] of flat cell i, so one trilinear sample is a
    SINGLE row gather instead of eight scalar gathers, at an 8x grid-memory
    cost. Built once on host (`GridSDF.make`); pass packed=None to trade the
    gather count back for memory.
    """

    grid: jnp.ndarray        # [X, Y, Z] float32 signed distance (meters)
    origin: jnp.ndarray      # [3] world position of voxel (0,0,0) center
    resolution: jnp.ndarray  # scalar meters/voxel
    packed: jnp.ndarray | None = None  # [X*Y*Z, 8] corner table (see above)

    @staticmethod
    def make(grid, origin, resolution, pack: bool = True) -> "GridSDF":
        """Build from a [X,Y,Z] array, precomputing the packed corner table."""
        import numpy as np

        g = np.asarray(grid, np.float32)
        packed = None
        if pack:
            X, Y, Z = g.shape
            p = np.empty((X, Y, Z, 8), np.float32)
            k = 0
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        # roll wraps at the far edges, but sample cells are
                        # clipped to [0, dim-2] so wrapped rows are never read
                        p[:, :, :, k] = np.roll(g, (-dx, -dy, -dz), (0, 1, 2))
                        k += 1
            packed = jnp.asarray(p.reshape(-1, 8))
        return GridSDF(grid=jnp.asarray(g),
                       origin=jnp.asarray(origin, jnp.float32),
                       resolution=jnp.asarray(resolution, jnp.float32),
                       packed=packed)


@struct.dataclass
class CompositeWorld:
    """A static voxel grid plus a dynamic analytic overlay, min-composed.

    Reference equivalent: ``distance_field::PropagationDistanceField``'s
    *incremental* updates — the reference re-propagates distances from
    changed obstacle cells so a grid world can change between queries
    (SURVEY §3.2). This design splits the world by rate of
    change instead: geometry that changes per control tick (MPC moving
    obstacles, BASELINE config 5) lives in the analytic `overlay` whose
    update is a pytree replace (zero rebuild, zero transfer), while the
    static scene stays in the precomputed `grid`. The composed SDF is
    min(grid, overlay) — exact for unions. Slow structural edits to the
    grid itself go through world/edt.IncrementalSDF (host-side bounded
    re-propagation, the direct PropagationDistanceField analogue).
    """

    grid: GridSDF
    overlay: AnalyticWorld

    @staticmethod
    def make(grid: GridSDF, spheres=(), boxes=()) -> "CompositeWorld":
        return CompositeWorld(grid=grid,
                              overlay=AnalyticWorld.make(spheres, boxes))


_BIG = 1e6


def safe_norm(x: jnp.ndarray, axis=-1) -> jnp.ndarray:
    """‖x‖ with a well-defined reverse-mode gradient (0) at x = 0.

    Forward values are bit-identical to ``jnp.linalg.norm`` (the `where`
    pair only reroutes the backward pass); needed because `jax.grad`
    through sqrt(0) is NaN and the exact-CHOMP gradient path
    (engine/chomp.exact_obstacle_gradient) differentiates through points
    *inside* boxes (max(q,0) = 0) and through stationary bodies (ẋ = 0).
    """
    sq = jnp.sum(x * x, axis=axis)
    pos = sq > 0.0
    # else-branch is sq*0, not 0: NaN inputs must stay NaN (the MPC failure
    # detector identifies dead shards by NaN propagation, engine/mpc.py)
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, sq, 1.0)), sq * 0.0)


def _analytic_sdf(world: AnalyticWorld, p: jnp.ndarray) -> jnp.ndarray:
    """p: [..., 3] -> signed distance [...]."""
    d = jnp.full(p.shape[:-1], _BIG, p.dtype)
    if world.sphere_radius.shape[0]:
        rel = p[..., None, :] - world.sphere_center          # [..., S, 3]
        ds = safe_norm(rel) - world.sphere_radius
        d = jnp.minimum(d, ds.min(axis=-1))
    if world.box_half.shape[0]:
        q = jnp.abs(p[..., None, :] - world.box_center) - world.box_half
        outside = safe_norm(jnp.maximum(q, 0.0))
        inside = jnp.minimum(q.max(axis=-1), 0.0)
        d = jnp.minimum(d, (outside + inside).min(axis=-1))
    return d


def _grid_sample(world: GridSDF, p: jnp.ndarray):
    """Trilinear sample + analytic gradient. p: [..., 3] -> (d, grad)."""
    g = (p - world.origin) / world.resolution
    shape = jnp.asarray(world.grid.shape, p.dtype)
    g = jnp.clip(g, 0.0, shape - 1.000001)
    i0 = jnp.clip(jnp.floor(g).astype(jnp.int32), 0,
                  jnp.asarray(world.grid.shape, jnp.int32) - 2)
    f = g - i0.astype(p.dtype)                                # [..., 3]

    X, Y, Z = world.grid.shape
    base = (i0[..., 0] * Y + i0[..., 1]) * Z + i0[..., 2]

    if world.packed is not None:
        # one 8-wide row gather per sample instead of eight scalar gathers
        # (class docstring)
        rows = jnp.take(world.packed, base, axis=0)           # [..., 8]
        (c000, c001, c010, c011, c100, c101, c110, c111) = (
            rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3],
            rows[..., 4], rows[..., 5], rows[..., 6], rows[..., 7])
    else:
        flat = world.grid.reshape(-1)

        def corner(dx, dy, dz):
            return jnp.take(flat, base + (dx * Y + dy) * Z + dz)

        c000 = corner(0, 0, 0); c001 = corner(0, 0, 1)
        c010 = corner(0, 1, 0); c011 = corner(0, 1, 1)
        c100 = corner(1, 0, 0); c101 = corner(1, 0, 1)
        c110 = corner(1, 1, 0); c111 = corner(1, 1, 1)

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    # interpolate z, then y, then x; keep intermediates for the gradient
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    d = c0 * (1 - fx) + c1 * fx

    inv_res = 1.0 / world.resolution
    gx = (c1 - c0) * inv_res
    gy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx) * inv_res
    gz = (((c001 - c000) * (1 - fy) + (c011 - c010) * fy) * (1 - fx)
          + ((c101 - c100) * (1 - fy) + (c111 - c110) * fy) * fx) * inv_res
    return d, jnp.stack([gx, gy, gz], axis=-1)


def _analytic_sdf_grad(world: AnalyticWorld, p: jnp.ndarray):
    """(distance, exact gradient) of the min-composed primitive SDF.

    Closed forms (one pass, no extra SDF evaluations — the CHOMP/HMC hot
    path calls this per sphere per waypoint):
      sphere: ∇d = rel / ‖rel‖;
      box outside: ∇d = (max(q,0) ⊙ sign(rel)) / ‖max(q,0)‖;
      box inside:  unit step toward the nearest face (argmax_i q_i).
    The union takes the argmin primitive's gradient (the SDF's true gradient
    everywhere except on the measure-zero equidistant set).
    """
    tiny = 1e-12
    dists, grads = [], []
    if world.sphere_radius.shape[0]:
        rel = p[..., None, :] - world.sphere_center          # [..., S, 3]
        norm = jnp.linalg.norm(rel, axis=-1)                 # [..., S]
        dists.append(norm - world.sphere_radius)
        grads.append(rel / (norm + tiny)[..., None])
    if world.box_half.shape[0]:
        rel = p[..., None, :] - world.box_center             # [..., X, 3]
        q = jnp.abs(rel) - world.box_half
        qp = jnp.maximum(q, 0.0)
        outside = jnp.linalg.norm(qp, axis=-1)               # [..., X]
        inside = jnp.minimum(q.max(axis=-1), 0.0)
        dists.append(outside + inside)
        sign = jnp.sign(rel)
        g_out = qp * sign / (outside + tiny)[..., None]
        # inside: move along the axis of the least-deep face (max q_i)
        face = (q == q.max(axis=-1, keepdims=True)).astype(p.dtype)
        face = face / jnp.maximum(face.sum(axis=-1, keepdims=True), 1.0)
        g_in = face * sign
        grads.append(jnp.where((outside > 0.0)[..., None], g_out, g_in))
    if not dists:
        return (jnp.full(p.shape[:-1], _BIG, p.dtype),
                jnp.zeros_like(p))
    d_all = jnp.concatenate(dists, axis=-1)                  # [..., P]
    g_all = jnp.concatenate(grads, axis=-2)                  # [..., P, 3]
    idx = jnp.argmin(d_all, axis=-1)
    d = jnp.take_along_axis(d_all, idx[..., None], axis=-1)[..., 0]
    g = jnp.take_along_axis(g_all, idx[..., None, None], axis=-2)[..., 0, :]
    return d, g


def sdf(world, p: jnp.ndarray) -> jnp.ndarray:
    """Signed distance at world points p [..., 3] (any world kind)."""
    if isinstance(world, GridSDF):
        return _grid_sample(world, p)[0]
    if isinstance(world, CompositeWorld):
        return jnp.minimum(_grid_sample(world.grid, p)[0],
                           _analytic_sdf(world.overlay, p))
    return _analytic_sdf(world, p)


def sdf_grad(world, p: jnp.ndarray):
    """(distance, gradient) at world points p [..., 3].

    Reference: StompCollisionSpace::getDistanceGradient (SURVEY §2 L1).
    """
    if isinstance(world, GridSDF):
        return _grid_sample(world, p)
    if isinstance(world, CompositeWorld):
        dg, gg = _grid_sample(world.grid, p)
        da, ga = _analytic_sdf_grad(world.overlay, p)
        take_grid = (dg <= da)[..., None]
        return jnp.minimum(dg, da), jnp.where(take_grid, gg, ga)
    return _analytic_sdf_grad(world, p)
