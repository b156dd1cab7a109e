"""Occupancy-grid → analytic-box decomposition (voxel worlds without gathers).

Why this exists: the voxel-SDF query is the one memory-irregular op in the
hot loop (SURVEY §8.3 hard part 1) — one table gather per (body, candidate,
waypoint) sample. For a STATIC occupancy there is another way: decompose it
into maximal axis-aligned boxes and evaluate them as analytic primitives
(~15 flops per box per sample, no gather). A voxelized tabletop is exactly
2 boxes; typical collision-map scenes decompose to tens–hundreds. Which of
the two is faster on a given device and scene is a measurement
(ROADMAP S5), not a rule.

Reference equivalent: none — the reference always queries the voxel
`distance_field` (SURVEY §3.2). This is a world *compilation* step this
design adds; `world/sdf.GridSDF` remains the exact-parity path.

Accuracy contract (document before swapping worlds):
  - Boxes span the HULL OF VOXEL CENTERS (half-extent (n−1)/2·res), matching
    `signed_edt`'s voxel-center seed convention: outside the solid the
    box-union SDF equals the distance to the nearest occupied voxel center
    on faces/corners and undershoots by at most O(res²/d) between lattice
    points. Pass `inflate=res/2` for the voxel-extent interpretation
    (conservative by half a voxel).
  - INSIDE the solid the union-min of per-box signed distances reports the
    distance to the nearest box face, which may be an interior seam —
    shallower than the true EDT. Collision checking is unaffected (inside
    is inside); the obstacle potential's linear zone sees a slightly
    smaller magnitude for deeply-penetrating states.
"""

from __future__ import annotations

import numpy as np

from tpustomp.world.sdf import AnalyticWorld


def boxes_from_occupancy(occ: np.ndarray) -> list[tuple]:
    """Greedy maximal-cuboid cover of a boolean occupancy grid.

    Returns a list of ((x0, y0, z0), (x1, y1, z1)) inclusive voxel-index
    ranges whose union covers exactly the occupied set (boxes are disjoint).
    Greedy growth order x→y→z from the lexicographically first uncovered
    voxel; O(V) per box, exact cover by construction.
    """
    occ = np.asarray(occ, bool)
    uncovered = occ.copy()
    boxes = []
    X, Y, Z = occ.shape
    while True:
        idx = np.argwhere(uncovered)
        if idx.size == 0:
            break
        x0, y0, z0 = idx[0]
        # grow +x while the voxel run stays occupied & uncovered
        x1 = x0
        while x1 + 1 < X and uncovered[x1 + 1, y0, z0]:
            x1 += 1
        # grow +y while the whole x-run stays occupied & uncovered
        y1 = y0
        while y1 + 1 < Y and uncovered[x0:x1 + 1, y1 + 1, z0].all():
            y1 += 1
        # grow +z while the whole x-y slab stays occupied & uncovered
        z1 = z0
        while z1 + 1 < Z and uncovered[x0:x1 + 1, y0:y1 + 1, z1 + 1].all():
            z1 += 1
        uncovered[x0:x1 + 1, y0:y1 + 1, z0:z1 + 1] = False
        boxes.append(((int(x0), int(y0), int(z0)),
                      (int(x1), int(y1), int(z1))))
    return boxes


def analytic_from_occupancy(occ: np.ndarray, resolution: float, origin,
                            inflate: float = 0.0,
                            max_boxes: int | None = None) -> AnalyticWorld:
    """Compile an occupancy grid into an AnalyticWorld of boxes.

    The boxes cover the voxel-CENTER hull of each cuboid (see module
    docstring for the accuracy contract); `inflate` grows every half-extent
    (e.g. res/2 for the voxel-extent interpretation). Raises if the
    decomposition exceeds `max_boxes` (when given) — a guard against
    pathological scenes where the fused-primitive path would be slower
    than the grid gather; there is no silent truncation.
    """
    origin = np.asarray(origin, np.float64)
    boxes = boxes_from_occupancy(occ)
    if max_boxes is not None and len(boxes) > max_boxes:
        raise ValueError(
            f"occupancy decomposes into {len(boxes)} boxes > max_boxes="
            f"{max_boxes}; use the GridSDF path for this scene")
    specs = []
    for (x0, y0, z0), (x1, y1, z1) in boxes:
        lo = origin + resolution * np.asarray([x0, y0, z0], np.float64)
        hi = origin + resolution * np.asarray([x1, y1, z1], np.float64)
        center = (lo + hi) / 2.0
        half = (hi - lo) / 2.0 + inflate
        specs.append((tuple(center), tuple(half)))
    return AnalyticWorld.make(boxes=specs)
