"""Navigable camera trajectories through a RoomWorld.

Counterpart of splatter360_tpu/preprocess/trajectory.py, a copy of its
numpy code (poses bit-equal for a seed): a free-space start and goal at a
minimum separation, a collision-free path by BFS over a 2D occupancy grid
(the navmesh's stand-in), Chaikin-smoothed and resampled by arc length, at
camera height, with yaw following the path's tangent and a slight pitch
wander. Poses are OpenCV-convention c2w (x right, y down in the camera, z
forward) in the y-up world of scene_builder, the convention of the ERP
geometry (geometry/erp.py).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from .scene_builder import RoomWorld


def _occupancy_grid(world: RoomWorld, res: float, inflate: float):
    """2D (x, z) occupancy: True = blocked. Returns (grid, x0, z0, res)."""
    x0, z0 = world.bounds_min[0], world.bounds_min[2]
    x1, z1 = world.bounds_max[0], world.bounds_max[2]
    nx = max(int(np.ceil((x1 - x0) / res)), 1)
    nz = max(int(np.ceil((z1 - z0) / res)), 1)
    grid = np.zeros((nx, nz), bool)
    xs = x0 + (np.arange(nx) + 0.5) * res
    zs = z0 + (np.arange(nz) + 0.5) * res
    for bmin, bmax in world.boxes:
        bx = (xs >= bmin[0] - inflate) & (xs <= bmax[0] + inflate)
        bz = (zs >= bmin[2] - inflate) & (zs <= bmax[2] + inflate)
        grid |= bx[:, None] & bz[None, :]
    return grid, x0, z0, res


def _bfs_path(grid, start, goal):
    """Shortest 4-connected path start->goal over free cells, or None."""
    nx, nz = grid.shape
    prev = -np.ones((nx, nz, 2), np.int32)
    seen = np.zeros((nx, nz), bool)
    q = deque([start])
    seen[start] = True
    while q:
        c = q.popleft()
        if c == goal:
            path = [c]
            while path[-1] != start:
                p = tuple(prev[path[-1]])
                path.append(p)
            return path[::-1]
        for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            n = (c[0] + dx, c[1] + dz)
            if (0 <= n[0] < nx and 0 <= n[1] < nz and not seen[n]
                    and not grid[n]):
                seen[n] = True
                prev[n] = c
                q.append(n)
    return None


def _smooth_polyline(pts: np.ndarray, iters: int = 2) -> np.ndarray:
    """Chaikin corner cutting (keeps endpoints)."""
    for _ in range(iters):
        if len(pts) < 3:
            break
        q = 0.75 * pts[:-1] + 0.25 * pts[1:]
        r = 0.25 * pts[:-1] + 0.75 * pts[1:]
        pts = np.concatenate([pts[:1], np.stack([q, r], 1).reshape(-1, 3)[1:-1],
                              pts[-1:]])
    return pts


def _resample_arclength(pts: np.ndarray, n: int) -> np.ndarray:
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=-1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    t = np.linspace(0.0, s[-1], n)
    out = np.empty((n, 3))
    for d in range(3):
        out[:, d] = np.interp(t, s, pts[:, d])
    return out


def _yaw_pitch_to_c2w(pos, yaw, pitch):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    # camera forward in the y-up world for ERP convention theta=yaw, phi=pitch
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    c2w = np.eye(4)
    c2w[:3, :3] = ry @ rx
    c2w[:3, 3] = pos
    return c2w


def sample_trajectory(
    world: RoomWorld,
    n_frames: int,
    seed: int = 0,
    min_path_len: float = 1.5,
    cam_height: float = 1.2,
    grid_res: float = 0.15,
    inflate: float = 0.3,
    max_tries: int = 50,
) -> np.ndarray:
    """[n_frames, 4, 4] float32 c2w poses along a collision-free indoor path."""
    rng = np.random.RandomState(seed)
    grid, x0, z0, res = _occupancy_grid(world, grid_res, inflate)
    free = np.argwhere(~grid)
    if free.size == 0:
        raise ValueError("no free space in world")

    path_w = None
    for _ in range(max_tries):
        a, b = free[rng.randint(len(free))], free[rng.randint(len(free))]
        dist = np.linalg.norm((a - b).astype(np.float64)) * res
        if dist < min_path_len:
            continue
        cells = _bfs_path(grid, tuple(a), tuple(b))
        if cells is None:
            continue
        pts = np.array(
            [[x0 + (c[0] + 0.5) * res, 0.0, z0 + (c[1] + 0.5) * res]
             for c in cells]
        )
        if np.linalg.norm(np.diff(pts, axis=0), axis=-1).sum() >= min_path_len:
            path_w = pts
            break
    if path_w is None:
        raise ValueError("could not sample a path; loosen min_path_len")

    path_w = _smooth_polyline(path_w)
    centers = _resample_arclength(path_w, n_frames)
    height = min(cam_height, float(world.bounds_max[1]) - 0.3)
    centers[:, 1] = height

    # yaw follows the path tangent, low-pass filtered; slight pitch wander
    tang = np.gradient(centers, axis=0)
    yaw_raw = np.arctan2(tang[:, 0], tang[:, 2])
    yaw = np.unwrap(yaw_raw)
    for _ in range(3):
        yaw[1:-1] = 0.5 * yaw[1:-1] + 0.25 * (yaw[:-2] + yaw[2:])
    yaw = yaw + rng.uniform(-0.15, 0.15)
    pitch = 0.06 * np.sin(
        np.linspace(0, 2 * np.pi, n_frames) + rng.uniform(0, 2 * np.pi)
    )
    poses = np.stack(
        [_yaw_pitch_to_c2w(centers[i], yaw[i], pitch[i])
         for i in range(n_frames)]
    )
    return poses.astype(np.float32)
