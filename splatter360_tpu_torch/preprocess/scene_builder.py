"""Procedural indoor worlds as dense Gaussian surfaces.

Counterpart of splatter360_tpu/preprocess/scene_builder.py, a copy of its
numpy code (the same np.random.RandomState draws in the same order, so a
seed gives the same world bit for bit). It plays the role of the scan
assets of the reference's Habitat data generator: a closed room with
textured walls, floor and ceiling plus box "furniture", as a lattice of thin
surface-aligned Gaussians the renderer draws, and the occupancy the
trajectory sampler needs (room bounds and furniture boxes), in the role of
Habitat's navmesh. Host numpy, once a scene.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RoomWorld(NamedTuple):
    # Gaussian surface soup (renderer inputs)
    means: np.ndarray        # [N, 3] float32
    covariances: np.ndarray  # [N, 3, 3] float32
    harmonics: np.ndarray    # [N, 3, d_sh] float32
    opacities: np.ndarray    # [N] float32
    # Navigation info (trajectory sampler inputs). y is UP in world space
    # (OpenCV camera convention: the dataset poses are c2w with +y down in
    # camera frame; world axes here use y-up and poses flip as needed).
    bounds_min: np.ndarray   # [3] room interior min corner
    bounds_max: np.ndarray   # [3] room interior max corner
    boxes: np.ndarray        # [K, 2, 3] furniture AABBs (min, max)


def _surface_grid(rng, p0, ex, ey, nx, ny, base_rgb, spacing, normal,
                  sh_degree, texture_freq=2.0):
    """A nx*ny lattice of thin Gaussians tiling the parallelogram p0 + u*ex + v*ey.

    Texture = base albedo modulated by low-frequency sin/cos fields (so LPIPS
    and the cost volume have gradients to latch onto, like real scan textures).
    """
    u = (np.arange(nx) + 0.5) / nx
    v = (np.arange(ny) + 0.5) / ny
    uu, vv = np.meshgrid(u, v, indexing="ij")
    pts = (
        p0[None, None]
        + uu[..., None] * ex[None, None]
        + vv[..., None] * ey[None, None]
    ).reshape(-1, 3)
    n = pts.shape[0]

    # tangent-aligned covariance: sigma = spacing*0.6 in-plane, thin out-of-plane
    t1 = ex / (np.linalg.norm(ex) + 1e-9)
    nrm = normal / (np.linalg.norm(normal) + 1e-9)
    t2 = np.cross(nrm, t1)
    rot = np.stack([t1, t2, nrm], axis=-1)  # columns = principal axes
    s_in = 0.62 * spacing
    s_out = 0.06 * spacing
    scale = np.diag([s_in**2, s_in**2, s_out**2])
    cov = rot @ scale @ rot.T
    covs = np.broadcast_to(cov, (n, 3, 3)).astype(np.float32)

    phase = rng.uniform(0, 2 * np.pi, size=(2, 3))
    freq = texture_freq * rng.uniform(0.6, 1.6, size=(2, 3))
    tex = 0.5 * (
        np.sin(freq[0][None] * uu.reshape(-1, 1) * 2 * np.pi + phase[0][None])
        + np.cos(freq[1][None] * vv.reshape(-1, 1) * 2 * np.pi + phase[1][None])
    )
    albedo = np.clip(base_rgb[None] * (1.0 + 0.25 * tex), 0.02, 0.98)

    d_sh = (sh_degree + 1) ** 2
    sh = np.zeros((n, 3, d_sh), np.float32)
    _SH_C0 = 0.28209479177387814
    sh[:, :, 0] = (albedo - 0.5) / _SH_C0
    if d_sh > 1:
        sh[:, :, 1:] = rng.normal(0, 0.02, size=(n, 3, d_sh - 1))

    opac = rng.uniform(0.93, 0.995, size=n).astype(np.float32)
    return pts.astype(np.float32), covs, sh, opac


def _box_surfaces(rng, bmin, bmax, spacing, base_rgb, sh_degree, skip_bottom=True):
    """The 6 (or 5) faces of an AABB as surface grids, normals pointing outward."""
    out = []
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    faces = [
        # (origin, ex, ey, normal)
        ((x0, y0, z0), (x1 - x0, 0, 0), (0, y1 - y0, 0), (0, 0, -1)),  # back
        ((x0, y0, z1), (x1 - x0, 0, 0), (0, y1 - y0, 0), (0, 0, 1)),   # front
        ((x0, y0, z0), (0, 0, z1 - z0), (0, y1 - y0, 0), (-1, 0, 0)),  # left
        ((x1, y0, z0), (0, 0, z1 - z0), (0, y1 - y0, 0), (1, 0, 0)),   # right
        ((x0, y1, z0), (x1 - x0, 0, 0), (0, 0, z1 - z0), (0, 1, 0)),   # top
    ]
    if not skip_bottom:
        faces.append(((x0, y0, z0), (x1 - x0, 0, 0), (0, 0, z1 - z0), (0, -1, 0)))
    for origin, ex, ey, nrm in faces:
        ex = np.asarray(ex, np.float64)
        ey = np.asarray(ey, np.float64)
        lx, ly = np.linalg.norm(ex), np.linalg.norm(ey)
        if lx < 1e-6 or ly < 1e-6:
            continue
        nx = max(int(round(lx / spacing)), 2)
        ny = max(int(round(ly / spacing)), 2)
        col = np.clip(base_rgb + rng.uniform(-0.08, 0.08, 3), 0.05, 0.95)
        out.append(
            _surface_grid(rng, np.asarray(origin, np.float64), ex, ey, nx, ny,
                          col, spacing, np.asarray(nrm, np.float64), sh_degree)
        )
    return out


def build_room_world(
    seed: int = 0,
    room_size=(5.0, 2.8, 7.0),
    n_furniture: int = 4,
    spacing: float = 0.09,
    sh_degree: int = 2,
    n_panels: int = 0,
    scale_jitter: float = 1.0,
) -> RoomWorld:
    """Build a closed textured room (x-width, y-height, z-depth) with furniture.

    Gaussian count scales as (surface area) / spacing^2: the defaults give
    ~19-25k. Use a coarser spacing for CPU tests.

    n_panels > 0 adds content that only stereo can place: thin textured
    rectangles floating at random positions/orientations/depths inside the
    room. Their texture is drawn from the same family as the walls, so
    APPEARANCE CARRIES NO DEPTH CUE: a monocular prior cannot place them
    (unlike walls/furniture, whose depth is predictable from room context),
    while two posed views can triangulate them. scale_jitter > 1 additionally widens the room-size
    randomization (monocular metric scale relies on a stable room prior).
    """
    rng = np.random.RandomState(seed)
    lo, hi = 0.8 / scale_jitter, 1.3 * scale_jitter
    w, h, d = (
        room_size[0] * rng.uniform(lo, hi),
        room_size[1] * rng.uniform(0.9, 1.15),
        room_size[2] * rng.uniform(lo, hi),
    )
    half = np.array([w / 2, 0.0, d / 2])
    bmin = np.array([-w / 2, 0.0, -d / 2])
    bmax = np.array([w / 2, h, d / 2])

    parts = []
    # floor (normal +y), ceiling (normal -y), 4 walls (inward normals)
    floor_rgb = rng.uniform(0.25, 0.6, 3)
    ceil_rgb = np.clip(rng.uniform(0.7, 0.9, 3), 0, 1)
    parts.append(_surface_grid(
        rng, bmin, np.array([w, 0, 0.0]), np.array([0, 0.0, d]),
        max(int(w / spacing), 2), max(int(d / spacing), 2),
        floor_rgb, spacing, np.array([0, 1.0, 0]), sh_degree))
    parts.append(_surface_grid(
        rng, np.array([-w / 2, h, -d / 2]), np.array([w, 0, 0.0]),
        np.array([0, 0.0, d]), max(int(w / spacing), 2),
        max(int(d / spacing), 2), ceil_rgb, spacing,
        np.array([0, -1.0, 0]), sh_degree))
    wall_rgb = rng.uniform(0.35, 0.85, 3)
    for origin, ex, nrm in [
        (bmin, np.array([w, 0, 0.0]), np.array([0, 0, 1.0])),
        (np.array([-w / 2, 0, d / 2]), np.array([w, 0, 0.0]), np.array([0, 0, -1.0])),
        (bmin, np.array([0, 0.0, d]), np.array([1.0, 0, 0])),
        (np.array([w / 2, 0, -d / 2]), np.array([0, 0.0, d]), np.array([-1.0, 0, 0])),
    ]:
        col = np.clip(wall_rgb + rng.uniform(-0.1, 0.1, 3), 0.05, 0.95)
        parts.append(_surface_grid(
            rng, origin, ex, np.array([0.0, h, 0.0]),
            max(int(np.linalg.norm(ex) / spacing), 2),
            max(int(h / spacing), 2), col, spacing, nrm, sh_degree))

    # furniture boxes on the floor, kept off the room border
    boxes = []
    for _ in range(n_furniture):
        size = rng.uniform([0.4, 0.3, 0.4], [1.2, 1.1, 1.2])
        margin = size[[0, 2]] / 2 + 0.45
        cx = rng.uniform(-w / 2 + margin[0], w / 2 - margin[0])
        cz = rng.uniform(-d / 2 + margin[1], d / 2 - margin[1])
        fmin = np.array([cx - size[0] / 2, 0.0, cz - size[2] / 2])
        fmax = np.array([cx + size[0] / 2, size[1], cz + size[2] / 2])
        boxes.append(np.stack([fmin, fmax]))
        col = rng.uniform(0.15, 0.9, 3)
        parts.extend(_box_surfaces(rng, fmin, fmax, spacing, col, sh_degree))

    # floating panels (stereo-hard content; see docstring). Kept above
    # furniture height and off the walls; orientation is a random rotation
    # about y plus a random tilt, texture from the wall palette.
    for _ in range(n_panels):
        pw = rng.uniform(0.5, 1.4)
        ph = rng.uniform(0.4, 1.0)
        cy = rng.uniform(1.2, h - 0.3)
        cx = rng.uniform(-w / 2 + 0.8, w / 2 - 0.8)
        cz = rng.uniform(-d / 2 + 0.8, d / 2 - 0.8)
        yaw = rng.uniform(0, 2 * np.pi)
        tilt = rng.uniform(-0.4, 0.4)
        ex = np.array([np.cos(yaw), 0.0, np.sin(yaw)]) * pw
        ey_dir = np.array(
            [-np.sin(yaw) * np.sin(tilt), np.cos(tilt),
             np.cos(yaw) * np.sin(tilt)]
        )
        ey = ey_dir * ph
        nrm = np.cross(ex / pw, ey_dir)
        origin = np.array([cx, cy, cz]) - ex / 2 - ey / 2
        col = np.clip(wall_rgb + rng.uniform(-0.1, 0.1, 3), 0.05, 0.95)
        parts.append(_surface_grid(
            rng, origin, ex, ey, max(int(pw / spacing), 2),
            max(int(ph / spacing), 2), col, spacing, nrm, sh_degree))

    means = np.concatenate([p[0] for p in parts])
    covs = np.concatenate([p[1] for p in parts])
    sh = np.concatenate([p[2] for p in parts])
    opac = np.concatenate([p[3] for p in parts])
    boxes_arr = (
        np.stack(boxes).astype(np.float32)
        if boxes else np.zeros((0, 2, 3), np.float32)
    )
    return RoomWorld(
        means=means, covariances=covs, harmonics=sh, opacities=opac,
        bounds_min=(bmin + np.array([0.25, 0.0, 0.25])).astype(np.float32),
        bounds_max=(bmax - np.array([0.25, 0.0, 0.25])).astype(np.float32),
        boxes=boxes_arr,
    )
