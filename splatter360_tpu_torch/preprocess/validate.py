"""Cross-view RGB-D consistency of a generated scene.

Counterpart of splatter360_tpu/preprocess/validate.py, a copy of its numpy
code over the port's data/scene_io.load_scene. The reference validates its
generated data by the epipolar geometry between frames; for RGB-D
panoramas the invariant every consumer of a scene depends on is that
lifting frame i's pixels to world points with its depth and pose and
reprojecting them into frame j lands on pixels of matching colour and
matching depth, except where occlusion intervenes. check_scene_consistency
measures that over sampled frame pairs; the preprocess CLI's --validate
gates generation on it.
"""

from __future__ import annotations

import numpy as np


def _spherical_project(pts: np.ndarray, h: int, w: int):
    """World->ERP pixel coords + radial distance for the hm3d convention
    (geometry/erp.py: theta = atan2(x, z), phi = asin(y / r))."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = np.sqrt(x * x + y * y + z * z)
    theta = np.arctan2(x, z)
    phi = np.arcsin(np.clip(y / np.maximum(r, 1e-9), -1.0, 1.0))
    u = (0.5 - theta / (2 * np.pi)) * w - 0.5
    v = (0.5 - phi / np.pi) * h - 0.5
    return u % w, v, r


def check_pair_consistency(
    rgb_i, depth_i, pose_i, rgb_j, depth_j, pose_j,
    stride: int = 4, occlusion_tol: float = 0.05,
):
    """Reproject frame i into frame j; return masked color/depth errors.

    rgb [H, W, 3] float in [0,1]; depth [H, W] meters (0 = hole);
    pose [4, 4] c2w. Returns dict(color_mae, depth_absrel, coverage).
    """
    h, w = depth_i.shape
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    d = depth_i[ys, xs]
    valid = d > 1e-3

    # ERP ray directions (hm3d convention, inverse of _spherical_project)
    theta = (0.5 - (xs + 0.5) / w) * 2 * np.pi
    phi = -((ys + 0.5) / h - 0.5) * np.pi
    dirs = np.stack(
        [np.cos(phi) * np.sin(theta), np.sin(phi),
         np.cos(phi) * np.cos(theta)], axis=-1,
    )
    pts_w = (pose_i[:3, :3] @ (dirs * d[..., None]).reshape(-1, 3).T).T \
        + pose_i[:3, 3]

    w2c_j = np.linalg.inv(pose_j)
    pts_j = (w2c_j[:3, :3] @ pts_w.T).T + w2c_j[:3, 3]
    u, v, r = _spherical_project(pts_j, h, w)

    ui = np.clip(np.round(u).astype(int), 0, w - 1)
    vi = np.clip(np.round(v).astype(int), 0, h - 1)
    d_j = depth_j[vi, ui]
    # occluded where frame j sees something closer than the reprojected point
    vis = (
        valid.reshape(-1)
        & (d_j > 1e-3)
        & (np.abs(d_j - r) / np.maximum(r, 1e-6) < occlusion_tol)
    )
    if vis.sum() == 0:
        return {"color_mae": np.nan, "depth_absrel": np.nan, "coverage": 0.0}
    c_i = rgb_i[ys, xs].reshape(-1, 3)[vis]
    c_j = rgb_j[vi, ui][vis]
    return {
        "color_mae": float(np.abs(c_i - c_j).mean()),
        "depth_absrel": float(
            (np.abs(d_j - r) / np.maximum(r, 1e-6))[vis].mean()
        ),
        "coverage": float(vis.mean()),
    }


def check_scene_consistency(
    root, split: str, scene: str, n_pairs: int = 6, max_gap: int = 4,
    seed: int = 0,
):
    """Sample frame pairs from a stored scene and aggregate pair stats.

    Healthy generated data: color_mae < ~0.05 (visible-surface recolor noise),
    depth_absrel << occlusion_tol, coverage well above 0 for small gaps."""
    from ..data.scene_io import load_scene

    data = load_scene(root, split, scene)
    rgb = data["rgb"].astype(np.float32) / 255.0
    depth = data["depth_m"]
    poses = data["poses"]
    n = poses.shape[0]
    rng = np.random.default_rng(seed)
    stats = []
    for _ in range(n_pairs):
        i = int(rng.integers(0, n - 1))
        j = int(rng.integers(i + 1, min(i + 1 + max_gap, n)))
        stats.append(
            check_pair_consistency(
                rgb[i], depth[i], poses[i], rgb[j], depth[j], poses[j]
            )
        )
    agg = {
        k: float(np.nanmean([s[k] for s in stats]))
        for k in ("color_mae", "depth_absrel", "coverage")
    }
    agg["n_pairs"] = n_pairs
    return agg
