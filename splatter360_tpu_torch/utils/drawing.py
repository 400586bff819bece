"""Vector drawing and 3D-validation figures.

Counterpart of splatter360_tpu/utils/drawing.py, a copy of its numpy code
(images equal bit for bit below the panel banners, which the port's
utils/image_io.add_label draws in its own font). After the reference's
src/visualization/drawing/ and validation_in_3d.py:
  * draw_lines / draw_points: antialiased segments and discs;
  * draw_cameras: camera frusta with near/far planes on the three
    axis-aligned projections;
  * render_projections: orthographic renders of the Gaussians down each
    world axis, through ops/rasterizer_ref.render_dense on the Gaussians'
    device (the card unless they, or `device`, say otherwise);
  * render_cameras: the context (white) and target (red) cameras of a batch.

Coverage is analytic, not the reference's recursive MSAA subdivision: each
primitive is a signed-distance field and a pixel's alpha is a 1-px linear
ramp of its centre distance, clip(halfwidth + 0.5 - d, 0, 1), one
vectorised numpy pass. Images are [h, w, 3] float in [0, 1].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .image_io import add_label


def _sanitize_vec(x, dim: int, n: Optional[int] = None) -> np.ndarray:
    x = np.asarray(x, np.float32)
    if x.ndim == 0:
        x = np.full((1, dim), float(x), np.float32)
    if x.ndim == 1:
        x = x[None] if x.shape[0] == dim else x[:, None].repeat(dim, 1)
    if n is not None and x.shape[0] == 1:
        x = np.broadcast_to(x, (n, dim))
    return x.astype(np.float32)


def _world_to_pixel(shape, x_range, y_range):
    """Map world xy -> pixel xy, preserving aspect.

    Deliberate departure from the reference: generate_conversions
    (drawing/coordinate_conversion.py:34-37) stretches x and y independently,
    so non-square ranges distort shapes. Here the world range is fit inside
    the image with ONE scale and centered along the looser axis, so circles
    stay circles. Identical whenever x_range/y_range spans match the image
    aspect (always true for draw_cameras, whose ranges are square)."""
    h, w = shape
    if x_range is None:
        x_range = (0.0, float(w))
    if y_range is None:
        y_range = (0.0, float(h))
    x0, x1 = (float(v) for v in x_range)
    y0, y1 = (float(v) for v in y_range)
    sx = w / max(x1 - x0, 1e-9)
    sy = h / max(y1 - y0, 1e-9)
    s = min(sx, sy)
    ox = 0.5 * (w - s * (x1 - x0))
    oy = 0.5 * (h - s * (y1 - y0))

    def conv(p):
        p = np.asarray(p, np.float32)
        out = np.empty_like(p)
        out[..., 0] = (p[..., 0] - x0) * s + ox
        out[..., 1] = (p[..., 1] - y0) * s + oy
        return out

    return conv


def _composite(image: np.ndarray, dist: np.ndarray, colors: np.ndarray,
               halfwidth: np.ndarray) -> np.ndarray:
    """Alpha-composite per-primitive SDFs onto the image.

    dist [P, h, w]: distance from each pixel center to primitive p.
    colors [P, 3]; halfwidth [P]. The winning color per pixel is the
    nearest-in-SDF primitive (the reference picks the highest-index covering
    line — drawing/lines.py:73-78; nearest is symmetric and looks identical
    for non-overlapping strokes)."""
    if dist.shape[0] == 0:  # no primitives: image unchanged
        return image
    cover = np.clip(halfwidth[:, None, None] + 0.5 - dist, 0.0, 1.0)  # [P,h,w]
    alpha = cover.max(axis=0)
    winner = (dist - halfwidth[:, None, None]).argmin(axis=0)
    top = colors[winner]  # [h, w, 3]
    return image * (1.0 - alpha[..., None]) + top * alpha[..., None]


def draw_lines(
    image: np.ndarray,
    start,
    end,
    color,
    width=2.0,
    cap: str = "round",
    x_range=None,
    y_range=None,
) -> np.ndarray:
    """Draw antialiased line segments. start/end: [L, 2] world (or pixel) xy."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    start = _sanitize_vec(start, 2)
    end = _sanitize_vec(end, 2)
    color = _sanitize_vec(color, 3)
    width = np.asarray(width, np.float32).reshape(-1)
    # broadcast count spans ALL per-line arguments (reference lines.py:29-34)
    n = max(start.shape[0], end.shape[0], color.shape[0], width.shape[0])
    start = _sanitize_vec(start, 2, n)
    end = _sanitize_vec(end, 2, n)
    color = _sanitize_vec(color, 3, n)
    width = np.broadcast_to(width, (n,))

    conv = _world_to_pixel((h, w), x_range, y_range)
    start, end = conv(start), conv(end)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    px = np.stack([xs + 0.5, ys + 0.5], -1)  # pixel centers [h, w, 2]

    delta = end - start  # [L, 2]
    len2 = np.maximum((delta**2).sum(-1), 1e-12)  # [L]
    rel = px[None] - start[:, None, None]  # [L, h, w, 2]
    t = (rel * delta[:, None, None]).sum(-1) / len2[:, None, None]
    if cap == "round":
        t = np.clip(t, 0.0, 1.0)
    elif cap == "square":
        ext = 0.5 * width / np.sqrt(len2)
        t = np.clip(t, -ext[:, None, None], 1.0 + ext[:, None, None])
    else:  # butt
        t = np.clip(t, 0.0, 1.0)
    closest = start[:, None, None] + t[..., None] * delta[:, None, None]
    dist = np.sqrt(((px[None] - closest) ** 2).sum(-1))  # [L, h, w]
    if cap == "butt":
        # butt caps: cut the ramp past the segment ends
        outside = (t <= 0.0) | (t >= 1.0)
        dist = np.where(outside, np.inf, dist)
    return _composite(image, dist, color, 0.5 * width)


def draw_points(
    image: np.ndarray,
    points,
    color,
    radius=2.0,
    x_range=None,
    y_range=None,
) -> np.ndarray:
    """Draw antialiased discs at [P, 2] world (or pixel) xy."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    points = _sanitize_vec(points, 2)
    n = points.shape[0]
    color = _sanitize_vec(color, 3, n)
    radius = np.broadcast_to(np.asarray(radius, np.float32).reshape(-1), (n,))

    conv = _world_to_pixel((h, w), x_range, y_range)
    points = conv(points)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    px = np.stack([xs + 0.5, ys + 0.5], -1)
    dist = np.sqrt(((px[None] - points[:, None, None]) ** 2).sum(-1))
    return _composite(image, dist, color, radius)


def _unproject_frustum_corners(extrinsics: np.ndarray, intrinsics: np.ndarray,
                               depth) -> np.ndarray:
    """World-space positions of the 4 image corners at z-depth `depth`.

    extrinsics [B, 4, 4] c2w, intrinsics [B, 3, 3] normalized (cx=cy=0.5).
    Returns [B, 4, 3] in circular corner order (reference cameras.py:168-195)."""
    b = extrinsics.shape[0]
    corners = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)  # circle
    depth = np.broadcast_to(np.asarray(depth, np.float32).reshape(-1), (b,))
    kinv = np.linalg.inv(intrinsics.astype(np.float32))  # [B, 3, 3]
    homo = np.concatenate([corners, np.ones((4, 1), np.float32)], -1)  # [4,3]
    dirs = np.einsum("bij,pj->bpi", kinv, homo)
    dirs = dirs / dirs[..., 2:3]  # z-depth scaling, not euclidean
    dirs = np.einsum("bij,bpj->bpi", extrinsics[:, :3, :3], dirs)
    return extrinsics[:, None, :3, 3] + depth[:, None, None] * dirs


def compute_equal_aabb_with_margin(minima, maxima, margin: float = 0.1):
    minima = np.asarray(minima, np.float32)
    maxima = np.asarray(maxima, np.float32)
    mid = 0.5 * (maxima + minima)
    span = (maxima - minima).max(-1, keepdims=True) * (1.0 + margin)
    return mid - 0.5 * span, mid + 0.5 * span


def draw_cameras(
    resolution: int,
    extrinsics: np.ndarray,
    intrinsics: np.ndarray,
    color,
    near=None,
    far=None,
    margin: float = 0.1,
    frustum_scale: float = 0.05,
) -> np.ndarray:
    """Draw camera frusta on the three axis-aligned scene projections.

    Returns [3, resolution, resolution, 3] (XY/YZ/ZX panels, labeled).
    Reference: src/visualization/drawing/cameras.py:14-120."""
    extrinsics = np.asarray(extrinsics, np.float32)
    intrinsics = np.asarray(intrinsics, np.float32)
    b = extrinsics.shape[0]
    color = _sanitize_vec(color, 3, b)

    pts = [extrinsics[:, :3, 3]]
    if near is not None:
        pts.append(_unproject_frustum_corners(
            extrinsics, intrinsics, near).reshape(-1, 3))
    if far is not None:
        pts.append(_unproject_frustum_corners(
            extrinsics, intrinsics, far).reshape(-1, 3))
    allpts = np.concatenate(pts, 0)
    minima, maxima = compute_equal_aabb_with_margin(
        allpts.min(0), allpts.max(0), margin)
    span = float((maxima - minima).max())

    corners = _unproject_frustum_corners(
        extrinsics, intrinsics, span * frustum_scale)
    near_c = (None if near is None else
              _unproject_frustum_corners(extrinsics, intrinsics, near))
    far_c = (None if far is None else
             _unproject_frustum_corners(extrinsics, intrinsics, far))

    panels = []
    for axis in range(3):
        ax_x, ax_y = (axis + 1) % 3, (axis + 2) % 3
        proj = lambda p: np.stack([p[..., ax_x], p[..., ax_y]], -1)  # noqa: E731
        x_range = (minima[ax_x], maxima[ax_x])
        y_range = (minima[ax_y], maxima[ax_y])
        img = np.zeros((resolution, resolution, 3), np.float32)

        gray = np.full((3,), 0.25, np.float32)
        for plane in (near_c, far_c):
            if plane is None:
                continue
            p = proj(plane)  # [B, 4, 2]
            img = draw_lines(img, p.reshape(-1, 2),
                             np.roll(p, 1, axis=1).reshape(-1, 2), gray,
                             width=2, x_range=x_range, y_range=y_range)
        if near_c is not None and far_c is not None:
            img = draw_lines(img, proj(near_c).reshape(-1, 2),
                             proj(far_c).reshape(-1, 2), gray, width=2,
                             x_range=x_range, y_range=y_range)

        # frusta: origin->corner spokes + corner ring, in per-camera color
        orig = proj(extrinsics[:, :3, 3])  # [B, 2]
        pc = proj(corners)  # [B, 4, 2]
        starts = np.concatenate([
            np.repeat(orig[:, None], 4, 1).reshape(-1, 2),
            np.roll(pc, 1, axis=1).reshape(-1, 2)], 0)
        ends = np.concatenate([pc.reshape(-1, 2), pc.reshape(-1, 2)], 0)
        cols = np.concatenate([np.repeat(color, 4, 0)] * 2, 0)
        img = draw_lines(img, starts, ends, cols, width=2,
                         x_range=x_range, y_range=y_range)
        img = add_label(img, f"{'XYZ'[ax_x]}{'XYZ'[ax_y]} Projection")
        panels.append(img)

    hh = max(p.shape[0] for p in panels)
    panels = [np.pad(p, ((0, hh - p.shape[0]), (0, 0), (0, 0)),
                     constant_values=1.0) for p in panels]
    return np.stack(panels)


def render_projections(
    means,
    covariances,
    harmonics,
    opacities,
    resolution: int,
    margin: float = 0.1,
    draw_label: bool = True,
    extra_label: str = "",
    device=None,
) -> np.ndarray:
    """Orthographic renders of the Gaussians down each world axis.

    Returns [3, resolution, resolution, 3]. Renders on `device`, by default
    that of `means` where it is a tensor and the card otherwise."""
    from ..ops.rasterizer_ref import render_dense

    if device is None:
        device = means.device if isinstance(means, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    g = [x.to(dev, torch.float32) if isinstance(x, torch.Tensor)
         else torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
         for x in (means, covariances, harmonics, opacities)]
    means = g[0].cpu().numpy()
    minima, maxima = compute_equal_aabb_with_margin(
        means.min(0), means.max(0), margin)
    extent = float((maxima - minima).max())

    panels = []
    for look in range(3):
        right, down = (look + 1) % 3, (look + 2) % 3
        c2w = np.zeros((4, 4), np.float32)
        c2w[right, 0] = 1.0
        c2w[down, 1] = 1.0
        c2w[look, 2] = 1.0
        c2w[right, 3] = 0.5 * (minima[right] + maxima[right])
        c2w[down, 3] = 0.5 * (minima[down] + maxima[down])
        c2w[look, 3] = minima[look]
        c2w[3, 3] = 1.0
        with torch.no_grad():
            out = render_dense(
                *g, torch.as_tensor(c2w, device=dev), (resolution, resolution),
                camera_kind="ortho", near=0.0, far=extent,
                ortho_extent=extent,
            )
        img = out.color.cpu().numpy()
        if draw_label:
            lbl = f"{'XYZ'[right]}{'XYZ'[down]} Projection {extra_label}"
            img = add_label(img, lbl.strip())
        panels.append(img)

    hh = max(p.shape[0] for p in panels)
    panels = [np.pad(p, ((0, hh - p.shape[0]), (0, 0), (0, 0)),
                     constant_values=1.0) for p in panels]
    return np.stack(panels)


# Canonical 90-degree-fov normalized intrinsics used to orient ERP cameras in
# figures: the sphere batch carries no pinhole intrinsics (deliberate redesign
# - cube artifacts are derived on device), so frusta are drawn with the front
# cube face's K. Reference draws per-view pinhole K (validation_in_3d.py:104).
_ERP_FIGURE_K = np.array(
    [[0.5, 0.0, 0.5], [0.0, 0.5, 0.5], [0.0, 0.0, 1.0]], np.float32)


def render_cameras(batch: dict, resolution: int) -> np.ndarray:
    """Context (white) + target (red) camera figure for a sphere batch
    (numpy arrays or tensors on any device).

    Reference: src/visualization/validation_in_3d.py:93-115."""
    def first(view, key):
        x = batch[view][key][0]
        return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)

    ctx, tgt = first("context", "extrinsics_sphere"), first("target", "extrinsics_sphere")
    vc, vt = ctx.shape[0], tgt.shape[0]
    color = np.ones((vc + vt, 3), np.float32)
    color[vc:, 1:] = 0.0
    extr = np.concatenate([ctx, tgt], 0)
    intr = np.broadcast_to(_ERP_FIGURE_K, (vc + vt, 3, 3))
    near = np.concatenate([first("context", "near").reshape(-1),
                           first("target", "near").reshape(-1)], 0)
    far = np.concatenate([first("context", "far").reshape(-1),
                          first("target", "far").reshape(-1)], 0)
    return draw_cameras(resolution, extr, intr, color, near=near, far=far)
