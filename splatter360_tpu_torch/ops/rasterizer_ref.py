"""Dense reference renderer: every Gaussian over every pixel (the oracle).

Counterpart of splatter360_tpu/ops/rasterizer_ref.py (`composite_dense`,
`render_dense`). Autograd-exact, for tests and offline rendering
(preprocess/generate.py, data/scene_io.write_synthetic_scene,
utils/drawing.render_projections); it shares no code with the tiled
compositor, so it checks it independently.
Compositing follows the CUDA rasterizer's numerics: alpha = min(0.99,
opacity exp(power)) inside the per-axis radius box, dropped below 1/255;
front to back, a Gaussian contributes while the transmittance after it
stays at or above 1e-4; the background is composited with the final
transmittance.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .projection import Projected, project_erp, project_ortho, project_pinhole, sh_colors
from .rasterizer import RenderOutput, transform_depth


# the Gaussians a chunk of composite_dense evaluates at once: as many as keep
# one [K, H, W] float32 tensor near this many bytes, on the card (K = 128 at
# 512x1024) and on the host, whose caches favour smaller chunks (K = 128 at
# 256x256: the three 256x256 panels of utils/drawing.render_projections of a
# 21k-Gaussian room took 10.4 s on an 8-core host against ~32 s at the
# card's budget)
CHUNK_BYTES, HOST_CHUNK_BYTES = 256 * 2**20, 32 * 2**20


def composite_dense(
    proj: Projected,
    colors: torch.Tensor,      # [N, C]
    opacities: torch.Tensor,   # [N]
    image_shape: tuple[int, int],
    background: torch.Tensor,  # [C]
    wrap_x: bool,
    return_depth: bool = False,
    depth_vals: Optional[torch.Tensor] = None,
):
    """Sort all Gaussians by depth and composite them over every pixel.
    Returns (image [H, W, C], transmittance [H, W], depth [H, W] or None).

    The Gaussians go in chunks of CHUNK_BYTES' worth (HOST_CHUNK_BYTES' on
    the CPU) along the sorted order. A chunk's alphas
    are computed at once as [K, h', w'] tensors over the window its radius
    boxes cover (all columns where x wraps); the Gaussians with a non-zero
    alpha at a pixel are then moved to the front of its column, in order,
    and the front-to-back recurrence walks those slots only. A zero alpha leaves T, colour and
    depth as they were, so every product and sum is the one the walk over
    all Gaussians, one at a time, takes: the result is the same bit for
    bit."""
    h, w = image_shape
    order = torch.argsort(torch.where(proj.valid, proj.depth,
                                      torch.full_like(proj.depth, math.inf)), stable=True)
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    col = colors[order]
    op = torch.where(proj.valid, opacities, torch.zeros_like(opacities))[order]
    dep = (proj.depth if depth_vals is None else depth_vals)[order]
    rad = proj.radius[order]

    dt, dev = mean2d.dtype, mean2d.device
    rgb = torch.zeros((h, w, col.shape[-1]), dtype=col.dtype, device=dev)
    trans = torch.ones((h, w), dtype=col.dtype, device=dev)
    dacc = torch.zeros((h, w), dtype=col.dtype, device=dev)
    n = mean2d.shape[0]
    budget = CHUNK_BYTES if dev.type == "cuda" else HOST_CHUNK_BYTES
    k = max(1, budget // (4 * h * w))
    for s in range(0, n, k):
        m, cn, r, o = mean2d[s:s + k], conic[s:s + k], rad[s:s + k], op[s:s + k]
        # the chunk's window: the pixels inside some of its radius boxes (a
        # pixel outside every box gets no alpha), with a pixel of margin
        on = (o > 0)[:, None]
        box = torch.cat([torch.where(on, m - r, math.inf).amin(0),
                         torch.where(on, m + r, -math.inf).amax(0)]).tolist()
        if not all(map(math.isfinite, box)):
            if box[0] == math.inf:  # no Gaussian of the chunk is visible
                continue
            box = [0, 0, w, h]
        x0, y0 = (max(math.floor(v) - 1, 0) for v in box[:2])
        x1, y1 = min(math.ceil(box[2]) + 2, w), min(math.ceil(box[3]) + 2, h)
        if wrap_x:
            x0, x1 = 0, w
        if x0 >= x1 or y0 >= y1:
            continue
        # dx varies along x only and dy along y only: [K, 1, w'] and [K, h', 1]
        xx = torch.arange(x0, x1, dtype=dt, device=dev)[None, None, :]
        yy = torch.arange(y0, y1, dtype=dt, device=dev)[None, :, None]
        m, cn = m[:, :, None, None], cn[:, :, None, None]
        dx = xx - m[:, 0]
        if wrap_x:
            dx = dx - w * torch.round(dx / w)
        dy = yy - m[:, 1]
        power = -0.5 * (cn[:, 0] * dx * dx + cn[:, 2] * dy * dy) - cn[:, 1] * dx * dy
        alpha = torch.clamp(o[:, None, None] * torch.exp(power), max=0.99)
        inside = (torch.abs(dx) <= r[:, 0, None, None]) & (torch.abs(dy) <= r[:, 1, None, None])
        live = inside & (power > -4.5) & (power <= 0.0) & (alpha >= 1.0 / 255.0)
        # each pixel's live Gaussians to the front of its column, in order:
        # the walk then takes as many steps as the busiest pixel has live
        # Gaussians, not K (walking all K slices was 5.6x slower on an H100
        # at 512x1024, chip_smoke.py 3s (a))
        rank = torch.cumsum(live, 0)
        depth_k = int(rank[-1].max())
        if depth_k == 0:
            continue
        slot = torch.where(live, rank - 1, depth_k)
        a = torch.zeros((depth_k + 1, *live.shape[1:]), dtype=alpha.dtype, device=dev).scatter(
            0, slot, torch.where(live, alpha, torch.zeros_like(alpha)))
        gi = torch.zeros((depth_k + 1, *live.shape[1:]), dtype=torch.long, device=dev).scatter(
            0, slot, torch.arange(s, s + live.shape[0], device=dev)[:, None, None].expand_as(slot))
        c, d = col[gi], dep[gi]
        win = (slice(y0, y1), slice(x0, x1))
        t, acc_c, acc_d = trans[win].clone(), rgb[win].clone(), dacc[win].clone()
        for j in range(depth_k):
            t_new = t * (1.0 - a[j])
            weight = torch.where(t_new >= 1e-4, a[j] * t, torch.zeros_like(a[j]))
            acc_c = acc_c + weight[..., None] * c[j]
            acc_d = acc_d + weight * d[j]
            t = t_new
        trans[win], rgb[win], dacc[win] = t, acc_c, acc_d
    rgb = rgb + trans[..., None] * background
    return rgb, trans, (dacc if return_depth else None)


def render_dense(
    means: torch.Tensor,        # [N, 3]
    covariances: torch.Tensor,  # [N, 6] sym6 or [N, 3, 3]
    harmonics: torch.Tensor,    # [N, 3, d_sh]
    opacities: torch.Tensor,    # [N]
    c2w: torch.Tensor,          # [4, 4]
    image_shape: tuple[int, int],
    camera_kind: str = "erp",
    intrinsics: Optional[torch.Tensor] = None,
    near=0.1,
    far=100.0,
    background: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    render_depth: bool = False,
    depth_mode: str = "depth",
    ortho_extent: float = 2.0,
) -> RenderOutput:
    """Render one view (camera_kind "erp", "pinhole" or "ortho", whose world
    square of side ortho_extent fills the image). d_sh == 1 means
    precomputed colours (no +0.5 offset). `dropped` is 0: nothing is
    capped."""
    if background is None:
        background = torch.zeros(3, dtype=means.dtype, device=means.device)
    if sh_degree is None:
        sh_degree = int(math.isqrt(harmonics.shape[-1]) - 1)
    if camera_kind == "erp":
        proj = project_erp(means, covariances, c2w, image_shape, near)
    elif camera_kind == "pinhole":
        if intrinsics is None:
            raise ValueError("a pinhole render needs intrinsics")
        proj = project_pinhole(means, covariances, c2w, intrinsics, image_shape, near)
    elif camera_kind == "ortho":
        proj = project_ortho(means, covariances, c2w, ortho_extent, image_shape, near, far)
    else:
        raise ValueError(f"camera_kind={camera_kind!r}: expected 'erp', 'pinhole' or 'ortho'")
    if harmonics.shape[-1] == 1:
        colors = harmonics[..., 0]
    else:
        colors = sh_colors(harmonics, means, c2w[:3, 3], sh_degree)
    rgb, trans, depth = composite_dense(
        proj, colors, opacities, image_shape, background, camera_kind == "erp", render_depth,
        depth_vals=transform_depth(proj.depth, depth_mode, near, far))
    return RenderOutput(color=rgb, depth=depth, alpha=1.0 - trans,
                        dropped=torch.zeros((), dtype=torch.int32, device=means.device))
