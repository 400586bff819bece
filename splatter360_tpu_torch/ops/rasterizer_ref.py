"""Dense reference renderer: every Gaussian over every pixel (the oracle).

Counterpart of splatter360_tpu/ops/rasterizer_ref.py (`composite_dense`,
`render_dense`). Slow and autograd-exact, for small images and tests; it
shares no code with the tiled compositor, so it checks it independently.
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
    """Sort all Gaussians by depth and composite them over every pixel, one
    Gaussian at a time. Returns (image [H, W, C], transmittance [H, W],
    depth [H, W] or None)."""
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
    yy, xx = torch.meshgrid(torch.arange(h, dtype=dt, device=dev),
                            torch.arange(w, dtype=dt, device=dev), indexing="ij")
    rgb = torch.zeros((h, w, col.shape[-1]), dtype=col.dtype, device=dev)
    trans = torch.ones((h, w), dtype=col.dtype, device=dev)
    dacc = torch.zeros((h, w), dtype=col.dtype, device=dev)
    for m, cn, c, o, d, r in zip(mean2d, conic, col, op, dep, rad):
        dx = xx - m[0]
        if wrap_x:
            dx = dx - w * torch.round(dx / w)
        dy = yy - m[1]
        power = -0.5 * (cn[0] * dx * dx + cn[2] * dy * dy) - cn[1] * dx * dy
        alpha = torch.clamp(o * torch.exp(power), max=0.99)
        inside = (torch.abs(dx) <= r[0]) & (torch.abs(dy) <= r[1])
        alpha = torch.where(inside & (power > -4.5) & (power <= 0.0) & (alpha >= 1.0 / 255.0),
                            alpha, torch.zeros_like(alpha))
        trans_new = trans * (1.0 - alpha)
        weight = torch.where(trans_new >= 1e-4, alpha * trans, torch.zeros_like(alpha))
        rgb = rgb + weight[..., None] * c
        dacc = dacc + weight * d
        trans = trans_new
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
